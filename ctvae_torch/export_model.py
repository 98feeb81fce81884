"""Export a model to a self-contained serving artifact.

    python -m ctvae_torch.export_model -c configs/ct_mcq_vae.yaml \\
        --out artifacts/ct [--ckpt <checkpoint file>] [--fns a,b] \\
        [--batch 8] [--poly-batch] [--num-samples 64] [--device cpu]

Counterpart of the JAX package's ``scripts/export_model.py``, with its
flags (``--device`` in place of ``--platforms``): builds the config's model
(read without PyYAML, ``config.read_config``), restores a port
checkpoint's weights (``load_weights_only``; without ``--ckpt`` it warns
and exports the random initialisation), takes its example batch from the
config's data module (an action-mode batch where there is one), exports
each entry point the model serves (``serving/export.py``), saves the
artifact, reloads it and holds each function against the live port on the
same key (``verify``: rtol 1e-4, atol 1e-5 at float32; at ``dtype:
bfloat16`` 4 bfloat16 ulps of the output's scale) before it prints the
artifact's path.
Serving needs torch and ``ctvae_torch.ops`` only::

    from ctvae_torch.serving.export import load_artifact
    fns, manifest = load_artifact("artifacts/ct")     # device="cpu" moves
    imgs = fns["reconstruct"](torch.tensor(0), batch)

``export_model(config, out, ...)`` does the same for a config dict; runs on
``cuda`` unless ``device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

KEY = 7     # the example key, as the JAX script's PRNGKey(7)


def example_batch(data_params: dict) -> Dict[str, np.ndarray]:
    """The first action-mode batch of the data module's test split (the
    JAX script's seek), else its first batch."""
    from .data import VAEDataset
    data = VAEDataset(**data_params)
    data.setup()
    batch = None
    for b in data.test_dataloader(0):
        if batch is None:
            batch = b
        if b.get("mode") == "action" or "mode" not in b:
            batch = b
            break
    return batch


def example_args(model, batch: Dict[str, np.ndarray], key, *, B: int,
                 num_samples: int) -> Dict[str, Optional[tuple]]:
    """Each entry point's example arguments (the key first) from the first
    ``B`` rows of ``batch``, on ``key``'s device; None where the batch
    lacks an input (an action entry point on a plain dataset). A labelled
    model's ``sample`` takes the labels tiled to ``num_samples`` rows."""
    import torch

    def rows(k):
        if k not in batch:
            return None
        return torch.as_tensor(np.asarray(batch[k][:B])).to(key.device)
    x = rows("image")
    if getattr(model, "needs_labels", False):
        labels = rows("labels")
        reps = -(-num_samples // labels.shape[0])
        sample_labels = labels.repeat(reps, 1)[:num_samples]
        return {"reconstruct": (key, x, labels), "encode": (key, x, labels),
                "sample": (key, sample_labels)}
    y, action = rows("input_y"), rows("action")
    return {"reconstruct": (key, x), "encode": (key, x), "sample": (key,),
            "apply_action": (key, x, y, action)
            if action is not None else None,
            "classify_action": (key, x, y) if y is not None else None}


def export_entry_points(model, args: Dict[str, tuple],
                        names: Sequence[str], *, poly_batch: bool,
                        num_samples: int, log=print) -> tuple:
    """Export each of ``names`` at ``args[name]`` (``sample`` never with a
    symbolic batch, as JAX's). Returns ({name: exported program},
    {name: its ``EntryPoint``}, {name: export seconds})."""
    from .serving.export import EntryPoint, export_fn
    exported, entries, seconds = {}, {}, {}
    for name in names:
        if args.get(name) is None:
            print(f"skip {name}: example batch lacks its inputs (need a "
                  f"transition dataset)", file=sys.stderr)
            continue
        entries[name] = EntryPoint(model, name, num_samples=num_samples)
        start = time.perf_counter()
        exported[name] = export_fn(entries[name], args[name],
                                   poly_batch=poly_batch
                                   and name != "sample")
        seconds[name] = time.perf_counter() - start
        log(f"exported {name} in {seconds[name]:.2f} s")
    return exported, entries, seconds


#: ``verify``'s bound at bfloat16: |artifact - live| <= BF16_ULPS ulps
#: (2^-8 relative) of the output's scale, max(1, max |live|)
BF16_ULPS = 4


def verify(art_dir: str, entries: dict, args: Dict[str, tuple],
           log=print) -> Dict[str, float]:
    """Load the artifact and hold each function against its live entry
    point on the same arguments. The program runs the same operations in
    the same order, not bit for bit the same fusions: at float32 within
    rtol 1e-4, atol 1e-5; at bfloat16 (``manifest["dtype"]``) within
    ``BF16_ULPS`` bfloat16 ulps of the output's scale, the bound on the
    images of tests/test_torch_bf16.py: one intermediate rounded the other
    way moves an output by an ulp or two of its scale, while a flipped
    decision (a code, an argmax, an edge) moves it by far more and fails.
    Returns the largest difference per function."""
    import torch

    from .serving.export import load_artifact
    fns, manifest = load_artifact(art_dir)
    bf16 = manifest.get("dtype") == "bfloat16"
    diffs = {}
    for name, fn in fns.items():
        got = fn(*args[name])
        with torch.inference_mode():
            want = entries[name](*args[name])
        got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
        diffs[name] = float(np.abs(got - want).max())
        log(f"verify {name}: max|artifact - live| = {diffs[name]:.3g}")
        if bf16:
            bound = BF16_ULPS * 2.0 ** -8 * max(1.0, float(np.abs(want).max()))
            assert diffs[name] <= bound, \
                f"{name} round trip mismatch: {diffs[name]} > {bound}"
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} round trip mismatch")
    return diffs


def export_model(config: dict, out: str, *, ckpt: Optional[str] = None,
                 fns: Optional[Sequence[str]] = None, batch: int = 8,
                 poly_batch: bool = False, num_samples: int = 64,
                 device=None, log=print) -> dict:
    """Export, save and verify the entry points of the model of
    ``config`` (``fns``, default all it serves) into ``out``. Returns the
    manifest, the export seconds and the verified differences."""
    import torch

    from .models import build_model
    from .ops.common import resolve_device
    from .serving.export import MANIFEST_NAME, model_manifest, save_artifact
    from .serving.inference import available_fns
    from .utils.checkpoint import load_weights_only

    device = resolve_device(device)
    model = build_model(config["model_params"], device=device)
    if ckpt:
        load_weights_only(ckpt, model)
    else:
        print("WARNING: no --ckpt given; exporting randomly initialized "
              "weights", file=sys.stderr)
    args = example_args(model, example_batch(config["data_params"]),
                        torch.tensor(KEY, device=device), B=batch,
                        num_samples=num_samples)
    exported, entries, seconds = export_entry_points(
        model, args, list(fns or available_fns(model)),
        poly_batch=poly_batch, num_samples=num_samples, log=log)
    save_artifact(out, exported, {
        **model_manifest(model), "model": config["model_params"].get("name"),
        "checkpoint": ckpt, "poly_batch": bool(poly_batch)})
    diffs = verify(out, entries, args, log=log)
    log(f"artifact -> {out}")
    with open(os.path.join(out, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    return {"manifest": manifest, "export_seconds": seconds,
            "max_abs_diff": diffs}


def main(argv: Optional[Sequence[str]] = None) -> Tuple[str, dict]:
    from .config import read_config
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", "-c", default="configs/vae.yaml")
    parser.add_argument("--ckpt", default=None,
                        help="port checkpoint file (omit to export at "
                             "random init, e.g. for pipeline smoke tests)")
    parser.add_argument("--out", required=True, help="artifact directory")
    parser.add_argument("--fns", default=None,
                        help="comma-separated entry points (default: all "
                             "the model family supports)")
    parser.add_argument("--batch", type=int, default=8,
                        help="example batch size used for tracing")
    parser.add_argument("--poly-batch", action="store_true",
                        help="export with a symbolic batch dimension (one "
                             "artifact serves any batch size)")
    parser.add_argument("--device", default=None,
                        help="device to export on (default: cuda)")
    parser.add_argument("--num-samples", type=int, default=64,
                        help="static sample count for the `sample` export")
    args = parser.parse_args(argv)
    result = export_model(
        read_config(args.config), args.out, ckpt=args.ckpt,
        fns=args.fns.split(",") if args.fns else None, batch=args.batch,
        poly_batch=args.poly_batch, num_samples=args.num_samples,
        device=args.device)
    return args.out, result


if __name__ == "__main__":
    main()
