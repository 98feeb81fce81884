"""Apply CT-VAE actions to images and measure causal accuracy.

    python -m ctvae_torch.apply_action -c configs/ct_mcq_vae.yaml \\
        --ckpt <checkpoint file> [--walk WALKS,STEPS,DIMS] \\
        [--navigate STEPS] [--device cpu]

Counterpart of the JAX package's ``apply_action.py``, with its file names:

1. build the config's CTMCQVAE and restore a checkpoint's weights only;
2. take the first action-mode batch of the test split;
3. apply every (+/-) action to one input image ``--steps`` times over,
   saving each result as ``images/<dataset>_<id>/CT-VAE_output_...png``;
4. optionally render latent walks (``CTMCQVAE.walk``) and a latent
   interpolation from a test image to its transition target
   (``CTMCQVAE.navigate``);
5. sweep the test split in causal mode and report the mean
   ``causal_acc`` / ``causal_nodir_acc``.

The config is read without PyYAML (``config.read_config``);
``apply_action(config, ckpt)`` does the same for a config dict. Runs on
``cuda`` unless ``device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

DRAW_SEED = 7   # the random draws of every forward, as the JAX tool fixes

ACTION_NAMES = {
    "TCeleba": ["5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive",
                "Bags_Under_Eyes", "Bald", "Bangs", "Big_Lips", "Big_Nose",
                "Black_Hair", "Blond_Hair"],
    "TCars3D": ["elevation", "azimuth", "object_type"],
    "TShapes3D": ["floor_hue", "wall_hue", "object_hue", "scale", "shape",
                  "orientation"],
    "TDSprites": ["shape", "scale", "orientation", "position_x",
                  "position_y"],
    "TSprites": ["bottomwear", "topwear", "hair", "eyes", "shoes", "body",
                 "action", "rotation", "frame"],
    "TSynthetic": [f"f{i}" for i in range(4)],
}


def apply_action(config: Dict, ckpt: str, out: str = "images/",
                 run_id: str = "test0", steps: int = 5,
                 walk: Optional[Tuple[int, int, int]] = None,
                 navigate: Optional[int] = None, device=None) -> Dict:
    """Run the rollout, the optional ``walk`` (walks, steps, dims) and
    ``navigate`` (intermediate steps) renders and the causal sweep for the
    model of ``config`` with the weights of checkpoint ``ckpt``. Returns
    the output directory, the PNG paths written, and the sweep's mean
    accuracies and batch count."""
    import torch

    from .data import VAEDataset
    from .models import build_model
    from .models.base import Draws
    from .ops.common import resolve_device
    from .data.prefetch import to_device
    from .utils.checkpoint import load_weights_only
    from .utils.images import save_image

    device = resolve_device(device)
    model = build_model(config["model_params"], device=device)
    load_weights_only(ckpt, model)
    data = VAEDataset(**config["data_params"])
    data.setup()
    batch = next((b for b in data.test_dataloader(0)
                  if b.get("mode") == "action"), None)
    if batch is None:
        raise ValueError("no action batches in the test split")
    batch.pop("mode")
    batch = to_device(batch, device)
    generator = torch.Generator(device).manual_seed(DRAW_SEED)

    dataset_name = config["data_params"].get("dataset_name", "TShapes3D")
    action_list = ACTION_NAMES.get(
        dataset_name, [f"a{i}" for i in range(model.action_dim // 2)])
    nb_actions = 2 * len(action_list)
    out_dir = os.path.join(out, f"{dataset_name}_{run_id}")
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []

    def save(images: torch.Tensor, name: str) -> None:
        path = os.path.join(out_dir, name)
        save_image(images.cpu().numpy(), path, normalize=True)
        written.append(path)

    with torch.inference_mode():
        # iterative action application
        sample = batch["image"][:1]
        save(sample, f"CT-VAE_input_{dataset_name}.png")
        sample = sample.repeat(nb_actions, 1, 1, 1)
        actions = torch.eye(model.action_dim, device=device)[:nb_actions]
        for step in range(steps):
            sample = model(sample, input_y=sample, action=actions,
                           mode="action",
                           draws=Draws(generator, device))["recons"]
            for sign_id, sign in enumerate(["+", "-"]):
                for a_id, a_name in enumerate(action_list):
                    save(sample[sign_id * len(action_list) + a_id][None],
                         f"CT-VAE_output_{dataset_name}_{a_name}_{sign}"
                         f"{step}.png")

        # latent traversals
        if walk is not None:
            n_walks, n_steps, n_dims = walk
            frames = model.walk(n_steps, n_dims, n_walks,
                                draws=Draws(generator, device))
            for w in range(n_walks):
                for s in range(n_steps):
                    save(frames[w * n_steps + s][None],
                         f"CT-VAE_walk{w}_step{s}.png")
        if navigate is not None:
            frames = model.navigate(batch["image"][0], batch["input_y"][0],
                                    navigate)
            for s in range(frames.shape[0]):
                save(frames[s][None], f"CT-VAE_navigate_{s}.png")

        # causal accuracy sweep
        accs, nodirs = [], []
        for b in data.test_dataloader(0):
            if b.pop("mode") != "causal":
                continue
            b = to_device(b, device)
            metrics = model(b["image"], input_y=b["input_y"],
                            action=b["action"], mode="causal",
                            draws=Draws(generator, device))["metrics"]
            accs.append(float(metrics["causal_acc"]))
            nodirs.append(float(metrics["causal_nodir_acc"]))
    return {"out_dir": out_dir, "images": written,
            "causal_acc": float(np.mean(accs)) if accs else None,
            "causal_nodir_acc": float(np.mean(nodirs)) if nodirs else None,
            "causal_batches": len(accs)}


def main(argv: Optional[List[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", "-c", default="configs/ct_mcq_vae.yaml")
    parser.add_argument("--ckpt", required=True,
                        help="checkpoint file (CheckpointManager)")
    parser.add_argument("--out", default="images/")
    parser.add_argument("--run-id", default="test0")
    parser.add_argument("--steps", type=int, default=5,
                        help="iterative action applications")
    parser.add_argument("--walk", metavar="WALKS,STEPS,DIMS", default=None,
                        help="also render random latent-space walks: hold "
                             "a base latent, re-randomize DIMS channels "
                             "per step (CTMCQVAE.walk)")
    parser.add_argument("--navigate", type=int, default=None,
                        metavar="STEPS",
                        help="also render a latent interpolation with "
                             "STEPS intermediates from a test image to "
                             "its transition target (CTMCQVAE.navigate)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda, which must exist)")
    args = parser.parse_args(argv)

    from .config import read_config
    config = read_config(args.config)
    walk = (tuple(int(v) for v in args.walk.split(","))
            if args.walk else None)
    result = apply_action(config, args.ckpt, out=args.out,
                          run_id=args.run_id, steps=args.steps, walk=walk,
                          navigate=args.navigate, device=args.device)
    print(f"action rollout images -> {result['out_dir']} "
          f"({len(result['images'])} files)")
    if result["causal_batches"]:
        print(f"val causal_acc mean:       {result['causal_acc']:.4f} over "
              f"{result['causal_batches']} batches")
        print(f"val causal_nodir_acc mean: {result['causal_nodir_acc']:.4f}")
    else:
        print("no causal batches in the test split")
    return result


if __name__ == "__main__":
    main()
