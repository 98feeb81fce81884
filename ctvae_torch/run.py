"""Training entry point of the port.

    python -m ctvae_torch.run -c configs/synthetic_ct.yaml [--device cpu]

Reads the same YAML schema as the JAX package's ``run.py``
(``model_params`` / ``data_params`` / ``exp_params`` / ``trainer_params``
/ ``logging_params``) and trains on ``cuda`` unless ``--device`` says
otherwise. The PL Trainer knobs ``gradient_clip_val`` and
``accumulate_grad_batches`` move from ``trainer_params`` to the optimizer,
as there. Checkpoints (the best two by ``val_Reconstruction_Loss`` and
``last``) go to ``<save_dir>/<name>/version_<n>/checkpoints``;
``trainer_params.resume_from_checkpoint`` resumes the full state from a
checkpoint file, or with ``load_weights_only: true`` loads its weights
only (the two-stage recipe). The metrics of each epoch are printed; the
logger is not ported yet (ROADMAP A4).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def next_version_dir(save_dir: str, name: str) -> str:
    """``<save_dir>/<name>/version_<n>`` with n one above the highest
    existing version (0 for the first run), as the JAX logger numbers
    its runs."""
    base = os.path.join(save_dir, name)
    versions = [int(d.split("_")[1]) for d in
                (os.listdir(base) if os.path.isdir(base) else [])
                if d.startswith("version_") and d.split("_")[1].isdigit()]
    return os.path.join(base, f"version_{max(versions) + 1 if versions else 0}")


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description="Train a model of the port")
    parser.add_argument("--config", "-c", dest="filename", metavar="FILE",
                        default="configs/synthetic_ct.yaml",
                        help="path to the config file")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda, which must exist)")
    args = parser.parse_args(argv)

    import yaml   # here, not at import: the card's machine has no PyYAML
    with open(args.filename) as f:
        config = yaml.safe_load(f)

    import torch

    from .data import VAEDataset
    from .models import build_model
    from .ops.common import resolve_device
    from .training import VAEXperiment
    from .utils.checkpoint import CheckpointManager

    exp_params = dict(config.get("exp_params", {}))
    trainer_params = dict(config.get("trainer_params", {}))
    data_params = dict(config.get("data_params", {}))
    logging_params = config.get("logging_params", {})
    model_params = config["model_params"]
    for knob in ("gradient_clip_val", "accumulate_grad_batches"):
        if knob in trainer_params:
            exp_params.setdefault(knob, trainer_params.pop(knob))

    seed = int(exp_params.get("manual_seed", 1265))
    device = resolve_device(args.device)
    model = build_model(model_params, device=device,
                        generator=torch.Generator(device).manual_seed(seed))
    data_params.setdefault("seed", seed)
    data = VAEDataset(**data_params)
    data.setup()
    log_dir = next_version_dir(
        logging_params.get("save_dir", "logs/"),
        logging_params.get("name", model_params.get("name", "model")))
    ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"), top_k=2,
                             monitor="val_Reconstruction_Loss")
    print(f"=> checkpoints to {ckpt.dir}", flush=True)
    experiment = VAEXperiment(model, exp_params, data, ckpt_manager=ckpt)
    experiment.setup(seed=seed)

    resume = trainer_params.get("resume_from_checkpoint")
    if resume:
        if trainer_params.get("load_weights_only", False):
            experiment.load_weights(resume)
            print(f"=> loaded weights (only) from {resume}", flush=True)
        else:
            experiment.restore_full_state(resume)
            print(f"=> resumed full state from {resume} (step "
                  f"{experiment.global_step}, epoch "
                  f"{experiment.start_epoch})", flush=True)

    max_epochs = int(trainer_params.get("max_epochs", 100))
    print(f"======= Training {model_params.get('name')} on "
          f"{device} ({data.steps_per_epoch()} steps per epoch) =======",
          flush=True)
    return experiment.fit(max_epochs, seed=seed)


if __name__ == "__main__":
    main()
