"""Training entry point of the port.

    python -m ctvae_torch.run -c configs/ct_mcq_vae.yaml [--device cpu]

Reads the same YAML schema as the JAX package's ``run.py``
(``model_params`` / ``data_params`` / ``exp_params`` / ``trainer_params``
/ ``logging_params``), without PyYAML (``config.read_config``), and
trains on ``cuda`` unless ``--device`` says otherwise. The PL Trainer
knobs ``gradient_clip_val`` and ``accumulate_grad_batches`` move from
``trainer_params`` to the optimizer, as there. The run's directory is
``<save_dir>/<name>/version_<n>`` (``utils/logging.py``): ``hparams.json``,
``scalars.jsonl``, the ``Inputs`` / ``Reconstructions`` / ``Samples``
grids of each epoch and ``checkpoints`` (the best two by
``val_Reconstruction_Loss`` and ``last``). ``trainer_params.
resume_from_checkpoint`` resumes the full state from a checkpoint file,
or with ``load_weights_only: true`` loads its weights only (the two-stage
recipe). SIGTERM saves ``last`` at the end of the running epoch and
stops.

``train(config, device)`` does the work for a config dict.
"""

from __future__ import annotations

import argparse
import os
import signal
from typing import Dict, List, Optional


def train(config: Dict, device=None) -> dict:
    """Train the model of ``config`` (the YAML's sections as dicts) on
    ``device`` (default ``cuda``); returns the last epoch's ``train_`` and
    ``val_`` metrics. The run's files go to the first free
    ``<save_dir>/<name>/version_<n>``."""
    import torch

    from .data import VAEDataset
    from .models import build_model
    from .ops.common import resolve_device
    from .training import VAEXperiment, install_preemption_handler
    from .utils.checkpoint import CheckpointManager
    from .utils.logging import ExperimentLogger

    exp_params = dict(config.get("exp_params", {}))
    trainer_params = dict(config.get("trainer_params", {}))
    data_params = dict(config.get("data_params", {}))
    logging_params = config.get("logging_params", {})
    model_params = config["model_params"]
    for knob in ("gradient_clip_val", "accumulate_grad_batches"):
        if knob in trainer_params:
            exp_params.setdefault(knob, trainer_params.pop(knob))

    seed = int(exp_params.get("manual_seed", 1265))
    device = resolve_device(device)
    logger = ExperimentLogger(
        save_dir=logging_params.get("save_dir", "logs/"),
        name=logging_params.get("name", model_params.get("name", "model")),
        use_wandb=bool(logging_params.get("use_wandb", False)),
        hparams=config)
    print(f"=> logging to {logger.log_dir}", flush=True)
    model = build_model(model_params, device=device,
                        generator=torch.Generator(device).manual_seed(seed))
    data_params.setdefault("seed", seed)
    data = VAEDataset(**data_params)
    data.setup()
    ckpt = CheckpointManager(os.path.join(logger.log_dir, "checkpoints"),
                             top_k=2, monitor="val_Reconstruction_Loss")
    experiment = VAEXperiment(model, exp_params, data, logger=logger,
                              ckpt_manager=ckpt)
    for sub in ("Inputs", "Samples", "Reconstructions"):
        os.makedirs(os.path.join(logger.log_dir, sub), exist_ok=True)
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
    # a preemption notice (SIGTERM) checkpoints and stops at the epoch's end
    previous = install_preemption_handler(experiment)
    try:
        out = experiment.fit(max_epochs, seed=seed,
                             sample_dir=logger.log_dir)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        logger.finish()
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description="Train a model of the port")
    parser.add_argument("--config", "-c", dest="filename", metavar="FILE",
                        default="configs/synthetic_ct.yaml",
                        help="path to the config file")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda, which must exist)")
    args = parser.parse_args(argv)

    from .config import read_config
    return train(read_config(args.filename), device=args.device)


if __name__ == "__main__":
    main()
