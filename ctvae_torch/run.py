"""Training entry point of the port.

    python -m ctvae_torch.run -c configs/synthetic_ct.yaml [--device cpu]

Reads the same YAML schema as the JAX package's ``run.py``
(``model_params`` / ``data_params`` / ``exp_params`` / ``trainer_params``)
and trains on ``cuda`` unless ``--device`` says otherwise. The PL Trainer
knobs ``gradient_clip_val`` and ``accumulate_grad_batches`` move from
``trainer_params`` to the optimizer, as there. Checkpoints, resume and
logging are not ported yet (ROADMAP A2): ``resume_from_checkpoint``
raises, and the metrics of each epoch are printed.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


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

    exp_params = dict(config.get("exp_params", {}))
    trainer_params = dict(config.get("trainer_params", {}))
    data_params = dict(config.get("data_params", {}))
    for knob in ("gradient_clip_val", "accumulate_grad_batches"):
        if knob in trainer_params:
            exp_params.setdefault(knob, trainer_params.pop(knob))
    if trainer_params.get("resume_from_checkpoint"):
        raise NotImplementedError("checkpoints are not ported yet "
                                  "(ROADMAP A2)")

    seed = int(exp_params.get("manual_seed", 1265))
    device = resolve_device(args.device)
    model = build_model(config["model_params"], device=device,
                        generator=torch.Generator(device).manual_seed(seed))
    data_params.setdefault("seed", seed)
    data = VAEDataset(**data_params)
    data.setup()
    experiment = VAEXperiment(model, exp_params, data)
    max_epochs = int(trainer_params.get("max_epochs", 100))
    print(f"======= Training {config['model_params'].get('name')} on "
          f"{device} ({data.steps_per_epoch()} steps per epoch) =======",
          flush=True)
    return experiment.fit(max_epochs, seed=seed)


if __name__ == "__main__":
    main()
