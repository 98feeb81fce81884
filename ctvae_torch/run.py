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
stops. ``exp_params.metrics`` (names of ``metrics.METRICS``) adds the
disentanglement metrics to each validation, computed over the validation
dataset's full factor dataset (``_full_data``) with 20 / 10 train batches'
worth of samples, as the JAX ``run.py`` wires them;
``exp_params.async_checkpointing`` writes checkpoints on a thread.

``train(config, device)`` does the work for a config dict.

Data-parallel training: launched by ``torchrun``,

    python -m torch.distributed.run --nproc_per_node N \
        -m ctvae_torch.run -c configs/ct_mcq_vae.yaml

each rank brings up the process group (also at a world of 1) on
``cuda:LOCAL_RANK``, or on the ``--device`` given (``cpu`` takes gloo,
a card NCCL; ``--backend gloo`` lets several ranks share one card), takes
its rows of each global batch of ``train_batch_size x N`` and tears the
group down at the end; only rank 0 writes the run's files
(``training/experiment.py``). A caller that brought a group up itself
keeps it.
"""

from __future__ import annotations

import argparse
import os
import signal
from typing import Dict, List, Optional


def _torchrun_device(device) -> "torch.device":
    """A ``torchrun`` rank's device: the caller's, with ``cuda`` meaning
    ``cuda:LOCAL_RANK``; a card past the machine's raises."""
    import torch
    local = int(os.environ["LOCAL_RANK"])
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return device
    index = local if device.index is None else device.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"rank {os.environ['RANK']} (LOCAL_RANK {local}) "
                           f"asks for cuda:{index}, but this machine has "
                           f"{torch.cuda.device_count()} card(s)")
    return torch.device("cuda", index)


def train(config: Dict, device=None, backend: Optional[str] = None) -> dict:
    """Train the model of ``config`` (the YAML's sections as dicts) on
    ``device`` (default ``cuda``); returns the last epoch's ``train_`` and
    ``val_`` metrics. The run's files go to the first free
    ``<save_dir>/<name>/version_<n>``. Under ``torchrun`` it brings the
    process group up (``backend``, or NCCL on a card and gloo on the CPU)
    and down; under a group that is already up it trains over that."""
    import torch.distributed as dist

    from .parallel import mesh

    own_group = mesh.launched_by_torchrun() and not dist.is_initialized()
    if own_group:
        device = _torchrun_device(device)
        mesh.init_distributed(backend, device=device)
    try:
        return _train(config, device)
    finally:
        if own_group:
            mesh.destroy()


def _train(config: Dict, device) -> dict:
    import torch

    from .data import VAEDataset
    from .metrics import MetricSet
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

    if str(exp_params.get("sharding", "")).lower() == "sp":
        # sequence parallelism splits the CT model's target nodes over the
        # mesh's model axis; build_model drops the key for models without
        # the field (they have no node axis to split), as JAX's run.py
        model_params = dict(model_params, seq_axis=model_params.get(
            "seq_axis", "model"))
    seed = int(exp_params.get("manual_seed", 1265))
    device = resolve_device(device)
    logger = ExperimentLogger(
        save_dir=logging_params.get("save_dir", "logs/"),
        name=logging_params.get("name", model_params.get("name", "model")),
        use_wandb=bool(logging_params.get("use_wandb", False)),
        hparams=config)
    if logger.writes:
        print(f"=> logging to {logger.log_dir}", flush=True)
    model = build_model(model_params, device=device,
                        generator=torch.Generator(device).manual_seed(seed))
    data_params.setdefault("seed", seed)
    data = VAEDataset(**data_params)
    data.setup()
    val_metrics = None
    if exp_params.get("metrics"):
        full = getattr(data.val_dataset, "_full_data", data.val_dataset)
        tbs = int(data_params.get("train_batch_size", 64))
        val_metrics = MetricSet(
            list(exp_params["metrics"]), full,
            batch_size=int(data_params.get("val_batch_size", 64)),
            num_train=tbs * 20, num_test=tbs * 10)
    ckpt = CheckpointManager(
        os.path.join(logger.log_dir, "checkpoints"), top_k=2,
        monitor="val_Reconstruction_Loss",
        async_save=bool(exp_params.get("async_checkpointing", False)))
    experiment = VAEXperiment(model, exp_params, data, logger=logger,
                              ckpt_manager=ckpt, val_metrics=val_metrics)
    for sub in ("Inputs", "Samples", "Reconstructions"):
        if logger.writes:
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
                        help="torch device (default: cuda, which must exist; "
                             "under torchrun cuda:LOCAL_RANK)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="process group backend under torchrun (default: "
                             "nccl on a card, gloo on the CPU)")
    args = parser.parse_args(argv)

    from .config import read_config
    return train(read_config(args.filename), device=args.device,
                 backend=args.backend)


if __name__ == "__main__":
    main()
