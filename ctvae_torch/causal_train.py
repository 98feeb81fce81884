"""Train the port's CT-MCQ-VAE on TSynthetic and print the causal-accuracy
trajectory as one JSON object, the schema of
``scripts/jax_causal_train.py`` (``"framework": "ctvae_torch"``).

    python -m ctvae_torch.causal_train --epochs 60 --seed 1265 \\
        [--pretrain-epochs N] [--device cpu] [--out result.json]

``--pretrain-epochs N > 0`` runs the two-stage recipe: pretrain an MCQVAE
on the same image stream for N epochs, save it with ``CheckpointManager``,
restore its weights only into a CTMCQVAE (the checkpoint goes through the
disk, as a user's would) and train ``ct_layer`` alone
(``update_parameters: ct_layer``). ``--pretrain-epochs 0`` trains the
whole model jointly. Runs on ``cuda`` unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=0.0005)
    ap.add_argument("--scheduler-gamma", type=float, default=1.0)
    ap.add_argument("--kld-weight", type=float, default=0.00025)
    ap.add_argument("--seed", type=int, default=1265)
    ap.add_argument("--img", type=int, default=16)
    ap.add_argument("--factor-sizes", default="5,5,3,4")
    ap.add_argument("--split-cuts", default="0.7,0.85")
    ap.add_argument("--pretrain-epochs", type=int, default=0,
                    help="> 0: two-stage recipe: pretrain MCQVAE for N "
                         "epochs, weights-only restore into CTMCQVAE, then "
                         "train ct_layer only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--out", default="")
    ap.add_argument("--progress", default="")
    return ap.parse_args(argv)


def _emit(rec: dict, progress: str) -> None:
    line = json.dumps(rec)
    print(line, flush=True)
    if progress:
        with open(progress, "a") as f:
            f.write(line + "\n")


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    import torch

    from .data import VAEDataset
    from .models import build_model
    from .ops.common import resolve_device
    from .training import VAEXperiment
    from .utils.checkpoint import CheckpointManager

    split_cuts = tuple(float(v) for v in args.split_cuts.split(","))
    factor_sizes = tuple(int(v) for v in args.factor_sizes.split(","))
    action_dim = 2 * len(factor_sizes)
    mp = dict(name="CTMCQVAE", in_channels=3, embedding_dim=8,
              action_dim=action_dim, hidden_dims=[8, 16],
              num_embeddings=8, img_size=args.img, codebooks=2,
              causal_hidden_dims=[16, 8], gamma=1.5)
    device = resolve_device(args.device)

    def model(params):
        return build_model(params, device=device, generator=torch.Generator(
            device).manual_seed(args.seed))

    data = VAEDataset("", dataset_name="TSynthetic",
                      train_batch_size=args.batch, val_batch_size=args.batch,
                      patch_size=args.img, seed=args.seed,
                      factor_sizes=factor_sizes, split_cuts=split_cuts)
    data.setup()
    exp_params = {"LR": args.lr, "weight_decay": 0.0,
                  "scheduler_gamma": args.scheduler_gamma,
                  "kld_weight": args.kld_weight, "manual_seed": args.seed}
    two_stage = args.pretrain_epochs > 0
    exp = VAEXperiment(
        model(mp), dict(exp_params, **({"update_parameters": "ct_layer"}
                                       if two_stage else {})), data)
    exp.setup(seed=args.seed)

    pre_traj = []
    if two_stage:
        # stage 1: reconstruction-only MCQVAE pretrain on the same stream
        mp1 = {k: v for k, v in mp.items()
               if k not in ("name", "action_dim", "causal_hidden_dims",
                            "gamma")}
        exp1 = VAEXperiment(model(dict(mp1, name="MCQVAE")),
                            dict(exp_params), data)
        exp1.setup(seed=args.seed)
        for epoch in range(args.pretrain_epochs):
            te = time.time()
            tm = exp1.train_epoch(epoch)
            rec = {"pretrain_epoch": epoch,
                   "recon_loss": round(tm.get("Reconstruction_Loss",
                                              float("nan")), 6),
                   "epoch_sec": round(time.time() - te, 1)}
            pre_traj.append(rec)
            _emit(rec, args.progress)
        # stage 2: weights-only restore from the checkpoint on disk
        # (encoder / vq_layer / decoder land, ct_layer keeps its init)
        with tempfile.TemporaryDirectory(prefix="mcq_pretrain_") as d:
            cm = CheckpointManager(d)
            cm.save(exp1.state, exp1.global_step)
            exp.load_weights(cm.path("last"))
        del exp1

    traj = []
    t0 = time.time()
    for epoch in range(args.epochs):
        te = time.time()
        tm = exp.train_epoch(epoch)
        val = exp.validate(epoch)
        rec = {"epoch": epoch,
               "causal_acc": round(val.get("val_causal_acc", float("nan")),
                                   4),
               "causal_nodir_acc": round(val.get("val_causal_nodir_acc",
                                                 float("nan")), 4),
               "train_img_per_sec": round(tm["images_per_sec"], 1),
               "epoch_sec": round(time.time() - te, 1)}
        traj.append(rec)
        _emit(rec, args.progress)

    result = {
        "framework": "ctvae_torch",
        "recipe": "two_stage" if two_stage else "joint",
        "pretrain_epochs": args.pretrain_epochs,
        "pretrain_trajectory": pre_traj,
        "epochs": args.epochs, "batch": args.batch, "lr": args.lr,
        "scheduler_gamma": args.scheduler_gamma,
        "factor_sizes": list(factor_sizes),
        "split_cuts": list(split_cuts),
        "seed": args.seed,
        "chance_acc": 1.0 / action_dim,
        "chance_nodir_acc": 2.0 / action_dim,
        "final_causal_acc": traj[-1]["causal_acc"],
        "final_causal_nodir_acc": traj[-1]["causal_nodir_acc"],
        "best_causal_acc": max(t["causal_acc"] for t in traj),
        "best_causal_nodir_acc": max(t["causal_nodir_acc"] for t in traj),
        "total_sec": round(time.time() - t0, 1),
        "trajectory": traj,
    }
    out = json.dumps(result)
    print(out, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out + "\n")
    return result


if __name__ == "__main__":
    main()
