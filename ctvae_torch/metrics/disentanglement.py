"""Disentanglement metrics of the port: DCI, MIG, SAP, FactorVAE score.

Counterpart of ``ctvae_tpu/metrics/disentanglement.py`` with the same
samplers, the same order of numpy draws and the same result keys, but no
sklearn: the reductions run in torch on the device of the representations
that ``repr_fn`` returns (a card's tensors stay on the card; a numpy
result is taken as a CPU tensor).

* MIG: ``info.discretize`` (20 bins) and ``info.mutual_info`` for every
  (code, factor) pair, normalised by the factor entropies.
* SAP: ``linear_svc.fit_linear_svc``, every code column against each
  factor in one batch; test accuracies; the mean top-1 / top-2 gap.
* DCI: ``gbt.fit_gbt`` per factor (100 rounds of depth 3 by default), the
  absolute importances and train / test accuracies, then the
  entropy-based scores. ``random_state`` (None: 0) seeds the feature
  order that breaks tied splits (see ``gbt``).
* FactorVAE: global variances of ``num_variance_estimate`` codes, dims
  with std below ``prune_threshold`` pruned, one majority vote per point
  from its own fixed-factor batch. Variances are float64 here.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .gbt import fit_gbt, predict_gbt
from .info import discretize, mutual_info
from .linear_svc import fit_linear_svc, predict_linear_svc

ReprFn = Callable[[np.ndarray], object]


class GroundTruthSampler:
    """Samples (factors, observations) of a factor dataset: on a complete
    row-major grid through ``factor_to_index``, ``images_raw`` and the
    dataset's transform; through the dataset's own
    ``observations_from_factors`` (procedural datasets); else by sampling
    rows with their stored factors (no fixed-factor sampling then)."""

    def __init__(self, dataset, rng: np.random.Generator = None):
        self.ds = dataset
        self.factor_sizes = tuple(dataset.factor_sizes)
        self.rng = rng or np.random.default_rng(0)
        self._grid = hasattr(dataset, "factor_to_index")
        self._own = (not self._grid
                     and hasattr(dataset, "observations_from_factors"))

    def sample_factors(self, n: int) -> np.ndarray:
        return np.stack([self.rng.integers(0, s, n)
                         for s in self.factor_sizes], axis=1)

    def observations_from_factors(self, factors: np.ndarray) -> np.ndarray:
        if self._grid:
            raw = self.ds.factor_to_index(factors)
            rows = self.ds.images_raw
            if isinstance(rows, np.ndarray):
                raws = np.asarray(rows[raw])
            else:
                raws = np.stack([np.asarray(rows[int(i)]) for i in raw])
            if hasattr(self.ds.transform, "batch"):
                return self.ds.transform.batch(raws)
            return np.stack([self.ds.transform(r) for r in raws])
        if self._own:
            return np.asarray(self.ds.observations_from_factors(factors))
        raise NotImplementedError(
            "fixed-factor sampling needs a grid dataset or a dataset-"
            "provided observations_from_factors")

    def sample(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._grid or self._own:
            f = self.sample_factors(n)
            return f, self.observations_from_factors(f)
        idx = self.rng.integers(0, len(self.ds), n)
        if hasattr(self.ds, "get_batch"):
            imgs, factors = self.ds.get_batch(idx)
        else:
            pairs = [self.ds[int(i)] for i in idx]
            imgs = np.stack([p[0] for p in pairs])
            factors = np.stack([p[1] for p in pairs])
        return np.asarray(factors), imgs


def _codes(repr_fn: ReprFn, x) -> torch.Tensor:
    z = repr_fn(x)
    return z if isinstance(z, torch.Tensor) else torch.as_tensor(
        np.asarray(z))


def _collect(sampler, repr_fn: ReprFn, num: int, batch_size: int
             ) -> Tuple[np.ndarray, torch.Tensor]:
    """``num`` (factors, codes) in chunks of ``batch_size``: factors on the
    host, codes [num, D] where ``repr_fn`` put them."""
    fs, zs = [], []
    done = 0
    while done < num:
        b = min(batch_size, num - done)
        f, x = sampler.sample(b)
        fs.append(f)
        zs.append(_codes(repr_fn, x))
        done += b
    return np.concatenate(fs), torch.cat(zs)


def _top_gap(score: torch.Tensor) -> torch.Tensor:
    """Per column, the largest value minus the second largest."""
    top = torch.topk(score, 2, dim=0).values
    return top[0] - top[1]


# ---------------------------------------------------------------------------
# MIG
# ---------------------------------------------------------------------------

def metric_mig(sampler, repr_fn: ReprFn, num_train: int = 1000,
               batch_size: int = 64, **kwargs) -> Dict[str, float]:
    factors, z = _collect(sampler, repr_fn, num_train, batch_size)
    f = torch.as_tensor(factors, device=z.device)
    mi = mutual_info(discretize(z), f)                    # [D, F]
    h = torch.diagonal(mutual_info(f, f))
    gap = _top_gap(mi) / h.clamp_min(1e-12)
    return {"mig.discrete_score": float(gap.mean())}


# ---------------------------------------------------------------------------
# SAP
# ---------------------------------------------------------------------------

def metric_sap(sampler, repr_fn: ReprFn, num_train: int = 1000,
               num_test: int = 500, batch_size: int = 64,
               **kwargs) -> Dict[str, float]:
    f_tr, z_tr = _collect(sampler, repr_fn, num_train, batch_size)
    f_te, z_te = _collect(sampler, repr_fn, num_test, batch_size)
    dev = z_tr.device
    D, F = z_tr.shape[1], f_tr.shape[1]
    score = torch.zeros((D, F), dtype=torch.float64, device=dev)
    for j in range(F):
        if len(np.unique(f_tr[:, j])) < 2:
            continue
        fit = fit_linear_svc(z_tr, torch.as_tensor(f_tr[:, j], device=dev))
        pred = predict_linear_svc(fit, z_te.to(dev))           # [m, D]
        y_te = torch.as_tensor(f_te[:, j], device=dev)
        score[:, j] = (pred == y_te[:, None]).double().mean(0)
    return {"sap.score": float(_top_gap(score).mean())}


# ---------------------------------------------------------------------------
# DCI
# ---------------------------------------------------------------------------

def _entropy_rows(p: torch.Tensor, dim: int) -> torch.Tensor:
    p = p / p.sum(dim, keepdim=True).clamp_min(1e-11)
    base = p.shape[dim]
    return 1.0 - (-(p * torch.log(p.clamp_min(1e-11))).sum(dim)
                  / np.log(base))


def _dci_scores(importance: torch.Tensor) -> Tuple[float, float]:
    """Entropy-based disentanglement / completeness of a [D codes, F
    factors] importance matrix (disentanglement_lib dci.py)."""
    code_importance = importance.sum(1)
    disent_per_code = _entropy_rows(importance, 1)
    weights = code_importance / code_importance.sum().clamp_min(1e-11)
    disentanglement = float((disent_per_code * weights).sum())
    completeness = float(_entropy_rows(importance, 0).mean())
    return disentanglement, completeness


def metric_dci(sampler, repr_fn: ReprFn, num_train: int = 1000,
               num_test: int = 500, batch_size: int = 64,
               n_estimators: int = 100, max_depth: int = 3,
               random_state=None, **kwargs) -> Dict[str, float]:
    f_tr, z_tr = _collect(sampler, repr_fn, num_train, batch_size)
    f_te, z_te = _collect(sampler, repr_fn, num_test, batch_size)
    dev = z_tr.device
    D, F = z_tr.shape[1], f_tr.shape[1]
    importance = torch.zeros((D, F), dtype=torch.float64, device=dev)
    acc_tr, acc_te = [], []
    for j in range(F):
        if len(np.unique(f_tr[:, j])) < 2:
            acc_tr.append(1.0)
            acc_te.append(1.0)
            continue
        y_tr = torch.as_tensor(f_tr[:, j], device=dev)
        y_te = torch.as_tensor(f_te[:, j], device=dev)
        fit = fit_gbt(z_tr, y_tr, n_estimators=n_estimators,
                      max_depth=max_depth, random_state=random_state)
        importance[:, j] = fit.importances.abs()
        acc_tr.append(float((predict_gbt(fit, z_tr) == y_tr).double()
                            .mean()))
        acc_te.append(float((predict_gbt(fit, z_te.to(dev)) == y_te)
                            .double().mean()))
    disentanglement, completeness = _dci_scores(importance)
    return {"dci.disentanglement": disentanglement,
            "dci.completeness": completeness,
            "dci.informativeness_train": float(np.mean(acc_tr)),
            "dci.informativeness_test": float(np.mean(acc_te))}


# ---------------------------------------------------------------------------
# FactorVAE score
# ---------------------------------------------------------------------------

def metric_factor_vae(sampler, repr_fn: ReprFn, num_train: int = 1000,
                      num_eval: int = 500, batch_size: int = 64,
                      num_variance_estimate: int = 512,
                      prune_threshold: float = 0.05,
                      **kwargs) -> Dict[str, float]:
    _, x = sampler.sample(num_variance_estimate)
    z = _codes(repr_fn, x).double()
    dev = z.device
    global_var = z.var(0)                                  # ddof = 1
    active = torch.sqrt(global_var) >= prune_threshold
    if not bool(active.any()):
        return {"factor_vae.mean_accuracy": 0.0,
                "factor_vae.eval_accuracy": 0.0,
                "factor_vae.num_active_dims": 0}
    scale = global_var.clamp_min(1e-11)
    F, D = len(sampler.factor_sizes), z.shape[1]

    def vote(n):
        # one vote per training/eval point, each from its own
        # fixed-factor batch (factor_vae.py::_generate_training_batch)
        js, dims = [], []
        for _ in range(n):
            j = int(sampler.rng.integers(0, F))
            fixed = sampler.sample_factors(batch_size)
            fixed[:, j] = fixed[0, j]
            rep = _codes(repr_fn, sampler.observations_from_factors(fixed))
            ratio = rep.to(dev).double().var(0) / scale
            dims.append(torch.where(active, ratio, torch.inf).argmin())
            js.append(j)
        votes = torch.zeros((F, D), dtype=torch.long, device=dev)
        votes.index_put_((torch.as_tensor(js, device=dev),
                          torch.stack(dims)),
                         torch.ones(n, dtype=torch.long, device=dev),
                         accumulate=True)
        return votes

    cols = torch.arange(D, device=dev)
    train_votes = vote(max(1, num_train))
    classifier = train_votes.argmax(0)
    train_acc = (train_votes[classifier, cols].sum()
                 / train_votes.sum().clamp_min(1))
    eval_votes = vote(max(1, num_eval))
    eval_acc = (eval_votes[classifier, cols].sum()
                / eval_votes.sum().clamp_min(1))
    return {"factor_vae.mean_accuracy": float(train_acc),
            "factor_vae.eval_accuracy": float(eval_acc),
            "factor_vae.num_active_dims": int(active.sum())}
