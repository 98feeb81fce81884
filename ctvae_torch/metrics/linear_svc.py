"""One-feature linear SVMs, all of a metric's problems in one batch.

The counterpart of ``sklearn.svm.LinearSVC(C=0.01,
class_weight="balanced", dual="auto", max_iter=2000)`` fitted on one code
column at a time, as the SAP score fits it (``dual="auto"`` picks
liblinear's primal L2-regularised squared-hinge solver there). For each
binary problem the objective is

    0.5 * (w**2 + b**2) + sum_i c_i * max(0, 1 - t_i * (w * x_i + b))**2

with the intercept ``b`` an extra feature of value 1, regularised as
liblinear does. Classes are ``unique(y)`` in sorted order and the balanced
weight of class k is ``n / (K * count_k)``. With two classes there is one
problem: ``t_i = +1`` for ``classes[1]`` and ``c_i = C * weight`` of the
sample's own class. With K > 2 classes there are K one-vs-rest problems:
for class k, ``c_i = C * weight_k`` for its samples and the plain ``C``
for every other sample.

liblinear stops at a gradient tolerance of 1e-4; here every problem is
solved to convergence by Newton steps (2 x 2 systems, float64, a halving
line search with liblinear's Armijo constant 0.01), so coefficients may
differ from sklearn's within that tolerance, and a prediction only where a
point lies that close to a class boundary. Predictions are the argmax of
the one-vs-rest scores, or, with two classes, ``classes[1]`` where the
score is positive.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

#: Newton iterations at most; a problem converges in a handful
MAX_ITER = 100
#: stop when every gradient is this small against its value at w = b = 0
GRAD_RTOL = 1e-12
ARMIJO = 0.01
#: elements of a [D, problems, n] temporary per chunk of code columns
CHUNK_ELEMENTS = 1 << 25


class LinearSVCFit(NamedTuple):
    """``coef`` and ``intercept`` [D, P] (P = 1 for two classes, else K)
    and the ``classes`` [K]."""
    coef: torch.Tensor
    intercept: torch.Tensor
    classes: torch.Tensor


def _problems(y: torch.Tensor, C: float):
    """Targets t [P, n] (+1 / -1), costs c [P, n] and the classes."""
    classes, inv = torch.unique(y, return_inverse=True)
    K, n = len(classes), len(y)
    counts = torch.bincount(inv, minlength=K).double()
    weight = n / (K * counts)
    if K == 2:
        t = torch.where(inv == 1, 1.0, -1.0).double()[None]
        c = (C * weight[inv])[None]
        return t, c, classes
    pos = inv[None] == torch.arange(K, device=y.device)[:, None]
    t = torch.where(pos, 1.0, -1.0).double()
    c = torch.where(pos, C * weight[:, None], torch.full_like(t, C))
    return t, c, classes


def _objective(w, b, x, t, c):
    r = (1.0 - t * (w[..., None] * x[:, None] + b[..., None])).clamp_min(0)
    return 0.5 * (w * w + b * b) + (c * r * r).sum(-1)


def _solve(x: torch.Tensor, t: torch.Tensor, c: torch.Tensor):
    """x [D, n], t and c [P, n] -> w, b [D, P]."""
    D, P = x.shape[0], t.shape[0]
    w = x.new_zeros(D, P)
    b = x.new_zeros(D, P)
    x3 = x[:, None]                          # [D, 1, n]
    g0 = None
    for _ in range(MAX_ITER):
        r = 1.0 - t * (w[..., None] * x3 + b[..., None])
        act = (r > 0).double() * c           # c_i on the active samples
        ctr = act * t * r
        gw = w - 2 * (ctr * x3).sum(-1)
        gb = b - 2 * ctr.sum(-1)
        gnorm = torch.maximum(gw.abs(), gb.abs())
        if g0 is None:
            g0 = gnorm.clamp_min(1.0)
        # a problem stops at its own convergence, so its solution does not
        # depend on the others in the batch
        live = gnorm > GRAD_RTOL * g0
        if not bool(live.any()):
            return w, b
        hww = 1 + 2 * (act * x3 * x3).sum(-1)
        hwb = 2 * (act * x3).sum(-1)
        hbb = 1 + 2 * act.sum(-1)
        det = hww * hbb - hwb * hwb
        sw = torch.where(live, -(hbb * gw - hwb * gb) / det, 0.0)
        sb = torch.where(live, -(hww * gb - hwb * gw) / det, 0.0)
        f = _objective(w, b, x, t, c)
        slope = gw * sw + gb * sb
        alpha = torch.ones_like(w)
        for _ in range(60):
            fn = _objective(w + alpha * sw, b + alpha * sb, x, t, c)
            bad = fn > f + ARMIJO * alpha * slope
            if not bool(bad.any()):
                break
            alpha = torch.where(bad, alpha / 2, alpha)
        w = w + alpha * sw
        b = b + alpha * sb
    raise RuntimeError(f"linear SVC: no convergence in {MAX_ITER} Newton "
                       f"steps")


def fit_linear_svc(x: torch.Tensor, y: torch.Tensor, C: float = 0.01
                   ) -> LinearSVCFit:
    """Fit every column of ``x`` [n, D] alone against the labels ``y``
    [n] (at least two classes); float64 on ``x``'s device."""
    x = x.double().t().contiguous()          # [D, n]
    t, c, classes = _problems(y.to(x.device), C)
    D, n, P = x.shape[0], x.shape[1], t.shape[0]
    step = max(1, CHUNK_ELEMENTS // max(1, P * n))
    ws, bs = [], []
    for lo in range(0, D, step):
        w, b = _solve(x[lo:lo + step], t, c)
        ws.append(w)
        bs.append(b)
    return LinearSVCFit(torch.cat(ws), torch.cat(bs), classes)


def predict_linear_svc(fit: LinearSVCFit, x: torch.Tensor) -> torch.Tensor:
    """Each column's classifier on its column of ``x`` [m, D]: the
    predicted class values [m, D]."""
    scores = x.double()[:, :, None] * fit.coef + fit.intercept   # [m, D, P]
    if fit.coef.shape[1] == 1:
        idx = (scores[..., 0] > 0).long()
    else:
        idx = scores.argmax(-1)
    return fit.classes[idx]
