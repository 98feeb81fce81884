"""Gradient-boosted trees on the device, all trees of a round in one pass.

The counterpart of ``sklearn.ensemble.GradientBoostingClassifier`` at the
defaults DCI uses (log-loss, 100 rounds, learning rate 0.1, depth 3,
``min_samples_split`` 2, ``min_samples_leaf`` 1, every feature searched;
sklearn 1.9's ``_gb.py``, ``tree/_splitter.pyx``, ``_criterion.pyx``,
``_partitioner.pxd``):

* classes are ``unique(y)``; the start is the class prior (clipped to
  [eps, 1 - eps]) through the link: the log-odds of ``classes[1]`` for two
  classes, ``log(p_k / gmean(p))`` for K > 2;
* each round fits one regression tree on the negative gradient
  ``y - sigmoid(raw)`` (two classes) or K trees on ``onehot - softmax(raw)``,
  all K from the softmax at the round's start;
* a tree grows to depth 3. A node with fewer than 2 samples or an impurity
  (the variance of its targets) at most float64's eps stays a leaf. Its
  split maximises sklearn's squared-error proxy ``s_l**2 / n_l + s_r**2 /
  n_r`` (sums of the targets left and right; sklearn 1.9 grows the
  boosting trees with ``squared_error``, whose proxy orders splits as
  ``friedman_mse``'s does) over every feature and every position between
  consecutive sorted values that differ by more than ``FEATURE_THRESHOLD``
  = 1e-7 in float32; the threshold is the midpoint ``a / 2 + b / 2`` in
  float64. X is cast to float32, the sums are float64, as in sklearn;
* a leaf's value is one Newton step, ``mean(neg_g) / mean(p * (1 - p))``,
  times ``(K - 1) / K`` for K > 2 (0 where the denominator is below
  1e-150); the raw predictions move by ``learning_rate`` times it;
* ``importances`` is ``feature_importances_``: per tree with more than one
  node, the impurity decrease ``n * imp - n_l * imp_l - n_r * imp_r`` of
  each split summed by feature over the root's ``n``, the mean over those
  trees, then normalised to sum 1;
* predictions are ``classes[raw >= 0]`` for two classes, else the argmax.

Ties: where candidates of equal proxy compete, sklearn takes the first
position of a feature and the first feature in a random feature order
(``random_state``; the metric passes None). Here candidates within
``TIE_RTOL`` (relative) of a node's best tie, and the feature first in a
random order drawn per tree from ``random_state`` wins, at its first such
position. The lowest feature index instead would credit tied splits, which
small nodes make common, to the low dims every time and bias DCI's scores.
``ties`` counts the split nodes where this decided; with none, the fit
follows sklearn's to rounding.

The search on the device: each feature's sample order is sorted once per
fit ([D, n]). At each level of the T trees of a round, that order is
partitioned stably by the samples' node, so each node's samples are a
contiguous segment sorted by the feature; one cumulative sum of the
gathered targets then gives every candidate of every node and feature at
once, and the best per node is a max over features and positions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

FEATURE_THRESHOLD = 1e-7            # float32, as _partitioner.pxd
EPSILON = torch.finfo(torch.float64).eps
#: two candidates' proxies this close (relative) count as a tie
TIE_RTOL = 1e-9
#: elements of a [trees, features, samples] block of the split search
CHUNK_ELEMENTS = 1 << 26


class GBTFit(NamedTuple):
    """A fitted ensemble: ``feature`` / ``threshold`` [R, P, 2**depth - 1]
    per internal node in heap order (``feature`` -1 where the node does not
    split), ``value`` [R, P, 2**depth] by the depth-``depth`` node a sample
    ends in (a leaf above that depth passes its samples down the left
    side), ``init`` [P] raw start, ``classes`` [K], the normalised
    ``importances`` [D], and ``ties``, the split nodes whose best proxy
    more than one candidate reaches (within ``TIE_RTOL``: there sklearn's
    choice follows its random feature order or its own rounding); P = 1
    for two classes, else K."""
    feature: torch.Tensor
    threshold: torch.Tensor
    value: torch.Tensor
    init: torch.Tensor
    classes: torch.Tensor
    importances: torch.Tensor
    learning_rate: float
    ties: torch.Tensor


def _stable_node_order(order0: torch.Tensor, nid: torch.Tensor,
                       starts: torch.Tensor, L: int) -> torch.Tensor:
    """[T, Dc, n] sample order per tree and feature: ``order0`` [Dc, n]
    (each feature's samples sorted) partitioned stably by node ``nid``
    [T, n], node l's samples at ``starts[:, l]`` onwards."""
    T, (Dc, n) = nid.shape[0], order0.shape
    src = order0.expand(T, Dc, n)
    if L == 1:
        return src
    key = nid[:, order0]                                 # [T, Dc, n]
    pos = torch.zeros_like(key)
    for node in range(L):
        m = key == node
        rank = torch.cumsum(m, -1, dtype=torch.int32) - 1
        pos += m * (starts[:, node, None, None] + rank)
    return torch.empty_like(src).scatter_(2, pos, src)


def _tol(v: torch.Tensor) -> torch.Tensor:
    """How far below ``v`` a proxy still ties with it (0 at -inf)."""
    return torch.where(torch.isfinite(v), TIE_RTOL * v.abs(), 0.0)


def _best_splits(xt, order0, g, nid, cnt, s_node, splittable, L, rank):
    """The best split of each of the T trees' L nodes at this level: (ok
    [T, L], feature, threshold, the count of nodes with tied candidates).
    Candidates within ``TIE_RTOL`` of a node's best proxy tie; among them
    the feature of lowest ``rank`` [T, D] wins, at its first such
    position."""
    T, n = g.shape
    D = xt.shape[0]
    dev = g.device
    ends = torch.cumsum(cnt, 1)
    starts = ends - cnt                                  # [T, L]
    ar = torch.arange(n, device=dev)
    lab = torch.searchsorted(ends, ar.expand(T, n).contiguous(),
                             right=True)                # node of a position
    start_p = starts.gather(1, lab)
    n_l = (ar - start_p).double()[:, None]                # [T, 1, n]
    n_r = cnt.gather(1, lab).double()[:, None] - n_l
    s_tot = s_node.gather(1, lab)[:, None]
    ok_p = (splittable.gather(1, lab) & (start_p < ar))[:, None]
    thresh = torch.tensor(FEATURE_THRESHOLD, dtype=torch.float32, device=dev)
    inf = float("inf")
    best_v = torch.full((T, L), -inf, dtype=torch.float64, device=dev)
    best_r = torch.full((T, L), inf, dtype=rank.dtype, device=dev)
    best_f = torch.zeros((T, L), dtype=torch.long, device=dev)
    best_t = torch.zeros((T, L), dtype=torch.float64, device=dev)
    tied = torch.zeros((T, L), dtype=torch.long, device=dev)
    step = max(1, CHUNK_ELEMENTS // max(1, T * n))
    node_ids = torch.arange(L, device=dev)[None, :, None]
    for d0 in range(0, D, step):
        oc = order0[d0:d0 + step]
        Dc = oc.shape[0]
        order = _stable_node_order(oc, nid, starts, L)
        gs = torch.gather(g[:, None, :].expand(T, Dc, n), 2, order)
        xs = torch.gather(xt[d0:d0 + step][None].expand(T, Dc, n), 2, order)
        cs = torch.cumsum(gs, -1)
        # sum left of position p: the node's targets before p
        s_l = torch.cat([cs.new_zeros(T, Dc, 1), cs[..., :-1]], -1)
        if L > 1:
            base = torch.where(start_p > 0, start_p - 1, 0)
            s_l = s_l - torch.where(
                (start_p > 0)[:, None],
                torch.gather(cs, 2, base[:, None, :].expand(T, Dc, n)), 0.0)
        s_r = s_tot - s_l
        valid = torch.zeros_like(xs, dtype=torch.bool)
        valid[..., 1:] = xs[..., 1:] > xs[..., :-1] + thresh
        valid &= ok_p
        proxy = torch.where(valid, s_l * s_l / n_l + s_r * s_r / n_r, -inf)
        per_node = torch.full((T, Dc, L), -inf, dtype=torch.float64,
                              device=dev).scatter_reduce_(
            2, lab[:, None, :].expand(T, Dc, n), proxy, "amax")
        bv = per_node.amax(1)                             # [T, L]
        floor = bv - _tol(bv)
        near_f = per_node >= floor[:, None]               # [T, Dc, L]
        r = torch.where(near_f, rank[:, d0:d0 + step, None], inf)
        bd = r.argmin(1)                                  # [T, L]
        br = r.gather(1, bd[:, None]).squeeze(1)
        # the chosen feature's first position within rounding of the best
        rows = proxy.gather(1, bd[..., None].expand(T, L, n))
        hit = (rows >= floor[..., None]) & (lab[:, None, :] == node_ids)
        bp = hit.to(torch.uint8).argmax(-1)
        xrow = xs.gather(1, bd[..., None].expand(T, L, n))
        hi = xrow.gather(2, bp[..., None]).squeeze(-1)
        lo = xrow.gather(2, (bp - 1).clamp_min(0)[..., None]).squeeze(-1)
        thr = lo.double() / 2.0 + hi.double() / 2.0
        near = torch.zeros_like(tied).scatter_add_(
            1, lab, (proxy >= floor.gather(1, lab)[:, None]).sum(1))
        # fold into the chunks so far: a clearly better chunk replaces
        # them, a tie keeps the lower rank
        dominates = bv > best_v + _tol(best_v)
        ties = ~dominates & (bv >= best_v - _tol(best_v))
        take = dominates | (ties & (br < best_r))
        tied = torch.where(dominates, near, torch.where(ties, tied + near,
                                                        tied))
        best_v = torch.where(dominates | ties, torch.maximum(bv, best_v),
                             best_v)
        best_r = torch.where(take, br, best_r)
        best_f = torch.where(take, bd + d0, best_f)
        best_t = torch.where(take, thr, best_t)
    ok = best_v > -inf
    return ok, best_f, best_t, (ok & (tied > 1)).sum()


def _node_sums(nid, g, L):
    """Count, sum and sum of squares of the targets per node: [T, L]."""
    T = g.shape[0]
    z = g.new_zeros(T, L)
    cnt = torch.zeros((T, L), dtype=torch.long, device=g.device
                      ).scatter_add_(1, nid, torch.ones_like(nid))
    return cnt, z.scatter_add(1, nid, g), z.scatter_add(1, nid, g * g)


def _impurity(cnt, s, q):
    n = cnt.clamp_min(1).double()
    return q / n - (s / n) ** 2


def _fit_trees(xt, order0, g, depth, rank):
    """T regression trees on the targets ``g`` [T, n]: the heap arrays,
    each sample's node at depth ``depth`` [T, n], the trees' unnormalised
    importances [T, D] (zero for a one-node tree) and the count of split
    nodes whose best proxy more than one candidate reaches within
    ``TIE_RTOL``."""
    T, n = g.shape
    D = xt.shape[0]
    dev = g.device
    n_inner = 2 ** depth - 1
    feature = torch.full((T, n_inner), -1, dtype=torch.long, device=dev)
    threshold = torch.zeros((T, n_inner), dtype=torch.float64, device=dev)
    importance = torch.zeros((T, D), dtype=torch.float64, device=dev)
    nid = torch.zeros((T, n), dtype=torch.long, device=dev)
    alive = torch.ones((T, 1), dtype=torch.bool, device=dev)
    ties = torch.zeros((), dtype=torch.long, device=dev)
    cnt, s, q = _node_sums(nid, g, 1)
    for level in range(depth):
        L = 2 ** level
        imp = _impurity(cnt, s, q)
        splittable = alive & (cnt >= 2) & (imp > EPSILON)
        ok, feat, thr, level_ties = _best_splits(xt, order0, g, nid, cnt,
                                                 s, splittable, L, rank)
        ties += level_ties
        heap = slice(L - 1, 2 * L - 1)
        feature[:, heap] = torch.where(ok, feat, -1)
        threshold[:, heap] = torch.where(ok, thr, 0.0)
        f_i = feat.gather(1, nid)                          # [T, n]
        x_i = xt[f_i, torch.arange(n, device=dev).expand(T, n)].double()
        right = ok.gather(1, nid) & (x_i > thr.gather(1, nid))
        nid = 2 * nid + right
        alive = torch.stack([ok, ok], -1).reshape(T, 2 * L)
        c_cnt, c_s, c_q = _node_sums(nid, g, 2 * L)
        c_imp = _impurity(c_cnt, c_s, c_q).view(T, L, 2)
        c_w = c_cnt.view(T, L, 2).double()
        gain = cnt.double() * imp - (c_w * c_imp).sum(-1)
        importance.scatter_add_(1, feat, torch.where(ok, gain, 0.0))
        cnt, s, q = c_cnt, c_s, c_q
    return feature, threshold, nid, importance / n, ties


def _walk(feature, threshold, xt_f32):
    """The depth-``depth`` node of every sample [..., m] under trees of
    heap arrays [..., 2**depth - 1]."""
    n_inner = feature.shape[-1]
    m = xt_f32.shape[1]
    lead = feature.shape[:-1]
    nid = torch.zeros(lead + (m,), dtype=torch.long, device=feature.device)
    cols = torch.arange(m, device=feature.device).expand_as(nid)
    level = 0
    while 2 ** level - 1 < n_inner:
        h = nid + (2 ** level - 1)
        f = feature.gather(-1, h)
        t = threshold.gather(-1, h)
        x = xt_f32[f.clamp_min(0), cols].double()
        nid = 2 * nid + ((f >= 0) & (x > t))
        level += 1
    return nid


def fit_gbt(x: torch.Tensor, y: torch.Tensor, n_estimators: int = 100,
            learning_rate: float = 0.1, max_depth: int = 3,
            random_state: int = 0) -> GBTFit:
    """Fit the boosted trees on ``x`` [n, D] and labels ``y`` [n] (at
    least two classes), on ``x``'s device. ``random_state`` seeds the
    feature order that breaks ties (drawn on the CPU, so the card and the
    CPU break them alike)."""
    dev = x.device
    xt = x.float().t().contiguous()                        # [D, n] float32
    order0 = torch.argsort(xt, dim=1, stable=True)
    classes, inv = torch.unique(y.to(dev), return_inverse=True)
    K, n = len(classes), len(inv)
    eps = torch.finfo(torch.float64).eps
    prior = (torch.bincount(inv, minlength=K).double() / n).clamp(eps,
                                                                 1 - eps)
    onehot = (inv[:, None] == torch.arange(K, device=dev)).double()
    if K == 2:
        init = torch.logit(prior[1:])
        target = onehot[:, 1:]
    else:
        init = torch.log(prior / torch.exp(torch.log(prior).mean()))
        target = onehot
    P = target.shape[1]
    raw = init.expand(n, P).clone()
    # a random feature order per tree, as sklearn's splitter visits them
    ranks = torch.rand((n_estimators, P, xt.shape[0]), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(
                           int(random_state or 0))).to(dev)
    feats, thrs, vals = [], [], []
    imp_sum = torch.zeros(xt.shape[0], dtype=torch.float64, device=dev)
    n_trees = torch.zeros((), dtype=torch.float64, device=dev)
    ties = torch.zeros((), dtype=torch.long, device=dev)
    for rnd in range(n_estimators):
        prob = torch.sigmoid(raw) if K == 2 else torch.softmax(raw, 1)
        neg_g = (target - prob).t().contiguous()           # [P, n]
        feature, threshold, leaf, importance, round_ties = _fit_trees(
            xt, order0, neg_g, max_depth, ranks[rnd])
        ties += round_ties
        p = target.t() - neg_g
        n_leaf = 2 ** max_depth
        z = neg_g.new_zeros(P, n_leaf)
        num = z.scatter_add(1, leaf, neg_g)
        den = z.scatter_add(1, leaf, p * (1 - p))
        cnt = z.scatter_add(1, leaf, torch.ones_like(p)).clamp_min(1)
        num, den = num / cnt, den / cnt
        if K > 2:
            num = num * ((K - 1) / K)
        value = torch.where(den.abs() < 1e-150, 0.0,
                            num / torch.where(den == 0, 1.0, den))
        raw += learning_rate * value.gather(1, leaf).t()
        split = feature[:, 0] >= 0
        imp_sum += (importance * split[:, None]).sum(0)
        n_trees += split.sum()
        feats.append(feature)
        thrs.append(threshold)
        vals.append(value)
    avg = imp_sum / n_trees.clamp_min(1)
    total = avg.sum()
    importances = torch.where(total > 0, avg / torch.where(total > 0, total,
                                                           1.0), 0.0)
    return GBTFit(torch.stack(feats), torch.stack(thrs), torch.stack(vals),
                  init, classes, importances, learning_rate, ties)


def decision_function(fit: GBTFit, x: torch.Tensor) -> torch.Tensor:
    """Raw predictions [m, P] for ``x`` [m, D] (cast to float32 first)."""
    xt = x.to(fit.value.device).float().t().contiguous()
    leaf = _walk(fit.feature, fit.threshold, xt)           # [R, P, m]
    contrib = fit.learning_rate * fit.value.gather(-1, leaf)
    return fit.init + contrib.sum(0).t()


def predict_gbt(fit: GBTFit, x: torch.Tensor) -> torch.Tensor:
    """Predicted class values [m]."""
    raw = decision_function(fit, x)
    idx = (raw[:, 0] >= 0).long() if raw.shape[1] == 1 else raw.argmax(1)
    return fit.classes[idx]
