"""How far the port's DCI and boosted trees sit from sklearn's, beyond the
fixed cases of ``tests/test_torch_metrics.py``.

    JAX_PLATFORMS=cpu python tests/torch_metrics_sweep.py

Prints (1) DCI on the cross-validation problem of
``tests/test_metrics_crossval.py`` from ``ctvae_tpu.metrics`` (sklearn) at
``random_state`` 0-4 and from the port at its tie-break seeds 0-4, with
each side's spread: the ground for ``test_dci_matches_jax``'s tolerance;
(2) a sweep of ``fit_gbt`` against ``GradientBoostingClassifier`` over
classes, samples, features, rounds, signal and seeds: how many fits have
no tied split (``fit.ties == 0``) and the largest raw-prediction and
importance differences among those. CPU only; about five minutes.
"""

import itertools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def dci_spread():
    from test_metrics_crossval import TableSampler, _z_table, repr_fn
    from ctvae_tpu.metrics import disentanglement as J
    from ctvae_torch.metrics import disentanglement as T
    z = _z_table()
    kw = dict(num_train=400, num_test=200, batch_size=64, n_estimators=40)
    for name, fn in (("sklearn", J.metric_dci), ("port", T.metric_dci)):
        rows = [fn(TableSampler(z, seed=7), repr_fn, random_state=rs, **kw)
                for rs in range(5)]
        for k in rows[0]:
            v = [r[k] for r in rows]
            print(f"{name} {k}: {' '.join(f'{x:.6f}' for x in v)} "
                  f"(spread {max(v) - min(v):.6f})")


def _data(seed, K, n, D, sig):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, K, n)
    x = (rng.normal(size=(K, D))[y] * sig
         + rng.normal(size=(n, D))).astype(np.float32)
    x[:, 1] = 1.5
    x[:, 2] = np.round(x[:, 2], 1)
    return x, y


def gbt_sweep():
    from sklearn.ensemble import GradientBoostingClassifier
    from ctvae_torch.metrics.gbt import decision_function, fit_gbt
    tie_free, worst_raw, worst_imp, fits = 0, 0.0, 0.0, 0
    for K, n, D, R, sig in itertools.product((2, 3, 4), (200, 300),
                                             (4, 6, 8), (10, 20),
                                             (1.0, 2.0, 3.0)):
        for seed in range(10):
            x, y = _data(seed, K, n, D, sig)
            fit = fit_gbt(torch.from_numpy(x), torch.from_numpy(y),
                          n_estimators=R)
            fits += 1
            if int(fit.ties):
                continue
            clf = GradientBoostingClassifier(n_estimators=R,
                                             random_state=0).fit(x, y)
            raw = decision_function(fit, torch.from_numpy(x)).numpy()
            worst_raw = max(worst_raw, float(np.abs(
                raw - clf.decision_function(x).reshape(n, -1)).max()))
            worst_imp = max(worst_imp, float(np.abs(
                fit.importances.numpy() - clf.feature_importances_).max()))
            tie_free += 1
    print(f"fit_gbt sweep: {tie_free} of {fits} fits without a tied split; "
          f"among them raw predictions within {worst_raw:.3g}, importances "
          f"within {worst_imp:.3g} of sklearn's")


if __name__ == "__main__":
    dci_spread()
    gbt_sweep()
