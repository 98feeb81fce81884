"""``Metric`` / ``MetricSet``: the JAX package's wrappers
(``ctvae_tpu/metrics/metric.py``) with its argument fixups: MIG drops
``num_test``; FactorVaeScore renames it ``num_eval`` and pins
``num_variance_estimate = 64 * 2**3``. Each metric samples with its own
``GroundTruthSampler`` (seed 0) unless it is given a sampler."""

from __future__ import annotations

from typing import Callable, Dict, List

from .disentanglement import (GroundTruthSampler, metric_dci,
                              metric_factor_vae, metric_mig, metric_sap)

METRICS = {
    "DCI": metric_dci,
    "MIG": metric_mig,
    "SAP": metric_sap,
    "FactorVaeScore": metric_factor_vae,
    "": None,
}


class Metric:

    def __init__(self, metric_name: str, dataset, batch_size: int = 64,
                 num_train: int = 1000, num_test: int = 500, **kwargs):
        self.metric = METRICS[metric_name]
        self.name = metric_name
        self.sampler = (dataset if isinstance(dataset, GroundTruthSampler)
                        else GroundTruthSampler(dataset))
        self.args = {"batch_size": batch_size, "num_train": num_train,
                     "num_test": num_test}
        if metric_name == "MIG":
            del self.args["num_test"]
        if metric_name == "FactorVaeScore":
            del self.args["num_test"]
            self.args["num_eval"] = num_test
            self.args["num_variance_estimate"] = 64 * 2 ** 3

    def compute(self, repr_func: Callable) -> Dict[str, float]:
        return self.metric(self.sampler, repr_func, **self.args)


class MetricSet(Metric):

    def __init__(self, metric_names: List[str], dataset,
                 batch_size: int = 64, num_train: int = 1000,
                 num_test: int = 500, **kwargs):
        self.metrics = [Metric(n, dataset, batch_size, num_train, num_test)
                        for n in metric_names]

    def compute(self, repr_func: Callable) -> Dict[str, float]:
        res: Dict[str, float] = {}
        for metric in self.metrics:
            res.update(metric.compute(repr_func))
        return res
