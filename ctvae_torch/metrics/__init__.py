"""Disentanglement metrics of the port (DCI, MIG, SAP, FactorVAE score),
without sklearn: the mutual information, the one-feature linear SVMs and
the gradient-boosted trees are torch code (``info``, ``linear_svc``,
``gbt``) that runs on the device of the representations."""

from .disentanglement import (GroundTruthSampler, metric_dci,
                              metric_factor_vae, metric_mig, metric_sap)
from .metric import METRICS, Metric, MetricSet

__all__ = ["GroundTruthSampler", "METRICS", "Metric", "MetricSet",
           "metric_dci", "metric_factor_vae", "metric_mig", "metric_sap"]
