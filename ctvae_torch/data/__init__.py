"""Data layer of the port: numpy datasets and the mode-homogeneous batch
schedule (counterpart of ``ctvae_tpu/data``, synthetic datasets only)."""

from .datamodule import DATASETS, VAEDataset
from .transition import MODES, TransitionBatchScheduler, TransitionDataset

__all__ = ["DATASETS", "MODES", "TransitionBatchScheduler",
           "TransitionDataset", "VAEDataset"]
