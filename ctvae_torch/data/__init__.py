"""Data layer of the port: numpy datasets (the disent image datasets and
the synthetic ones), their transform and transition files, the
mode-homogeneous batch schedule and the copy to the device (counterpart
of ``ctvae_tpu/data``; CelebA and OxfordPets are not ported yet)."""

from .datamodule import DATASETS, VAEDataset
from .transition import MODES, TransitionBatchScheduler, TransitionDataset

__all__ = ["DATASETS", "MODES", "TransitionBatchScheduler",
           "TransitionDataset", "VAEDataset"]
