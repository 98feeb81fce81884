"""Data layer of the port: numpy datasets (CelebA and OxfordPets through
the port's JPEG codec, the disent image datasets and the synthetic ones),
their transform and transition files, the mode-homogeneous batch
schedule and the copy to the device (counterpart of
``ctvae_tpu/data``)."""

from .datamodule import DATASETS, VAEDataset
from .transition import MODES, TransitionBatchScheduler, TransitionDataset

__all__ = ["DATASETS", "MODES", "TransitionBatchScheduler",
           "TransitionDataset", "VAEDataset"]
