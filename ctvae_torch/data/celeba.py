"""CelebA and its transition form, read from torchvision's layout.

Counterpart of ``ctvae_tpu/data/celeba.py``: ``<root>/celeba/`` holds
``img_align_celeba/*.jpg``, ``list_eval_partition.txt`` (the split of
each file: 0 train, 1 valid, 2 test) and, optionally,
``list_attr_celeba.txt`` (40 attributes of +-1 per file, read as 0 / 1
labels; zeros for every file when it is absent). Images are decoded by
the port's JPEG codec (``ctvae_torch/native``) and go through the
dataset's transform as one batch. ``TCeleba`` adds the transitions of
``variation_attrs_10.txt`` (``data/variations.py::generate_celeba``),
keyed by file name.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from .. import native
from .transforms import StandardTransform
from .transition import TransitionDataset

N_ATTRS = 40
SPLITS = {"train": (0,), "valid": (1,), "test": (2,), "all": (0, 1, 2)}


class MyCelebA:
    base_folder = "celeba"

    def __init__(self, data_dir: str, split: str = "train",
                 transform: Optional[Callable] = None, download: bool = False,
                 **kwargs):
        self.root = data_dir
        self.split = split
        self.transform = transform or StandardTransform(64)
        folder = os.path.join(data_dir, self.base_folder)
        part_file = os.path.join(folder, "list_eval_partition.txt")
        if not os.path.exists(part_file):
            raise FileNotFoundError(
                f"CelebA not found under {folder}: it needs "
                f"img_align_celeba/ and list_eval_partition.txt (write a "
                f"stand-in with python -m ctvae_torch.data.standins celeba)")
        keep = SPLITS[split]
        self.filename = []
        with open(part_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2 and int(parts[1]) in keep:
                    self.filename.append(parts[0])
        self.attr = {}
        attr_file = os.path.join(folder, "list_attr_celeba.txt")
        if os.path.exists(attr_file):
            with open(attr_file) as f:
                lines = f.read().splitlines()
            for line in lines[2:]:
                parts = line.split()
                self.attr[parts[0]] = np.array(
                    [(int(v) + 1) // 2 for v in parts[1:]], np.float32)
        self.indices = self.filename
        self._full_data = self

    def __len__(self) -> int:
        return len(self.filename)

    def _path(self, name: str) -> str:
        return os.path.join(self.root, self.base_folder, "img_align_celeba",
                            name)

    def get_batch(self, idxs):
        """(images float32 [B, h, w, 3] in [0, 1], labels float32 [B, 40]):
        the files decoded as one batch (equal sizes, as CelebA's are),
        then the transform over the batch."""
        names = [self.filename[int(i)] for i in idxs]
        labels = np.stack([self.attr.get(n, np.zeros(N_ATTRS, np.float32))
                           for n in names])
        raw = native.codec().decode_batch([self._path(n) for n in names])
        return self.transform.batch(raw), labels

    def __getitem__(self, idx: int):
        imgs, labels = self.get_batch([idx])
        return imgs[0], labels[0]


def TCeleba(data_dir: str, split: str = "train",
            transform: Optional[Callable] = None, **kwargs
            ) -> TransitionDataset:
    """CelebA with the 10-variation transitions of its first 10
    attributes (20 actions)."""
    base = MyCelebA(data_dir, split=split, transform=transform, **kwargs)
    return TransitionDataset.from_variation_file(base, 10)
