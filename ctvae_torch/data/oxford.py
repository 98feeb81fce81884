"""OxfordPets: ``<root>/OxfordPets/images/*.jpg`` and ``*.png``, label 0.

Counterpart of ``ctvae_tpu/data/oxford.py``: the sorted file list split
75 / 25 into train and the rest. Images differ in size, so each is
decoded and transformed on its own. The decoder is chosen by the file's
first bytes, not its name (a folder of photos from the web holds files
whose bytes do not match their extension): a PNG signature goes to
``utils/images.py::read_png``, a JPEG start-of-image marker to the
port's JPEG codec, and anything else raises naming the file. Both give
uint8 RGB as PIL's ``convert("RGB")``, which the JAX package reads every
file through; the codec refuses a CMYK JPEG, which PIL reads (ROADMAP
C).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from .. import native
from ..utils.images import PNG_SIGNATURE, read_png
from .transforms import StandardTransform

JPEG_SOI = b"\xff\xd8"


def read_image(path: str) -> np.ndarray:
    """A PNG or JPEG file, told apart by its first bytes -> uint8
    [h, w, 3]."""
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
    if head == PNG_SIGNATURE:
        return read_png(path)
    if head[:2] == JPEG_SOI:
        return native.codec().decode(path)
    raise ValueError(f"{path} is neither a PNG nor a JPEG file (first "
                     f"bytes {head!r})")


class OxfordPets:
    base_folder = "OxfordPets"

    def __init__(self, data_dir: str, split: str = "train",
                 transform: Optional[Callable] = None, **kwargs):
        self.root = data_dir
        self.split = split
        self.transform = transform or StandardTransform(64)
        folder = os.path.join(data_dir, self.base_folder, "images")
        if not os.path.isdir(folder):
            raise FileNotFoundError(f"OxfordPets images not found at {folder}")
        imgs = sorted(f for f in os.listdir(folder)
                      if f.endswith((".jpg", ".png")))
        cut = int(len(imgs) * 0.75)
        self.filename = imgs[:cut] if split == "train" else imgs[cut:]
        self.indices = self.filename

    def __len__(self) -> int:
        return len(self.filename)

    def __getitem__(self, idx: int):
        path = os.path.join(self.root, self.base_folder, "images",
                            self.filename[idx])
        return self.transform(read_image(path)), np.float32(0.0)

    def get_batch(self, idxs):
        """(images float32 [B, h, w, 3], labels float32 zeros [B])."""
        imgs = np.stack([self[int(i)][0] for i in idxs])
        return imgs, np.zeros(len(imgs), np.float32)
