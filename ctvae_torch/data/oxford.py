"""OxfordPets: ``<root>/OxfordPets/images/*.jpg``, label 0.

Counterpart of ``ctvae_tpu/data/oxford.py``: the sorted file list split
75 / 25 into train and the rest. Images differ in size, so each is
decoded by the port's JPEG codec and transformed on its own. The JAX
package also lists ``.png`` files and reads them with PIL; the port has
no PNG decoder, and a folder with a ``.png`` raises, naming it.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np

from .. import native
from .transforms import StandardTransform


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
        png = [f for f in imgs if f.endswith(".png")]
        if png:
            raise NotImplementedError(
                f"{folder} holds PNG files, which the port does not decode "
                f"(JPEG only): {png[:5]}")
        cut = int(len(imgs) * 0.75)
        self.filename = imgs[:cut] if split == "train" else imgs[cut:]
        self.indices = self.filename

    def __len__(self) -> int:
        return len(self.filename)

    def __getitem__(self, idx: int):
        path = os.path.join(self.root, self.base_folder, "images",
                            self.filename[idx])
        return self.transform(native.codec().decode(path)), np.float32(0.0)

    def get_batch(self, idxs):
        """(images float32 [B, h, w, 3], labels float32 zeros [B])."""
        imgs = np.stack([self[int(i)][0] for i in idxs])
        return imgs, np.zeros(len(imgs), np.float32)
