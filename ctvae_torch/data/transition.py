"""Transition datasets and the mode-homogeneous batch schedule (numpy).

Counterpart of ``ctvae_tpu/data/transition.py``. ``TransitionDataset``
adds (x, y, action) pairs to a base dataset; its virtual index space is
[0, ld) = base, [ld, ld + lt) = action, [ld + lt, ld + 2 lt) = causal.
``TransitionBatchScheduler`` is the seeded per-epoch schedule of
(mode, index batch) pairs: every batch holds one mode, and with several
hosts each takes its slice of one global batch, so all hosts run the same
mode at each step. Transitions come from the reference's
``variation_attrs_<N>.txt`` files of the image datasets
(``TransitionDataset.from_variation_file``) or from the base dataset's
``causal_transitions()`` (the synthetic grid).
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

MODES = ("base", "action", "causal")


class TransitionDataset:
    """A base dataset (``indices``, ``get_batch``) plus transition pairs
    ``transitions`` [(x name, y name)] with one-hot ``actions``."""

    def __init__(self, dataset, transitions: List[Tuple[str, str]],
                 actions: np.ndarray):
        self.dataset = dataset
        self.split = dataset.split
        self.indices = dataset.indices
        self._index_of = {name: i for i, name in enumerate(self.indices)}
        self._full_data = getattr(dataset, "_full_data", dataset)
        self.transitions = list(transitions)
        self.actions = actions
        self.num_variations = actions.shape[1] // 2

    @classmethod
    def from_variation_file(cls, dataset, num_variations: int
                            ) -> "TransitionDataset":
        """The transitions of ``dataset``'s split read from
        ``<root>/<base_folder>/variation_attrs_<num_variations>.txt``
        (CSV ``,Inputs,Outputs,Variations,Sources,Targets,Splits``), each
        with the 2N-dim one-hot action ``N * direction + variation``,
        direction = (target < source)."""
        keep = {"train": (0,), "valid": (1,), "test": (2,),
                "all": (0, 1, 2)}[dataset.split]
        path = os.path.join(dataset.root, dataset.base_folder,
                            f"variation_attrs_{num_variations}.txt")
        with open(path) as f:
            rows = list(csv.reader(f))[1:]
        transitions, actions = [], []
        for _, inp, out, variation, source, target, spl in rows:
            if int(spl) in keep:
                transitions.append((inp, out))
                direction = int(int(target) < int(source))
                actions.append(num_variations * direction + int(variation))
        onehot = np.zeros((len(actions), 2 * num_variations), np.float32)
        onehot[np.arange(len(actions)), actions] = 1.0
        return cls(dataset, transitions, onehot)

    def __len__(self) -> int:
        return len(self.dataset) + 2 * len(self.transitions)

    def mode_ranges(self):
        ld, lt = len(self.dataset), len(self.transitions)
        return {"base": range(ld), "action": range(ld, ld + lt),
                "causal": range(ld + lt, ld + 2 * lt)}

    def get_batch(self, idxs: np.ndarray, mode: str):
        """Batch of virtual indices that all share ``mode``."""
        ld, lt = len(self.dataset), len(self.transitions)
        idxs = np.asarray(idxs)
        if mode == "base":
            imgs, labels = self.dataset.get_batch(idxs)
            return {"image": imgs, "labels": labels}
        t = idxs - ld if mode == "action" else idxs - ld - lt
        x_ids = np.array([self._index_of[self.transitions[int(i)][0]]
                          for i in t])
        y_ids = np.array([self._index_of[self.transitions[int(i)][1]]
                          for i in t])
        imgs, labels = self.dataset.get_batch(x_ids)
        imgs_y, _ = self.dataset.get_batch(y_ids)
        return {"image": imgs, "labels": labels, "input_y": imgs_y,
                "action": self.actions[t]}


class TransitionBatchScheduler:
    """Deterministic per-epoch schedule of mode-homogeneous batches."""

    def __init__(self, data: TransitionDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 limit: Optional[int] = None, seed: int = 0,
                 host_id: int = 0, num_hosts: int = 1):
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.limit = limit
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts

    def _mode_indices(self, rng: np.random.Generator):
        out = {}
        for mode, rr in self.data.mode_ranges().items():
            idx = np.array(list(rr), np.int64)
            if self.limit is not None and len(idx) > 0:
                idx = rng.choice(idx, size=min(self.limit, len(idx)),
                                 replace=False)
            out[mode] = idx
        return out

    def epoch(self, epoch: int) -> Iterator[Tuple[str, np.ndarray]]:
        """(mode, indices) pairs with ``batch_size`` indices each; at step
        t every host yields the same mode (a slice of one global batch)."""
        rng = np.random.default_rng((self.seed, epoch))
        per_mode = self._mode_indices(rng)
        gbs = self.batch_size * self.num_hosts
        batches: List[Tuple[str, np.ndarray]] = []
        for mode, idx in per_mode.items():
            if self.shuffle:
                idx = rng.permutation(idx)
            n_full = len(idx) // gbs
            for b in range(n_full):
                batches.append((mode, idx[b * gbs:(b + 1) * gbs]))
            if not self.drop_last and len(idx) % gbs:
                batches.append((mode, idx[n_full * gbs:]))
        if self.shuffle:
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        lo = self.host_id * self.batch_size
        return iter((mode, g[lo:lo + self.batch_size]) for mode, g in batches)

    def batches_per_epoch(self) -> int:
        gbs = self.batch_size * self.num_hosts
        total = 0
        for rr in self.data.mode_ranges().values():
            n = len(rr) if self.limit is None else min(self.limit, len(rr))
            total += n // gbs if self.drop_last else -(-n // gbs)
        return total
