"""VAEDataset: the data module of the port (numpy batches on the host).

Counterpart of ``ctvae_tpu/data/datamodule.py`` for the datasets the port
takes so far: ``Synthetic`` (random-factor images, base batches only) and
``TSynthetic`` (the synthetic factor grid with its one-factor transitions,
batches of all three modes). Batches are dicts of numpy arrays plus a
``mode`` string; the trainer moves them to the device. Host sharding takes
``host_id`` / ``num_hosts`` as arguments (default one host).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Sequence, Union

import numpy as np

from .synthetic import GRID_FACTOR_SIZES, SyntheticDataset, SyntheticGridDataset
from .transition import TransitionBatchScheduler, TransitionDataset

NOT_PORTED = ("is not ported yet: the port reads Synthetic and TSynthetic "
              "only (ROADMAP A2, the image datasets)")


def _synthetic(split="train", n=512, img_size=64, **kw):
    return SyntheticDataset(n=n, split=split, img_size=img_size)


def _t_synthetic(split="train", img_size=64, factor_sizes=None,
                 split_cuts=None, **kw):
    """Transition dataset over the synthetic factor grid: pairs differ in
    exactly one factor and the action names it."""
    base = SyntheticGridDataset(
        img_size=img_size, split=split,
        factor_sizes=tuple(factor_sizes or GRID_FACTOR_SIZES),
        split_cuts=tuple(split_cuts or (0.7, 0.85)))
    return TransitionDataset(base, *base.causal_transitions())


DATASETS: Dict[str, Callable] = {"Synthetic": _synthetic,
                                 "TSynthetic": _t_synthetic}


def _plain_batches(ds, batch_size: int, shuffle: bool, seed: int,
                   epoch: int):
    n = len(ds)
    rng = np.random.default_rng((seed, epoch))
    idx = rng.permutation(n) if shuffle else np.arange(n)
    for b in range(n // batch_size):
        imgs, labels = ds.get_batch(idx[b * batch_size:(b + 1) * batch_size])
        yield {"image": imgs, "labels": labels}


class VAEDataset:
    """Arguments of the config's ``data_params``; loader-only knobs
    (``num_workers``, ``pin_memory``) are accepted and ignored."""

    def __init__(self, data_path: str = "", dataset_name: str = "TSynthetic",
                 train_batch_size: int = 8, val_batch_size: int = 8,
                 patch_size: Union[int, Sequence[int]] = (64, 64),
                 num_workers: int = 0, pin_memory: bool = False,
                 limit: Optional[int] = None, val_limit: Optional[int] = None,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 **kwargs):
        if dataset_name not in DATASETS:
            raise NotImplementedError(f"dataset {dataset_name!r} {NOT_PORTED}")
        self.data_dir = data_path
        self.dataset_name = dataset_name
        self.train_batch_size = train_batch_size
        self.val_batch_size = val_batch_size
        self.patch_size = patch_size
        self.limit = limit
        self.val_limit = val_limit
        self.seed = seed
        self.host_id, self.num_hosts = host_id, num_hosts
        self.extra = kwargs

    def setup(self, stage: Optional[str] = None) -> None:
        ps = self.patch_size
        self.extra.setdefault("img_size", ps if isinstance(ps, int) else ps[0])
        factory = DATASETS[self.dataset_name]
        self.train_dataset = factory(split="train", **self.extra)
        self.val_dataset = factory(split="test", **self.extra)

    def _loader(self, ds, batch_size, shuffle, epoch):
        if isinstance(ds, TransitionDataset):
            sched = TransitionBatchScheduler(
                ds, batch_size=batch_size, shuffle=shuffle, drop_last=True,
                limit=self.limit if shuffle else self.val_limit,
                seed=self.seed, host_id=self.host_id,
                num_hosts=self.num_hosts)
            for mode, idxs in sched.epoch(epoch):
                batch = ds.get_batch(idxs, mode)
                batch["mode"] = mode
                yield batch
        else:
            for i, batch in enumerate(_plain_batches(
                    ds, batch_size, shuffle, self.seed, epoch)):
                if i % self.num_hosts == self.host_id:
                    batch["mode"] = "base"
                    yield batch

    def train_dataloader(self, epoch: int = 0) -> Iterator[dict]:
        return self._loader(self.train_dataset, self.train_batch_size, True,
                            epoch)

    def val_dataloader(self, epoch: int = 0) -> Iterator[dict]:
        return self._loader(self.val_dataset, self.val_batch_size, False,
                            epoch)

    def test_dataloader(self, epoch: int = 0) -> Iterator[dict]:
        """The validation split, shuffled, with the train ``limit``."""
        return self._loader(self.val_dataset, self.val_batch_size, True,
                            epoch)

    def steps_per_epoch(self) -> int:
        ds = self.train_dataset
        if isinstance(ds, TransitionDataset):
            return TransitionBatchScheduler(
                ds, batch_size=self.train_batch_size, limit=self.limit,
                seed=self.seed, host_id=self.host_id,
                num_hosts=self.num_hosts).batches_per_epoch()
        return len(ds) // self.train_batch_size // self.num_hosts
