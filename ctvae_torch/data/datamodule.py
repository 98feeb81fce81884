"""VAEDataset: the data module of the port (numpy batches on the host).

Counterpart of ``ctvae_tpu/data/datamodule.py``. It registers the
JPEG datasets (``Celeba``, its transition form ``TCeleba`` and
``OxfordPets``, decoded by the port's codec, ``ctvae_torch/native``), the
disent-family image datasets (``Cars3D``, ``DSprites``, ``SmallNORB``,
``Shapes3D``, ``Sprites``) and their transition variants (``T*``, read
from the datasets' ``variation_attrs_<N>.txt`` files), and ``Synthetic``
(random-factor images, base batches only) / ``TSynthetic`` (the synthetic
factor grid with its one-factor transitions). Image datasets go through
``StandardTransform(patch_size, crop=148)``; ``data_params``'
``cache_transformed`` and ``device_normalize`` reach their loaders.
Batches are dicts of numpy arrays plus a ``mode`` string; only ``image``
and ``input_y`` may be uint8 (``data/prefetch.py``). Host sharding takes
``host_id`` / ``num_hosts`` as arguments; without them it follows the
process group where one is up (the rank and the world, as JAX's follow
``jax.process_index()`` / ``process_count()``), else one host. A host
gets the same number of batches as every other: a plain dataset's
batches are dealt round-robin and the last incomplete round is dropped.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Sequence, Union

import numpy as np

from .celeba import MyCelebA, TCeleba
from .disent_data import DISENT_LOADERS, FACTOR_NAMES
from .oxford import OxfordPets
from .synthetic import GRID_FACTOR_SIZES, SyntheticDataset, SyntheticGridDataset
from .transforms import StandardTransform
from .transition import TransitionBatchScheduler, TransitionDataset

def _disent(name):
    def factory(data_dir, split="train", transform=None, **kw):
        return DISENT_LOADERS[name](data_dir, split=split,
                                    transform=transform, **kw)
    return factory


def _t_disent(name):
    def factory(data_dir, split="train", transform=None, **kw):
        base = DISENT_LOADERS[name](data_dir, split=split,
                                    transform=transform, **kw)
        return TransitionDataset.from_variation_file(
            base, len(FACTOR_NAMES[name]))
    return factory


def _synthetic(data_dir="", split="train", transform=None, n=512,
               img_size=64, **kw):
    return SyntheticDataset(n=n, split=split, img_size=img_size)


def _t_synthetic(data_dir="", split="train", transform=None, img_size=64,
                 factor_sizes=None, split_cuts=None, **kw):
    """Transition dataset over the synthetic factor grid: pairs differ in
    exactly one factor and the action names it."""
    base = SyntheticGridDataset(
        img_size=img_size, split=split,
        factor_sizes=tuple(factor_sizes or GRID_FACTOR_SIZES),
        split_cuts=tuple(split_cuts or (0.7, 0.85)))
    return TransitionDataset(base, *base.causal_transitions())


DATASETS: Dict[str, Callable] = {
    "Celeba": MyCelebA,
    "TCeleba": TCeleba,
    "Cars3D": _disent("cars3d"),
    "TCars3D": _t_disent("cars3d"),
    "DSprites": _disent("dsprites"),
    "TDSprites": _t_disent("dsprites"),
    "SmallNORB": _disent("smallnorb"),
    "TSmallNORB": _t_disent("smallnorb"),
    "Shapes3D": _disent("3dshapes"),
    "TShapes3D": _t_disent("3dshapes"),
    "Sprites": _disent("sprites"),
    "TSprites": _t_disent("sprites"),
    "OxfordPets": OxfordPets,
    "Synthetic": _synthetic,
    "TSynthetic": _t_synthetic,
}


def _plain_batches(ds, batch_size: int, shuffle: bool, seed: int,
                   epoch: int, num_hosts: int = 1):
    n = len(ds)
    rng = np.random.default_rng((seed, epoch))
    idx = rng.permutation(n) if shuffle else np.arange(n)
    for b in range(n // batch_size // num_hosts * num_hosts):
        imgs, labels = ds.get_batch(idx[b * batch_size:(b + 1) * batch_size])
        yield {"image": imgs, "labels": labels}


class VAEDataset:
    """Arguments of the config's ``data_params``; loader-only knobs
    (``num_workers``, ``pin_memory``) are accepted and ignored.

    Each host (``host_id`` of ``num_hosts``; by default the process's rank
    and world) loads its ``train_batch_size`` rows of each global batch.
    Under a mesh with a ``model`` axis the ranks of a model group share
    their rows, so ``VAEXperiment.setup`` sets the two to the rank's data
    index and the data size (its batch group's rank and size)."""

    def __init__(self, data_path: str = "", dataset_name: str = "TSynthetic",
                 train_batch_size: int = 8, val_batch_size: int = 8,
                 patch_size: Union[int, Sequence[int]] = (64, 64),
                 num_workers: int = 0, pin_memory: bool = False,
                 limit: Optional[int] = None, val_limit: Optional[int] = None,
                 seed: int = 0, host_id: Optional[int] = None,
                 num_hosts: Optional[int] = None, **kwargs):
        if dataset_name not in DATASETS:
            raise ValueError(f"unknown dataset {dataset_name!r}; the port "
                             f"reads {sorted(DATASETS)}")
        self.data_dir = data_path
        self.dataset_name = dataset_name
        self.train_batch_size = train_batch_size
        self.val_batch_size = val_batch_size
        self.patch_size = patch_size
        self.limit = limit
        self.val_limit = val_limit
        self.seed = seed
        if host_id is None or num_hosts is None:
            from ..parallel.mesh import rank, world_size
            host_id, num_hosts = rank(), world_size()
        self.host_id, self.num_hosts = host_id, num_hosts
        self.extra = kwargs

    def setup(self, stage: Optional[str] = None) -> None:
        transform = StandardTransform(self.patch_size, crop=148)
        if "Synthetic" in self.dataset_name:
            ps = self.patch_size
            self.extra.setdefault("img_size",
                                  ps if isinstance(ps, int) else ps[0])
        factory = DATASETS[self.dataset_name]
        self.train_dataset = factory(self.data_dir, split="train",
                                     transform=transform, **self.extra)
        self.val_dataset = factory(self.data_dir, split="test",
                                   transform=transform, **self.extra)

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
                    ds, batch_size, shuffle, self.seed, epoch,
                    self.num_hosts)):
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
