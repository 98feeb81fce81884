"""Ops of the port: each kernel wrapper sits beside its plain version.

Each wrapper module counts the launches of its kernels in module-level
counters (``vq.launches``, ``pairwise_flash.bwd_launches``, ...);
``launch_counts`` reads them all by kernel name and ``set_launch_counts``
writes them back.
"""

from __future__ import annotations

import importlib
from typing import Dict

#: kernel name -> (wrapper module, its counter)
COUNTERS = {
    "vq_l2_argmin": ("vq", "launches"),
    "pairwise_fwd": ("pairwise_flash", "launches"),
    "pairwise_bwd": ("pairwise_flash", "bwd_launches"),
    "gat_fwd": ("gat_flash", "launches"),
    "gat_bwd": ("gat_flash", "bwd_launches"),
    "gat_logits_fwd": ("gat_logits", "launches"),
    "gat_logits_bwd": ("gat_logits", "bwd_launches"),
}


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch counter, by kernel name."""
    return {k: getattr(_module(m), c) for k, (m, c) in COUNTERS.items()}


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Write ``counts`` (by kernel name) into the counters."""
    for k, n in counts.items():
        m, c = COUNTERS[k]
        setattr(_module(m), c, n)
