"""Shared helpers for the ops layer: dtype promotion, device choice and
the kernel wrappers' argument checks."""

from __future__ import annotations

from typing import Optional, Union

import torch


#: the ``torch.library`` namespace of the kernels' custom ops
#: (``ops/library.py``): ``ctvae``, or ``ctvae_<package>`` for a copy of
#: the package imported under another name beside this one
OPS_NAMESPACE = ("ctvae" if __name__.split(".")[0] == "ctvae_torch"
                 else "ctvae_" + __name__.split(".")[0])


def custom_ops():
    """``torch.ops.<OPS_NAMESPACE>``: the kernels' custom ops (registered
    by importing ``ops/library.py``, which ``ops/__init__.py`` does)."""
    return getattr(torch.ops, OPS_NAMESPACE)


def upcast32(x: torch.Tensor) -> torch.Tensor:
    """Promote to at least float32, never downcast (float64 stays)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


#: the element types the kernels have instantiations for: float32 and
#: bfloat16 (the JAX package's two compute dtypes)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def kernel_dtype(what: str, t: torch.Tensor) -> torch.dtype:
    """The dtype of a kernel's main input ``t``, which every other input
    that the JAX kernel holds in the compute dtype must share; raises for
    a dtype without an instantiation (no silent cast)."""
    if t.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: no kernel for {t.dtype}; the kernels take "
                        f"{', '.join(map(str, KERNEL_DTYPES))}")
    return t.dtype


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: the caller's, else ``cuda``.

    Without an explicit device and without a card this raises instead of
    dropping to the CPU, so a serving process never runs the slow plain
    path by accident."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run the plain PyTorch path explicitly")
    return torch.device("cuda")


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: tuple) -> None:
    """Validate a kernel argument: CUDA, ``dtype``, contiguous, ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def smem_limit() -> int:
    """Bytes of shared memory a block may opt in to on the current card
    (232,448 on the H100): the attribute the kernels choose their layouts
    against (``smem_limit`` in ``csrc/gat.cu`` and ``csrc/pairwise.cu``)."""
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).shared_memory_per_block_optin


def check_smem(what: str, smem: int) -> None:
    """Raise when a launch would ask for more shared memory than a block
    may have (the launch would be refused)."""
    limit = smem_limit()
    if smem > limit:
        raise ValueError(f"{what} needs {smem} bytes of shared memory, more "
                         f"than {limit}")


def warps_for(n: int) -> int:
    """Warps per block for a kernel whose warps loop over ``n`` rows: at
    most 16, chosen so the rows split evenly (n = 65 -> 13 warps x 5)."""
    return -(-n // -(-n // 16)) if n > 0 else 1
