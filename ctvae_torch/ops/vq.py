"""Vector-quantization codebook search: CUDA kernel + plain version.

Counterpart of ``ctvae_tpu/ops/vq.py``. ``l2_argmin`` calls the custom
op ``ctvae::vq_l2_argmin`` (``ops/library.py``), which launches the
hand-written kernel of ``csrc/vq.cu`` (``l2_argmin_cuda``; it replaces the
TPU kernel ``l2_argmin_pallas``) on CUDA tensors and runs
``l2_argmin_plain`` on CPU tensors. The kernel drops the per-row
constant ||x||^2 as the TPU kernel does; the plain version keeps it, as
``l2_argmin_xla`` does, so the two can disagree only on rows whose two
best distances are within rounding.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .common import check_cuda_tensor, custom_ops, upcast32

#: kernel launches since the last reset (``launches = 0`` to reset)
launches = 0


def l2_argmin_plain(flat: torch.Tensor, codebook: torch.Tensor
                    ) -> torch.Tensor:
    """[N, D] x [K, D] -> int64 [N]: index of the nearest codebook row."""
    flat = upcast32(flat)
    codebook = upcast32(codebook)
    dist = (torch.sum(flat ** 2, dim=1, keepdim=True)
            + torch.sum(codebook ** 2, dim=1)
            - 2.0 * flat @ codebook.T)
    return torch.argmin(dist, dim=1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("vq")
    lib.vq_argmin.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]
    lib.vq_argmin.restype = ctypes.c_int
    lib.vq_argmin_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p, ctypes.c_void_p]
    lib.vq_argmin_blocks_per_sm.restype = ctypes.c_int
    return lib


def l2_argmin_cuda(flat: torch.Tensor, codebook: torch.Tensor
                   ) -> torch.Tensor:
    """Launch the CUDA kernel: float32 contiguous [N, D], [K, D]."""
    global launches
    n, d = flat.shape
    k = codebook.shape[0]
    check_cuda_tensor("flat", flat, torch.float32, (n, d))
    check_cuda_tensor("codebook", codebook, torch.float32, (k, d))
    if codebook.device != flat.device:
        raise ValueError("flat and codebook must be on one device")
    lib = _lib()
    out = torch.empty((n,), dtype=torch.int64, device=flat.device)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    _build.check(lib.vq_argmin(flat.data_ptr(), codebook.data_ptr(),
                               out.data_ptr(), n, k, d, stream), "vq_argmin")
    launches += 1
    return out


def occupancy(k: int, d: int, lib: Optional[ctypes.CDLL] = None) -> dict:
    """What the kernel's launch gets on this card at K codes of D floats:
    warps per block, registers and local (spill) bytes per thread and
    resident blocks per SM (of ``lib``, another build of ``csrc/vq.cu``,
    when given)."""
    fn = (lib or _lib()).vq_argmin_blocks_per_sm
    regs, local = ctypes.c_int(), ctypes.c_int()
    n = fn(k, d, ctypes.byref(regs), ctypes.byref(local))
    if n < 0:
        raise RuntimeError("vq_argmin_blocks_per_sm failed")
    return {"warps": 8, "regs": regs.value, "local_bytes": local.value,
            "blocks_per_sm": n}


def l2_argmin(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook row per latent (``ctvae::vq_l2_argmin``): the
    kernel on CUDA, plain on CPU."""
    return custom_ops().vq_l2_argmin(flat, codebook)
