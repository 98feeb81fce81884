"""Pairwise discoverer scores, forward: CUDA kernel wrapper.

Counterpart of ``ctvae_tpu/ops/pairwise_flash.py``. ``flash_pairwise``
launches the kernel of ``csrc/pairwise.cu`` (which replaces the TPU
``_fwd_kernel``) on CUDA tensors; on CPU tensors it runs the plain
``ops/pairwise.py::fused_pairwise_scores``. The [B, S, T, Hd] domain never
exists in device memory on the kernel path. Forward only: the backward
kernel comes with training.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .common import check_cuda_tensor
from .pairwise import fused_pairwise_scores

#: kernel launches since the last reset (``launches = 0`` to reset)
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("pairwise")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.pairwise_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i64, i64, i64,
                                 ctypes.c_float, p]
    lib.pairwise_fwd.restype = ctypes.c_int
    return lib


def _param(name: str, p: torch.Tensor, B: int, shape: tuple, row: int
           ) -> int:
    """Validate a shared ([*shape]) or per-sample ([B, *shape]) param and
    return its batch stride in elements (0 when shared)."""
    if tuple(p.shape) == shape:
        check_cuda_tensor(name, p, torch.float32, shape)
        return 0
    check_cuda_tensor(name, p, torch.float32, (B,) + shape)
    return row


def flash_pairwise_cuda(xl: torch.Tensor, xr: torch.Tensor, w2: torch.Tensor,
                        b1: torch.Tensor, b2: torch.Tensor, ns: float
                        ) -> torch.Tensor:
    """Launch the CUDA kernel. xl [B,S,Hd], xr [B,T,Hd] float32 contiguous;
    w2/b1 [Hd] or [B,Hd]; b2 scalar or [B]. Returns [B, S, T]."""
    global launches
    B, S, H = xl.shape
    T = xr.shape[1]
    check_cuda_tensor("xl", xl, torch.float32, (B, S, H))
    check_cuda_tensor("xr", xr, torch.float32, (B, T, H))
    w2_stride = _param("w2", w2, B, (H,), H)
    b1_stride = _param("b1", b1, B, (H,), H)
    b2_stride = _param("b2", b2, B, (), 1)
    if not 0.0 <= ns <= 1.0:
        raise ValueError(f"negative slope {ns} outside [0, 1]")
    lib = _lib()
    out = torch.empty((B, S, T), dtype=torch.float32, device=xl.device)
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    _build.check(lib.pairwise_fwd(
        xl.data_ptr(), xr.data_ptr(), w2.data_ptr(), b1.data_ptr(),
        b2.data_ptr(), out.data_ptr(), B, S, T, H, w2_stride, b1_stride,
        b2_stride, ns, stream), "pairwise_fwd")
    launches += 1
    return out


def flash_pairwise(xl: torch.Tensor, xr: torch.Tensor, w2: torch.Tensor,
                   b1: torch.Tensor, b2: torch.Tensor, ns: float
                   ) -> torch.Tensor:
    """``sigmoid(sum_h leaky(xl_s + xr_t + b1) * w2 + b2)`` [B, S, T]: the
    kernel on CUDA, the plain version on CPU."""
    if xl.is_cuda:
        return flash_pairwise_cuda(xl, xr, w2, b1, b2, ns)
    return fused_pairwise_scores(xl, xr, w2, b1, b2, ns)
