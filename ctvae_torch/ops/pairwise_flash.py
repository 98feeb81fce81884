"""Pairwise discoverer scores, forward and backward: CUDA kernel wrappers.

Counterpart of ``ctvae_tpu/ops/pairwise_flash.py``. ``flash_pairwise``
runs ``FlashPairwise`` on CUDA tensors: its forward launches
``pairwise_fwd`` and its backward ``pairwise_bwd``, both in
``csrc/pairwise.cu`` (which replace the TPU ``_fwd_kernel`` and
``_bwd_kernel``). The residual is the [B, S, T] output, as in JAX; the
[B, S, T, Hd] domain never exists in device memory. On CPU tensors
``flash_pairwise`` runs the plain ``ops/pairwise.py::fused_pairwise_scores``,
whose autograd is the backward's plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .common import check_cuda_tensor
from .pairwise import fused_pairwise_scores

#: launches of the forward / backward kernel since the last reset (set to 0)
launches = 0
bwd_launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("pairwise")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.pairwise_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i64, i64, i64,
                                 ctypes.c_float, p]
    lib.pairwise_fwd.restype = ctypes.c_int
    lib.pairwise_bwd.argtypes = [p] * 11 + [i, i, i, i, i64, i64,
                                            ctypes.c_float, p]
    lib.pairwise_bwd.restype = ctypes.c_int
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


def _check_slope(ns: float) -> None:
    if not 0.0 <= ns <= 1.0:
        raise ValueError(f"negative slope {ns} outside [0, 1]")


def flash_pairwise_cuda(xl: torch.Tensor, xr: torch.Tensor, w2: torch.Tensor,
                        b1: torch.Tensor, b2: torch.Tensor, ns: float
                        ) -> torch.Tensor:
    """Launch the forward kernel. xl [B,S,Hd], xr [B,T,Hd] float32
    contiguous; w2/b1 [Hd] or [B,Hd]; b2 scalar or [B]. Returns [B, S, T]."""
    global launches
    B, S, H = xl.shape
    T = xr.shape[1]
    check_cuda_tensor("xl", xl, torch.float32, (B, S, H))
    check_cuda_tensor("xr", xr, torch.float32, (B, T, H))
    w2_stride = _param("w2", w2, B, (H,), H)
    b1_stride = _param("b1", b1, B, (H,), H)
    b2_stride = _param("b2", b2, B, (), 1)
    _check_slope(ns)
    lib = _lib()
    out = torch.empty((B, S, T), dtype=torch.float32, device=xl.device)
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    _build.check(lib.pairwise_fwd(
        xl.data_ptr(), xr.data_ptr(), w2.data_ptr(), b1.data_ptr(),
        b2.data_ptr(), out.data_ptr(), B, S, T, H, w2_stride, b1_stride,
        b2_stride, ns, stream), "pairwise_fwd")
    launches += 1
    return out


def flash_pairwise_bwd_cuda(xl: torch.Tensor, xr: torch.Tensor,
                            w2: torch.Tensor, b1: torch.Tensor,
                            out: torch.Tensor, dout: torch.Tensor, ns: float
                            ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel on the forward's inputs, its output
    ``out`` and the output gradient ``dout`` [B, S, T]. Returns dxl
    [B,S,Hd], dxr [B,T,Hd] and the per-sample dw2 [B,Hd], db1 [B,Hd],
    db2 [B] (the caller sums them over B for a shared param)."""
    global bwd_launches
    B, S, H = xl.shape
    T = xr.shape[1]
    check_cuda_tensor("xl", xl, torch.float32, (B, S, H))
    check_cuda_tensor("xr", xr, torch.float32, (B, T, H))
    check_cuda_tensor("out", out, torch.float32, (B, S, T))
    check_cuda_tensor("dout", dout, torch.float32, (B, S, T))
    w2_stride = _param("w2", w2, B, (H,), H)
    b1_stride = _param("b1", b1, B, (H,), H)
    _check_slope(ns)
    if H == 0:
        raise ValueError("flash_pairwise backward needs Hd > 0")
    lib = _lib()
    grads = (torch.empty_like(xl), torch.empty_like(xr),
             xl.new_empty((B, H)), xl.new_empty((B, H)), xl.new_empty((B,)))
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    _build.check(lib.pairwise_bwd(
        xl.data_ptr(), xr.data_ptr(), w2.data_ptr(), b1.data_ptr(),
        out.data_ptr(), dout.data_ptr(), *(g.data_ptr() for g in grads),
        B, S, T, H, w2_stride, b1_stride, ns, stream), "pairwise_bwd")
    bwd_launches += 1
    return grads


def _fold(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A per-sample gradient in the param's shape: summed over the batch
    when the param was shared."""
    return g if g.shape == p.shape else g.sum(0)


class FlashPairwise(torch.autograd.Function):
    """The pairwise scores with the CUDA forward and backward kernels."""

    @staticmethod
    def forward(ctx, xl, xr, w2, b1, b2, ns):
        out = flash_pairwise_cuda(xl, xr, w2, b1, b2, ns)
        ctx.save_for_backward(xl, xr, w2, b1, b2, out)
        ctx.ns = ns
        return out

    @staticmethod
    def backward(ctx, dout):
        xl, xr, w2, b1, b2, out = ctx.saved_tensors
        dxl, dxr, dw2, db1, db2 = flash_pairwise_bwd_cuda(
            xl, xr, w2, b1, out, dout.contiguous(), ctx.ns)
        return (dxl, dxr, _fold(dw2, w2), _fold(db1, b1), _fold(db2, b2),
                None)


def flash_pairwise(xl: torch.Tensor, xr: torch.Tensor, w2: torch.Tensor,
                   b1: torch.Tensor, b2: torch.Tensor, ns: float
                   ) -> torch.Tensor:
    """``sigmoid(sum_h leaky(xl_s + xr_t + b1) * w2 + b2)`` [B, S, T]: the
    kernels on CUDA, the plain version (and its autograd) on CPU."""
    if not xl.is_cuda:
        return fused_pairwise_scores(xl, xr, w2, b1, b2, ns)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xl, xr, w2, b1, b2)):
        return FlashPairwise.apply(xl, xr, w2, b1, b2, ns)
    return flash_pairwise_cuda(xl, xr, w2, b1, b2, ns)
