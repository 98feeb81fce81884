"""GATv2 per-head edge logits, forward and backward: CUDA kernel wrappers.

Counterpart of ``ctvae_tpu/ops/gat.py::fused_gat_logits`` (the logits
``e[b,s,t,k] = att_k . leaky(xl_s + xr_t + adj_st we_k)`` without the
softmax) and its one-walk backward ``_fgl_bwd``. ``fused_gat_logits`` on
CUDA tensors launches ``gat_logits_fwd`` of ``csrc/gat_logits.cu`` (which
replaces ``scripts/bench_gat.py::pallas_logits``); when autograd needs
gradients it runs ``FusedGATLogits``, whose backward launches
``gat_logits_bwd``. On CPU tensors it runs the plain
``ops/gat.py::gat_logits``, whose autograd is the backward's plain version.
The kernels never store the [B, S, T, K, F] domain.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from .common import check_cuda_tensor, check_smem, warps_for
from .gat import gat_logits

#: launches of the forward / backward kernel since the last reset (set to 0)
launches = 0
bwd_launches = 0

_MAX_F = 128   # features per head the backward keeps in registers


def _lib() -> ctypes.CDLL:
    lib = _build.load("gat_logits")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gat_logits_fwd.argtypes = [p] * 6 + [i] * 6 + [f, p]
    lib.gat_logits_fwd.restype = ctypes.c_int
    lib.gat_logits_fwd_smem_bytes.argtypes = [i, i, i]
    lib.gat_logits_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.gat_logits_bwd.argtypes = [p] * 11 + [i] * 7 + [f, p]
    lib.gat_logits_bwd.restype = ctypes.c_int
    lib.gat_logits_bwd_smem_bytes.argtypes = [i, i, i, i]
    lib.gat_logits_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check(xl, xr, adj, we, att, ns) -> Tuple[int, ...]:
    """Validate the kernels' arguments; returns (B, S, T, K, F, the batch
    stride of we / att: K*F per sample, 0 shared)."""
    B, S, K, F = xl.shape
    T = xr.shape[1]
    check_cuda_tensor("xl", xl, torch.float32, (B, S, K, F))
    check_cuda_tensor("xr", xr, torch.float32, (B, T, K, F))
    check_cuda_tensor("adj", adj, torch.float32, (B, S, T))
    pshape = (B, K, F) if we.dim() == 3 else (K, F)
    check_cuda_tensor("we", we, torch.float32, pshape)
    check_cuda_tensor("att", att, torch.float32, pshape)
    if F > _MAX_F:
        raise ValueError(f"fused_gat_logits takes at most {_MAX_F} features "
                         f"per head, got {F}")
    if not 0.0 <= ns <= 1.0:
        raise ValueError(f"negative slope {ns} outside [0, 1]")
    return B, S, T, K, F, K * F if we.dim() == 3 else 0


def fused_gat_logits_cuda(xl: torch.Tensor, xr: torch.Tensor,
                          adj: torch.Tensor, we: torch.Tensor,
                          att: torch.Tensor, ns: float) -> torch.Tensor:
    """Launch the forward kernel; float32 contiguous inputs. Returns the
    logits [B, S, T, K]."""
    global launches
    B, S, T, K, F, wstride = _check(xl, xr, adj, we, att, ns)
    lib = _lib()
    check_smem(f"fused_gat_logits: S={S}, T={T}, F={F}",
                lib.gat_logits_fwd_smem_bytes(S, T, F))
    out = xl.new_empty((B, S, T, K))
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    _build.check(lib.gat_logits_fwd(
        xl.data_ptr(), xr.data_ptr(), adj.data_ptr(), we.data_ptr(),
        att.data_ptr(), out.data_ptr(), B, S, T, K, F, wstride, ns, stream),
        "gat_logits_fwd")
    launches += 1
    return out


def fused_gat_logits_bwd_cuda(xl: torch.Tensor, xr: torch.Tensor,
                              adj: torch.Tensor, we: torch.Tensor,
                              att: torch.Tensor, d_e: torch.Tensor,
                              ns: float) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel on the forward's inputs and ``d_e``
    [B,S,T,K]. Returns dxl, dxr, dadj [B,S,T], dwe, datt (we's shape): the
    kernel's per-head dadj and per-sample dwe / datt are summed here, as
    the JAX package sums them over heads and (shared heads) the batch."""
    global bwd_launches
    B, S, T, K, F, wstride = _check(xl, xr, adj, we, att, ns)
    check_cuda_tensor("d_e", d_e, torch.float32, (B, S, T, K))
    lib = _lib()
    nw = warps_for(max(S, T))
    check_smem(f"fused_gat_logits backward: S={S}, T={T}, F={F}",
                lib.gat_logits_bwd_smem_bytes(S, T, F, nw))
    dxl, dxr = torch.empty_like(xl), torch.empty_like(xr)
    dadj_k = xl.new_empty((B, K, S, T))
    dwe_b, datt_b = xl.new_empty((B, K, F)), xl.new_empty((B, K, F))
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    _build.check(lib.gat_logits_bwd(
        xl.data_ptr(), xr.data_ptr(), adj.data_ptr(), we.data_ptr(),
        att.data_ptr(), d_e.data_ptr(), dxl.data_ptr(), dxr.data_ptr(),
        dadj_k.data_ptr(), dwe_b.data_ptr(), datt_b.data_ptr(), B, S, T, K,
        F, wstride, nw, ns, stream), "gat_logits_bwd")
    bwd_launches += 1
    if wstride == 0:
        dwe_b, datt_b = dwe_b.sum(0), datt_b.sum(0)
    return dxl, dxr, dadj_k.sum(1), dwe_b, datt_b


class FusedGATLogits(torch.autograd.Function):
    """The GATv2 edge logits with the CUDA forward and backward kernels."""

    @staticmethod
    def forward(ctx, xl, xr, adj, we, att, ns):
        ctx.save_for_backward(xl, xr, adj, we, att)
        ctx.ns = ns
        return fused_gat_logits_cuda(xl, xr, adj, we, att, ns)

    @staticmethod
    def backward(ctx, d_e):
        xl, xr, adj, we, att = ctx.saved_tensors
        return (*fused_gat_logits_bwd_cuda(xl, xr, adj, we, att,
                                           d_e.contiguous(), ctx.ns), None)


def fused_gat_logits(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
                     we: torch.Tensor, att: torch.Tensor, ns: float
                     ) -> torch.Tensor:
    """GATv2 edge logits [B, S, T, K]: the kernels on CUDA (the backward
    only when autograd needs it), the plain version on CPU. xl [B,S,K,F],
    xr [B,T,K,F], adj [B,S,T]; we / att [K,F] shared or [B,K,F] per
    sample."""
    if not xl.is_cuda:
        return gat_logits(xl, xr, adj, we, att, ns)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xl, xr, adj, we, att)):
        return FusedGATLogits.apply(xl, xr, adj, we, att, ns)
    return fused_gat_logits_cuda(xl, xr, adj, we, att, ns)
