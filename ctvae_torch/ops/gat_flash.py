"""GATv2 masked attention, forward and backward: CUDA kernel wrappers.

Counterpart of ``ctvae_tpu/ops/gat_flash.py``. ``flash_gat`` on CUDA
tensors launches ``gat_fwd`` of ``csrc/gat.cu`` (which replaces the TPU
``_fwd_kernel``); when autograd needs gradients it runs ``FlashGAT``,
whose forward also writes the f32 alpha residual [B, H, T, S] and whose
backward launches ``gat_bwd`` (which replaces the TPU ``_bwd_kernel``).
On CPU tensors it runs ``flash_gat_plain``, the logits + masked softmax +
aggregation of ``ops/gat.py``, whose autograd is the backward's plain
version. The kernels never store the [B, T, S, H, F] domain.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .common import check_cuda_tensor
from .gat import gat_logits, masked_incoming_softmax

#: launches of the forward / backward kernel since the last reset (set to 0)
launches = 0
bwd_launches = 0

_MAX_F = 128         # features per head the kernels keep in registers
_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


def flash_gat_plain(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
                    mask: torch.Tensor, we: torch.Tensor, att: torch.Tensor,
                    ns: float) -> torch.Tensor:
    """xl [B,S,H,F], xr [B,T,H,F], adj/mask [B,S,T], we/att [H,F] ->
    out [B,T,H,F] (no bias)."""
    logits = gat_logits(xl, xr, adj, we, att, ns)
    alpha = masked_incoming_softmax(logits, mask)
    return torch.einsum("bsth,bshf->bthf", alpha, xl)


def _lib() -> ctypes.CDLL:
    lib = _build.load("gat")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gat_fwd.argtypes = [p] * 8 + [i] * 6 + [f, p]
    lib.gat_fwd.restype = ctypes.c_int
    lib.gat_fwd_smem_bytes.argtypes = [i, i, i]
    lib.gat_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.gat_bwd.argtypes = [p] * 13 + [i] * 6 + [f, p]
    lib.gat_bwd.restype = ctypes.c_int
    lib.gat_bwd_smem_bytes.argtypes = [i, i, i, i]
    lib.gat_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _warps(T: int) -> int:
    """Warps per block (one target each, looping): at most 16, chosen so
    the targets split evenly (T = 65 -> 13 warps x 5 targets)."""
    return -(-T // -(-T // 16)) if T > 0 else 1


def _check(xl, xr, adj, mask, we, att, ns) -> Tuple[int, ...]:
    B, S, H, F = xl.shape
    T = xr.shape[1]
    check_cuda_tensor("xl", xl, torch.float32, (B, S, H, F))
    check_cuda_tensor("xr", xr, torch.float32, (B, T, H, F))
    check_cuda_tensor("adj", adj, torch.float32, (B, S, T))
    check_cuda_tensor("mask", mask, torch.bool, (B, S, T))
    check_cuda_tensor("we", we, torch.float32, (H, F))
    check_cuda_tensor("att", att, torch.float32, (H, F))
    if F > _MAX_F:
        raise ValueError(f"flash_gat takes at most {_MAX_F} features per "
                         f"head, got {F}")
    if not 0.0 <= ns <= 1.0:
        raise ValueError(f"negative slope {ns} outside [0, 1]")
    return B, S, T, H, F


def _check_smem(what: str, smem: int) -> None:
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{what} needs {smem} bytes of shared memory, more "
                         f"than {_SMEM_LIMIT}")


def flash_gat_cuda(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
                   mask: torch.Tensor, we: torch.Tensor, att: torch.Tensor,
                   ns: float, *, keep_alpha: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel; float32 contiguous inputs, bool mask.
    Returns (out [B,T,H,F], alpha [B,H,T,S] if ``keep_alpha`` else None)."""
    global launches
    B, S, T, H, F = _check(xl, xr, adj, mask, we, att, ns)
    lib = _lib()
    nw = _warps(T)
    _check_smem(f"flash_gat: S={S}, F={F}", lib.gat_fwd_smem_bytes(S, F, nw))
    out = torch.empty((B, T, H, F), dtype=torch.float32, device=xl.device)
    alpha = (torch.empty((B, H, T, S), dtype=torch.float32, device=xl.device)
             if keep_alpha else None)
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    _build.check(lib.gat_fwd(
        xl.data_ptr(), xr.data_ptr(), adj.data_ptr(), mask.data_ptr(),
        we.data_ptr(), att.data_ptr(), out.data_ptr(),
        alpha.data_ptr() if keep_alpha else None, B, S, T, H, F, nw, ns,
        stream), "gat_fwd")
    launches += 1
    return out, alpha


def flash_gat_bwd_cuda(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
                       mask: torch.Tensor, we: torch.Tensor, att: torch.Tensor,
                       alpha: torch.Tensor, dout: torch.Tensor, ns: float
                       ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel on the forward's inputs, its alpha
    residual and ``dout`` [B,T,H,F]. Returns dxl, dxr, dadj [B,S,T],
    dwe, datt [H,F]: the kernel's per-head dadj and per-sample dwe / datt
    are summed here, as the JAX package sums them outside Pallas."""
    global bwd_launches
    B, S, T, H, F = _check(xl, xr, adj, mask, we, att, ns)
    check_cuda_tensor("alpha", alpha, torch.float32, (B, H, T, S))
    check_cuda_tensor("dout", dout, torch.float32, (B, T, H, F))
    lib = _lib()
    nw = _warps(T)
    _check_smem(f"flash_gat backward: S={S}, T={T}, F={F}",
                lib.gat_bwd_smem_bytes(S, T, F, nw))
    dxl, dxr = torch.empty_like(xl), torch.empty_like(xr)
    dadj_h = xl.new_empty((B, H, T, S))
    dwe_b, datt_b = xl.new_empty((B, H, F)), xl.new_empty((B, H, F))
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    _build.check(lib.gat_bwd(
        xl.data_ptr(), xr.data_ptr(), adj.data_ptr(), mask.data_ptr(),
        we.data_ptr(), att.data_ptr(), alpha.data_ptr(), dout.data_ptr(),
        dxl.data_ptr(), dxr.data_ptr(), dadj_h.data_ptr(), dwe_b.data_ptr(),
        datt_b.data_ptr(), B, S, T, H, F, nw, ns, stream), "gat_bwd")
    bwd_launches += 1
    return (dxl, dxr, dadj_h.sum(1).transpose(1, 2), dwe_b.sum(0),
            datt_b.sum(0))


class FlashGAT(torch.autograd.Function):
    """The GATv2 attention with the CUDA forward and backward kernels."""

    @staticmethod
    def forward(ctx, xl, xr, adj, mask, we, att, ns):
        out, alpha = flash_gat_cuda(xl, xr, adj, mask, we, att, ns,
                                    keep_alpha=True)
        ctx.save_for_backward(xl, xr, adj, mask, we, att, alpha)
        ctx.ns = ns
        return out

    @staticmethod
    def backward(ctx, dout):
        xl, xr, adj, mask, we, att, alpha = ctx.saved_tensors
        dxl, dxr, dadj, dwe, datt = flash_gat_bwd_cuda(
            xl, xr, adj, mask, we, att, alpha, dout.contiguous(), ctx.ns)
        return dxl, dxr, dadj, None, dwe, datt, None


def flash_gat(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
              mask: torch.Tensor, we: torch.Tensor, att: torch.Tensor,
              ns: float) -> torch.Tensor:
    """Fused GATv2 attention out [B, T, H, F] (no bias): the kernels on
    CUDA (alpha is kept only when autograd needs it), the plain version
    on CPU."""
    if not xl.is_cuda:
        return flash_gat_plain(xl, xr, adj, mask, we, att, ns)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xl, xr, adj, we, att)):
        return FlashGAT.apply(xl, xr, adj, mask, we, att, ns)
    return flash_gat_cuda(xl, xr, adj, mask, we, att, ns)[0]
