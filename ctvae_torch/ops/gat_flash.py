"""GATv2 masked attention, forward and backward: CUDA kernel wrappers.

Counterpart of ``ctvae_tpu/ops/gat_flash.py``. ``flash_gat`` calls the
custom op ``ctvae::gat_fwd`` (``ops/library.py``), whose CUDA kernel
launches ``gat_fwd`` of ``csrc/gat.cu`` (which replaces the TPU
``_fwd_kernel``; ``gat_fwd_bf16`` / ``gat_bwd_bf16`` are the bfloat16
instantiations: bfloat16 in device memory, float32 in registers and in
alpha, as JAX's kernels); when autograd needs gradients it calls
``ctvae::gat_fwd_alpha``, whose launch also writes the f32 alpha residual
[B, H, T, S] and whose gradient, ``ctvae::gat_bwd``, launches ``gat_bwd``
(which replaces the TPU ``_bwd_kernel``). On CPU tensors the ops run
``flash_gat_plain``, the logits + masked softmax + aggregation of
``ops/gat.py``, and the vjp of its autograd. The kernels never store the
[B, T, S, H, F] domain.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .common import (check_cuda_tensor, check_smem, custom_ops, kernel_dtype,
                     upcast32, warps_for)
from .gat import gat_logits32, masked_incoming_softmax

#: launches of the forward / backward kernel since the last reset (set to 0)
launches = 0
bwd_launches = 0

_MAX_F = 128         # features per head the kernels keep in registers
_BWD_MAX_WARPS = 13  # the backward's launch bounds (csrc/gat.cu kBwdWarps)


def flash_gat_plain(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
                    mask: torch.Tensor, we: torch.Tensor, att: torch.Tensor,
                    ns: float) -> torch.Tensor:
    """xl [B,S,H,F], xr [B,T,H,F], adj/mask [B,S,T], we/att [H,F] ->
    out [B,T,H,F] (no bias). As the JAX kernel: the logits, the softmax
    and the sum in float32, the output in xl's dtype."""
    return plain_gat(xl, xr, adj, mask, we, att, ns)[0]


def plain_gat(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
              mask: torch.Tensor, we: torch.Tensor, att: torch.Tensor,
              ns: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,T,H,F] in xl's dtype, the float32 alpha [B,S,T,H]) of the
    plain version."""
    # one upcast of xl for both of its uses, so that its two gradients
    # meet in float32 and are rounded once
    xl32 = upcast32(xl)
    logits = gat_logits32(xl32, xr, adj, we, att, ns)
    alpha = masked_incoming_softmax(logits, mask)
    out = torch.einsum("bsth,bshf->bthf", alpha, xl32)
    return out.to(xl.dtype), alpha


def _lib() -> ctypes.CDLL:
    lib = _build.load("gat")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.gat_fwd, lib.gat_fwd_bf16):
        fn.argtypes = [p] * 8 + [i] * 6 + [f, p]
        fn.restype = ctypes.c_int
    lib.gat_fwd_smem_bytes.argtypes = [i, i, i, i]
    lib.gat_fwd_smem_bytes.restype = ctypes.c_size_t
    for fn in (lib.gat_bwd, lib.gat_bwd_bf16):
        fn.argtypes = [p] * 13 + [i] * 6 + [f, p]
        fn.restype = ctypes.c_int
    lib.gat_bwd_smem_bytes.argtypes = [i, i, i, i]
    lib.gat_bwd_smem_bytes.restype = ctypes.c_size_t
    for fn in (lib.gat_fwd_blocks_per_sm, lib.gat_bwd_blocks_per_sm):
        fn.argtypes = [i] * 4 + [p, p]
        fn.restype = ctypes.c_int
    return lib


def _check(xl, xr, adj, mask, we, att, ns) -> Tuple[int, ...]:
    """Validate the kernels' arguments (xl, xr, adj, we and att of one
    dtype, float32 or bfloat16); returns (B, S, T, H, F)."""
    B, S, H, F = xl.shape
    T = xr.shape[1]
    dt = kernel_dtype("flash_gat", xl)
    check_cuda_tensor("xl", xl, dt, (B, S, H, F))
    check_cuda_tensor("xr", xr, dt, (B, T, H, F))
    check_cuda_tensor("adj", adj, dt, (B, S, T))
    check_cuda_tensor("mask", mask, torch.bool, (B, S, T))
    check_cuda_tensor("we", we, dt, (H, F))
    check_cuda_tensor("att", att, dt, (H, F))
    if F > _MAX_F:
        raise ValueError(f"flash_gat takes at most {_MAX_F} features per "
                         f"head, got {F}")
    if not 0.0 <= ns <= 1.0:
        raise ValueError(f"negative slope {ns} outside [0, 1]")
    return B, S, T, H, F


def flash_gat_cuda(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
                   mask: torch.Tensor, we: torch.Tensor, att: torch.Tensor,
                   ns: float, *, keep_alpha: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel; contiguous inputs of one dtype (float32
    or bfloat16), bool mask. Returns (out [B,T,H,F] in that dtype, the
    float32 alpha [B,H,T,S] if ``keep_alpha`` else None)."""
    global launches
    B, S, T, H, F = _check(xl, xr, adj, mask, we, att, ns)
    lib = _lib()
    nw = warps_for(T)
    check_smem(f"flash_gat: S={S}, T={T}, F={F}",
               lib.gat_fwd_smem_bytes(S, T, F, nw))
    out = torch.empty((B, T, H, F), dtype=xl.dtype, device=xl.device)
    alpha = (torch.empty((B, H, T, S), dtype=torch.float32, device=xl.device)
             if keep_alpha else None)
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    fwd = lib.gat_fwd if xl.dtype == torch.float32 else lib.gat_fwd_bf16
    _build.check(fwd(
        xl.data_ptr(), xr.data_ptr(), adj.data_ptr(), mask.data_ptr(),
        we.data_ptr(), att.data_ptr(), out.data_ptr(),
        alpha.data_ptr() if keep_alpha else None, B, S, T, H, F, nw, ns,
        stream), "gat_fwd")
    launches += 1
    return out, alpha


def _bwd_warps(T: int) -> int:
    """Warps per backward block: as the forward's, at most 13, so that two
    blocks fit on an SM."""
    return min(warps_for(T), _BWD_MAX_WARPS)


def flash_gat_bwd_cuda(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
                       mask: torch.Tensor, we: torch.Tensor, att: torch.Tensor,
                       alpha: torch.Tensor, dout: torch.Tensor, ns: float
                       ) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel on the forward's inputs, its alpha
    residual and ``dout`` [B,T,H,F]. Returns dxl, dxr, dadj [B,S,T],
    dwe, datt [H,F], each in its input's dtype: the kernel writes dxl and
    dxr in it and the per-head dadj and per-sample dwe / datt in float32,
    which are summed here, as the JAX package sums them outside Pallas,
    and cast once."""
    global bwd_launches
    B, S, T, H, F = _check(xl, xr, adj, mask, we, att, ns)
    f32 = torch.float32
    check_cuda_tensor("alpha", alpha, f32, (B, H, T, S))
    check_cuda_tensor("dout", dout, xl.dtype, (B, T, H, F))
    lib = _lib()
    nw = _bwd_warps(T)
    check_smem(f"flash_gat backward: S={S}, T={T}, F={F}",
                lib.gat_bwd_smem_bytes(S, T, F, nw))
    dxl, dxr = torch.empty_like(xl), torch.empty_like(xr)
    dadj_h = xl.new_empty((B, H, T, S), dtype=f32)
    dwe_b = xl.new_empty((B, H, F), dtype=f32)
    datt_b = xl.new_empty((B, H, F), dtype=f32)
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    bwd = lib.gat_bwd if xl.dtype == f32 else lib.gat_bwd_bf16
    _build.check(bwd(
        xl.data_ptr(), xr.data_ptr(), adj.data_ptr(), mask.data_ptr(),
        we.data_ptr(), att.data_ptr(), alpha.data_ptr(), dout.data_ptr(),
        dxl.data_ptr(), dxr.data_ptr(), dadj_h.data_ptr(), dwe_b.data_ptr(),
        datt_b.data_ptr(), B, S, T, H, F, nw, ns, stream), "gat_bwd")
    bwd_launches += 1
    return (dxl, dxr, dadj_h.transpose(2, 3).sum(1).to(adj.dtype),
            dwe_b.sum(0).to(we.dtype), datt_b.sum(0).to(att.dtype))


def _occupancy(fn, S: int, T: int, F: int, nw: int) -> dict:
    regs, local = ctypes.c_int(), ctypes.c_int()
    n = fn(S, T, F, nw, ctypes.byref(regs), ctypes.byref(local))
    if n < 0:
        raise RuntimeError(f"{fn.__name__} failed")
    return {"warps": nw, "regs": regs.value, "local_bytes": local.value,
            "blocks_per_sm": n}


def fwd_occupancy(S: int, T: int, F: int) -> dict:
    """What the forward kernel's launch gets on this card at these shapes:
    warps per block, registers and local (spill) bytes per thread and
    resident blocks per SM."""
    return _occupancy(_lib().gat_fwd_blocks_per_sm, S, T, F, warps_for(T))


def bwd_occupancy(S: int, T: int, F: int) -> dict:
    """As ``fwd_occupancy``, for the backward kernel."""
    return _occupancy(_lib().gat_bwd_blocks_per_sm, S, T, F, _bwd_warps(T))


def flash_gat(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
              mask: torch.Tensor, we: torch.Tensor, att: torch.Tensor,
              ns: float) -> torch.Tensor:
    """Fused GATv2 attention out [B, T, H, F] (no bias): the kernels on
    CUDA, the plain version on CPU; ``ctvae::gat_fwd_alpha`` (which keeps
    alpha for the backward) when autograd needs it, else
    ``ctvae::gat_fwd``."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xl, xr, adj, we, att)):
        return custom_ops().gat_fwd_alpha(xl, xr, adj, mask, we, att, ns)[0]
    return custom_ops().gat_fwd(xl, xr, adj, mask, we, att, ns)
