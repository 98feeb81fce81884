"""GATv2 per-head edge logits, forward and backward: CUDA kernel wrappers.

Counterpart of ``ctvae_tpu/ops/gat.py::fused_gat_logits`` (the logits
``e[b,s,t,k] = att_k . leaky(xl_s + xr_t + adj_st we_k)`` without the
softmax) and its one-walk backward ``_fgl_bwd``. ``fused_gat_logits``
calls the custom op ``ctvae::gat_logits_fwd`` (``ops/library.py``), whose
CUDA kernel launches ``gat_logits_fwd`` of ``csrc/gat_logits.cu`` (which
replaces ``scripts/bench_gat.py::pallas_logits``) and whose gradient,
``ctvae::gat_logits_bwd``, launches ``gat_logits_bwd``; ``*_bf16`` are
their bfloat16 instantiations (bfloat16 in device memory, float32 in
registers and in the dwe / datt partials). On CPU tensors the
ops run the plain ``ops/gat.py::gat_logits`` and the vjp of its autograd.
The kernels never store the [B, S, T, K, F] domain; the backward walks
only the pairs with a non-zero upstream gradient. ``fwd_occupancy`` /
``bwd_occupancy`` read what their launches get on the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .common import check_cuda_tensor, check_smem, custom_ops, kernel_dtype

#: launches of the forward / backward kernel since the last reset (set to 0)
launches = 0
bwd_launches = 0

_MAX_F = 128   # features per head the kernels take (4 per lane)
GRID_LIMIT = 65535   # the grids' y dimension: B x K (forward), B (backward)


def _lib() -> ctypes.CDLL:
    lib = _build.load("gat_logits")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (lib.gat_logits_fwd, lib.gat_logits_fwd_bf16):
        fn.argtypes = [p] * 6 + [i] * 6 + [f, p]
        fn.restype = ctypes.c_int
    lib.gat_logits_fwd_smem_bytes.argtypes = [i] * 5
    lib.gat_logits_fwd_smem_bytes.restype = ctypes.c_size_t
    for fn in (lib.gat_logits_bwd, lib.gat_logits_bwd_bf16):
        fn.argtypes = [p] * 10 + [i] * 6 + [f, p]
        fn.restype = ctypes.c_int
    lib.gat_logits_bwd_parts.argtypes = [i, i, i]
    lib.gat_logits_bwd_parts.restype = ctypes.c_int
    lib.gat_logits_bwd_smem_bytes.argtypes = [i] * 4
    lib.gat_logits_bwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _check(xl, xr, adj, we, att, ns) -> Tuple[int, ...]:
    """Validate the kernels' arguments (all of one dtype, float32 or
    bfloat16); returns (B, S, T, K, F, the batch stride of we / att: K*F
    per sample, 0 shared)."""
    B, S, K, F = xl.shape
    T = xr.shape[1]
    dt = kernel_dtype("fused_gat_logits", xl)
    check_cuda_tensor("xl", xl, dt, (B, S, K, F))
    check_cuda_tensor("xr", xr, dt, (B, T, K, F))
    check_cuda_tensor("adj", adj, dt, (B, S, T))
    pshape = (B, K, F) if we.dim() == 3 else (K, F)
    check_cuda_tensor("we", we, dt, pshape)
    check_cuda_tensor("att", att, dt, pshape)
    if F > _MAX_F:
        raise ValueError(f"fused_gat_logits takes at most {_MAX_F} features "
                         f"per head, got {F}")
    if not 0.0 <= ns <= 1.0:
        raise ValueError(f"negative slope {ns} outside [0, 1]")
    return B, S, T, K, F, K * F if we.dim() == 3 else 0


def fused_gat_logits_cuda(xl: torch.Tensor, xr: torch.Tensor,
                          adj: torch.Tensor, we: torch.Tensor,
                          att: torch.Tensor, ns: float) -> torch.Tensor:
    """Launch the forward kernel; contiguous inputs of one dtype (float32
    or bfloat16). Returns the logits [B, S, T, K] in that dtype."""
    global launches
    B, S, T, K, F, wstride = _check(xl, xr, adj, we, att, ns)
    if B * K > GRID_LIMIT:
        raise ValueError(f"fused_gat_logits: {B} samples x {K} heads above "
                         f"the grid's {GRID_LIMIT}")
    lib = _lib()
    check_smem(f"fused_gat_logits: S={S}, T={T}, F={F}",
                lib.gat_logits_fwd_smem_bytes(B, S, T, K, F))
    out = xl.new_empty((B, S, T, K))
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    fwd = (lib.gat_logits_fwd if xl.dtype == torch.float32
           else lib.gat_logits_fwd_bf16)
    _build.check(fwd(
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
    [B,S,T,K]. Returns dxl, dxr, dadj [B,S,T] and dw: dwe and datt stacked
    ([2, K, F] shared, [B, 2, K, F] per sample; ``dw.unbind(-3)``). The
    kernel writes dxl, dxr and dadj (summed over heads) and per-block
    dwe / datt partials, which are summed here in one reduction (over the
    blocks, and for shared heads the batch, as the JAX package sums
    them) and cast once to we's dtype. dxl, dxr and dadj come in the
    inputs' dtype."""
    global bwd_launches
    B, S, T, K, F, wstride = _check(xl, xr, adj, we, att, ns)
    check_cuda_tensor("d_e", d_e, xl.dtype, (B, S, T, K))
    if B > GRID_LIMIT:
        raise ValueError(f"fused_gat_logits backward: batch {B} above the "
                         f"grid's {GRID_LIMIT}")
    lib = _lib()
    parts = lib.gat_logits_bwd_parts(B, S, T)
    if parts < 0:
        raise RuntimeError("gat_logits_bwd_parts failed")
    check_smem(f"fused_gat_logits backward: S={S}, T={T}, F={F}",
               lib.gat_logits_bwd_smem_bytes(B, S, T, F))
    dxl, dxr = torch.empty_like(xl), torch.empty_like(xr)
    dadj = xl.new_empty((B, S, T))
    part = xl.new_empty((B, parts, 2, K, F), dtype=torch.float32)
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    bwd = (lib.gat_logits_bwd if xl.dtype == torch.float32
           else lib.gat_logits_bwd_bf16)
    _build.check(bwd(
        xl.data_ptr(), xr.data_ptr(), adj.data_ptr(), we.data_ptr(),
        att.data_ptr(), d_e.data_ptr(), dxl.data_ptr(), dxr.data_ptr(),
        dadj.data_ptr(), part.data_ptr(), B, S, T, K, F, wstride, ns,
        stream), "gat_logits_bwd")
    bwd_launches += 1
    return dxl, dxr, dadj, part.sum(1 if wstride else (0, 1)).to(we.dtype)


def _occupancy(fn, *shape) -> dict:
    regs, local = ctypes.c_int(), ctypes.c_int()
    n = fn(*shape, ctypes.byref(regs), ctypes.byref(local))
    if n < 0:
        raise RuntimeError(f"{fn.__name__} failed")
    return {"regs": regs.value, "local_bytes": local.value,
            "blocks_per_sm": n}


def fwd_occupancy(B: int, S: int, T: int, K: int, F: int,
                  lib: Optional[ctypes.CDLL] = None) -> dict:
    """What the forward kernel's launch gets on this card at these shapes:
    registers and local (spill) bytes per thread, resident blocks per SM
    and the strips of sources a (b, k) plane is split into (of ``lib``,
    another build of ``csrc/gat_logits.cu``, when given)."""
    lib = lib or _lib()
    return {**_occupancy(lib.gat_logits_fwd_blocks_per_sm, B, S, T, K, F),
            "strips": lib.gat_logits_fwd_strips(B, S, T, K)}


def bwd_occupancy(B: int, S: int, T: int, F: int,
                  lib: Optional[ctypes.CDLL] = None) -> dict:
    """As ``fwd_occupancy``, for the backward kernel, with its blocks per
    sample (``parts``: the row blocks, then the column blocks)."""
    lib = lib or _lib()
    return {**_occupancy(lib.gat_logits_bwd_blocks_per_sm, B, S, T, F),
            "parts": lib.gat_logits_bwd_parts(B, S, T)}


def fused_gat_logits(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
                     we: torch.Tensor, att: torch.Tensor, ns: float
                     ) -> torch.Tensor:
    """GATv2 edge logits [B, S, T, K] (``ctvae::gat_logits_fwd``): the
    kernels on CUDA (the backward only when autograd needs it), the plain
    version on CPU. xl [B,S,K,F], xr [B,T,K,F], adj [B,S,T]; we / att
    [K,F] shared or [B,K,F] per sample."""
    return custom_ops().gat_logits_fwd(xl, xr, adj, we, att, ns)
