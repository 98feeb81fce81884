"""Pairwise discoverer scores, forward and backward: CUDA kernel wrappers.

Counterpart of ``ctvae_tpu/ops/pairwise_flash.py``. ``flash_pairwise``
calls the custom op ``ctvae::pairwise_fwd`` (``ops/library.py``), whose
CUDA kernel launches ``pairwise_fwd`` and whose gradient,
``ctvae::pairwise_bwd``, launches ``pairwise_bwd``, both in
``csrc/pairwise.cu`` (which replace the TPU ``_fwd_kernel`` and
``_bwd_kernel``), each in a float32 and a bfloat16 instantiation
(``pairwise_fwd_bf16`` / ``pairwise_bwd_bf16``: bfloat16 in device
memory, float32 in registers, as JAX's kernels upcast at the load). The
residual is the [B, S, T] output, as in JAX; the [B, S, T, Hd] domain
never exists in device memory. The forward's
blocks split each sample's hidden units over a thread-block cluster
(``fwd_occupancy`` reads the split a launch takes). On CPU tensors the
ops run the plain ``ops/pairwise.py::fused_pairwise_scores`` and the vjp
of its autograd.
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("pairwise")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for fn in (lib.pairwise_fwd, lib.pairwise_fwd_bf16):
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i64, i64, i64,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    for fn in (lib.pairwise_bwd, lib.pairwise_bwd_bf16):
        fn.argtypes = [p] * 11 + [i, i, i, i, i64, i64, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    lib.pairwise_bwd_smem_bytes.argtypes = [i, i]
    lib.pairwise_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.pairwise_bwd_blocks_per_sm.argtypes = [i, i, p, p]
    lib.pairwise_bwd_blocks_per_sm.restype = ctypes.c_int
    lib.pairwise_fwd_smem_bytes.argtypes = []
    lib.pairwise_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.pairwise_fwd_cluster.argtypes = [i, i, i, i]
    lib.pairwise_fwd_cluster.restype = ctypes.c_int
    lib.pairwise_fwd_blocks_per_sm.argtypes = [p, p]
    lib.pairwise_fwd_blocks_per_sm.restype = ctypes.c_int
    return lib


def _param(name: str, p: torch.Tensor, B: int, shape: tuple, row: int,
           dtype: torch.dtype) -> int:
    """Validate a shared ([*shape]) or per-sample ([B, *shape]) param of
    ``dtype`` and return its batch stride in elements (0 when shared)."""
    if tuple(p.shape) == shape:
        check_cuda_tensor(name, p, dtype, shape)
        return 0
    check_cuda_tensor(name, p, dtype, (B,) + shape)
    return row


def _check_slope(ns: float) -> None:
    if not 0.0 <= ns <= 1.0:
        raise ValueError(f"negative slope {ns} outside [0, 1]")


#: the most samples, and 64 x 64 tiles of pairs per sample, that the
#: forward's grid takes (its y and z dimensions)
GRID_LIMIT = 65535


def flash_pairwise_cuda(xl: torch.Tensor, xr: torch.Tensor, w2: torch.Tensor,
                        b1: torch.Tensor, b2: torch.Tensor, ns: float
                        ) -> torch.Tensor:
    """Launch the forward kernel. xl [B,S,Hd], xr [B,T,Hd] contiguous,
    float32 or bfloat16 (every input of one dtype); w2/b1 [Hd] or [B,Hd];
    b2 scalar or [B]. Returns the scores [B, S, T] in that dtype."""
    global launches
    B, S, H = xl.shape
    T = xr.shape[1]
    dt = kernel_dtype("flash_pairwise", xl)
    check_cuda_tensor("xl", xl, dt, (B, S, H))
    check_cuda_tensor("xr", xr, dt, (B, T, H))
    w2_stride = _param("w2", w2, B, (H,), H, dt)
    b1_stride = _param("b1", b1, B, (H,), H, dt)
    b2_stride = _param("b2", b2, B, (), 1, dt)
    _check_slope(ns)
    tiles = -(-S // 64) * -(-T // 64)
    if B > GRID_LIMIT or tiles > GRID_LIMIT:
        raise ValueError(f"flash_pairwise: B={B} samples or {tiles} tiles of "
                         f"64 x 64 pairs exceed the grid's {GRID_LIMIT}")
    lib = _lib()
    check_smem(f"flash_pairwise: S={S}, T={T}, Hd={H}",
               lib.pairwise_fwd_smem_bytes())
    out = torch.empty((B, S, T), dtype=dt, device=xl.device)
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    fwd = lib.pairwise_fwd if dt == torch.float32 else lib.pairwise_fwd_bf16
    _build.check(fwd(
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
    ``out`` and the output gradient ``dout`` [B, S, T] (all of one dtype,
    float32 or bfloat16). Returns dxl [B,S,Hd], dxr [B,T,Hd] in that
    dtype and the per-sample float32 sums dw2 [B,Hd], db1 [B,Hd], db2 [B]
    (``ctvae::pairwise_bwd`` sums them over B for a shared param and casts
    them to the param's dtype)."""
    global bwd_launches
    B, S, H = xl.shape
    T = xr.shape[1]
    dt = kernel_dtype("flash_pairwise backward", xl)
    check_cuda_tensor("xl", xl, dt, (B, S, H))
    check_cuda_tensor("xr", xr, dt, (B, T, H))
    check_cuda_tensor("out", out, dt, (B, S, T))
    check_cuda_tensor("dout", dout, dt, (B, S, T))
    w2_stride = _param("w2", w2, B, (H,), H, dt)
    b1_stride = _param("b1", b1, B, (H,), H, dt)
    _check_slope(ns)
    if H == 0:
        raise ValueError("flash_pairwise backward needs Hd > 0")
    lib = _lib()
    check_smem(f"flash_pairwise backward: S={S}, T={T}",
               lib.pairwise_bwd_smem_bytes(S, T))
    f32 = torch.float32
    grads = (torch.empty_like(xl), torch.empty_like(xr),
             xl.new_empty((B, H), dtype=f32), xl.new_empty((B, H), dtype=f32),
             xl.new_empty((B,), dtype=f32))
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    bwd = lib.pairwise_bwd if dt == f32 else lib.pairwise_bwd_bf16
    _build.check(bwd(
        xl.data_ptr(), xr.data_ptr(), w2.data_ptr(), b1.data_ptr(),
        out.data_ptr(), dout.data_ptr(), *(g.data_ptr() for g in grads),
        B, S, T, H, w2_stride, b1_stride, ns, stream), "pairwise_bwd")
    bwd_launches += 1
    return grads


def fwd_occupancy(B: int, S: int, T: int, H: int,
                  lib: Optional[ctypes.CDLL] = None) -> dict:
    """What the forward kernel's launch gets on this card: warps per block,
    registers and local (spill) bytes per thread, resident blocks per SM,
    and the blocks of a cluster that split the hidden units at these shapes
    (of ``lib``, another build of ``csrc/pairwise.cu``, when given)."""
    lib = lib or _lib()
    regs, local = ctypes.c_int(), ctypes.c_int()
    n = lib.pairwise_fwd_blocks_per_sm(ctypes.byref(regs), ctypes.byref(local))
    cluster = lib.pairwise_fwd_cluster(B, S, T, H)
    if n < 0 or cluster < 0:
        raise RuntimeError("pairwise_fwd_blocks_per_sm failed")
    return {"warps": 8, "regs": regs.value, "local_bytes": local.value,
            "blocks_per_sm": n, "cluster": cluster}


def bwd_occupancy(S: int, T: int, lib: Optional[ctypes.CDLL] = None
                  ) -> dict:
    """What the backward kernel's launch gets on this card at these shapes:
    warps per block, registers and local (spill) bytes per thread and
    resident blocks per SM (of ``lib``, another build of
    ``csrc/pairwise.cu``, when given)."""
    fn = (lib or _lib()).pairwise_bwd_blocks_per_sm
    regs, local = ctypes.c_int(), ctypes.c_int()
    n = fn(S, T, ctypes.byref(regs), ctypes.byref(local))
    if n < 0:
        raise RuntimeError("pairwise_bwd_blocks_per_sm failed")
    return {"warps": 8, "regs": regs.value, "local_bytes": local.value,
            "blocks_per_sm": n}


def flash_pairwise(xl: torch.Tensor, xr: torch.Tensor, w2: torch.Tensor,
                   b1: torch.Tensor, b2: torch.Tensor, ns: float
                   ) -> torch.Tensor:
    """``sigmoid(sum_h leaky(xl_s + xr_t + b1) * w2 + b2)`` [B, S, T]
    (``ctvae::pairwise_fwd``): the kernels on CUDA, the plain version on
    CPU."""
    return custom_ops().pairwise_fwd(xl, xr, w2, b1, b2, ns)
