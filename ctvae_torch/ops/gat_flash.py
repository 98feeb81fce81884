"""GATv2 masked attention, forward: CUDA kernel wrapper.

Counterpart of ``ctvae_tpu/ops/gat_flash.py``. ``flash_gat`` launches the
kernel of ``csrc/gat.cu`` (which replaces the TPU ``_fwd_kernel``) on CUDA
tensors; on CPU tensors it runs ``flash_gat_plain``, the logits + masked
softmax + aggregation of ``ops/gat.py``. The kernel never stores the
[B, T, S, H, F] domain, nor the alpha residual (a training output that
comes back with the backward kernel).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .common import check_cuda_tensor
from .gat import gat_logits, masked_incoming_softmax

#: kernel launches since the last reset (``launches = 0`` to reset)
launches = 0

_MAX_F = 128         # features per head the kernel keeps in registers
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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gat_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                            ctypes.c_float, p]
    lib.gat_fwd.restype = ctypes.c_int
    lib.gat_fwd_smem_bytes.argtypes = [i, i, i]
    lib.gat_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def _warps(T: int) -> int:
    """Warps per block (one target each, looping): at most 16, chosen so
    the targets split evenly (T = 65 -> 13 warps x 5 targets)."""
    return -(-T // -(-T // 16))


def flash_gat_cuda(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
                   mask: torch.Tensor, we: torch.Tensor, att: torch.Tensor,
                   ns: float) -> torch.Tensor:
    """Launch the CUDA kernel; float32 contiguous inputs, bool mask."""
    global launches
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
    lib = _lib()
    nw = _warps(T) if T > 0 else 1
    smem = lib.gat_fwd_smem_bytes(S, F, nw)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"flash_gat: S={S}, F={F} needs {smem} bytes of "
                         f"shared memory, more than {_SMEM_LIMIT}")
    out = torch.empty((B, T, H, F), dtype=torch.float32, device=xl.device)
    stream = torch.cuda.current_stream(xl.device).cuda_stream
    _build.check(lib.gat_fwd(
        xl.data_ptr(), xr.data_ptr(), adj.data_ptr(), mask.data_ptr(),
        we.data_ptr(), att.data_ptr(), out.data_ptr(), B, S, T, H, F, nw,
        ns, stream), "gat_fwd")
    launches += 1
    return out


def flash_gat(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
              mask: torch.Tensor, we: torch.Tensor, att: torch.Tensor,
              ns: float) -> torch.Tensor:
    """Fused GATv2 attention out [B, T, H, F] (no bias): the kernel on
    CUDA, the plain version on CPU."""
    if xl.is_cuda:
        return flash_gat_cuda(xl, xr, adj, mask, we, att, ns)
    return flash_gat_plain(xl, xr, adj, mask, we, att, ns)
