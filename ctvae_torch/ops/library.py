"""The port's kernels as ``torch.library`` custom ops (namespace ``ctvae``).

One op per kernel entry point:

* ``ctvae::vq_l2_argmin``: the codebook search (``csrc/vq.cu``);
* ``ctvae::pairwise_fwd`` / ``pairwise_bwd``: the discoverer scores
  (``csrc/pairwise.cu``);
* ``ctvae::gat_fwd``, ``gat_fwd_alpha`` (which also returns the f32 alpha
  residual [B, H, T, S] the backward reads) and ``gat_bwd``: the GATv2
  attention (``csrc/gat.cu``);
* ``ctvae::gat_logits_fwd`` / ``gat_logits_bwd``: the per-head edge
  logits (``csrc/gat_logits.cu``).

Each op has a CPU kernel (the plain PyTorch version), a CUDA kernel (the
hand-written launch of its wrapper module, ``*_cuda``, which counts the
launch) and a fake kernel (shapes only), so the dispatcher routes by the
tensors' device and ``torch.export`` / ``torch.compile`` trace through it:
an exported program carries the ops, and a CUDA tensor reaches the
kernel wherever the program runs. ``pairwise_fwd``, ``gat_fwd_alpha`` and
``gat_logits_fwd`` have gradients (``register_autograd``) through their
backward ops, whose outputs have the shapes of the forward's inputs (a
shared parameter's per-sample gradients are summed inside the op), but
``gat_logits_bwd``'s dwe and datt, which come stacked, [..., 2, K, F]:
its wrapper sums their partials in one reduction. A
backward op's CPU kernel is the vjp of the plain version's own autograd,
so CPU gradients are those the plain version always gave. ``gat_fwd``
has none: the wrapper takes ``gat_fwd_alpha`` when autograd needs it.
The ops take float32 or bfloat16 (the JAX package's compute dtypes,
each with its own kernel instantiation) and give every output the dtype
JAX's kernel gives it: the input dtype, but GAT's alpha residual
(float32) and the gradients, which are summed in float32 and cast once
to their input's dtype.
Importing this module registers the ops (``ops/__init__.py`` does); it
imports nothing of the models. A copy of the package imported under
another name registers its own namespace (``common.OPS_NAMESPACE``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import Tensor

from . import gat_flash, gat_logits, pairwise_flash, vq
from .common import OPS_NAMESPACE, upcast32
from .gat import gat_logits as plain_gat_logits
from .pairwise import fused_pairwise_scores, pairwise_logits

_C = torch._C
_AUTOGRAD_KEYS = (_C.DispatchKey.AutogradFunctionality,
                  _C.DispatchKey.ADInplaceOrView)


def _plain_vjp(fn, inputs: Sequence[Tensor], grad: Tensor, *args
               ) -> Tuple[Tensor, ...]:
    """The vjp of ``fn(*inputs, *args)`` against ``grad`` by autograd,
    contiguous as the kernels write it.

    An op's kernel runs below the dispatcher's autograd keys; they are
    switched back on for this one recorded forward and its backward."""
    exclude = _C._dispatch_tls_local_exclude_set()
    for key in _AUTOGRAD_KEYS:
        exclude = exclude.remove(key)
    with _C._ForceDispatchKeyGuard(_C._dispatch_tls_local_include_set(),
                                   exclude), torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves, *args)
        grads = torch.autograd.grad(out, leaves, grad,
                                    materialize_grads=True)
    return tuple(g.contiguous() for g in grads)


def _fold(g: Tensor, p: Tensor) -> Tensor:
    """A per-sample float32 gradient in the param's shape and dtype:
    summed over the batch when the param was shared, then cast once."""
    return (g if g.shape == p.shape else g.sum(0)).to(p.dtype)


# --- the VQ search -----------------------------------------------------------

@torch.library.custom_op(f"{OPS_NAMESPACE}::vq_l2_argmin",
                         mutates_args=(), device_types="cpu")
def vq_l2_argmin(flat: Tensor, codebook: Tensor) -> Tensor:
    """[N, D] x [K, D] -> int64 [N]: index of the nearest codebook row."""
    return vq.l2_argmin_plain(flat, codebook)


@vq_l2_argmin.register_kernel("cuda")
def _(flat, codebook):
    return vq.l2_argmin_cuda(flat, codebook)


@vq_l2_argmin.register_fake
def _(flat, codebook):
    return flat.new_empty((flat.shape[0],), dtype=torch.int64)


# --- the pairwise scores -----------------------------------------------------

@torch.library.custom_op(f"{OPS_NAMESPACE}::pairwise_fwd",
                         mutates_args=(), device_types="cpu")
def pairwise_fwd(xl: Tensor, xr: Tensor, w2: Tensor, b1: Tensor,
                 b2: Tensor, ns: float) -> Tensor:
    """``sigmoid(sum_h leaky(xl_s + xr_t + b1) * w2 + b2)`` [B, S, T]."""
    return fused_pairwise_scores(xl, xr, w2, b1, b2, ns)


@pairwise_fwd.register_kernel("cuda")
def _(xl, xr, w2, b1, b2, ns):
    return pairwise_flash.flash_pairwise_cuda(xl, xr, w2, b1, b2, ns)


@pairwise_fwd.register_fake
def _(xl, xr, w2, b1, b2, ns):
    return xl.new_empty((xl.shape[0], xl.shape[1], xr.shape[1]))


@torch.library.custom_op(f"{OPS_NAMESPACE}::pairwise_bwd",
                         mutates_args=(), device_types="cpu")
def pairwise_bwd(xl: Tensor, xr: Tensor, w2: Tensor, b1: Tensor,
                 b2: Tensor, out: Tensor, dout: Tensor, ns: float
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Gradients of ``pairwise_fwd`` (whose output is ``out``) against
    ``dout``: dxl, dxr, dw2, db1, db2 in the inputs' shapes and dtypes.
    As the JAX kernel, the sigmoid's gradient reads the output residual
    as stored (bfloat16 scores at bfloat16), ``dout (1 - out) out`` in
    float32, and the rest is the vjp of the float32 logits."""
    out32 = upcast32(out)
    dz = upcast32(dout) * (1 - out32) * out32
    return _plain_vjp(pairwise_logits, (xl, xr, w2, b1, b2), dz, ns)


@pairwise_bwd.register_kernel("cuda")
def _(xl, xr, w2, b1, b2, out, dout, ns):
    dxl, dxr, dw2, db1, db2 = pairwise_flash.flash_pairwise_bwd_cuda(
        xl, xr, w2, b1, out, dout, ns)
    return dxl, dxr, _fold(dw2, w2), _fold(db1, b1), _fold(db2, b2)


@pairwise_bwd.register_fake
def _(xl, xr, w2, b1, b2, out, dout, ns):
    return tuple(t.new_empty(t.shape) for t in (xl, xr, w2, b1, b2))


def _pairwise_setup(ctx, inputs, output):
    *tensors, ctx.ns = inputs
    ctx.save_for_backward(*tensors, output)


def _pairwise_backward(ctx, dout):
    return (*pairwise_bwd(*ctx.saved_tensors, dout.contiguous(), ctx.ns),
            None)


pairwise_fwd.register_autograd(_pairwise_backward,
                               setup_context=_pairwise_setup)


# --- the GATv2 attention -----------------------------------------------------

def _plain_gat(xl, xr, adj, mask, we, att, ns):
    """(out [B,T,H,F], the float32 alpha [B,H,T,S]) of the plain
    version."""
    out, alpha = gat_flash.plain_gat(xl, xr, adj, mask, we, att, ns)
    return out.contiguous(), alpha.permute(0, 3, 2, 1).contiguous()


@torch.library.custom_op(f"{OPS_NAMESPACE}::gat_fwd",
                         mutates_args=(), device_types="cpu")
def gat_fwd(xl: Tensor, xr: Tensor, adj: Tensor, mask: Tensor, we: Tensor,
            att: Tensor, ns: float) -> Tensor:
    """xl [B,S,H,F], xr [B,T,H,F], adj / mask [B,S,T], we / att [H,F] ->
    out [B,T,H,F] (no bias)."""
    return gat_flash.flash_gat_plain(xl, xr, adj, mask, we, att,
                                     ns).contiguous()


@gat_fwd.register_kernel("cuda")
def _(xl, xr, adj, mask, we, att, ns):
    return gat_flash.flash_gat_cuda(xl, xr, adj, mask, we, att, ns)[0]


@gat_fwd.register_fake
def _(xl, xr, adj, mask, we, att, ns):
    return xl.new_empty((xl.shape[0], xr.shape[1], *xl.shape[2:]))


@torch.library.custom_op(f"{OPS_NAMESPACE}::gat_fwd_alpha",
                         mutates_args=(), device_types="cpu")
def gat_fwd_alpha(xl: Tensor, xr: Tensor, adj: Tensor, mask: Tensor,
                  we: Tensor, att: Tensor, ns: float
                  ) -> Tuple[Tensor, Tensor]:
    """``gat_fwd`` and its alpha residual [B, H, T, S]."""
    return _plain_gat(xl, xr, adj, mask, we, att, ns)


@gat_fwd_alpha.register_kernel("cuda")
def _(xl, xr, adj, mask, we, att, ns):
    return gat_flash.flash_gat_cuda(xl, xr, adj, mask, we, att, ns,
                                    keep_alpha=True)


@gat_fwd_alpha.register_fake
def _(xl, xr, adj, mask, we, att, ns):
    B, S, H, _ = xl.shape
    T = xr.shape[1]
    return (xl.new_empty((B, T, *xl.shape[2:])),
            xl.new_empty((B, H, T, S), dtype=torch.float32))


@torch.library.custom_op(f"{OPS_NAMESPACE}::gat_bwd",
                         mutates_args=(), device_types="cpu")
def gat_bwd(xl: Tensor, xr: Tensor, adj: Tensor, mask: Tensor, we: Tensor,
            att: Tensor, alpha: Tensor, dout: Tensor, ns: float
            ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Gradients of ``gat_fwd_alpha`` (whose residual is ``alpha``)
    against ``dout``: dxl, dxr, dadj, dwe, datt (the mask has none)."""
    def fwd(xl, xr, adj, we, att):
        return gat_flash.flash_gat_plain(xl, xr, adj, mask, we, att, ns)
    return _plain_vjp(fwd, (xl, xr, adj, we, att), dout)


@gat_bwd.register_kernel("cuda")
def _(xl, xr, adj, mask, we, att, alpha, dout, ns):
    return gat_flash.flash_gat_bwd_cuda(xl, xr, adj, mask, we, att, alpha,
                                        dout, ns)


@gat_bwd.register_fake
def _(xl, xr, adj, mask, we, att, alpha, dout, ns):
    return tuple(t.new_empty(t.shape) for t in (xl, xr, adj, we, att))


def _gat_setup(ctx, inputs, output):
    *tensors, ctx.ns = inputs
    ctx.save_for_backward(*tensors, output[1])


def _gat_backward(ctx, dout, _dalpha):
    xl, xr, adj, mask, we, att, alpha = ctx.saved_tensors
    dxl, dxr, dadj, dwe, datt = gat_bwd(xl, xr, adj, mask, we, att, alpha,
                                        dout.contiguous(), ctx.ns)
    return dxl, dxr, dadj, None, dwe, datt, None


gat_fwd_alpha.register_autograd(_gat_backward, setup_context=_gat_setup)


# --- the per-head edge logits ------------------------------------------------

@torch.library.custom_op(f"{OPS_NAMESPACE}::gat_logits_fwd",
                         mutates_args=(), device_types="cpu")
def gat_logits_fwd(xl: Tensor, xr: Tensor, adj: Tensor, we: Tensor,
                   att: Tensor, ns: float) -> Tensor:
    """Edge logits [B, S, T, K]: xl [B,S,K,F], xr [B,T,K,F], adj [B,S,T];
    we / att [K,F] shared or [B,K,F] per sample."""
    return plain_gat_logits(xl, xr, adj, we, att, ns)


@gat_logits_fwd.register_kernel("cuda")
def _(xl, xr, adj, we, att, ns):
    return gat_logits.fused_gat_logits_cuda(xl, xr, adj, we, att, ns)


@gat_logits_fwd.register_fake
def _(xl, xr, adj, we, att, ns):
    return xl.new_empty((*xl.shape[:2], xr.shape[1], xl.shape[2]))


@torch.library.custom_op(f"{OPS_NAMESPACE}::gat_logits_bwd",
                         mutates_args=(), device_types="cpu")
def gat_logits_bwd(xl: Tensor, xr: Tensor, adj: Tensor, we: Tensor,
                   att: Tensor, d_e: Tensor, ns: float
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Gradients of ``gat_logits_fwd`` against ``d_e``: dxl, dxr, dadj in
    the inputs' shapes and dwe / datt stacked, [..., 2, K, F]."""
    dxl, dxr, dadj, dwe, datt = _plain_vjp(
        plain_gat_logits, (xl, xr, adj, we, att), d_e, ns)
    return dxl, dxr, dadj, torch.stack((dwe, datt), -3)


@gat_logits_bwd.register_kernel("cuda")
def _(xl, xr, adj, we, att, d_e, ns):
    return gat_logits.fused_gat_logits_bwd_cuda(xl, xr, adj, we, att, d_e,
                                                ns)


@gat_logits_bwd.register_fake
def _(xl, xr, adj, we, att, d_e, ns):
    return (*(t.new_empty(t.shape) for t in (xl, xr, adj)),
            we.new_empty((*we.shape[:-2], 2, *we.shape[-2:])))


def _logits_setup(ctx, inputs, output):
    *tensors, ctx.ns = inputs
    ctx.save_for_backward(*tensors)


def _logits_backward(ctx, d_e):
    dxl, dxr, dadj, dw = gat_logits_bwd(*ctx.saved_tensors, d_e.contiguous(),
                                        ctx.ns)
    return (dxl, dxr, dadj, *dw.unbind(-3), None)


gat_logits_fwd.register_autograd(_logits_backward,
                                 setup_context=_logits_setup)
