"""Dense GATv2 attention over weighted adjacency matrices (PyTorch).

Counterpart of ``ctvae_tpu/ops/gat.py``; the semantics are
torch-geometric's GATv2Conv (edge_dim=1, concat heads, PyG's default
mean-filled self-loops):

* ``adj[b, s, t] != 0`` is a directed edge s -> t carrying its value as a
  1-dim edge feature;
* every layer removes the diagonal edges and gives each node one
  self-loop whose attr is the mean of its other incoming weights;
* per head, ``e[s, t] = att . leaky(Wl x_s + Wr x_t + We w_st)``, a
  softmax over the incoming edges of t only (a target with none gets a
  zero row), and node t's output is the alpha-weighted sum of ``Wl x_s``.

The full-head attention (``forward``) runs in the CUDA kernels of
``ops/gat_flash.py`` on CUDA tensors (forward and backward). ``heads_call``
computes its per-sample-head logits in the CUDA kernels of
``ops/gat_logits.py`` (forward and backward, the counterpart of JAX's
``fused_gat_logits`` and its one-walk VJP); its masked softmax and
aggregation are plain PyTorch with autograd. On CPU tensors every kernel
runs its plain version.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .common import upcast32
from .layers import Linear

NEG = -1e30


def gat_logits32(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
                 we: torch.Tensor, att: torch.Tensor, ns: float
                 ) -> torch.Tensor:
    """``gat_logits`` in at least float32 (every input upcast first, as
    the JAX kernels load them), not rounded back."""
    def bhf(p):
        return p[:, None, None] if p.ndim == 3 else p
    xl, xr, adj, we, att = map(upcast32, (xl, xr, adj, we, att))
    pre = (xl[:, :, None, :, :] + xr[:, None, :, :, :]
           + adj[:, :, :, None, None] * bhf(we))
    act = torch.where(pre >= 0, pre, ns * pre)
    return torch.sum(act * bhf(att), dim=-1)


def gat_logits(xl: torch.Tensor, xr: torch.Tensor, adj: torch.Tensor,
               we: torch.Tensor, att: torch.Tensor, ns: float) -> torch.Tensor:
    """Edge logits ``e[b,s,t,h] = att_h . leaky(xl_s + xr_t + adj_st we_h)``.

    xl [B,S,H,F], xr [B,T,H,F], adj [B,S,T]; we/att [H,F] or per-sample
    [B,H,F]. Returns [B, S, T, H] (the domain is materialised), computed
    in float32 and returned in xl's dtype."""
    return gat_logits32(xl, xr, adj, we, att, ns).to(xl.dtype)


def masked_incoming_softmax(logits: torch.Tensor, edge_mask: torch.Tensor
                            ) -> torch.Tensor:
    """Softmax over the source axis (1) restricted to real edges; targets
    with no incoming edge get an all-zero row. logits [B, S, T, H'],
    edge_mask [B, S, T] bool. The max is a constant of the gradient, as
    the JAX package's ``stop_gradient`` makes it."""
    mask = edge_mask[:, :, :, None]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG))
    logits = logits - torch.amax(logits, dim=1, keepdim=True).detach()
    w = torch.where(mask, torch.exp(logits), torch.zeros_like(logits))
    denom = torch.sum(w, dim=1, keepdim=True)
    return w / torch.where(denom == 0, torch.ones_like(denom), denom)


def replace_self_loops(adj: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyG ``remove_self_loops`` + ``add_self_loops(fill_value='mean')``:
    returns ``(adj, edge_mask)`` with the mean-filled diagonal and the mask
    ``(off-diagonal adj != 0) | eye`` (a sampled zero removes an edge)."""
    T = adj.shape[1]
    eye = torch.eye(T, dtype=torch.bool, device=adj.device)[None]
    off = torch.where(eye, torch.zeros_like(adj), adj)
    cnt = torch.sum(off != 0, dim=1)                          # [B, T]
    fill = torch.sum(off, dim=1) / torch.clamp(cnt, min=1)
    adj = off + eye * fill[:, None, :].to(adj.dtype)
    return adj, (off != 0) | eye


class DenseGATv2Layer(nn.Module):
    """One GATv2 layer with ``heads`` heads of ``out_features`` each.

    flax's ``dtype`` is split in two: ``lin_edge``, ``att`` and ``bias``
    are created in ``param_dtype``; ``compute_dtype`` (float32 unless
    ``ops/layers.py::set_compute_dtype`` sets it, as the models do) is
    what ``lin_l`` / ``lin_r`` compute in (their parameters stay float32)
    and what the kernels take the adjacency in. ``block_cols`` > 0
    bounds the plain version's [B, S, C, H, F] workspace as JAX's XLA
    path does: on CPU tensors the targets go through the attention
    ``block_cols`` at a time (each target's softmax and sum read only its
    own column, so the result is the unchunked one), and ``heads_call``
    takes the chunked full-head forward and gathers its heads, as JAX
    does. The CUDA kernels ignore it: they never build that workspace,
    and where JAX on a TPU leaves its flash kernel for the chunked XLA
    path, the port keeps the kernel, whose values are the same."""

    compute_dtype = torch.float32

    def __init__(self, in_features: int, out_features: int, heads: int = 1,
                 negative_slope: float = 0.2, *,
                 param_dtype=torch.float32, block_cols: int = 0,
                 device=None):
        super().__init__()
        self.heads, self.out_features = heads, out_features
        self.negative_slope = negative_slope
        self.block_cols = block_cols
        hf = heads * out_features
        self.lin_l = Linear(in_features, hf, device=device)
        self.lin_r = Linear(in_features, hf, device=device)
        # edge_dim=1: We maps the scalar edge weight to [H, F]
        self.lin_edge = nn.Parameter(torch.zeros(1, hf, device=device,
                                                 dtype=param_dtype))
        self.att = nn.Parameter(torch.zeros(heads, out_features,
                                            device=device, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(hf, device=device,
                                             dtype=param_dtype))

    def _chunked(self, x: torch.Tensor) -> bool:
        """Whether the target axis goes in blocks: ``block_cols`` below
        the node count, on the plain (CPU) path."""
        return (0 < self.block_cols < x.shape[1]
                and x.device.type == "cpu")

    def identity_call(self, x: torch.Tensor) -> torch.Tensor:
        """Exact fast path for an identity adjacency: each target's only
        incoming edge is its mean-filled self-loop, the softmax over a
        singleton is 1, and the layer collapses to ``lin_l(x) + bias``."""
        return self.lin_l(x) + self.bias

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x [B, T, Fin], adj [B, T, T] -> [B, T, heads * out_features]."""
        from .gat_flash import flash_gat
        B, T, _ = x.shape
        H, Fo = self.heads, self.out_features
        adj, edge_mask = replace_self_loops(adj)
        adj = adj.to(self.compute_dtype)
        xl = self.lin_l(x).reshape(B, T, H, Fo)
        xr = self.lin_r(x).reshape(B, T, H, Fo)
        we = self.lin_edge.reshape(H, Fo)
        if self._chunked(x):
            C = self.block_cols
            out = torch.cat([
                flash_gat(xl, xr[:, c:c + C].contiguous(),
                          adj[:, :, c:c + C].contiguous(),
                          edge_mask[:, :, c:c + C].contiguous(), we,
                          self.att, self.negative_slope)
                for c in range(0, T, C)], dim=1)
        else:
            out = flash_gat(xl, xr, adj, edge_mask, we, self.att,
                            self.negative_slope)
        return out.reshape(B, T, H * Fo) + self.bias

    def heads_call(self, x: torch.Tensor, adj: torch.Tensor,
                   head_idx: torch.Tensor) -> torch.Tensor:
        """Only the per-sample heads ``head_idx`` [B, K]: identical to
        ``forward`` followed by a gather of those heads. Returns
        [B, T, K, F] (heads not concatenated)."""
        from .gat_logits import fused_gat_logits
        B, T, _ = x.shape
        H, Fo = self.heads, self.out_features
        K = head_idx.shape[1]
        hsel = head_idx[:, None, :, None].expand(B, T, K, Fo)
        if self._chunked(x):
            out = self(x, adj).reshape(B, T, H, Fo)
            return torch.gather(out, 2, hsel)
        adj, edge_mask = replace_self_loops(adj)
        xl = torch.gather(self.lin_l(x).reshape(B, T, H, Fo), 2, hsel)
        xr = torch.gather(self.lin_r(x).reshape(B, T, H, Fo), 2, hsel)
        we = self.lin_edge.reshape(H, Fo)[head_idx]            # [B, K, F]
        att = self.att[head_idx]
        bias = self.bias.reshape(H, Fo)[head_idx]
        logits = fused_gat_logits(xl, xr, adj.to(self.compute_dtype), we,
                                  att, self.negative_slope)
        alpha = masked_incoming_softmax(logits, edge_mask)
        out = torch.einsum("bstk,bskf->btkf", alpha, xl)
        return out + bias[:, None]


class GATv2Stack(nn.Module):
    """[GATv2 -> LeakyReLU(0.01)] * len(hidden) -> GATv2 (no activation);
    every layer has ``heads`` heads and the last maps to ``input_dim``."""

    def __init__(self, input_dim: int, hidden: Sequence[int], heads: int, *,
                 param_dtype=torch.float32, block_cols: int = 0,
                 device=None):
        super().__init__()
        dims = list(hidden) + [input_dim]
        fin = input_dim
        for i, dim in enumerate(dims):
            # names follow the JAX param tree (DenseGATv2Layer_0, _1, ...)
            setattr(self, f"DenseGATv2Layer_{i}",
                    DenseGATv2Layer(fin, dim, heads=heads,
                                    param_dtype=param_dtype,
                                    block_cols=block_cols, device=device))
            fin = heads * dim
        self._n_layers = len(dims)

    def _layers(self):
        return [getattr(self, f"DenseGATv2Layer_{i}")
                for i in range(self._n_layers)]

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        *hidden_layers, last = self._layers()
        for layer in hidden_layers:
            x = F.leaky_relu(layer(x, adj), 0.01)
        return last(x, adj)

    def select_forward(self, x: torch.Tensor, adj: torch.Tensor,
                       head_idx: torch.Tensor) -> torch.Tensor:
        """Full stack; the final layer computes only the ``head_idx``
        [B, K] heads. Returns [B, T, K, out_features]."""
        *hidden_layers, last = self._layers()
        for layer in hidden_layers:
            x = F.leaky_relu(layer(x, adj), 0.01)
        return last.heads_call(x, adj, head_idx)

    def identity_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The stack under an identity adjacency (support nodes not
        needed: they have no outgoing edges)."""
        *hidden_layers, last = self._layers()
        for layer in hidden_layers:
            x = F.leaky_relu(layer.identity_call(x), 0.01)
        return last.identity_call(x)
