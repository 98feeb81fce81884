"""CT-VAE: CausalTransition module + CTMCQVAE model, eval forward.

Counterpart of ``ctvae_tpu/models/ct_vae.py``. The causal variables are
the ``S = codebooks * h * w`` latent sites, each an N-dim distribution
over codebook entries; sequences are [B, S, N]. Causal mode scores all A
actions as one [A*B] virtual batch, with the positional encoding and the
discoverer-0 scores computed once on [B] and tiled.

Every random draw goes through a ``Draws`` provider (``models/base.py``)
in the JAX package's order: under ``train`` the positional-encoding
dropout mask at each ``pos_encoding`` call, the Gumbel intervention mask,
the Gumbel edge sample, then the uniform KL target. With ``noise='off'``
there is no exo or endo draw.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.gat import GATv2Stack
from ..ops.pairwise import pairwise_mlp_scores
from .backbones import VQDecoder, VQEncoder
from .base import Draws, cross_entropy_from_probs, dropout, mse_loss
from .quantizers import MultipleCodebookVectorQuantizer, codebook_perplexity

CLAMP_EPS = 1e-4


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """Sinusoidal positional encoding table [max_len, d_model], computed
    on the host in float64 (callers cast)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * (-math.log(10000.0) / d_model))
    angles = position * div_term
    pe = np.zeros((max_len, d_model))
    pe[:, 0::2] = np.sin(angles)
    pe[:, 1::2] = np.cos(angles[:, : (d_model // 2)])
    return pe


def st_bernoulli_gumbel(gumbel: torch.Tensor, probs: torch.Tensor,
                        tau: float = 1.0) -> torch.Tensor:
    """Straight-through Gumbel-softmax Bernoulli sample of ``probs`` with
    the given Gumbel noise [*probs.shape, 2]: logits log(clamp([1-p, p])),
    hard one-hot forward, soft gradient."""
    logits = torch.log(torch.clamp(torch.stack([1.0 - probs, probs], -1),
                                   min=CLAMP_EPS))
    y_soft = torch.softmax((logits + gumbel) / tau, dim=-1)
    hard = (torch.argmax(y_soft, dim=-1) == 1).to(probs.dtype)
    return hard + y_soft[..., 1] - y_soft[..., 1].detach()


class CausalTransition(nn.Module):
    """Operates on one-hot codebook distributions over S causal variables."""

    def __init__(self, input_dim: int, action_dim: int,
                 latent_dims: Optional[Sequence[int]] = None,
                 c_alpha: float = 0.7, c_beta: float = 0.4,
                 c_delta: float = 0.4, c_epsilon: float = 0.4,
                 dropout_rate: float = 0.1, max_len: int = 4096, *,
                 device=None):
        super().__init__()
        ld = tuple(latent_dims) if latent_dims else (800, 100)
        N, A, H = input_dim, action_dim, ld[0]
        self.input_dim, self.action_dim = N, A
        self.c_alpha, self.c_beta = c_alpha, c_beta
        self.c_delta, self.c_epsilon = c_delta, c_epsilon
        self.dropout_rate = dropout_rate
        self.a_dense = nn.Linear(A, N, device=device)
        self.register_buffer(
            "pe_table", torch.tensor(sinusoidal_pe(max_len, N),
                                     dtype=torch.float32, device=device),
            persistent=False)

        def param(*shape):
            return nn.Parameter(torch.zeros(*shape, device=device))
        # (A+1) pairwise discoverers, first layer factored into the
        # left/right halves of the concat; shapes as in the JAX params
        self.disc_w1l = param(A + 1, N, H)
        self.disc_w1r = param(A + 1, N, H)
        self.disc_b1 = param(A + 1, H)
        self.disc_w2 = param(A + 1, H, 1)
        self.disc_b2 = param(A + 1, 1)
        self.mask_kernel = param(A + N, N)
        self.mask_bias = param(N)
        self.graph_transitioner = GATv2Stack(N, ld[1:], 1 + A, device=device)

    # --- building blocks ----------------------------------------------

    def pos_encoding(self, x: torch.Tensor, draws: Draws, train: bool
                     ) -> torch.Tensor:
        """``x`` plus the sinusoidal table, then dropout under ``train``."""
        pe = self.pe_table[None, : x.shape[1], :].to(x.dtype)
        return dropout(x + pe, self.dropout_rate, draws, train)

    def _compute_mask(self, one_hot_latent: torch.Tensor,
                      action: torch.Tensor, draws: Draws, train: bool
                      ) -> torch.Tensor:
        """Gumbel-hard per-variable intervention mask [B, S, 1]."""
        B, S, N = one_hot_latent.shape
        a_rep = action[:, None, :].to(one_hot_latent.dtype).expand(
            B, S, action.shape[-1])
        pos_embed = self.pos_encoding(torch.zeros_like(one_hot_latent),
                                      draws, train)
        inter_mask = torch.sigmoid(
            torch.cat([a_rep, pos_embed], dim=-1) @ self.mask_kernel
            + self.mask_bias)
        inter_masked = torch.sum(one_hot_latent * inter_mask, dim=-1)
        g = draws.gumbel(inter_masked.shape + (2,))
        return st_bernoulli_gumbel(g, inter_masked)[..., None]

    def _no_inter_scores(self, latent: torch.Tensor) -> torch.Tensor:
        """Discoverer-0 (no-intervention) pairwise scores [B, S, S]."""
        u0 = latent @ self.disc_w1l[0]
        v0 = latent @ self.disc_w1r[0]
        return pairwise_mlp_scores(u0, v0, self.disc_w2[0, :, 0],
                                   self.disc_b2[0, 0], self.disc_b1[0])

    def _compute_adj(self, latent: torch.Tensor, action: torch.Tensor,
                     mask: torch.Tensor,
                     no_inter: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Mask-mixed adjacency [B, S, S]: discoverer 0 for every sample,
        discoverer ``1 + argmax(action)`` for each sample's intervention."""
        if no_inter is None:
            no_inter = self._no_inter_scores(latent)
        aid = 1 + torch.argmax(action, dim=-1)
        ui = torch.einsum("bsn,bnh->bsh", latent, self.disc_w1l[aid])
        vi = torch.einsum("bsn,bnh->bsh", latent, self.disc_w1r[aid])
        inter = pairwise_mlp_scores(ui, vi, self.disc_w2[aid, :, 0],
                                    self.disc_b2[aid, 0], self.disc_b1[aid])
        return no_inter * (1 - mask) + inter * mask

    @staticmethod
    def _pad_adjacency(adjacency: torch.Tensor, vs: int) -> torch.Tensor:
        """Append ``vs`` support nodes: an incoming edge of weight 1 from
        every variable, no outgoing edges."""
        B, S, _ = adjacency.shape
        adj = torch.cat([adjacency, adjacency.new_ones(B, S, vs)], dim=2)
        return torch.cat([adj, adjacency.new_zeros(B, vs, S + vs)], dim=1)

    def _compute_y_identity(self, latent: torch.Tensor) -> torch.Tensor:
        """``_compute_y`` for the identity adjacency, in closed form."""
        nodes_y = self.graph_transitioner.identity_forward(latent)
        return torch.softmax(nodes_y[..., : self.input_dim], dim=-1)

    def _compute_y(self, latent: torch.Tensor, action: torch.Tensor,
                   adjacency: torch.Tensor, mask: torch.Tensor,
                   mask_is_zero: bool = False) -> torch.Tensor:
        """GNN transition + action-head selection; the final GAT layer
        computes only head 0 and each sample's action head."""
        B, S, N = latent.shape
        action = action.to(latent.dtype)
        nodes = torch.cat([latent, self.a_dense(action)[:, None, :]], dim=1)
        padded_adj = self._pad_adjacency(adjacency, 1)
        zeros = torch.zeros((B,), dtype=torch.long, device=latent.device)
        if mask_is_zero:
            heads = self.graph_transitioner.select_forward(
                nodes, padded_adj, zeros[:, None])[:, :S]
            mixed = heads[:, :, 0, :]
        else:
            head_idx = torch.stack([zeros, 1 + torch.argmax(action, -1)], 1)
            heads = self.graph_transitioner.select_forward(
                nodes, padded_adj, head_idx)[:, :S]
            mixed = heads[:, :, 0, :] * (1 - mask) + heads[:, :, 1, :] * mask
        return torch.softmax(mixed, dim=-1)

    # --- forward modes --------------------------------------------------

    def forward(self, latent: torch.Tensor, draws: Draws, *,
                train: bool = False):
        """Identity transition (action = 0), regularized toward identity."""
        B, S, N = latent.shape
        mask = latent.new_zeros(B, S, 1)
        pos_latent = self.pos_encoding(latent, draws, train)
        action = latent.new_zeros(B, self.action_dim)
        adjacency = self._compute_adj(pos_latent, action, mask)
        causal_graph = st_bernoulli_gumbel(
            draws.gumbel(adjacency.shape + (2,)), adjacency)
        latent_y = self._compute_y(pos_latent, action,
                                   adjacency * causal_graph, mask,
                                   mask_is_zero=True)
        identity = torch.eye(S, dtype=latent.dtype, device=latent.device)
        y_id = self._compute_y_identity(pos_latent)
        ct_reg = self.c_alpha * (
            cross_entropy_from_probs(y_id.reshape(-1, N),
                                     torch.argmax(latent.reshape(-1, N), -1))
            + mse_loss(causal_graph, identity.expand(B, S, S)))
        return latent_y, ct_reg, {"ct_adjacency": adjacency.mean(0)}

    def forward_action(self, latent: torch.Tensor, action: torch.Tensor,
                       draws: Draws, *, train: bool = False,
                       _pos_latent: Optional[torch.Tensor] = None,
                       _no_inter: Optional[torch.Tensor] = None):
        """Masked intervention. ``_pos_latent`` / ``_no_inter`` carry the
        shared encoding and discoverer-0 scores of ``forward_transition``."""
        mask = self._compute_mask(latent, action, draws, train)
        pos_latent = (self.pos_encoding(latent, draws, train)
                      if _pos_latent is None else _pos_latent)
        adjacency = self._compute_adj(pos_latent, action, mask,
                                      no_inter=_no_inter)
        causal_graph = st_bernoulli_gumbel(
            draws.gumbel(adjacency.shape + (2,)), adjacency)
        latent_y = self._compute_y(pos_latent, action,
                                   adjacency * causal_graph, mask)
        ct_reg = (self.c_beta * self.adjacency_kl_loss(adjacency, draws)
                  + self.c_delta * self.graph_size_loss(causal_graph)
                  + self.c_epsilon * self.positive_trial_loss(adjacency))
        return latent_y, ct_reg, {"ct_mask": mask[..., 0].mean(0),
                                  "ct_adjacency": adjacency.mean(0)}

    def forward_transition(self, latent: torch.Tensor,
                           latent_y: torch.Tensor, draws: Draws, *,
                           train: bool = False):
        """Action classification: all A actions as one [A*B] batch, softmin
        of the CE distances to ``latent_y``. Returns probas [B, A]."""
        B, S, N = latent.shape
        A = self.action_dim
        actions = torch.eye(A, dtype=latent.dtype, device=latent.device)
        lat_rep = latent[None].expand(A, B, S, N).reshape(A * B, S, N)
        act_rep = actions[:, None, :].expand(A, B, A).reshape(A * B, A)
        pos_latent = self.pos_encoding(latent, draws, train)
        no_inter = self._no_inter_scores(pos_latent)
        pos_rep = pos_latent[None].expand(A, B, S, N).reshape(A * B, S, N)
        ni_rep = no_inter[None].expand(A, B, S, S).reshape(A * B, S, S)
        y_pred, _, _ = self.forward_action(lat_rep, act_rep, draws,
                                           train=train, _pos_latent=pos_rep,
                                           _no_inter=ni_rep)
        y_pred = y_pred.reshape(A, B, S, N)
        y_inds = torch.argmax(latent_y, dim=-1)
        logits = torch.log_softmax(
            torch.log(torch.clamp(y_pred, min=CLAMP_EPS)), dim=-1)
        nll = -torch.gather(logits, -1,
                            y_inds[None, :, :, None].expand(A, B, S, 1))[..., 0]
        distances = nll.mean(-1).T                                # [B, A]
        probas = torch.softmax(-distances, dim=-1)
        return probas, latent.new_zeros(()), {}

    # --- losses & metrics -----------------------------------------------

    @staticmethod
    def latent_loss(latent: torch.Tensor, latent_y: torch.Tensor
                    ) -> torch.Tensor:
        """CE(latent distributions, argmax of the detached target)."""
        N = latent.shape[-1]
        return cross_entropy_from_probs(
            latent.reshape(-1, N),
            torch.argmax(latent_y.detach().reshape(-1, N), -1))

    @staticmethod
    def adjacency_kl_loss(adjacency: torch.Tensor, draws: Draws
                          ) -> torch.Tensor:
        """KL(log_softmax(adj) || softmax(uniform noise)), batch mean."""
        B = adjacency.shape[0]
        log_q = torch.log_softmax(adjacency.reshape(B, -1), dim=-1)
        target = torch.softmax(draws.uniform(log_q.shape).to(log_q.dtype),
                               dim=-1)
        kl = torch.sum(target * (torch.log(torch.clamp(target, min=1e-12))
                                 - log_q), dim=-1)
        return kl.mean()

    @staticmethod
    def graph_size_loss(causal_graph: torch.Tensor) -> torch.Tensor:
        return torch.linalg.matrix_norm(causal_graph).mean()

    @staticmethod
    def positive_trial_loss(adjacency: torch.Tensor) -> torch.Tensor:
        """||prod_j (1 - adj_ij)||_2 per sample, 0 where it underflows."""
        prod = torch.prod(1.0 - adjacency, dim=-1)
        sq = torch.sum(torch.square(prod), dim=-1)
        safe = torch.sqrt(torch.where(sq == 0, torch.ones_like(sq), sq))
        return torch.where(sq == 0, torch.zeros_like(sq), safe).mean()

    @staticmethod
    def causal_accuracy(action_probas: torch.Tensor, action: torch.Tensor
                        ) -> torch.Tensor:
        return (torch.argmax(action_probas, -1)
                == torch.argmax(action, -1)).float().mean()

    @staticmethod
    def causal_undirected_accuracy(action_probas: torch.Tensor,
                                   action: torch.Tensor) -> torch.Tensor:
        dim = action.shape[-1]
        recons = F.one_hot(torch.argmax(action_probas, -1), dim).to(
            action.dtype)
        recons_dir = recons[:, dim // 2:] + recons[:, : dim // 2]
        action_dir = action[:, dim // 2:] + action[:, : dim // 2]
        return CausalTransition.causal_accuracy(recons_dir, action_dir)


class CTMCQVAE(nn.Module):
    """MCQ-VAE backbone + CausalTransition over quantization indices, with
    the modes ``base`` / ``action`` / ``causal``; ``train=True`` turns on
    the positional-encoding dropout (``ct_dropout_rate``)."""

    FORWARD_MODES = ("base", "action", "causal")

    def __init__(self, in_channels: int = 3, embedding_dim: int = 128,
                 action_dim: int = 12, num_embeddings: int = 64,
                 hidden_dims: Optional[Sequence[int]] = None,
                 causal_hidden_dims: Optional[Sequence[int]] = None,
                 beta: float = 0.25, gamma: float = 0.25, img_size: int = 64,
                 codebooks: int = 1, skip_transition: bool = False,
                 noise: str = "off", c_alpha: float = 0.7,
                 c_beta: float = 0.4, c_delta: float = 0.4,
                 c_epsilon: float = 0.4, slicing: str = "chunk",
                 grad_estimator: str = "ste", ema: bool = False,
                 pairwise_block_rows: Optional[int] = None,
                 gat_block_cols: int = 0, ct_dropout_rate: float = 0.1,
                 seq_axis: Optional[str] = None, dtype="float32", *,
                 device=None):
        super().__init__()
        unsupported = {"ema": ema, "grad_estimator='rotation'":
                       grad_estimator != "ste",
                       "pairwise_block_rows": pairwise_block_rows is not None,
                       "gat_block_cols": bool(gat_block_cols),
                       "seq_axis": seq_axis is not None,
                       f"noise={noise!r}": noise != "off",
                       f"dtype={dtype!r}": str(dtype) not in ("float32",
                                                              "torch.float32")}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
        hd = tuple(hidden_dims) if hidden_dims else (128, 256)
        self.in_channels, self.embedding_dim = in_channels, embedding_dim
        self.action_dim, self.num_embeddings = action_dim, num_embeddings
        self.gamma, self.codebooks = gamma, codebooks
        self.skip_transition = skip_transition
        self.nb_latents = img_size // (2 ** len(hd))
        self.encoder = VQEncoder(in_channels, hd, embedding_dim,
                                 device=device)
        self.vq_layer = MultipleCodebookVectorQuantizer(
            num_embeddings, embedding_dim, codebooks, beta, slicing=slicing,
            device=device)
        self.ct_layer = CausalTransition(
            num_embeddings, action_dim, causal_hidden_dims, c_alpha=c_alpha,
            c_beta=c_beta, c_delta=c_delta, c_epsilon=c_epsilon,
            dropout_rate=ct_dropout_rate, device=device)
        self.decoder = VQDecoder(embedding_dim, hd, in_channels,
                                 device=device)

    @property
    def device(self) -> torch.device:
        return self.ct_layer.disc_b1.device

    def _draws(self, draws: Optional[Draws]) -> Draws:
        return draws if draws is not None else Draws(None, self.device)

    # --- plumbing -------------------------------------------------------

    def encode(self, x: torch.Tensor):
        return [self.encoder(x)]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def ct_preprocess(self, inds: torch.Tensor) -> torch.Tensor:
        """int inds [B, K, h, w] -> one-hot sequence [B, K*h*w, N]."""
        one_hot = F.one_hot(inds, self.num_embeddings).float()
        return one_hot.reshape(inds.shape[0], -1, self.num_embeddings)

    def ct_postprocess(self, seq: torch.Tensor) -> torch.Tensor:
        """[B, S, N] distributions -> int inds [B, K, h, w] via argmax."""
        hw = self.nb_latents
        return torch.argmax(seq, dim=-1).reshape(seq.shape[0],
                                                 self.codebooks, hw, hw)

    # --- forward modes --------------------------------------------------

    def forward_base(self, x: torch.Tensor, *, draws: Optional[Draws] = None,
                     train: bool = False) -> Dict:
        draws = self._draws(draws)
        latents = self.encoder(x)
        inds = self.vq_layer.compute_inds(latents)
        one_hot = self.ct_preprocess(inds)
        ct_seq, ct_reg, ct_metrics = self.ct_layer(one_hot, draws,
                                                    train=train)
        ct_loss = ct_reg + self.ct_layer.latent_loss(ct_seq, one_hot)
        use_inds = inds if self.skip_transition else self.ct_postprocess(ct_seq)
        quantized, vq_loss = self.vq_layer.compute_latents(latents, use_inds)
        return {"recons": self.decoder(quantized), "input": x,
                "vq_loss": vq_loss, "ct_loss": ct_loss, "mode": "base",
                "metrics": {"mode_id": x.new_tensor(0.0), **ct_metrics,
                            "codebook_perplexity": codebook_perplexity(
                                inds, self.num_embeddings)}}

    def forward_action(self, x: torch.Tensor, action: torch.Tensor,
                       input_y: torch.Tensor, *,
                       draws: Optional[Draws] = None,
                       train: bool = False) -> Dict:
        draws = self._draws(draws)
        # x and input_y ride one encoder pass
        latents, latents_y = torch.chunk(
            self.encoder(torch.cat([x, input_y], dim=0)), 2, dim=0)
        inds = self.vq_layer.compute_inds(latents)
        one_hot = self.ct_preprocess(inds)
        ct_seq, ct_reg, ct_metrics = self.ct_layer.forward_action(
            one_hot, action, draws, train=train)
        target_inds = self.vq_layer.compute_inds(latents_y)
        ct_loss = ct_reg + self.ct_layer.latent_loss(
            ct_seq, self.ct_preprocess(target_inds))
        use_inds = inds if self.skip_transition else self.ct_postprocess(ct_seq)
        quantized, _ = self.vq_layer.compute_latents(latents, use_inds)
        return {"recons": self.decoder(quantized), "input": input_y,
                "vq_loss": x.new_tensor(0.0), "ct_loss": ct_loss,
                "mode": "action",
                "metrics": {"mode_id": x.new_tensor(1.0), **ct_metrics,
                            "codebook_perplexity": codebook_perplexity(
                                inds, self.num_embeddings)}}

    def forward_causal(self, x: torch.Tensor, input_y: torch.Tensor,
                       action: torch.Tensor, *,
                       draws: Optional[Draws] = None,
                       train: bool = False) -> Dict:
        draws = self._draws(draws)
        latents_x, latents_y = torch.chunk(
            self.encoder(torch.cat([x, input_y], dim=0)), 2, dim=0)
        inds_x = self.vq_layer.compute_inds(latents_x)
        inds_y = self.vq_layer.compute_inds(latents_y)
        probas, ct_reg, _ = self.ct_layer.forward_transition(
            self.ct_preprocess(inds_x), self.ct_preprocess(inds_y), draws,
            train=train)
        return {"recons": probas, "input": action,
                "vq_loss": x.new_tensor(0.0), "ct_loss": ct_reg,
                "mode": "causal",
                "metrics": {
                    "causal_acc": self.ct_layer.causal_accuracy(probas, action),
                    "causal_nodir_acc":
                        self.ct_layer.causal_undirected_accuracy(probas,
                                                                 action),
                    "mode_id": x.new_tensor(2.0),
                    "codebook_perplexity": codebook_perplexity(
                        inds_x, self.num_embeddings)}}

    def forward(self, x: torch.Tensor, input_y: torch.Tensor = None,
                action: torch.Tensor = None, mode: str = "base", *,
                draws: Optional[Draws] = None, train: bool = False) -> Dict:
        if isinstance(mode, (list, tuple)):
            mode = mode[0]
        if mode == "base":
            return self.forward_base(x, draws=draws, train=train)
        if mode == "action":
            return self.forward_action(x, action, input_y, draws=draws,
                                       train=train)
        if mode == "causal":
            return self.forward_causal(x, input_y, action, draws=draws,
                                       train=train)
        raise ValueError(f"unknown mode {mode!r}")

    def loss_function(self, outputs: Dict, **kwargs) -> Dict:
        recons, target = outputs["recons"], outputs["input"]
        vq_loss, ct_loss = outputs["vq_loss"], outputs["ct_loss"]
        if outputs.get("mode") == "causal":
            recons_loss = cross_entropy_from_probs(
                recons, torch.argmax(target, dim=-1))
        else:
            recons_loss = mse_loss(recons, target)
        loss = recons_loss + vq_loss + self.gamma * ct_loss
        return {"loss": loss, "Reconstruction_Loss": recons_loss,
                "VQ_Loss": vq_loss, "CT_Loss": ct_loss,
                **outputs.get("metrics", {})}
