"""Vector quantizers (single + multi-codebook).

Counterpart of ``ctvae_tpu/models/quantizers.py``: the two-phase API
(``compute_inds`` / ``compute_latents``) the causal transition splices
between, and the one-call quantizer (``__call__``) of the MCQVAE and of
``sample`` / ``walk`` / ``navigate``. NHWC latents; the codebook search
runs through ``ops/vq.py::l2_argmin`` (the CUDA kernel on CUDA tensors); quantized
vectors come from a direct gather. ``slicing="chunk"`` gives disjoint
per-codebook channel chunks, ``"overlap"`` the reference's stride-1
slices.

``grad_estimator="rotation"`` passes the gradient through ``rotate_to``
(the rotation trick) instead of the straight-through identity.
``ema=True`` learns the codebook by exponential moving averages: the
codebook (``embedding``), the per-code counts (``cluster_size``) and the
assigned-vector sums (``embed_avg``) are float32 buffers, not parameters
(the JAX package's ``vq_stats`` collection), updated in place under
``no_grad`` by a train pass with no host read of a device value, so a
captured CUDA graph replays the update. ``revive_threshold > 0``
re-seeds the codes whose count fell below it from random rows of the
batch: one ``randint`` draw per codebook, where JAX draws from its
``noise`` stream.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.vq import l2_argmin
from .base import Draws, mse_loss


def codebook_perplexity(inds: torch.Tensor, num_embeddings: int
                        ) -> torch.Tensor:
    """exp(entropy) of the batch's code-assignment distribution. The
    counts come from a scatter-add, not ``bincount``, whose CUDA version
    reads the largest index back to the host (a CUDA graph cannot hold
    that)."""
    flat = inds.reshape(-1)
    counts = torch.zeros(num_embeddings, dtype=torch.int64,
                         device=flat.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    probs = counts.float() / torch.clamp(torch.sum(counts), min=1)
    plogp = torch.where(probs > 0, probs * torch.log(probs),
                        torch.zeros_like(probs))
    return torch.exp(-torch.sum(plogp))


def rotate_to(e: torch.Tensor, q: torch.Tensor, eps: float = 1e-6
              ) -> torch.Tensor:
    """The rotation trick: ``q`` in value, while the gradient w.r.t.
    ``e`` is the upstream gradient through ``lambda R``, the rotation and
    rescale that carries ``e`` onto ``q``, instead of the identity.
    ``R e = e - 2 r (r.e) + 2 qhat (ehat.e)`` with ``r = (ehat + qhat) /
    |ehat + qhat|`` (two reflections, no matrix); ``lambda``, ``r``,
    ``qhat`` and ``ehat`` are constants of the gradient. Norms are taken
    in float32."""
    dt = e.dtype
    e32, q32 = e.float(), q.float()
    en = torch.linalg.vector_norm(e32, dim=-1, keepdim=True)
    qn = torch.linalg.vector_norm(q32, dim=-1, keepdim=True)
    ehat = e32 / torch.clamp(en, min=eps)
    qhat = q32 / torch.clamp(qn, min=eps)
    r = ehat + qhat
    # antiparallel e and q (r ~ 0): eps floors the norm, and the qhat
    # term alone lands on q there
    r = r / torch.clamp(torch.linalg.vector_norm(r, dim=-1, keepdim=True),
                        min=eps)
    lam = (qn / torch.clamp(en, min=eps)).to(dt).detach()
    ehat, qhat, r = (x.to(dt).detach() for x in (ehat, qhat, r))
    rot = (e - 2.0 * r * torch.sum(r * e, dim=-1, keepdim=True)
           + 2.0 * qhat * torch.sum(ehat * e, dim=-1, keepdim=True))
    return lam * rot


def _draws(draws: Optional[Draws], like: torch.Tensor) -> Draws:
    return draws if draws is not None else Draws(None, like.device)


class VectorQuantizerMS(nn.Module):
    """One codebook; index search separated from latent retrieval. The
    code vectors ``embedding`` [K, D] are a parameter or, with ``ema``, a
    buffer that train passes update with its statistics
    (``update_stats``, ``compute_latents(train=True)``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 beta: float = 0.25, grad_estimator: str = "ste",
                 ema: bool = False, ema_decay: float = 0.99,
                 ema_eps: float = 1e-5, revive_threshold: float = 0.0, *,
                 device=None):
        super().__init__()
        if grad_estimator not in ("ste", "rotation"):
            raise ValueError(f"unknown grad_estimator {grad_estimator!r}")
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.beta = beta
        self.grad_estimator = grad_estimator
        self.ema, self.ema_decay, self.ema_eps = ema, ema_decay, ema_eps
        self.revive_threshold = revive_threshold
        shape = (num_embeddings, embedding_dim)
        if ema:
            for name, size in (("embedding", shape),
                               ("cluster_size", (num_embeddings,)),
                               ("embed_avg", shape)):
                self.register_buffer(name, torch.zeros(size, device=device))
        else:
            self.embedding = nn.Parameter(torch.zeros(shape, device=device))

    def compute_inds(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, H, W, D] -> int64 [B, H, W] (no gradient)."""
        flat = latents.detach().reshape(-1, self.embedding_dim).contiguous()
        inds = l2_argmin(flat, self.embedding.detach())
        return inds.reshape(latents.shape[:-1])

    @torch.no_grad()
    def _ema_update(self, flat: torch.Tensor, inds_flat: torch.Tensor,
                    draws: Draws) -> None:
        """Fold one batch's assignments into the EMA buffers, in place and
        in float32, in the JAX package's order of operations: the decayed
        counts and sums, Laplace smoothing, then the revival."""
        K = self.num_embeddings
        flat = flat.detach().float()
        one_hot = F.one_hot(inds_flat, K).float()                 # [N, K]
        counts = torch.sum(one_hot, dim=0)                        # [K]
        dw = one_hot.T @ flat                                     # [K, D]
        d = self.ema_decay
        cluster = d * self.cluster_size + (1.0 - d) * counts
        avg = d * self.embed_avg + (1.0 - d) * dw
        n = torch.sum(cluster)
        smoothed = (cluster + self.ema_eps) / (n + K * self.ema_eps) * n
        embed = avg / smoothed[:, None]
        if self.revive_threshold > 0.0:
            dead = cluster < self.revive_threshold                # [K]
            pick = draws.randint(0, flat.shape[0], (K,))
            repl = flat.index_select(0, pick.to(flat.device).long())
            embed = torch.where(dead[:, None], repl, embed)
            avg = torch.where(dead[:, None], repl, avg)
            cluster = torch.where(dead, torch.ones_like(cluster), cluster)
        self.embedding.copy_(embed)
        self.embed_avg.copy_(avg)
        self.cluster_size.copy_(cluster)

    def update_stats(self, latents: torch.Tensor, inds: torch.Tensor,
                     draws: Draws) -> None:
        """The EMA fold-in for callers that decode through other indices
        (CTMCQVAE decodes the CT layer's): the statistics track the
        encoder's own nearest codes ``inds``."""
        if not self.ema:
            raise ValueError("update_stats is an EMA-mode API")
        self._ema_update(latents.reshape(-1, self.embedding_dim),
                         inds.reshape(-1), draws)

    def compute_latents(self, latents: torch.Tensor, inds: torch.Tensor, *,
                        train: bool = False, draws: Optional[Draws] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather + VQ loss + the gradient estimator. In EMA mode the loss
        is the commitment term alone, and a ``train`` pass folds the batch
        into the buffers after the gather."""
        quantized = self.embedding[inds.reshape(-1)].reshape(latents.shape)
        commitment = mse_loss(quantized.detach(), latents)
        if self.ema:
            vq_loss = commitment * self.beta
            if train:
                self._ema_update(latents.reshape(-1, self.embedding_dim),
                                 inds.reshape(-1), _draws(draws, latents))
        else:
            embedding_loss = mse_loss(quantized, latents.detach())
            vq_loss = commitment * self.beta + embedding_loss
        if self.grad_estimator == "rotation":
            return rotate_to(latents, quantized.detach()), vq_loss
        return latents + (quantized - latents).detach(), vq_loss

    def forward(self, latents: torch.Tensor, inds: bool = False, *,
                train: bool = False, draws: Optional[Draws] = None):
        """Search + retrieval: (quantized, vq_loss), and the indices when
        ``inds``."""
        encoding_inds = self.compute_inds(latents)
        quantized, vq_loss = self.compute_latents(
            latents, encoding_inds, train=train, draws=draws)
        if inds:
            return quantized, vq_loss, encoding_inds
        return quantized, vq_loss


class MultipleCodebookVectorQuantizer(nn.Module):
    """C codebooks, each owning ``embedding_dim / C`` channels."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 codebooks: int = 1, beta: float = 0.25,
                 slicing: str = "chunk", grad_estimator: str = "ste",
                 ema: bool = False, ema_decay: float = 0.99,
                 ema_eps: float = 1e-5, revive_threshold: float = 0.0, *,
                 device=None):
        super().__init__()
        if embedding_dim % codebooks:
            raise ValueError("embedding_dim must divide by codebooks")
        if slicing not in ("chunk", "overlap"):
            raise ValueError(f"unknown slicing {slicing!r}")
        self.slicing = slicing
        self.reduced_embedding_dim = rd = embedding_dim // codebooks
        self.codebooks = codebooks
        for i in range(codebooks):
            # names follow the JAX param tree (quantizers_0, _1, ...)
            setattr(self, f"quantizers_{i}", VectorQuantizerMS(
                num_embeddings, rd, beta, grad_estimator=grad_estimator,
                ema=ema, ema_decay=ema_decay, ema_eps=ema_eps,
                revive_threshold=revive_threshold, device=device))

    @property
    def quantizers(self):
        return [getattr(self, f"quantizers_{i}")
                for i in range(self.codebooks)]

    def _sub(self, latents: torch.Tensor, i: int) -> torch.Tensor:
        rd = self.reduced_embedding_dim
        if self.slicing == "overlap":
            return latents[..., i:i + rd]
        return latents[..., i * rd:(i + 1) * rd]

    def compute_inds(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, H, W, D] -> int64 [B, C, H, W]."""
        return torch.stack([q.compute_inds(self._sub(latents, i))
                            for i, q in enumerate(self.quantizers)], dim=1)

    def update_stats(self, latents: torch.Tensor, inds: torch.Tensor,
                     draws: Draws) -> None:
        """The EMA fold-in of ``inds`` [B, C, H, W], codebook by codebook
        (``VectorQuantizerMS.update_stats``)."""
        for i, q in enumerate(self.quantizers):
            q.update_stats(self._sub(latents, i), inds[:, i], draws)

    def compute_latents(self, latents: torch.Tensor, inds: torch.Tensor, *,
                        train: bool = False, draws: Optional[Draws] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        outs, losses = [], []
        for i, q in enumerate(self.quantizers):
            sub_q, sub_loss = q.compute_latents(
                self._sub(latents, i), inds[:, i], train=train, draws=draws)
            outs.append(sub_q)
            losses.append(sub_loss)
        return torch.cat(outs, dim=-1), sum(losses)

    # search + retrieval over the C codebooks; indices [B, C, H, W]
    forward = VectorQuantizerMS.forward
