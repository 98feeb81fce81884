"""Vector quantizers (single + multi-codebook).

Counterpart of ``ctvae_tpu/models/quantizers.py``: the two-phase API
(``compute_inds`` / ``compute_latents``) the causal transition splices
between, and the one-call quantizer (``__call__``) of the MCQVAE and of
``sample`` / ``walk`` / ``navigate``. NHWC latents; the codebook search
runs through ``ops/vq.py::l2_argmin`` (the CUDA kernel on CUDA tensors); quantized
vectors come from a direct gather. ``slicing="chunk"`` gives disjoint
per-codebook channel chunks, ``"overlap"`` the reference's stride-1
slices.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops.vq import l2_argmin
from .base import mse_loss


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


class VectorQuantizerMS(nn.Module):
    """One codebook; index search separated from latent retrieval."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 beta: float = 0.25, *, device=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.beta = beta
        self.embedding = nn.Parameter(
            torch.zeros(num_embeddings, embedding_dim, device=device))

    def compute_inds(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, H, W, D] -> int64 [B, H, W] (no gradient)."""
        flat = latents.detach().reshape(-1, self.embedding_dim).contiguous()
        inds = l2_argmin(flat, self.embedding.detach())
        return inds.reshape(latents.shape[:-1])

    def compute_latents(self, latents: torch.Tensor, inds: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather + VQ loss + straight-through estimator."""
        quantized = self.embedding[inds.reshape(-1)].reshape(latents.shape)
        commitment = mse_loss(quantized.detach(), latents)
        embedding_loss = mse_loss(quantized, latents.detach())
        vq_loss = commitment * self.beta + embedding_loss
        return latents + (quantized - latents).detach(), vq_loss

    def forward(self, latents: torch.Tensor, inds: bool = False):
        """Search + retrieval: (quantized, vq_loss), and the indices when
        ``inds``."""
        encoding_inds = self.compute_inds(latents)
        quantized, vq_loss = self.compute_latents(latents, encoding_inds)
        if inds:
            return quantized, vq_loss, encoding_inds
        return quantized, vq_loss


class MultipleCodebookVectorQuantizer(nn.Module):
    """C codebooks, each owning ``embedding_dim / C`` channels."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 codebooks: int = 1, beta: float = 0.25,
                 slicing: str = "chunk", *, device=None):
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
            setattr(self, f"quantizers_{i}",
                    VectorQuantizerMS(num_embeddings, rd, beta,
                                      device=device))

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

    def compute_latents(self, latents: torch.Tensor, inds: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        outs, losses = [], []
        for i, q in enumerate(self.quantizers):
            sub_q, sub_loss = q.compute_latents(self._sub(latents, i),
                                                inds[:, i])
            outs.append(sub_q)
            losses.append(sub_loss)
        return torch.cat(outs, dim=-1), sum(losses)

    # search + retrieval over the C codebooks; indices [B, C, H, W]
    forward = VectorQuantizerMS.forward
