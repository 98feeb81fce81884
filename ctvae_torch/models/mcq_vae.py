"""MCQVAE: the multi-codebook vector-quantized VAE (stage 1 of the
two-stage CT recipe).

Counterpart of ``ctvae_tpu/models/mcq_vae.py``. Its parameter names are
those of the CTMCQVAE backbone (``encoder``, ``vq_layer``, ``decoder``),
so a weights-only restore of its checkpoint lands in a CTMCQVAE.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .backbones import VQDecoder, VQEncoder
from .base import Draws, mse_loss
from .quantizers import MultipleCodebookVectorQuantizer, codebook_perplexity


class MCQVAE(nn.Module):

    def __init__(self, in_channels: int = 3, embedding_dim: int = 64,
                 num_embeddings: int = 512,
                 hidden_dims: Optional[Sequence[int]] = None,
                 beta: float = 0.25, img_size: int = 64, codebooks: int = 1,
                 slicing: str = "chunk", grad_estimator: str = "ste",
                 ema: bool = False, dtype="float32", *, device=None):
        super().__init__()
        unsupported = {"ema": ema, "grad_estimator='rotation'":
                       grad_estimator != "ste",
                       f"dtype={dtype!r}": str(dtype) not in ("float32",
                                                              "torch.float32")}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
        hd = tuple(hidden_dims) if hidden_dims else (128, 256)
        self.in_channels, self.embedding_dim = in_channels, embedding_dim
        self.num_embeddings, self.codebooks = num_embeddings, codebooks
        self.nb_latents = img_size // (2 ** len(hd))
        self.encoder = VQEncoder(in_channels, hd, embedding_dim,
                                 device=device)
        self.vq_layer = MultipleCodebookVectorQuantizer(
            num_embeddings, embedding_dim, codebooks, beta, slicing=slicing,
            device=device)
        self.decoder = VQDecoder(embedding_dim, hd, in_channels,
                                 device=device)

    @property
    def device(self) -> torch.device:
        return self.vq_layer.quantizers_0.embedding.device

    def encode(self, x: torch.Tensor):
        return [self.encoder(x)]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor, input_y: torch.Tensor = None,
                action: torch.Tensor = None, mode: str = "base", *,
                draws: Optional[Draws] = None, train: bool = False) -> Dict:
        """Reconstruct ``x``. The transition keys (``input_y``,
        ``action``, ``mode``, ``draws``) are taken and ignored, so the
        trainer drives it on a transition stream as it drives CTMCQVAE."""
        quantized, vq_loss, inds = self.vq_layer(self.encoder(x), inds=True)
        # pooled over the C codebooks (each shares num_embeddings codes)
        return {"recons": self.decoder(quantized), "input": x,
                "vq_loss": vq_loss,
                "perplexity": codebook_perplexity(inds, self.num_embeddings)}

    def _decode_quantized(self, z: torch.Tensor) -> torch.Tensor:
        quantized, _ = self.vq_layer(z.to(self.device))
        return self.decoder(quantized)

    def sample(self, num_samples: int, *, draws: Optional[Draws] = None
               ) -> torch.Tensor:
        """Random continuous z -> quantize -> decode (CTMCQVAE's too)."""
        draws = draws if draws is not None else Draws(None, self.device)
        hw = self.nb_latents
        return self._decode_quantized(draws.normal(
            (num_samples, hw, hw, self.embedding_dim)))

    def loss_function(self, outputs: Dict, **kwargs) -> Dict:
        recons_loss = mse_loss(outputs["recons"], outputs["input"])
        vq_loss = outputs["vq_loss"]
        out = {"loss": recons_loss + vq_loss,
               "Reconstruction_Loss": recons_loss, "VQ_Loss": vq_loss}
        if "perplexity" in outputs:
            out["Codebook_Perplexity"] = outputs["perplexity"]
        return out
