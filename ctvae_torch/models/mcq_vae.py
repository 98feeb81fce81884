"""MCQVAE: the multi-codebook vector-quantized VAE (stage 1 of the
two-stage CT recipe).

Counterpart of ``ctvae_tpu/models/mcq_vae.py``, with its quantizer
options (``grad_estimator``, ``ema``, ``ema_decay``,
``revive_threshold``: ``models/quantizers.py``). Its parameter names are
those of the CTMCQVAE backbone (``encoder``, ``vq_layer``, ``decoder``),
so a weights-only restore of its checkpoint lands in a CTMCQVAE.
``dtype: bfloat16`` computes the backbone in bfloat16 with float32
parameters, as flax's ``dtype``; the codebook stays float32 and the
search runs on the latents upcast to it, as JAX's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.layers import set_compute_dtype
from .backbones import VQDecoder, VQEncoder
from .base import Draws, check_dtype, mse_loss
from .quantizers import MultipleCodebookVectorQuantizer, codebook_perplexity


class MCQVAE(nn.Module):

    def __init__(self, in_channels: int = 3, embedding_dim: int = 64,
                 num_embeddings: int = 512,
                 hidden_dims: Optional[Sequence[int]] = None,
                 beta: float = 0.25, img_size: int = 64, codebooks: int = 1,
                 slicing: str = "chunk", grad_estimator: str = "ste",
                 ema: bool = False, ema_decay: float = 0.99,
                 revive_threshold: float = 0.0, dtype="float32", *,
                 device=None):
        super().__init__()
        self.compute_dtype = check_dtype(dtype, bf16=True)
        hd = tuple(hidden_dims) if hidden_dims else (128, 256)
        self.in_channels, self.embedding_dim = in_channels, embedding_dim
        self.num_embeddings, self.codebooks = num_embeddings, codebooks
        self.nb_latents = img_size // (2 ** len(hd))
        self.encoder = VQEncoder(in_channels, hd, embedding_dim,
                                 device=device)
        self.vq_layer = MultipleCodebookVectorQuantizer(
            num_embeddings, embedding_dim, codebooks, beta, slicing=slicing,
            grad_estimator=grad_estimator, ema=ema, ema_decay=ema_decay,
            revive_threshold=revive_threshold, device=device)
        self.decoder = VQDecoder(embedding_dim, hd, in_channels,
                                 device=device)
        set_compute_dtype(self, self.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.vq_layer.quantizers_0.embedding.device

    def encode(self, x: torch.Tensor):
        return [self.encoder(x)]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor, input_y: torch.Tensor = None,
                action: torch.Tensor = None, mode: str = "base", *,
                draws: Optional[Draws] = None, train: bool = False,
                **kwargs) -> Dict:
        """Reconstruct ``x``. The transition keys (``input_y``,
        ``action``, ``mode``) and the batch's other keys (``labels``) are
        taken and ignored, so the trainer drives
        it on a transition stream as it drives CTMCQVAE; ``draws`` serves
        an EMA codebook's revival under ``train``."""
        quantized, vq_loss, inds = self.vq_layer(self.encoder(x), inds=True,
                                                 train=train, draws=draws)
        # pooled over the C codebooks (each shares num_embeddings codes)
        return {"recons": self.decoder(quantized), "input": x,
                "vq_loss": vq_loss,
                "perplexity": codebook_perplexity(inds, self.num_embeddings)}

    def generate(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """The forward's images (the transition keys are ignored)."""
        return self(x, **kwargs)["recons"]

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
