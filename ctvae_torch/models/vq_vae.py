"""VQVAE: the vector-quantized VAE on the residual conv backbone.

Counterpart of ``ctvae_tpu/models/vq_vae.py``, with the quantizer options
(``grad_estimator``, ``ema``, ``ema_decay``, ``revive_threshold``:
``models/quantizers.py``). The codebook search is ``ops/vq.py::
l2_argmin`` (the CUDA kernel on the card). Its codes have no prior, so it
defines no ``sample``: the loop writes it no Samples grid and serving
offers no ``sample`` entry point. ``dtype: bfloat16`` computes the
backbone in bfloat16 with float32 parameters, as flax's ``dtype``
(MCQVAE's split); the codebook stays float32 and the search runs on the
latents upcast to it, as JAX's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..ops.layers import set_compute_dtype
from .backbones import VQDecoder, VQEncoder
from .base import BaseVAE, Draws, check_dtype, mse_loss
from .quantizers import VectorQuantizerMS, codebook_perplexity


class VQVAE(BaseVAE):

    def __init__(self, in_channels: int = 3, embedding_dim: int = 64,
                 num_embeddings: int = 512,
                 hidden_dims: Optional[Sequence[int]] = None,
                 beta: float = 0.25, img_size: int = 64,
                 grad_estimator: str = "ste", ema: bool = False,
                 ema_decay: float = 0.99, revive_threshold: float = 0.0,
                 dtype="float32", *, device=None):
        super().__init__()
        self.compute_dtype = check_dtype(dtype)
        hd = tuple(hidden_dims) if hidden_dims else (128, 256)
        self.in_channels, self.embedding_dim = in_channels, embedding_dim
        self.num_embeddings = num_embeddings
        self.encoder = VQEncoder(in_channels, hd, embedding_dim,
                                 device=device)
        self.vq_layer = VectorQuantizerMS(
            num_embeddings, embedding_dim, beta,
            grad_estimator=grad_estimator, ema=ema, ema_decay=ema_decay,
            revive_threshold=revive_threshold, device=device)
        self.decoder = VQDecoder(embedding_dim, hd, in_channels,
                                 device=device)
        set_compute_dtype(self, self.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.vq_layer.embedding.device

    def encode(self, x: torch.Tensor, *, train: bool = False):
        return [self.encoder(x)]

    def decode(self, z: torch.Tensor, *, train: bool = False
               ) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        """Reconstruct ``x``; the loop's other batch keys are ignored, and
        ``draws`` serves an EMA codebook's revival under ``train``."""
        quantized, vq_loss, inds = self.vq_layer(
            self.encoder(x), inds=True, train=train, draws=draws)
        return {"recons": self.decoder(quantized), "input": x,
                "vq_loss": vq_loss,
                "perplexity": codebook_perplexity(inds, self.num_embeddings)}

    def loss_function(self, outputs: Dict, **kwargs) -> Dict:
        recons_loss = mse_loss(outputs["recons"], outputs["input"])
        vq_loss = outputs["vq_loss"]
        out = {"loss": recons_loss + vq_loss,
               "Reconstruction_Loss": recons_loss, "VQ_Loss": vq_loss}
        if "perplexity" in outputs:
            out["Codebook_Perplexity"] = outputs["perplexity"]
        return out
