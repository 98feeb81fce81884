"""ConditionalVAE: a VAE conditioned on a label vector (CelebA's 40
attributes), embedded as an extra image channel on encode and
concatenated to z on decode.

Counterpart of ``ctvae_tpu/models/cvae.py``: ``embed_class`` (a dense
layer from the labels to one img x img channel), ``embed_data`` (a 1x1
conv of the image), the standard encoder over in_channels + 1 channels,
the Gaussian heads, ``decoder_input`` over latent + num_classes and the
standard decoder. ``encode`` takes the already-embedded input;
``encode_labeled`` the raw image and its labels.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..ops.common import upcast32
from ..ops.layers import Conv2d, Linear, set_compute_dtype
from .backbones import (DEFAULT_HIDDEN_DIMS, ConvDecoder, ConvEncoder,
                        GaussianHead)
from .base import (BaseVAE, Draws, check_dtype, gaussian_kl, mse_loss,
                   reparameterize)


def _labels(labels: Optional[torch.Tensor]) -> torch.Tensor:
    if labels is None:
        raise ValueError("ConditionalVAE needs the batch's labels")
    return upcast32(labels)


class ConditionalVAE(BaseVAE):
    #: the serving entry points and the loop's Samples grid pass labels
    needs_labels = True

    def __init__(self, in_channels: int = 3, num_classes: int = 40,
                 latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, dtype="float32", *, device=None):
        super().__init__()
        self.compute_dtype = check_dtype(dtype)
        hd = tuple(hidden_dims) if hidden_dims else DEFAULT_HIDDEN_DIMS
        self.in_channels, self.num_classes = in_channels, num_classes
        self.latent_dim, self.img_size, self._hd = latent_dim, img_size, hd
        self._feat_hw = img_size // (2 ** len(hd))
        flat = hd[-1] * self._feat_hw ** 2
        self.embed_class = Linear(num_classes, img_size * img_size,
                                  device=device)
        self.embed_data = Conv2d(in_channels, in_channels, 1, device=device)
        self.encoder = ConvEncoder(in_channels + 1, hd, device=device)
        self.head = GaussianHead(flat, latent_dim, device=device)
        self.decoder_input = Linear(latent_dim + num_classes, flat,
                                    device=device)
        self.decoder = ConvDecoder(hd, in_channels, device=device)
        set_compute_dtype(self, self.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.decoder.Conv_0.weight.device

    def encode(self, x: torch.Tensor, *, train: bool = False):
        """[mu, log_var] of the label-embedded input [B, H, W, C + 1]."""
        return list(self.head(self.encoder(x, train=train)))

    def encode_labeled(self, x: torch.Tensor, labels: torch.Tensor, *,
                       train: bool = False):
        """[mu, log_var] of a raw image [B, H, W, C] and its labels: the
        labels embedded as a last channel beside the 1x1 conv of x."""
        y = _labels(labels)
        emb_class = self.embed_class(y).reshape(-1, self.img_size,
                                                self.img_size, 1)
        emb_data = self.embed_data(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.encode(torch.cat([emb_data, emb_class], dim=-1),
                           train=train)

    def decode(self, z: torch.Tensor, *, train: bool = False
               ) -> torch.Tensor:
        hw = self._feat_hw
        x = self.decoder_input(z).reshape(z.shape[0], hw, hw, self._hd[-1])
        return self.decoder(x, train=train)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                *, train: bool = False, draws: Optional[Draws] = None,
                **kwargs) -> Dict:
        y = _labels(labels)
        mu, log_var = self.encode_labeled(x, y, train=train)
        z = reparameterize(mu, log_var, draws) if train else mu
        return {"recons": self.decode(torch.cat([z, y], dim=1), train=train),
                "input": x, "mu": mu, "log_var": log_var, "z": z}

    def sample(self, num_samples: int, labels: Optional[torch.Tensor] = None,
               *, draws: Optional[Draws] = None) -> torch.Tensor:
        """Decode ``num_samples`` latents of the N(0, I) prior beside the
        first ``num_samples`` rows of ``labels``."""
        y = _labels(labels)[:num_samples].to(self.device)
        draws = draws if draws is not None else Draws(None, self.device)
        z = draws.normal((num_samples, self.latent_dim)).to(self.device)
        return self.decode(torch.cat([z, y], dim=1))

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        recons_loss = mse_loss(outputs["recons"], outputs["input"])
        kld = gaussian_kl(outputs["mu"], outputs["log_var"])
        return {"loss": recons_loss + M_N * kld,
                "Reconstruction_Loss": recons_loss, "KLD": -kld}
