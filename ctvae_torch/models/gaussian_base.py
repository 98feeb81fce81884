"""The standard Gaussian VAE that most of the zoo shares.

Counterpart of ``ctvae_tpu/models/gaussian_base.py``: the stride-2
Conv/BatchNorm/LeakyReLU encoder, the ``fc_mu`` / ``fc_var`` heads, the
decoder input and the mirrored decoder (``backbones.py``); subclasses
define ``loss_function`` (and their fields). ``deterministic`` swaps the
heads for the single ``fc_z`` of WAE / SWAE, with no reparameterisation.

The forward takes the batch keys the loop passes every model (``mode``,
``input_y``, ``action``) and ignores them. ``train`` selects BatchNorm's
batch statistics (and updates its running buffers) and the
reparameterised ``z``; otherwise the running statistics and ``z = mu``.
``encode`` and ``sample`` run on the running statistics.
``dtype: bfloat16`` (VanillaVAE only, ``BF16``) computes every layer in
bfloat16 with float32 parameters and BatchNorm statistics, as flax's
``dtype``; the heads' ``mu`` / ``log_var`` and the decoder's image come
back in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.layers import set_compute_dtype
from .backbones import (DEFAULT_HIDDEN_DIMS, ConvDecoder, ConvEncoder,
                        DecoderInput, GaussianHead)
from .base import BaseVAE, Draws, check_dtype, reparameterize


class StandardGaussianVAE(BaseVAE):

    #: whether ``dtype: bfloat16`` is ported for the model (VanillaVAE)
    BF16 = False

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", *, device=None):
        super().__init__()
        self.compute_dtype = check_dtype(dtype, bf16=type(self).BF16)
        hd = tuple(hidden_dims) if hidden_dims else DEFAULT_HIDDEN_DIMS
        self.in_channels, self.latent_dim = in_channels, latent_dim
        self.img_size, self.deterministic = img_size, deterministic
        feat_hw = img_size // (2 ** len(hd))
        flat = hd[-1] * feat_hw * feat_hw
        self.encoder = ConvEncoder(in_channels, hd, device=device)
        if deterministic:
            self.fc_z = nn.Linear(flat, latent_dim, device=device)
        else:
            self.head = GaussianHead(flat, latent_dim, device=device)
        self.decoder_input = DecoderInput(latent_dim, hd[-1], feat_hw,
                                          device=device)
        self.decoder = ConvDecoder(hd, in_channels, device=device)
        set_compute_dtype(self, self.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.decoder.Conv_0.weight.device

    def encode(self, x: torch.Tensor, *, train: bool = False):
        """[mu, log_var], or [z] when ``deterministic``."""
        feat = self.encoder(x, train=train)
        if self.deterministic:
            return [self.fc_z(feat.reshape(feat.shape[0], -1))]
        return list(self.head(feat))

    def decode(self, z: torch.Tensor, *, train: bool = False
               ) -> torch.Tensor:
        return self.decoder(self.decoder_input(z), train=train)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        if self.deterministic:
            z = self.encode(x, train=train)[0]
            return {"recons": self.decode(z, train=train), "input": x,
                    "z": z}
        mu, log_var = self.encode(x, train=train)
        z = reparameterize(mu, log_var, draws) if train else mu
        return {"recons": self.decode(z, train=train), "input": x,
                "mu": mu, "log_var": log_var, "z": z}

    def sample(self, num_samples: int, *, draws: Optional[Draws] = None
               ) -> torch.Tensor:
        """Decode ``num_samples`` latents of the N(0, I) prior."""
        draws = draws if draws is not None else Draws(None, self.device)
        z = draws.normal((num_samples, self.latent_dim)).to(self.device)
        return self.decode(z)
