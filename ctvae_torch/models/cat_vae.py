"""CategoricalVAE (alias GumbelVAE): a categorical latent [B, D, Q] with
the Gumbel-softmax reparameterisation.

Counterpart of ``ctvae_tpu/models/cat_vae.py``. The Gumbel noise is the
reference's own construction, ``-log(-log(u + 1e-7) + 1e-7)`` of one
``uniform`` draw (not ``Draws.gumbel``), in train and eval alike. The
temperature follows the global ``step`` the step passes to the forward
(a tensor on the model's device, so a captured graph reads each replay's
step): every ``anneal_interval`` steps it is ``temperature *
exp(-anneal_rate * step)`` clamped from below at ``temperature``, so
constant in practice, as in the reference. ``sample`` decodes one-hot
categories of one ``randint`` draw.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch.nn import functional as F

from ..ops.common import upcast32
from ..ops.layers import Linear, set_compute_dtype
from .backbones import (DEFAULT_HIDDEN_DIMS, ConvDecoder, ConvEncoder,
                        DecoderInput)
from .base import BaseVAE, Draws, check_dtype


def gumbel_softmax_sample(draws: Draws, logits: torch.Tensor, tau,
                          eps: float = 1e-7) -> torch.Tensor:
    """The soft Gumbel-softmax sample of ``logits`` at temperature
    ``tau`` (a float or a tensor)."""
    u = draws.uniform(logits.shape).to(logits)
    g = -torch.log(-torch.log(u + eps) + eps)
    return torch.softmax((logits + g) / tau, dim=-1)


def categorical_kl(q: torch.Tensor, categorical_dim: int,
                   dims) -> torch.Tensor:
    """The reference's KL of softmax(``q``) to the uniform prior, summed
    over ``dims`` and averaged over the batch."""
    q_p = torch.softmax(q, dim=-1)
    eps = 1e-7
    h1 = q_p * torch.log(q_p + eps)
    h2 = q_p * math.log(1.0 / categorical_dim + eps)
    return torch.mean(torch.sum(h1 - h2, dim=dims))


def one_hot(cats: torch.Tensor, n: int) -> torch.Tensor:
    return F.one_hot(cats.long(), n).float()


class CategoricalVAE(BaseVAE):

    def __init__(self, in_channels: int = 3, latent_dim: int = 40,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", categorical_dim: int = 40,
                 temperature: float = 0.5, anneal_rate: float = 3e-5,
                 anneal_interval: int = 100, alpha: float = 30.0, *,
                 device=None):
        super().__init__()
        self.compute_dtype = check_dtype(dtype)
        hd = tuple(hidden_dims) if hidden_dims else DEFAULT_HIDDEN_DIMS
        self.in_channels, self.latent_dim = in_channels, latent_dim
        self.img_size, self.deterministic = img_size, deterministic
        self.categorical_dim, self.temperature = categorical_dim, temperature
        self.anneal_rate, self.anneal_interval = anneal_rate, anneal_interval
        self.alpha = alpha
        feat_hw = img_size // (2 ** len(hd))
        width = latent_dim * categorical_dim
        self.encoder = ConvEncoder(in_channels, hd, device=device)
        self.fc_z = Linear(hd[-1] * feat_hw * feat_hw, width, device=device)
        self.decoder_input = DecoderInput(width, hd[-1], feat_hw,
                                          device=device)
        self.decoder = ConvDecoder(hd, in_channels, device=device)
        set_compute_dtype(self, self.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.fc_z.weight.device

    def _temp(self, step) -> torch.Tensor:
        step_f = torch.as_tensor(step, device=self.device).float()
        last = torch.floor(step_f / self.anneal_interval) \
            * self.anneal_interval
        return torch.clamp(self.temperature
                           * torch.exp(-self.anneal_rate * last),
                           min=self.temperature)

    def encode(self, x: torch.Tensor, *, train: bool = False):
        feat = self.encoder(x, train=train)
        z = upcast32(self.fc_z(feat.reshape(feat.shape[0], -1)))
        return [z.reshape(-1, self.latent_dim, self.categorical_dim)]

    def decode(self, z: torch.Tensor, *, train: bool = False
               ) -> torch.Tensor:
        return self.decoder(self.decoder_input(z), train=train)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, step=0, **kwargs) -> Dict:
        q = self.encode(x, train=train)[0]
        s = gumbel_softmax_sample(draws, q, self._temp(step))
        s = s.reshape(-1, self.latent_dim * self.categorical_dim)
        return {"recons": self.decode(s, train=train), "input": x, "q": q}

    def sample(self, num_samples: int, *, draws: Optional[Draws] = None
               ) -> torch.Tensor:
        draws = draws if draws is not None else Draws(None, self.device)
        cats = draws.randint(0, self.categorical_dim,
                             (num_samples, self.latent_dim)).to(self.device)
        z = one_hot(cats, self.categorical_dim).reshape(
            num_samples, self.latent_dim * self.categorical_dim)
        return self.decode(z)

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        recons, x, q = outputs["recons"], outputs["input"], outputs["q"]
        recons_loss = torch.mean(torch.square(recons - x))
        kld = categorical_kl(q, self.categorical_dim, (1, 2))
        loss = self.alpha * recons_loss + M_N * kld
        return {"loss": loss, "Reconstruction_Loss": recons_loss,
                "KLD": -kld}
