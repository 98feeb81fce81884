"""GammaVAE: a Gamma-distributed latent through the shape-augmented
reparameterisation.

Counterpart of ``ctvae_tpu/models/gamma_vae.py``: the standard encoder,
softmax heads for the Gamma's shape ``alpha`` and rate ``beta`` whose
kernels start orthogonal (``orthogonal_kernels``, drawn so by
``init_weights``), and the standard decoder ending in a sigmoid. The
forward draws ``z_hat ~ Gamma(alpha + gamma_shape)`` without gradient and
carries the gradient through ``h`` and its inverse, in train and eval
alike; the loss is the per-example MSE plus the Gamma-Gamma KL to the
prior. ``sample`` draws ``Gamma(prior_shape)`` / ``prior_rate``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..ops.common import upcast32
from ..ops.layers import Linear, set_compute_dtype
from .backbones import (DEFAULT_HIDDEN_DIMS, ConvDecoder, ConvEncoder,
                        DecoderInput)
from .base import BaseVAE, Draws, check_dtype


def h_func(alpha: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    return (alpha - 1.0 / 3.0) * (1 + eps / torch.sqrt(9.0 * alpha - 3.0)
                                  ) ** 3


def inv_h_func(alpha: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(9.0 * alpha - 3.0) * (
        (z / (alpha - 1.0 / 3.0)) ** (1.0 / 3.0) - 1.0)


def _I_function(a, b, c, d):
    return (-c * d / a - b * torch.log(a) - torch.lgamma(b)
            + (b - 1) * (torch.digamma(d) + torch.log(c)))


def gamma_kl(a, b, c, d) -> torch.Tensor:
    """The reference's KL of Gamma(``a``, ``b``) to Gamma(``c``, ``d``)
    through its I-function, summed over the latent."""
    a, c = 1.0 / a, 1.0 / c
    losses = _I_function(c, d, c, d) - _I_function(a, b, c, d)
    return torch.sum(losses, dim=1)


class GammaVAE(BaseVAE):

    #: the Dense kernels flax initialises orthogonally
    orthogonal_kernels = ("fc_mu", "fc_var")

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 gamma_shape: float = 8.0, prior_shape: float = 2.0,
                 prior_rate: float = 1.0, img_size: int = 64,
                 dtype="float32", *, device=None):
        super().__init__()
        self.compute_dtype = check_dtype(dtype)
        hd = tuple(hidden_dims) if hidden_dims else DEFAULT_HIDDEN_DIMS
        self.in_channels, self.latent_dim = in_channels, latent_dim
        self.img_size, self.gamma_shape = img_size, gamma_shape
        self.prior_shape, self.prior_rate = prior_shape, prior_rate
        feat_hw = img_size // (2 ** len(hd))
        flat = hd[-1] * feat_hw * feat_hw
        self.encoder = ConvEncoder(in_channels, hd, device=device)
        self.fc_mu = Linear(flat, latent_dim, device=device)
        self.fc_var = Linear(flat, latent_dim, device=device)
        self.decoder_input = DecoderInput(latent_dim, hd[-1], feat_hw,
                                          device=device)
        self.decoder = ConvDecoder(hd, in_channels, "sigmoid",
                                   device=device)
        set_compute_dtype(self, self.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.fc_mu.weight.device

    def encode(self, x: torch.Tensor, *, train: bool = False):
        feat = self.encoder(x, train=train)
        flat = feat.reshape(feat.shape[0], -1)
        return [torch.softmax(upcast32(self.fc_mu(flat)), dim=-1),
                torch.softmax(upcast32(self.fc_var(flat)), dim=-1)]

    def decode(self, z: torch.Tensor, *, train: bool = False
               ) -> torch.Tensor:
        return self.decoder(self.decoder_input(z), train=train)

    def reparameterize(self, alpha: torch.Tensor, beta: torch.Tensor,
                       draws: Draws) -> torch.Tensor:
        # z_hat ~ Gamma(alpha + gamma_shape, 1), drawn without gradient
        z_hat = draws.gamma(alpha.detach() + self.gamma_shape).to(alpha)
        eps = inv_h_func(alpha + self.gamma_shape, z_hat)
        return h_func(alpha + self.gamma_shape, eps) / beta

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        alpha, beta = self.encode(x, train=train)
        z = self.reparameterize(alpha, beta, draws)
        return {"recons": self.decode(z, train=train), "input": x,
                "alpha": alpha, "beta": beta}

    def sample(self, num_samples: int, *, draws: Optional[Draws] = None
               ) -> torch.Tensor:
        draws = draws if draws is not None else Draws(None, self.device)
        shape = torch.full((num_samples, self.latent_dim), self.prior_shape,
                           device=self.device)
        return self.decode(draws.gamma(shape).to(self.device)
                           / self.prior_rate)

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        recons, x = outputs["recons"], outputs["input"]
        alpha, beta = outputs["alpha"], outputs["beta"]
        recons_per_ex = torch.mean(torch.square(recons - x), dim=(1, 2, 3))
        prior_alpha = torch.full((1,), self.prior_shape, device=alpha.device)
        prior_beta = torch.full((1,), self.prior_rate, device=alpha.device)
        kld = gamma_kl(alpha, beta, prior_alpha, prior_beta)
        return {"loss": torch.mean(recons_per_ex + kld),
                "Reconstruction_Loss": torch.mean(recons_per_ex)}
