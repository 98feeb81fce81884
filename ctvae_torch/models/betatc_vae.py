"""BetaTCVAE: the KL split into mutual information, total correlation and
dimension-wise KL by minibatch importance weighting.

Counterpart of ``ctvae_tpu/models/betatc_vae.py``, with its own backbone:
k4-s2 convs without BatchNorm (``enc_convs_i``), an ``fc`` of 256, the
``fc_mu`` / ``fc_var`` heads, and k3-s2 transposed convs padded ((1, 2),
(1, 2)) (``dec_convs_i``, ``dec_final_up``) before ``dec_final_conv``.
The loss takes the reference's importance-weight matrix (fill ``1 / (B -
1)``, column 0 ``1 / N``, column 1 and ``[B - 2, 0]`` the stratified
weight, ``N = B / M_N``); the KL's anneal grows with the global ``step``
under ``train`` and is 1 outside it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .backbones import deconv_k3s2, leaky_relu, nhwc_flat
from .base import BaseVAE, Draws, check_dtype, reparameterize


def log_density_gaussian(x: torch.Tensor, mu: torch.Tensor,
                         log_var: torch.Tensor) -> torch.Tensor:
    norm = -0.5 * (math.log(2 * math.pi) + log_var)
    return norm - 0.5 * torch.square(x - mu) * torch.exp(-log_var)


class BetaTCVAE(BaseVAE):

    cross_batch_loss = (
        "the total-correlation terms pair every two rows of the batch")

    def __init__(self, in_channels: int = 3, latent_dim: int = 10,
                 hidden_dims: Optional[Sequence[int]] = None,
                 anneal_steps: int = 200, alpha: float = 1.0,
                 beta: float = 6.0, gamma: float = 1.0, img_size: int = 64,
                 dtype="float32", *, device=None):
        super().__init__()
        check_dtype(dtype)
        hd = tuple(hidden_dims) if hidden_dims else (32, 32, 32, 32)
        self.in_channels, self.latent_dim, self.img_size = (
            in_channels, latent_dim, img_size)
        self.anneal_steps = anneal_steps
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self._hd, self._feat_hw = hd, img_size // (2 ** len(hd))
        fin = in_channels
        for i, h in enumerate(hd):
            setattr(self, f"enc_convs_{i}", nn.Conv2d(
                fin, h, 4, stride=2, padding=1, device=device))
            fin = h
        flat = hd[-1] * self._feat_hw ** 2
        self.fc = nn.Linear(flat, 256, device=device)
        self.fc_mu = nn.Linear(256, latent_dim, device=device)
        self.fc_var = nn.Linear(256, latent_dim, device=device)
        self.decoder_input = nn.Linear(latent_dim, flat, device=device)
        rev = list(hd)[::-1]
        for i, h in enumerate(rev[1:]):
            setattr(self, f"dec_convs_{i}",
                    deconv_k3s2(rev[i], h, device=device))
        self.dec_final_up = deconv_k3s2(hd[0], hd[0], device=device)
        self.dec_final_conv = nn.Conv2d(hd[0], in_channels, 3, padding=1,
                                        device=device)

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    def encode(self, x: torch.Tensor, *, train: bool = False):
        h = x.permute(0, 3, 1, 2)
        for i in range(len(self._hd)):
            h = leaky_relu(getattr(self, f"enc_convs_{i}")(h))
        h = self.fc(nhwc_flat(h))
        return [self.fc_mu(h), self.fc_var(h)]

    def decode(self, z: torch.Tensor, *, train: bool = False
               ) -> torch.Tensor:
        hw = self._feat_hw
        h = self.decoder_input(z).reshape(z.shape[0], hw, hw, self._hd[-1])
        h = h.permute(0, 3, 1, 2)
        for i in range(len(self._hd) - 1):
            h = leaky_relu(getattr(self, f"dec_convs_{i}")(h))
        h = leaky_relu(self.dec_final_up(h))
        h = torch.tanh(self.dec_final_conv(h))
        return h.permute(0, 2, 3, 1).contiguous()

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        mu, log_var = self.encode(x)
        z = reparameterize(mu, log_var, draws) if train else mu
        return {"recons": self.decode(z), "input": x, "mu": mu,
                "log_var": log_var, "z": z}

    def sample(self, num_samples: int, *, draws: Optional[Draws] = None
               ) -> torch.Tensor:
        draws = draws if draws is not None else Draws(None, self.device)
        z = draws.normal((num_samples, self.latent_dim)).to(self.device)
        return self.decode(z)

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0, step=0,
                      train: bool = True, **kwargs) -> Dict:
        recons, x = outputs["recons"], outputs["input"]
        mu, log_var, z = outputs["mu"], outputs["log_var"], outputs["z"]
        B = z.shape[0]

        recons_loss = torch.sum(torch.square(recons - x))
        log_q_zx = torch.sum(log_density_gaussian(z, mu, log_var), dim=1)
        zeros = torch.zeros_like(z)
        log_p_z = torch.sum(log_density_gaussian(z, zeros, zeros), dim=1)
        mat_log_q_z = log_density_gaussian(z[:, None, :], mu[None],
                                           log_var[None])        # [B, B, D]

        dataset_size = (1.0 / M_N) * B
        strat_weight = (dataset_size - B + 1) / (dataset_size * (B - 1))
        iw = torch.full((B, B), 1.0 / (B - 1), device=z.device)
        iw[:, 0] = 1.0 / dataset_size
        iw[:, 1] = strat_weight
        iw[B - 2, 0] = strat_weight
        mat_log_q_z = mat_log_q_z + torch.log(iw)[:, :, None]

        log_q_z = torch.logsumexp(torch.sum(mat_log_q_z, dim=2), dim=1)
        log_prod_q_z = torch.sum(torch.logsumexp(mat_log_q_z, dim=1), dim=1)

        mi_loss = torch.mean(log_q_zx - log_q_z)
        tc_loss = torch.mean(log_q_z - log_prod_q_z)
        kld_loss = torch.mean(log_prod_q_z - log_p_z)
        if train:
            step_f = torch.as_tensor(step, device=z.device).float() + 1.0
            anneal_rate = torch.clamp(step_f / self.anneal_steps, max=1.0)
        else:
            anneal_rate = 1.0
        loss = (recons_loss / B + self.alpha * mi_loss
                + self.beta * tc_loss + anneal_rate * self.gamma * kld_loss)
        return {"loss": loss, "Reconstruction_Loss": recons_loss,
                "KLD": kld_loss, "TC_Loss": tc_loss, "MI_Loss": mi_loss}
