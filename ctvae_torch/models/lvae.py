"""LVAE: the ladder VAE with precision-weighted top-down merges.

Counterpart of ``ctvae_tpu/models/lvae.py``: per-rung ``EncoderBlock``s
(a k3-s2 conv, BatchNorm, LeakyReLU, and ``encoder_mu`` /
``encoder_var`` heads on the flattened map), top-down ``LadderBlock``s
(a Dense, a BatchNorm over the [B, D] vector, ``fc_mu`` / ``fc_var``),
``merge_gauss`` of each rung's posterior with the ladder's, and the KL
summed during the top-down pass. One ``normal`` per rung, top rung
first, in train and eval alike. Its own decoder: ``decoder_input``,
``dec_blocks_i_0`` (k3-s2 ConvTranspose) / ``dec_blocks_i_1``
(BatchNorm), ``final_up``, ``final_bn``, ``final_conv`` and a tanh.
``encode`` returns the rungs' (mu, log_var), bottom rung first.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.common import upcast32
from ..ops.layers import Conv2d, Linear, set_compute_dtype
from .backbones import BatchNorm, deconv_k3s2, leaky_relu, nhwc_flat
from .base import BaseVAE, Draws, check_dtype, mse_loss, reparameterize


class EncoderBlock(nn.Module):
    """[B, C, H, W] -> (the [B, out, H/2, W/2] map, mu, log_var)."""

    def __init__(self, in_channels: int, out_channels: int, latent_dim: int,
                 out_hw: int, *, device=None):
        super().__init__()
        self.Conv_0 = Conv2d(in_channels, out_channels, 3, stride=2,
                             padding=1, device=device)
        self.BatchNorm_0 = BatchNorm(out_channels, device=device)
        flat = out_channels * out_hw * out_hw
        self.encoder_mu = Linear(flat, latent_dim, device=device)
        self.encoder_var = Linear(flat, latent_dim, device=device)

    def forward(self, x: torch.Tensor, *, train: bool):
        h = leaky_relu(self.BatchNorm_0(self.Conv_0(x), train=train))
        flat = nhwc_flat(h)
        return (h, upcast32(self.encoder_mu(flat)),
                upcast32(self.encoder_var(flat)))


class LadderBlock(nn.Module):
    """z [B, in] -> the rung below's prior (mu, log_var) [B, latent]."""

    def __init__(self, in_features: int, latent_dim: int, *, device=None):
        super().__init__()
        self.Dense_0 = Linear(in_features, latent_dim, device=device)
        self.BatchNorm_0 = BatchNorm(latent_dim, device=device)
        self.fc_mu = Linear(latent_dim, latent_dim, device=device)
        self.fc_var = Linear(latent_dim, latent_dim, device=device)

    def forward(self, z: torch.Tensor, *, train: bool):
        z = self.BatchNorm_0(self.Dense_0(z), train=train)
        return upcast32(self.fc_mu(z)), upcast32(self.fc_var(z))


def merge_gauss(mu_1, mu_2, log_var_1, log_var_2):
    p_1 = 1.0 / (torch.exp(log_var_1) + 1e-7)
    p_2 = 1.0 / (torch.exp(log_var_2) + 1e-7)
    mu = (mu_1 * p_1 + mu_2 * p_2) / (p_1 + p_2)
    return mu, torch.log(1.0 / (p_1 + p_2))


def kl_divergence(mu_q, log_var_q, mu_p, log_var_p) -> torch.Tensor:
    kl = ((log_var_p - log_var_q)
          + (torch.exp(log_var_q) + torch.square(mu_q - mu_p))
          / (2 * torch.exp(log_var_p)) - 0.5)
    return torch.sum(kl, dim=-1)


class LVAE(BaseVAE):

    def __init__(self, in_channels: int = 3,
                 latent_dims: Sequence[int] = (16, 32, 64),
                 hidden_dims: Sequence[int] = (32, 64, 128),
                 img_size: int = 64, dtype="float32", *, device=None):
        super().__init__()
        self.compute_dtype = check_dtype(dtype)
        ld, hd = tuple(latent_dims), tuple(hidden_dims)
        if len(ld) != len(hd):
            raise ValueError(f"LVAE: {len(ld)} latent_dims for {len(hd)} "
                             f"hidden_dims")
        self.in_channels, self.img_size = in_channels, img_size
        self.latent_dims, self.hidden_dims = ld, hd
        self._feat_hw = img_size // (2 ** len(hd))
        fin = in_channels
        for i, (h, lat) in enumerate(zip(hd, ld)):
            setattr(self, f"encoders_{i}", EncoderBlock(
                fin, h, lat, img_size // 2 ** (i + 1), device=device))
            fin = h
        for j, i in enumerate(range(len(ld) - 1, 0, -1)):
            setattr(self, f"ladders_{j}",
                    LadderBlock(ld[i], ld[i - 1], device=device))
        self.decoder_input = Linear(ld[0], hd[-1] * self._feat_hw ** 2,
                                    device=device)
        rev = list(hd)[::-1]
        for i, h in enumerate(rev[1:]):
            setattr(self, f"dec_blocks_{i}_0",
                    deconv_k3s2(rev[i], h, device=device))
            setattr(self, f"dec_blocks_{i}_1", BatchNorm(h, device=device))
        self.final_up = deconv_k3s2(hd[0], hd[0], device=device)
        self.final_bn = BatchNorm(hd[0], device=device)
        self.final_conv = Conv2d(hd[0], in_channels, 3, padding=1,
                                 device=device)
        set_compute_dtype(self, self.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.decoder_input.weight.device

    def encode(self, x: torch.Tensor, *, train: bool = False):
        h = x.permute(0, 3, 1, 2)
        post_params = []
        for i in range(len(self.hidden_dims)):
            h, mu, log_var = getattr(self, f"encoders_{i}")(h, train=train)
            post_params.append((mu, log_var))
        return post_params

    def _run_decoder(self, z: torch.Tensor, *, train: bool
                     ) -> torch.Tensor:
        hw = self._feat_hw
        h = self.decoder_input(z).reshape(-1, hw, hw, self.hidden_dims[-1])
        h = h.permute(0, 3, 1, 2)
        for i in range(len(self.hidden_dims) - 1):
            h = getattr(self, f"dec_blocks_{i}_0")(h)
            h = leaky_relu(getattr(self, f"dec_blocks_{i}_1")(h, train=train))
        h = leaky_relu(self.final_bn(self.final_up(h), train=train))
        # the tanh in float32 (XLA drops its rounding before the upcast)
        h = torch.tanh(upcast32(self.final_conv(h)))
        return h.permute(0, 2, 3, 1).contiguous()

    def _ladders(self):
        return [getattr(self, f"ladders_{j}")
                for j in range(len(self.latent_dims) - 1)]

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        post_params = self.encode(x, train=train)
        mu, log_var = post_params[-1]
        z = reparameterize(mu, log_var, draws)
        kl_div = x.new_zeros(x.shape[0])
        below = post_params[:-1][::-1]
        for i, ladder in enumerate(self._ladders()):
            mu_e, log_var_e = below[i]
            mu_t, log_var_t = ladder(z, train=train)
            mu_m, log_var_m = merge_gauss(mu_e, mu_t, log_var_e, log_var_t)
            z = reparameterize(mu_m, log_var_m, draws)
            kl_div = kl_div + kl_divergence(mu_m, log_var_m, mu_e, log_var_e)
        return {"recons": self._run_decoder(z, train=train), "input": x,
                "kl_div": kl_div}

    def sample(self, num_samples: int, *, draws: Optional[Draws] = None
               ) -> torch.Tensor:
        draws = draws if draws is not None else Draws(None, self.device)
        z = draws.normal((num_samples, self.latent_dims[-1])).to(self.device)
        for ladder in self._ladders():
            mu, log_var = ladder(z, train=False)
            z = reparameterize(mu, log_var, draws)
        return self._run_decoder(z, train=False)

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        recons_loss = mse_loss(outputs["recons"], outputs["input"])
        kld_loss = torch.mean(outputs["kl_div"])
        return {"loss": recons_loss + M_N * kld_loss,
                "Reconstruction_Loss": recons_loss, "KLD": -kld_loss}
