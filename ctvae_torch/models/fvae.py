"""FactorVAE: an adversarial total-correlation penalty from a latent
discriminator, trained by a second optimizer.

Counterpart of ``ctvae_tpu/models/fvae.py``. One forward computes what
both optimizer phases need: ``D_z`` (the discriminator on z, gradients
flowing into the encoder: the VAE phase, optimizer 0), ``D_z_sg`` (on
z detached) and ``D_z_perm`` (on z detached with its dims permuted
within each sample: the discriminator phase, optimizer 1, which
``exp_params.submodel: discriminator`` restricts to the discriminator).
The discriminator's BatchNorm runs three times in a train forward, so its
running statistics take three updates, in the order ``D_z``, ``D_z_sg``,
``D_z_perm``, as flax's do. The permutation is drawn in eval too.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.common import upcast32
from ..ops.layers import Linear, set_compute_dtype
from .backbones import BatchNorm
from .base import Draws, gaussian_kl, mse_loss, reparameterize
from .gaussian_base import StandardGaussianVAE


class LatentDiscriminator(nn.Module):
    """3 x [Linear(1000) -> BatchNorm (momentum 0.9, eps 1e-5) ->
    LeakyReLU(0.2)] -> Linear(2), on [B, D] latents."""

    def __init__(self, latent_dim: int, width: int = 1000, *, device=None):
        super().__init__()
        fin = latent_dim
        for i in range(3):
            setattr(self, f"Dense_{i}", Linear(fin, width, device=device))
            setattr(self, f"BatchNorm_{i}", BatchNorm(width, device=device))
            fin = width
        self.Dense_3 = Linear(fin, 2, device=device)

    def forward(self, z: torch.Tensor, *, train: bool) -> torch.Tensor:
        x = z
        for i in range(3):
            x = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Dense_{i}")(x),
                                                train=train)
            x = F.leaky_relu(x, 0.2)
        return upcast32(self.Dense_3(x))


def permute_latent(draws: Draws, z: torch.Tensor) -> torch.Tensor:
    """Each sample's latent dims in an independent random order."""
    B, D = z.shape
    perms = draws.permutation(B, D).to(z.device)
    return torch.gather(z, 1, perms)


class FactorVAE(StandardGaussianVAE):

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", gamma: float = 40.0, *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        self.gamma = gamma
        self.discriminator = LatentDiscriminator(latent_dim, device=device)
        set_compute_dtype(self, self.compute_dtype)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        mu, log_var = self.encode(x, train=train)
        z = reparameterize(mu, log_var, draws) if train else mu
        recons = self.decode(z, train=train)
        D_z = self.discriminator(z, train=train)
        z_sg = z.detach()
        D_z_sg = self.discriminator(z_sg, train=train)
        D_z_perm = self.discriminator(permute_latent(draws, z_sg),
                                      train=train)
        return {"recons": recons, "input": x, "mu": mu, "log_var": log_var,
                "z": z, "D_z": D_z, "D_z_sg": D_z_sg, "D_z_perm": D_z_perm}

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      optimizer_idx: int = 0, **kwargs) -> Dict:
        if optimizer_idx == 0:
            recons_loss = mse_loss(outputs["recons"], outputs["input"])
            kld = gaussian_kl(outputs["mu"], outputs["log_var"])
            D_z = outputs["D_z"]
            vae_tc_loss = torch.mean(D_z[:, 0] - D_z[:, 1])
            loss = recons_loss + M_N * kld + self.gamma * vae_tc_loss
            return {"loss": loss, "Reconstruction_Loss": recons_loss,
                    "KLD": -kld, "VAE_TC_Loss": vae_tc_loss}
        # the discriminator phase: D(z) -> class 0 (the true latents),
        # D(permuted z) -> class 1 (factorised)
        logp_z = torch.log_softmax(outputs["D_z_sg"], dim=-1)
        logp_perm = torch.log_softmax(outputs["D_z_perm"], dim=-1)
        D_tc_loss = 0.5 * (-torch.mean(logp_z[:, 0])
                           - torch.mean(logp_perm[:, 1]))
        return {"loss": D_tc_loss, "D_TC_Loss": D_tc_loss}
