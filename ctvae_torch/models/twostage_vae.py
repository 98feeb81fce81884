"""TwoStageVAE: a stage-1 convolutional VAE and a stage-2 VAE over its
latents (Dai & Wipf 2019).

Counterpart of ``ctvae_tpu/models/twostage_vae.py``, and like it not in
the registry (import it from ``ctvae_torch.models``). The stage-2 MLPs
(``encoder2`` / ``decoder2``: Linear -> BatchNorm with flax's default
momentum 0.99 -> LeakyReLU(0.01) per width) run in every forward on the
stage-1 ``z`` detached, with ``fc_mu2`` / ``fc_var2`` heads and the
``fc_out2`` projection back to the latent. ``train_stage`` 1 trains the
stage-1 VanillaVAE loss, 2 the stage-2 VAE's over the detached latents.
``sample`` decodes u ~ N(0, I) through ``decode2`` then the stage-1
decoder (``two_stage=True``), or u directly.
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

DEFAULT_HIDDEN_DIMS2 = (1024, 1024)


class MLPStack(nn.Module):
    """Linear -> BatchNorm (momentum 0.99) -> LeakyReLU(0.01) per width."""

    def __init__(self, in_features: int, widths: Sequence[int], *,
                 device=None):
        super().__init__()
        fin = in_features
        for i, w in enumerate(widths):
            setattr(self, f"Dense_{i}", Linear(fin, w, device=device))
            setattr(self, f"BatchNorm_{i}",
                    BatchNorm(w, momentum=0.99, device=device))
            fin = w
        self._n = len(widths)

    def forward(self, x: torch.Tensor, *, train: bool = False
                ) -> torch.Tensor:
        for i in range(self._n):
            x = getattr(self, f"BatchNorm_{i}")(
                getattr(self, f"Dense_{i}")(x), train=train)
            x = F.leaky_relu(x, 0.01)
        return x


class TwoStageVAE(StandardGaussianVAE):

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", hidden_dims2: Optional[Sequence[int]] = None,
                 train_stage: int = 1, *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        hd2 = tuple(hidden_dims2) if hidden_dims2 else DEFAULT_HIDDEN_DIMS2
        self.train_stage = train_stage
        self.encoder2 = MLPStack(latent_dim, hd2, device=device)
        self.fc_mu2 = Linear(hd2[-1], latent_dim, device=device)
        self.fc_var2 = Linear(hd2[-1], latent_dim, device=device)
        self.decoder2 = MLPStack(latent_dim, hd2[::-1], device=device)
        self.fc_out2 = Linear(hd2[0], latent_dim, device=device)
        set_compute_dtype(self, self.compute_dtype)

    def encode2(self, z: torch.Tensor, *, train: bool = False):
        feat = self.encoder2(z, train=train)
        return [upcast32(self.fc_mu2(feat)), upcast32(self.fc_var2(feat))]

    def decode2(self, u: torch.Tensor, *, train: bool = False
                ) -> torch.Tensor:
        return upcast32(self.fc_out2(self.decoder2(u, train=train)))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        out = super().forward(x, train=train, draws=draws, **kwargs)
        # stage 2 takes the stage-1 latents as data
        z1 = out["z"].detach()
        mu2, log_var2 = self.encode2(z1, train=train)
        u = reparameterize(mu2, log_var2, draws) if train else mu2
        out.update({"z1": z1, "mu2": mu2, "log_var2": log_var2,
                    "z_hat": self.decode2(u, train=train)})
        return out

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        if self.train_stage == 2:
            recons_loss = mse_loss(outputs["z_hat"], outputs["z1"])
            kld = gaussian_kl(outputs["mu2"], outputs["log_var2"])
        else:
            recons_loss = mse_loss(outputs["recons"], outputs["input"])
            kld = gaussian_kl(outputs["mu"], outputs["log_var"])
        return {"loss": recons_loss + M_N * kld,
                "Reconstruction_Loss": recons_loss, "KLD": -kld}

    def sample(self, num_samples: int, *, draws: Optional[Draws] = None,
               two_stage: bool = True) -> torch.Tensor:
        draws = draws if draws is not None else Draws(None, self.device)
        u = draws.normal((num_samples, self.latent_dim)).to(self.device)
        z = self.decode2(u) if two_stage else u
        return self.decode(z)
