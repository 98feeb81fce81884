"""JointVAE: a joint continuous and categorical latent with a capacity
schedule for each.

Counterpart of ``ctvae_tpu/models/joint_vae.py``: the standard backbone's
Gaussian heads beside a categorical ``fc_z``, the decoder fed with the
two side by side. The forward draws the reparameterisation's ``normal``,
then the Gumbel-softmax's ``uniform`` at the fixed ``temperature``, in
train and eval alike; ``sample`` draws a ``normal``, then a ``randint``.
Both capacities grow with ``step + 1`` (the reference's counter starts at
1 and is incremented after use). In a data-parallel step both KLs are
the global batch's means (``parallel/mesh.py::sum_batch``) before
``|C - KL|``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from ..ops.common import upcast32
from ..ops.layers import Linear, set_compute_dtype
from ..parallel.mesh import batch_world, sum_batch
from .backbones import DEFAULT_HIDDEN_DIMS, DecoderInput
from .base import Draws, gaussian_kl, reparameterize
from .cat_vae import categorical_kl, gumbel_softmax_sample, one_hot
from .gaussian_base import StandardGaussianVAE


class JointVAE(StandardGaussianVAE):

    def __init__(self, in_channels: int = 3, latent_dim: int = 10,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", categorical_dim: int = 10,
                 latent_min_capacity: float = 0.0,
                 latent_max_capacity: float = 25.0,
                 latent_gamma: float = 30.0, latent_num_iter: int = 25000,
                 categorical_min_capacity: float = 0.0,
                 categorical_max_capacity: float = 25.0,
                 categorical_gamma: float = 30.0,
                 categorical_num_iter: int = 25000,
                 temperature: float = 0.5, anneal_rate: float = 3e-5,
                 anneal_interval: int = 100, alpha: float = 30.0, *,
                 device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        hd = tuple(hidden_dims) if hidden_dims else DEFAULT_HIDDEN_DIMS
        feat_hw = img_size // (2 ** len(hd))
        # the decoder reads [z, s]: the latent beside the categories
        self.decoder_input = DecoderInput(latent_dim + categorical_dim,
                                          hd[-1], feat_hw, device=device)
        self.fc_z = Linear(hd[-1] * feat_hw * feat_hw, categorical_dim,
                           device=device)
        self.categorical_dim = categorical_dim
        self.latent_min_capacity = latent_min_capacity
        self.latent_max_capacity = latent_max_capacity
        self.latent_gamma, self.latent_num_iter = latent_gamma, \
            latent_num_iter
        self.categorical_min_capacity = categorical_min_capacity
        self.categorical_max_capacity = categorical_max_capacity
        self.categorical_gamma = categorical_gamma
        self.categorical_num_iter = categorical_num_iter
        self.temperature, self.anneal_rate = temperature, anneal_rate
        self.anneal_interval, self.alpha = anneal_interval, alpha
        set_compute_dtype(self, self.compute_dtype)

    def encode(self, x: torch.Tensor, *, train: bool = False):
        feat = self.encoder(x, train=train)
        mu, log_var = self.head(feat)
        return [mu, log_var,
                upcast32(self.fc_z(feat.reshape(feat.shape[0], -1)))]

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        mu, log_var, q = self.encode(x, train=train)
        z = reparameterize(mu, log_var, draws)
        s = gumbel_softmax_sample(draws, q, self.temperature)
        return {"recons": self.decode(torch.cat([z, s], dim=1), train=train),
                "input": x, "q": q, "mu": mu, "log_var": log_var}

    def sample(self, num_samples: int, *, draws: Optional[Draws] = None
               ) -> torch.Tensor:
        draws = draws if draws is not None else Draws(None, self.device)
        z = draws.normal((num_samples, self.latent_dim)).to(self.device)
        cats = draws.randint(0, self.categorical_dim,
                             (num_samples,)).to(self.device)
        s = one_hot(cats, self.categorical_dim)
        return self.decode(torch.cat([z, s], dim=1))

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0, step=0,
                      **kwargs) -> Dict:
        recons, x, q = outputs["recons"], outputs["input"], outputs["q"]
        num_iter = torch.as_tensor(step, device=q.device).float() + 1.0
        recons_loss = torch.mean(torch.square(recons - x))

        disc_curr = ((self.categorical_max_capacity
                      - self.categorical_min_capacity) * num_iter
                     / self.categorical_num_iter
                     + self.categorical_min_capacity)
        disc_curr = torch.clamp(disc_curr,
                                max=math.log(self.categorical_dim))
        kld_disc = sum_batch(categorical_kl(q, self.categorical_dim, 1)) \
            / batch_world()

        cont_curr = ((self.latent_max_capacity - self.latent_min_capacity)
                     * num_iter / self.latent_num_iter
                     + self.latent_min_capacity)
        cont_curr = torch.clamp(cont_curr, max=self.latent_max_capacity)
        kld_cont = sum_batch(gaussian_kl(outputs["mu"], outputs["log_var"])) \
            / batch_world()

        capacity_loss = (
            self.categorical_gamma * torch.abs(disc_curr - kld_disc)
            + self.latent_gamma * torch.abs(cont_curr - kld_cont))
        loss = self.alpha * recons_loss + M_N * capacity_loss
        return {"loss": loss, "Reconstruction_Loss": recons_loss,
                "Capacity_Loss": capacity_loss}
