"""DIPVAE: the DIP-VAE-II covariance penalty on ``mu``.

Counterpart of ``ctvae_tpu/models/dip_vae.py``: sum-reduced
reconstruction and KL, and the penalties on the off-diagonal and the
diagonal of ``cov_z``. ``variance_term="paper"`` takes ``cov_z = cov_mu +
diag(E_b[exp(log_var)])``; ``"reference"`` adds the reference's scalar
``mean(diag(exp(2 log_var)))`` to every entry of ``cov_mu``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..ops.common import upcast32
from .gaussian_base import StandardGaussianVAE


class DIPVAE(StandardGaussianVAE):

    cross_batch_loss = (
        "the DIP term squares the covariance of mu over the batch, and the "
        "losses are sums over it")

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", lambda_diag: float = 10.0,
                 lambda_offdiag: float = 5.0, variance_term: str = "paper",
                 *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        if variance_term not in ("paper", "reference"):
            raise ValueError(f"unknown variance_term {variance_term!r}")
        self.lambda_diag, self.lambda_offdiag = lambda_diag, lambda_offdiag
        self.variance_term = variance_term

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        recons, x = outputs["recons"], outputs["input"]
        mu, log_var = upcast32(outputs["mu"]), upcast32(outputs["log_var"])
        recons_loss = torch.sum(torch.square(recons - x))
        kld = torch.sum(-0.5 * torch.sum(
            1 + log_var - torch.square(mu) - torch.exp(log_var), dim=1))

        centered = mu - torch.mean(mu, dim=1, keepdim=True)
        cov_mu = centered.T @ centered                          # [D, D]
        if self.variance_term == "reference":
            n = min(log_var.shape)
            idx = torch.arange(n, device=log_var.device)
            cov_z = cov_mu + torch.mean(torch.exp(2.0 * log_var)[idx, idx])
        else:
            cov_z = cov_mu + torch.diag(torch.mean(torch.exp(log_var), dim=0))
        cov_diag = torch.diagonal(cov_z)
        cov_offdiag = cov_z - torch.diag(cov_diag)
        dip_loss = (self.lambda_offdiag * torch.sum(torch.square(cov_offdiag))
                    + self.lambda_diag * torch.sum(
                        torch.square(cov_diag - 1.0)))
        loss = recons_loss + M_N * kld + dip_loss
        return {"loss": loss, "Reconstruction_Loss": recons_loss,
                "KLD": -kld, "DIP_Loss": dip_loss}
