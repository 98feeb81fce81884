"""DFCVAE: the deep-feature-consistent VAE, an MSE in frozen VGG19-bn
feature space at layers {'14', '24', '34', '43'} beside the pixel MSE.

Counterpart of ``ctvae_tpu/models/dfcvae.py``. ``feature_network`` holds
its weights as buffers (``models/vgg.py``), so they are in the
``state_dict`` (checkpoints carry them) and in no optimizer.
``VAEXperiment.setup`` loads pretrained weights into it, and without them
refuses to train unless ``allow_random_features`` is set.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from .base import Draws, gaussian_kl, mse_loss
from .gaussian_base import StandardGaussianVAE
from .vgg import FrozenVGG19BN


class DFCVAE(StandardGaussianVAE):

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", alpha: float = 1.0, beta: float = 0.5,
                 allow_random_features: bool = False, *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        self.alpha, self.beta = alpha, beta
        self.allow_random_features = allow_random_features
        self.feature_network = FrozenVGG19BN(in_channels, device=device)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        out = super().forward(x, train=train, draws=draws, **kwargs)
        out["recons_features"] = self.feature_network(out["recons"])
        out["input_features"] = self.feature_network(x)
        return out

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        recons_loss = mse_loss(outputs["recons"], outputs["input"])
        feature_loss = 0.0
        for r, i in zip(outputs["recons_features"],
                        outputs["input_features"]):
            feature_loss = feature_loss + mse_loss(r, i)
        kld = gaussian_kl(outputs["mu"], outputs["log_var"])
        loss = (self.beta * (recons_loss + feature_loss)
                + self.alpha * M_N * kld)
        return {"loss": loss, "Reconstruction_Loss": recons_loss,
                "KLD": -kld}
