"""MSSIMVAE: the reconstruction loss is ``1 - MS-SSIM`` over 5 scales.

Counterpart of ``ctvae_tpu/models/mssim_vae.py``; the loss is
``ops/ssim.py::mssim_loss`` with the model's ``window_size``,
``window_mode`` and ``normalize`` (``size_average`` is a field that the
loss does not read, as in JAX).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..ops.ssim import mssim_loss
from .base import gaussian_kl
from .gaussian_base import StandardGaussianVAE


class MSSIMVAE(StandardGaussianVAE):

    cross_batch_loss = (
        "MS-SSIM multiplies powers of batch means")

    def __init__(self, in_channels: int = 3, latent_dim: int = 128,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, deterministic: bool = False,
                 dtype="float32", window_size: int = 11,
                 size_average: bool = True, window_mode: str = "gaussian",
                 normalize: bool = True, *, device=None):
        super().__init__(in_channels, latent_dim, hidden_dims, img_size,
                         deterministic, dtype, device=device)
        self.window_size, self.size_average = window_size, size_average
        self.window_mode, self.normalize = window_mode, normalize

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        recons_loss = mssim_loss(outputs["recons"], outputs["input"],
                                 window_size=self.window_size,
                                 normalize=self.normalize,
                                 window_mode=self.window_mode)
        kld = gaussian_kl(outputs["mu"], outputs["log_var"])
        return {"loss": recons_loss + M_N * kld,
                "Reconstruction_Loss": recons_loss, "KLD": -kld}
