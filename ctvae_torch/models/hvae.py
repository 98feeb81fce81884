"""HVAE: the two-level hierarchical VAE, z2 -> z1 -> x.

Counterpart of ``ctvae_tpu/models/hvae.py``. ``encode`` itself draws z2
(in eval too: it takes the ``draws`` as JAX's takes the stream keys),
then encodes the image beside ``embed_z2_code(z2)``, an img x img map
concatenated as one more channel; the forward then draws z1. The two
debed vectors fill the **channels** of the decoder's first map, z1's the
first half at every position, z2's the second (the reference's NCHW
view). The prior head p(z1 | z2) (``recons_z1_mu`` / ``_log_var``) runs
in the forward, so the loss is arithmetic on its outputs.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from ..ops.common import upcast32
from ..ops.layers import Conv2d, Linear, set_compute_dtype
from .backbones import (DEFAULT_HIDDEN_DIMS, ConvDecoder, ConvEncoder,
                        GaussianHead)
from .base import BaseVAE, Draws, check_dtype, mse_loss, reparameterize


class HVAE(BaseVAE):

    #: ``encode`` draws (z2): serving and the metrics pass it ``draws``
    stochastic_encode = True

    def __init__(self, in_channels: int = 3, latent1_dim: int = 64,
                 latent2_dim: int = 32,
                 hidden_dims: Optional[Sequence[int]] = None,
                 img_size: int = 64, pseudo_input_size: int = 128,
                 dtype="float32", *, device=None):
        super().__init__()
        self.compute_dtype = check_dtype(dtype)
        hd = tuple(hidden_dims) if hidden_dims else DEFAULT_HIDDEN_DIMS
        if hd[-1] % 2:
            raise ValueError(
                f"HVAE: hidden_dims[-1] must be even (got {hd[-1]}): the "
                "decoder feature map's channels are split in half "
                "between the z1 and z2 debed vectors")
        self.in_channels, self.img_size = in_channels, img_size
        self.latent1_dim, self.latent2_dim = latent1_dim, latent2_dim
        self.pseudo_input_size = pseudo_input_size
        self._hd, self._feat_hw = hd, img_size // (2 ** len(hd))
        flat = hd[-1] * self._feat_hw ** 2
        self.encoder_z2_layers = ConvEncoder(in_channels, hd, device=device)
        self.head_z2 = GaussianHead(flat, latent2_dim, device=device)
        self.embed_z2_code = Linear(latent2_dim, img_size * img_size,
                                    device=device)
        self.embed_data = Conv2d(in_channels, in_channels, 1, device=device)
        self.encoder_z1_layers = ConvEncoder(in_channels + 1, hd,
                                             device=device)
        self.head_z1 = GaussianHead(flat, latent1_dim, device=device)
        self.recons_z1_mu = Linear(latent2_dim, latent1_dim, device=device)
        self.recons_z1_log_var = Linear(latent2_dim, latent1_dim,
                                        device=device)
        self.debed_z1_code = Linear(latent1_dim, flat // 2, device=device)
        self.debed_z2_code = Linear(latent2_dim, flat // 2, device=device)
        self.decoder = ConvDecoder(hd, in_channels, device=device)
        set_compute_dtype(self, self.compute_dtype)

    @property
    def device(self) -> torch.device:
        return self.embed_z2_code.weight.device

    def encode_z2(self, x: torch.Tensor, *, train: bool):
        return self.head_z2(self.encoder_z2_layers(x, train=train))

    def encode_z1(self, x: torch.Tensor, z2: torch.Tensor, *, train: bool):
        emb_x = self.embed_data(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        emb_z2 = self.embed_z2_code(z2).reshape(-1, self.img_size,
                                                self.img_size, 1)
        h = torch.cat([emb_x, emb_z2], dim=-1)
        return self.head_z1(self.encoder_z1_layers(h, train=train))

    def encode(self, x: torch.Tensor, *, train: bool = False,
               draws: Optional[Draws] = None):
        """[z1_mu, z1_log_var, z2_mu, z2_log_var, z2]; z2 is drawn."""
        draws = draws if draws is not None else Draws(None, self.device)
        z2_mu, z2_log_var = self.encode_z2(x, train=train)
        z2 = reparameterize(z2_mu, z2_log_var, draws)
        z1_mu, z1_log_var = self.encode_z1(x, z2, train=train)
        return [z1_mu, z1_log_var, z2_mu, z2_log_var, z2]

    def _decode_z1z2(self, z1: torch.Tensor, z2: torch.Tensor, *,
                     train: bool) -> torch.Tensor:
        hw, half_c = self._feat_hw, self._hd[-1] // 2
        d1 = self.debed_z1_code(z1).reshape(-1, hw, hw, half_c)
        d2 = self.debed_z2_code(z2).reshape(-1, hw, hw, half_c)
        return self.decoder(torch.cat([d1, d2], dim=-1), train=train)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                draws: Optional[Draws] = None, **kwargs) -> Dict:
        z1_mu, z1_log_var, z2_mu, z2_log_var, z2 = self.encode(
            x, train=train, draws=draws)
        z1 = reparameterize(z1_mu, z1_log_var, draws)
        return {"recons": self._decode_z1z2(z1, z2, train=train),
                "input": x, "z1_mu": z1_mu, "z1_log_var": z1_log_var,
                "z2_mu": z2_mu, "z2_log_var": z2_log_var, "z1": z1,
                "z2": z2, "z1_p_mu": upcast32(self.recons_z1_mu(z2)),
                "z1_p_log_var": upcast32(self.recons_z1_log_var(z2))}

    def sample(self, num_samples: int, *, draws: Optional[Draws] = None
               ) -> torch.Tensor:
        draws = draws if draws is not None else Draws(None, self.device)
        z2 = draws.normal((num_samples, self.latent2_dim)).to(self.device)
        z1 = reparameterize(upcast32(self.recons_z1_mu(z2)),
                            upcast32(self.recons_z1_log_var(z2)), draws)
        return self._decode_z1z2(z1, z2, train=False)

    def loss_function(self, outputs: Dict, *, M_N: float = 1.0,
                      **kwargs) -> Dict:
        recons_loss = mse_loss(outputs["recons"], outputs["input"])

        def neg_kl(mu, lv, target=0.0):
            return torch.mean(-0.5 * torch.sum(
                1 + lv - torch.square(mu - target) - torch.exp(lv), dim=1))

        z1_kld = neg_kl(outputs["z1_mu"], outputs["z1_log_var"])
        z2_kld = neg_kl(outputs["z2_mu"], outputs["z2_log_var"])
        z1_p_kld = neg_kl(outputs["z1"], outputs["z1_p_log_var"],
                          outputs["z1_p_mu"])
        kld_loss = -(z1_p_kld - z1_kld - z2_kld)
        return {"loss": recons_loss + M_N * kld_loss,
                "Reconstruction_Loss": recons_loss, "KLD": -kld_loss}
