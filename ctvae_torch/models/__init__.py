"""Model registry of the port: name -> ``nn.Module`` class.

Counterpart of ``ctvae_tpu/models/__init__.py``; the registry holds the
CT-MCQ-VAE, the MCQVAE of the two-stage recipe's first stage, VQVAE,
and the Gaussian members VanillaVAE (aliases ``VAE`` and
``GaussianVAE``), BetaVAE, LogCoshVAE, DIPVAE, InfoVAE, WAE_MMD,
ConditionalVAE (alias ``CVAE``; its forward takes the batch's
``labels``), IWAE, MIWAE, SWAE, BetaTCVAE, CategoricalVAE (alias
``GumbelVAE``), JointVAE, GammaVAE, VampVAE, HVAE, LVAE, MSSIMVAE,
DFCVAE and FactorVAE: every name of the JAX registry. TwoStageVAE is
importable from here and, as in JAX, not registered (construct it and
call ``init_weights``).
``build_model`` initialises the weights with flax's distributions
(``lecun_normal`` kernels, zero biases, ``U(-1/K, 1/K)`` codebooks; an
EMA codebook's buffers as flax fills ``vq_stats``; BatchNorm's scale 1,
bias 0 and running mean 0 and variance 1; the Dense kernels a model
lists in ``orthogonal_kernels`` orthogonal, as flax's ``orthogonal()``;
a frozen VGG's buffers as flax fills its ``frozen`` collection:
``he_normal`` conv kernels, zero biases, BatchNorm's scale and variance
1, bias and mean 0) so activations at random init have the JAX model's
ranges.
"""

from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch import nn

from ..ops.common import resolve_device
from .backbones import BatchNorm
from .base import BaseVAE, lecun_normal
from .beta_vae import BetaVAE
from .betatc_vae import BetaTCVAE
from .cat_vae import CategoricalVAE
from .ct_vae import CTMCQVAE, CausalTransition
from .cvae import ConditionalVAE
from .dfcvae import DFCVAE
from .dip_vae import DIPVAE
from .fvae import FactorVAE
from .gamma_vae import GammaVAE
from .gaussian_base import StandardGaussianVAE
from .hvae import HVAE
from .info_vae import InfoVAE
from .iwae import IWAE
from .joint_vae import JointVAE
from .logcosh_vae import LogCoshVAE
from .lvae import LVAE
from .mcq_vae import MCQVAE
from .miwae import MIWAE
from .mssim_vae import MSSIMVAE
from .quantizers import VectorQuantizerMS
from .swae import SWAE
from .twostage_vae import TwoStageVAE
from .vampvae import VampVAE
from .vanilla_vae import VanillaVAE
from .vgg import FrozenVGG19BN
from .vq_vae import VQVAE
from .wae_mmd import WAE_MMD

vae_models = {"CTMCQVAE": CTMCQVAE, "MCQVAE": MCQVAE, "VQVAE": VQVAE,
              "VanillaVAE": VanillaVAE, "BetaVAE": BetaVAE,
              "LogCoshVAE": LogCoshVAE, "DIPVAE": DIPVAE,
              "InfoVAE": InfoVAE, "WAE_MMD": WAE_MMD,
              "ConditionalVAE": ConditionalVAE, "IWAE": IWAE,
              "MIWAE": MIWAE, "SWAE": SWAE, "BetaTCVAE": BetaTCVAE,
              "CategoricalVAE": CategoricalVAE, "JointVAE": JointVAE,
              "GammaVAE": GammaVAE, "VampVAE": VampVAE, "HVAE": HVAE,
              "LVAE": LVAE, "MSSIMVAE": MSSIMVAE, "DFCVAE": DFCVAE,
              "FactorVAE": FactorVAE,
              # aliases of the JAX registry
              "VAE": VanillaVAE, "GaussianVAE": VanillaVAE,
              "CVAE": ConditionalVAE, "GumbelVAE": CategoricalVAE}


def model_fields(cls) -> set:
    """The config keys a model class takes: its constructor's arguments
    but ``device``, the fields of its JAX counterpart."""
    return set(inspect.signature(cls.__init__).parameters) - {"self",
                                                              "device"}


def _fan_in(p: torch.Tensor, module: nn.Module) -> int:
    """flax's fan-in of a kernel, read off the port's layout."""
    if isinstance(module, nn.Conv2d):           # [O, I, kh, kw]
        return p.shape[1] * p.shape[2] * p.shape[3]
    if isinstance(module, nn.ConvTranspose2d):  # [I, O, kh, kw]
        return p.shape[0] * p.shape[2] * p.shape[3]
    if isinstance(module, nn.Linear):           # [out, in]
        return p.shape[1]
    # raw flax-layout params [..., in, out]: fan-in = prod(shape[:-1])
    fan = 1
    for d in p.shape[:-1]:
        fan *= d
    return fan


def _uniform_codebook(q: VectorQuantizerMS, generator: torch.Generator
                      ) -> torch.Tensor:
    e = q.embedding
    return (torch.rand(e.shape, generator=generator, device=e.device)
            * 2 - 1) / q.num_embeddings


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter as flax initialises its JAX counterpart; an
    EMA codebook (``vq_stats``) as flax fills it: the codebook from U(-1/K,
    1/K), ``embed_avg`` a copy of it, ``cluster_size`` zeros; BatchNorm
    (``batch_stats``) with scale 1, bias 0, mean 0 and variance 1; the
    kernels of the Dense layers named in the model's
    ``orthogonal_kernels`` orthogonal (flax's ``orthogonal()``: orthonormal
    columns of the [in, out] kernel, so rows of the port's weight)."""
    orthogonal = {id(getattr(model, n))
                  for n in getattr(model, "orthogonal_kernels", ())}
    for module in model.modules():
        if isinstance(module, FrozenVGG19BN):
            for name, b in module.named_buffers(recurse=False):
                if name.endswith("_weight"):    # OIHW; variance 2 / fan_in
                    fan_in = b.shape[1] * b.shape[2] * b.shape[3]
                    b.copy_(lecun_normal(b.shape, fan_in / 2.0, generator,
                                         b.device))
                else:
                    b.fill_(1.0 if name.endswith(("_scale", "_var"))
                            else 0.0)
            continue
        if isinstance(module, BatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
            continue
        if isinstance(module, VectorQuantizerMS) and module.ema:
            module.embedding.copy_(_uniform_codebook(module, generator))
            module.embed_avg.copy_(module.embedding)
            module.cluster_size.zero_()
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, VectorQuantizerMS):
                p.copy_(_uniform_codebook(module, generator))
            elif name == "bias" or name in ("disc_b1", "disc_b2",
                                            "mask_bias"):
                p.zero_()
            elif id(module) in orthogonal:
                nn.init.orthogonal_(p, generator=generator)
            else:
                p.copy_(lecun_normal(p.shape, _fan_in(p, module),
                                     generator, p.device))


def build_model(model_params: dict, device=None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Instantiate a model from a ``model_params`` config section on
    ``device`` (default ``cuda``; raises when no card is present). Keys
    that are no field of the JAX model are dropped, as in the JAX
    registry; each class takes every field of its JAX counterpart (or
    raises ``NotImplementedError`` naming a value it does not port yet).
    Weights are drawn from ``generator`` (a fresh seed-0 generator by
    default)."""
    device = resolve_device(device)
    params = dict(model_params)
    cls = vae_models[params.pop("name")]
    params = {k: v for k, v in params.items() if k in model_fields(cls)}
    model = cls(**params, device=device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    init_weights(model, generator)
    return model.eval()


__all__ = ["BaseVAE", "BetaTCVAE", "BetaVAE", "CTMCQVAE",
           "CategoricalVAE", "CausalTransition", "ConditionalVAE", "DFCVAE",
           "DIPVAE", "FactorVAE", "FrozenVGG19BN", "GammaVAE", "HVAE",
           "IWAE", "InfoVAE", "JointVAE", "LVAE", "LogCoshVAE", "MCQVAE",
           "MIWAE", "MSSIMVAE", "SWAE", "StandardGaussianVAE",
           "TwoStageVAE", "VQVAE", "VampVAE", "VanillaVAE", "WAE_MMD",
           "build_model", "init_weights", "model_fields", "vae_models"]
