"""Model registry of the port: name -> ``nn.Module`` class.

Counterpart of ``ctvae_tpu/models/__init__.py``; the registry holds the
CT-MCQ-VAE and the MCQVAE of the two-stage recipe's first stage.
``build_model`` initialises the weights with flax's distributions
(``lecun_normal`` kernels, zero biases, ``U(-1/K, 1/K)`` codebooks) so
activations at random init have the JAX model's ranges.
"""

from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch import nn

from ..ops.common import resolve_device
from .base import lecun_normal
from .ct_vae import CTMCQVAE, CausalTransition
from .mcq_vae import MCQVAE
from .quantizers import VectorQuantizerMS

vae_models = {"CTMCQVAE": CTMCQVAE, "MCQVAE": MCQVAE}


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


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter as flax initialises its JAX counterpart."""
    for module in model.modules():
        for name, p in module.named_parameters(recurse=False):
            if isinstance(module, VectorQuantizerMS):
                k = module.num_embeddings
                p.copy_((torch.rand(p.shape, generator=generator,
                                    device=p.device) * 2 - 1) / k)
            elif name == "bias" or name in ("disc_b1", "disc_b2",
                                            "mask_bias"):
                p.zero_()
            else:
                p.copy_(lecun_normal(p.shape, _fan_in(p, module),
                                     generator, p.device))


def build_model(model_params: dict, device=None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """Instantiate a model from a ``model_params`` config section on
    ``device`` (default ``cuda``; raises when no card is present). Keys
    the class does not take are dropped, as in the JAX registry. Weights
    are drawn from ``generator`` (a fresh seed-0 generator by default)."""
    device = resolve_device(device)
    params = dict(model_params)
    cls = vae_models[params.pop("name")]
    accepted = set(inspect.signature(cls.__init__).parameters) - {"self"}
    params = {k: v for k, v in params.items() if k in accepted}
    model = cls(**params, device=device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    init_weights(model, generator)
    return model.eval()


__all__ = ["CTMCQVAE", "CausalTransition", "MCQVAE", "build_model",
           "init_weights", "vae_models"]
