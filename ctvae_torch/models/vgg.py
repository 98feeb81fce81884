"""A frozen VGG19-bn feature extractor for DFCVAE's perceptual loss.

Counterpart of ``ctvae_tpu/models/vgg.py``: torchvision's ``vgg19_bn``
``features`` Sequential (config E: Conv2d, BatchNorm2d, ReLU per conv
entry, a 2 x 2 MaxPool2d per 'M'), indexed as torchvision indexes it and
run only up to the largest tap. The weights are buffers, not parameters:
no optimizer holds them and no gradient norm counts them, while gradients
flow through the features to the reconstruction. BatchNorm is always in
its inference form, ``scale * (x - mean) * rsqrt(var + 1e-5) + bias``,
under ``train`` too.

Buffers per layer index ``i``: ``conv<i>_weight`` (OIHW, torchvision's
layout; JAX's ``conv<i>_kernel`` is HWIO) and ``conv<i>_bias``;
``bn<i>_scale``, ``bn<i>_bias``, ``bn<i>_mean`` and ``bn<i>_var``.

The taps keep the reference's in-place ReLU quirk: its tap loop keeps the
BatchNorm output, which the next module (an in-place ReLU) then
overwrites, so a tap at a BatchNorm index ('24', '34') yields the
post-ReLU activation; conv taps ('14', '43') yield the conv output.

Without network access no pretrained weights are fetched:
``attach_pretrained_vgg`` loads a local torchvision ``state_dict``
(``CTVAE_VGG19_WEIGHTS``, then the cache paths torchvision would use) and
otherwise refuses, unless random features were asked for.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

# torchvision VGG config 'E' (vgg19): channel counts, 'M' = maxpool
_VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M")

BN_EPS = 1e-5


def _sequential_plan() -> List[Tuple[str, int]]:
    """Config E in the torchvision Sequential's index order."""
    plan = []
    for v in _VGG19_CFG:
        if v == "M":
            plan.append(("pool", 0))
        else:
            plan += [("conv", v), ("bn", v), ("relu", v)]
    return plan


def _effective(plan: List[Tuple[str, int]], idx: int) -> int:
    """The index whose output a tap at ``idx`` yields (the in-place ReLU
    quirk: a BatchNorm followed by a ReLU yields the ReLU's output)."""
    if (plan[idx][0] == "bn" and idx + 1 < len(plan)
            and plan[idx + 1][0] == "relu"):
        return idx + 1
    return idx


class FrozenVGG19BN(nn.Module):
    """Runs the features Sequential on NHWC images and returns the
    activations at ``feature_layers`` (module indices as strings), NHWC,
    in the order asked."""

    def __init__(self, in_channels: int = 3,
                 feature_layers: Sequence[str] = ("14", "24", "34", "43"),
                 *, device=None):
        super().__init__()
        self.feature_layers = tuple(feature_layers)
        self.plan = _sequential_plan()
        # (effective index, output position): a BatchNorm tap and the tap
        # of its ReLU collapse onto one index, and both are emitted
        self.wanted = [(_effective(self.plan, int(k)), pos)
                       for pos, k in enumerate(self.feature_layers)]
        self.last = max(e for e, _ in self.wanted)
        fin = in_channels
        for idx, (kind, ch) in enumerate(self.plan[:self.last + 1]):
            if kind == "conv":
                self.register_buffer(f"conv{idx}_weight", torch.empty(
                    ch, fin, 3, 3, device=device))
                self.register_buffer(f"conv{idx}_bias",
                                     torch.zeros(ch, device=device))
                fin = ch
            elif kind == "bn":
                for name, fill in (("scale", 1.0), ("bias", 0.0),
                                   ("mean", 0.0), ("var", 1.0)):
                    self.register_buffer(f"bn{idx}_{name}", torch.full(
                        (ch,), fill, device=device))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous()
        feats = []
        for idx, (kind, _) in enumerate(self.plan[:self.last + 1]):
            if kind == "conv":
                x = F.conv2d(x, getattr(self, f"conv{idx}_weight"),
                             getattr(self, f"conv{idx}_bias"), padding=1)
            elif kind == "bn":
                c = (-1, 1, 1)
                scale, bias, mean, var = (
                    getattr(self, f"bn{idx}_{n}").view(c)
                    for n in ("scale", "bias", "mean", "var"))
                x = scale * (x - mean) * torch.rsqrt(var + BN_EPS) + bias
            elif kind == "relu":
                x = torch.relu(x)
            else:
                x = F.max_pool2d(x, 2)
            feats += [(pos, x) for eff, pos in self.wanted if eff == idx]
        return [f.permute(0, 2, 3, 1) for _, f in sorted(feats,
                                                         key=lambda t: t[0])]


def find_pretrained_weights() -> Optional[str]:
    """A local vgg19_bn ``state_dict``: ``CTVAE_VGG19_WEIGHTS`` first, then
    the torch hub cache paths torchvision would have used; None when none
    exists."""
    candidates = [
        os.environ.get("CTVAE_VGG19_WEIGHTS"),
        os.path.expanduser("~/.cache/ctvae/vgg19_bn.pth"),
        os.path.expanduser(
            "~/.cache/torch/hub/checkpoints/vgg19_bn-c79401a0.pth"),
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    return None


REFUSAL = ("DFCVAE: no pretrained VGG19-bn weights found — the "
           "perceptual loss would use RANDOM features, diverging "
           "from the reference's pretrained torchvision model. Set "
           "CTVAE_VGG19_WEIGHTS to a local torchvision vgg19_bn "
           "state_dict to match")


def attach_pretrained_vgg(model: nn.Module, allow_random: bool = False
                          ) -> nn.Module:
    """Load local pretrained weights into every ``FrozenVGG19BN`` of
    ``model``. Without weights this raises, unless ``allow_random`` (then
    it warns and keeps the random features): the reference's perceptual
    loss uses torchvision's pretrained features, so random ones are
    another objective that a user must ask for
    (``model_params.allow_random_features: true``)."""
    vggs = [m for m in model.modules() if isinstance(m, FrozenVGG19BN)]
    if not vggs:
        return model
    path = find_pretrained_weights()
    if path is None:
        if not allow_random:
            raise RuntimeError(
                REFUSAL + ", or set model_params.allow_random_features: "
                "true to explicitly accept random perceptual features.")
        warnings.warn(REFUSAL + " (training anyway: allow_random_features "
                      "is set).", stacklevel=2)
        return model
    for vgg in vggs:
        load_vgg19_bn_weights(vgg, path)
    return model


#: buffer suffix -> the torchvision ``features.<i>`` key's suffix
_TORCHVISION = {"conv": {"weight": "weight", "bias": "bias"},
                "bn": {"scale": "weight", "bias": "bias",
                       "mean": "running_mean", "var": "running_var"}}


@torch.no_grad()
def load_vgg19_bn_weights(vgg: FrozenVGG19BN, state_dict_path: str
                          ) -> FrozenVGG19BN:
    """Overwrite ``vgg``'s buffers from a torchvision vgg19_bn
    ``state_dict`` file (keys ``features.<i>.weight`` etc.; its conv
    kernels are OIHW, as the buffers); raises on a missing key or a shape
    mismatch."""
    sd = torch.load(state_dict_path, map_location="cpu", weights_only=True)
    for name, buf in vgg.named_buffers():
        layer, suffix = name.split("_", 1)
        kind, idx = layer.rstrip("0123456789"), layer[len(
            layer.rstrip("0123456789")):]
        key = f"features.{idx}.{_TORCHVISION[kind][suffix]}"
        w = sd[key]
        if tuple(w.shape) != tuple(buf.shape):
            raise ValueError(f"{key}: shape {tuple(w.shape)}, the VGG's "
                             f"{name} has {tuple(buf.shape)}")
        buf.copy_(w.to(buf.dtype))
    return vgg
