"""VQ-family convolutional backbone (k4-s2 convs + residual stacks).

Counterpart of ``ctvae_tpu/models/backbones.py`` (``ResidualLayer``,
``VQEncoder``, ``VQDecoder``). Inputs and outputs are NHWC like the JAX
modules; the permutation to PyTorch's NCHW happens inside. flax's 'SAME'
padding equals ``padding=1`` for the k4-s2 and k3 convs on even inputs,
and flax's k4-s2 'SAME' ``ConvTranspose`` equals ``ConvTranspose2d(k4, s2,
p1)`` with the taps flipped (``convert.py`` flips them). Submodule names
follow the JAX param tree (``Conv_0``, ``ResidualLayer_0``, ...).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


class ResidualLayer(nn.Module):
    """3x3 conv -> ReLU -> 1x1 conv, bias-free, added to the input (NCHW
    inside the backbones)."""

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.Conv_0 = nn.Conv2d(features, features, 3, padding=1, bias=False,
                                device=device)
        self.Conv_1 = nn.Conv2d(features, features, 1, bias=False,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.Conv_1(torch.relu(self.Conv_0(x)))


class VQEncoder(nn.Module):
    """k4-s2 downsampling stack + 3x3 conv + residual layers + 1x1 conv to
    ``embedding_dim``. [B, H, W, C] -> [B, H/2^L, W/2^L, embedding_dim]."""

    def __init__(self, in_channels: int, hidden_dims: Sequence[int],
                 embedding_dim: int, num_residual: int = 6, *, device=None):
        super().__init__()
        hd = list(hidden_dims)
        fin = in_channels
        for i, h in enumerate(hd):
            setattr(self, f"Conv_{i}", nn.Conv2d(fin, h, 4, stride=2,
                                                 padding=1, device=device))
            fin = h
        L = len(hd)
        setattr(self, f"Conv_{L}", nn.Conv2d(fin, fin, 3, padding=1,
                                             device=device))
        for i in range(num_residual):
            setattr(self, f"ResidualLayer_{i}",
                    ResidualLayer(fin, device=device))
        setattr(self, f"Conv_{L + 1}", nn.Conv2d(fin, embedding_dim, 1,
                                                 device=device))
        self._n_down, self._n_res = L, num_residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self._n_down + 1):
            x = leaky_relu(getattr(self, f"Conv_{i}")(x))
        for i in range(self._n_res):
            x = getattr(self, f"ResidualLayer_{i}")(x)
        x = leaky_relu(x)
        x = leaky_relu(getattr(self, f"Conv_{self._n_down + 1}")(x))
        return x.permute(0, 2, 3, 1).contiguous()


class VQDecoder(nn.Module):
    """Mirror of ``VQEncoder``: [B, h, w, D] -> tanh image [B, H, W, C]."""

    def __init__(self, embedding_dim: int, hidden_dims: Sequence[int],
                 out_channels: int = 3, num_residual: int = 6, *,
                 device=None):
        super().__init__()
        rev = list(hidden_dims)[::-1]
        self.Conv_0 = nn.Conv2d(embedding_dim, rev[0], 3, padding=1,
                                device=device)
        for i in range(num_residual):
            setattr(self, f"ResidualLayer_{i}",
                    ResidualLayer(rev[0], device=device))
        outs = rev[1:] + [out_channels]
        fin = rev[0]
        for i, h in enumerate(outs):
            setattr(self, f"ConvTranspose_{i}",
                    nn.ConvTranspose2d(fin, h, 4, stride=2, padding=1,
                                       device=device))
            fin = h
        self._n_res, self._n_up = num_residual, len(outs)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.Conv_0(z.permute(0, 3, 1, 2)))
        for i in range(self._n_res):
            x = getattr(self, f"ResidualLayer_{i}")(x)
        x = leaky_relu(x)
        for i in range(self._n_up):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            if i < self._n_up - 1:
                x = leaky_relu(x)
        return torch.tanh(x).permute(0, 2, 3, 1).contiguous()
