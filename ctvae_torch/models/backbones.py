"""Convolutional backbones: the standard Gaussian one and the VQ family's.

Counterpart of ``ctvae_tpu/models/backbones.py``:

* the standard backbone of the Gaussian zoo: a stride-2 3x3
  Conv/BatchNorm/LeakyReLU pyramid (``ConvBNBlock``, ``ConvEncoder``), the
  twin ``fc_mu`` / ``fc_var`` heads (``GaussianHead``), the latent's
  ``DecoderInput`` and the mirrored ConvTranspose decoder
  (``DeconvBNBlock``, ``ConvDecoder``);
* the VQ family's k4-s2 convs and residual stacks (``ResidualLayer``,
  ``VQEncoder``, ``VQDecoder``).

Inputs and outputs are NHWC like the JAX modules; the permutation to
PyTorch's NCHW happens inside, and a feature map is flattened in its NHWC
order as flax flattens it. flax's 'SAME' padding equals ``padding=1`` for
the k4-s2 and k3 convs on even inputs. flax's transposed convs correlate
with the kernel as stored, torch's with its taps flipped (``convert.py``
flips them): the k4-s2 'SAME' one is ``ConvTranspose2d(k4, s2, p1)``, the
k3-s2 one padded ((1, 2), (1, 2)) is ``ConvTranspose2d(k3, s2, p1,
output_padding=1)``. Submodule names follow the JAX param tree
(``Conv_0``, ``ConvBNBlock_0``, ``BatchNorm_0``, ...).

Every conv, linear layer and BatchNorm computes in its ``compute_dtype``
(``ops/layers.py``; float32 unless a model sets bfloat16), with its
parameters in float32, as a flax module built with ``dtype``; the
decoders and the Gaussian heads return float32 (flax's ``upcast32``).

``BatchNorm`` is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` (or
another ``momentum``): it
follows the ``train`` argument, never ``Module.training``; a train pass
normalises with the batch's statistics and folds its mean and *biased*
variance into the running buffers (``running = 0.9 running + 0.1 batch``,
where torch's own would take the unbiased variance), in place under
``no_grad`` with no host read, so a captured CUDA graph replays the
update; an eval pass normalises with the running buffers. In a
data-parallel step (``parallel/mesh.py``) a train pass takes the
statistics of the global batch.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.common import upcast32
from ..ops.layers import Conv2d, ConvTranspose2d, Linear
from ..parallel.mesh import all_reduce_autograd, batch_group, group_size


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


class ResidualLayer(nn.Module):
    """3x3 conv -> ReLU -> 1x1 conv, bias-free, added to the input (NCHW
    inside the backbones)."""

    def __init__(self, features: int, *, device=None):
        super().__init__()
        self.Conv_0 = Conv2d(features, features, 3, padding=1, bias=False,
                                device=device)
        self.Conv_1 = Conv2d(features, features, 1, bias=False,
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
            setattr(self, f"Conv_{i}", Conv2d(fin, h, 4, stride=2,
                                                 padding=1, device=device))
            fin = h
        L = len(hd)
        setattr(self, f"Conv_{L}", Conv2d(fin, fin, 3, padding=1,
                                             device=device))
        for i in range(num_residual):
            setattr(self, f"ResidualLayer_{i}",
                    ResidualLayer(fin, device=device))
        setattr(self, f"Conv_{L + 1}", Conv2d(fin, embedding_dim, 1,
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
        self.Conv_0 = Conv2d(embedding_dim, rev[0], 3, padding=1,
                                device=device)
        for i in range(num_residual):
            setattr(self, f"ResidualLayer_{i}",
                    ResidualLayer(rev[0], device=device))
        outs = rev[1:] + [out_channels]
        fin = rev[0]
        for i, h in enumerate(outs):
            setattr(self, f"ConvTranspose_{i}",
                    ConvTranspose2d(fin, h, 4, stride=2, padding=1,
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
        return upcast32(torch.tanh(x)).permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# the standard backbone of the Gaussian zoo
# ---------------------------------------------------------------------------

DEFAULT_HIDDEN_DIMS = (32, 64, 128, 256, 512)


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over dim 1 of a [B, C, ...] tensor: the
    channels of an NCHW map, or the features of a [B, D] vector (LVAE's
    ladder); ``weight`` / ``bias`` are flax's ``scale`` / ``bias``,
    ``running_mean`` / ``running_var`` its ``batch_stats``. ``momentum``
    0.9 is the zoo's; TwoStageVAE's MLPs take flax's default, 0.99.
    As flax's with ``dtype``: the statistics, the normalisation and the
    running buffers in float32, the output in ``compute_dtype``."""

    EPS = 1e-5
    compute_dtype = torch.float32

    def __init__(self, features: int, momentum: float = 0.9, *,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        # flax normalises in at least float32 and returns its dtype
        return self._normalise(upcast32(x), train).to(self.compute_dtype)

    def _normalise(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            # the eval kernel itself: ``F.batch_norm`` picks cuDNN on the
            # card below a batch of 65,536, a choice that fixes an
            # exported program's symbolic batch to that range (on the CPU
            # the two are the same kernel, bit for bit)
            return torch.ops.aten._native_batch_norm_legit_no_training(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, 0.0, self.EPS)[0]
        dims = (0,) + tuple(range(2, x.dim()))
        group = batch_group()
        if group is not None:
            return self._global_forward(x, dims, group)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            self._fold(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.EPS)

    @torch.no_grad()
    def _fold(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
        self.running_var.mul_(m).add_(var, alpha=1.0 - m)

    def _global_forward(self, x: torch.Tensor, dims, group) -> torch.Tensor:
        """A data-parallel train pass: the mean and the biased variance of
        the global batch (two sums over the ranks, the gradient flowing
        through both), as flax normalises a sharded global batch."""
        shape = [1, -1] + [1] * (x.dim() - 2)
        n = float(x.numel() // x.shape[1] * group_size(group))
        mean = all_reduce_autograd(torch.sum(x, dim=dims), group) / n
        centred = x - mean.reshape(shape)
        var = all_reduce_autograd(torch.sum(torch.square(centred), dim=dims),
                                  group) / n
        self._fold(mean.detach(), var.detach())
        return (centred * torch.rsqrt(var + self.EPS).reshape(shape)
                * self.weight.reshape(shape) + self.bias.reshape(shape))


class ConvBNBlock(nn.Module):
    """Conv(k3, s2, p1) -> BatchNorm -> LeakyReLU (NCHW)."""

    def __init__(self, in_features: int, features: int, *, device=None):
        super().__init__()
        self.Conv_0 = Conv2d(in_features, features, 3, stride=2,
                                padding=1, device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        return leaky_relu(self.BatchNorm_0(self.Conv_0(x), train=train))


def deconv_k3s2(in_features: int, features: int, *, device=None
                ) -> ConvTranspose2d:
    """flax's ConvTranspose((3, 3), strides (2, 2), padding ((1, 2), (1,
    2))): a 2x upsample (NCHW)."""
    return ConvTranspose2d(in_features, features, 3, stride=2, padding=1,
                              output_padding=1, device=device)


def nhwc_flat(x: torch.Tensor) -> torch.Tensor:
    """An NCHW map flattened per sample in flax's NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class DeconvBNBlock(nn.Module):
    """ConvTranspose(k3, s2), a 2x upsample -> BatchNorm -> LeakyReLU
    (NCHW)."""

    def __init__(self, in_features: int, features: int, *, device=None):
        super().__init__()
        self.ConvTranspose_0 = deconv_k3s2(in_features, features,
                                           device=device)
        self.BatchNorm_0 = BatchNorm(features, device=device)

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        return leaky_relu(self.BatchNorm_0(self.ConvTranspose_0(x),
                                           train=train))


class ConvEncoder(nn.Module):
    """The stride-2 pyramid: [B, H, W, C] -> [B, H/2^L, W/2^L, hd[-1]]."""

    def __init__(self, in_channels: int,
                 hidden_dims: Sequence[int] = DEFAULT_HIDDEN_DIMS, *,
                 device=None):
        super().__init__()
        fin = in_channels
        for i, h in enumerate(hidden_dims):
            setattr(self, f"ConvBNBlock_{i}",
                    ConvBNBlock(fin, h, device=device))
            fin = h
        self._n = len(hidden_dims)

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self._n):
            x = getattr(self, f"ConvBNBlock_{i}")(x, train=train)
        return x.permute(0, 2, 3, 1)


class ConvDecoder(nn.Module):
    """The mirrored ConvTranspose pyramid, then a last 2x upsample at the
    first width, a 3x3 conv to ``out_channels`` and ``final_activation``
    ("tanh", "sigmoid" or "none"): [B, h, w, hd[-1]] -> [B, H, W, C]."""

    def __init__(self, hidden_dims: Sequence[int] = DEFAULT_HIDDEN_DIMS,
                 out_channels: int = 3, final_activation: str = "tanh", *,
                 device=None):
        super().__init__()
        if final_activation not in ("tanh", "sigmoid", "none"):
            raise ValueError(f"unknown final_activation "
                             f"{final_activation!r}")
        rev = list(hidden_dims)[::-1]
        outs = rev[1:] + [rev[-1]]
        fin = rev[0]
        for i, h in enumerate(outs):
            setattr(self, f"DeconvBNBlock_{i}",
                    DeconvBNBlock(fin, h, device=device))
            fin = h
        self.Conv_0 = Conv2d(fin, out_channels, 3, padding=1,
                                device=device)
        self.final_activation = final_activation
        self._n = len(outs)

    def forward(self, x: torch.Tensor, *, train: bool) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self._n):
            x = getattr(self, f"DeconvBNBlock_{i}")(x, train=train)
        # the activation in float32 (XLA drops its rounding before the
        # upcast)
        x = upcast32(self.Conv_0(x))
        if self.final_activation == "tanh":
            x = torch.tanh(x)
        elif self.final_activation == "sigmoid":
            x = torch.sigmoid(x)
        return x.permute(0, 2, 3, 1).contiguous()


class GaussianHead(nn.Module):
    """Flatten (NHWC order) + the twin linear heads: (mu, log_var)."""

    def __init__(self, in_features: int, latent_dim: int, *, device=None):
        super().__init__()
        self.fc_mu = Linear(in_features, latent_dim, device=device)
        self.fc_var = Linear(in_features, latent_dim, device=device)

    def forward(self, feat: torch.Tensor):
        flat = feat.reshape(feat.shape[0], -1)
        return upcast32(self.fc_mu(flat)), upcast32(self.fc_var(flat))


class DecoderInput(nn.Module):
    """Linear latent -> the [B, spatial, spatial, features] feature map."""

    def __init__(self, latent_dim: int, features: int, spatial: int = 2, *,
                 device=None):
        super().__init__()
        self.features, self.spatial = features, spatial
        self.decoder_input = Linear(latent_dim,
                                       features * spatial * spatial,
                                       device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        s = self.spatial
        return self.decoder_input(z).reshape(z.shape[0], s, s, self.features)
