"""The MS-SSIM loss, in plain PyTorch (cuDNN's depthwise convolutions on
the card).

Counterpart of ``ctvae_tpu/ops/ssim.py`` (plain XLA there, no Pallas
kernel): 5 scales with the weights [0.0448, 0.2856, 0.3001, 0.2363,
0.1333], an 11 x 11 window of sigma 1.5 applied per channel with 'SAME'
padding, C1 = 0.01^2, C2 = 0.03^2, a 2 x 2 'VALID' average pool between
scales (an odd side loses its last row or column), and ``1 - output``.

``window_mode="gaussian"`` is the Gaussian window; ``"reference"`` the
inverted one of the reference implementation (a positive exponent),
built in float64 and cast to float32. ``normalize`` maps each scale's
SSIM and contrast term into [0, 1] by ``(x + 1) / 2`` before the
fractional powers; without it a negative term gives NaN, as in JAX.
The final combination is JAX's exactly: ``prod(pow1[:-1] * pow2[-1])``,
which multiplies the last scale's SSIM term in four times. In a
data-parallel step each scale's two means are the global batch's (sums
reduced over the ranks with their gradients, ``parallel/mesh.py::
sum_batch``) before the powers and the product.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.nn import functional as F

from ..parallel.mesh import batch_world, sum_batch
from .common import upcast32

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


@functools.lru_cache(maxsize=None)
def _window_np(window_size: int, sigma: float,
               window_mode: str = "gaussian") -> np.ndarray:
    x = np.arange(window_size) - window_size // 2
    sign = 1.0 if window_mode == "reference" else -1.0
    k1d = np.exp(sign * (x ** 2) / (2.0 * sigma ** 2))
    k1d /= k1d.sum()
    return np.outer(k1d, k1d).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _constants(window_size: int, sigma: float, window_mode: str,
               device: torch.device):
    """(window, scale weights) on ``device``, made once: a CUDA graph
    captured later reads them and could not copy them from the host."""
    return (torch.from_numpy(_window_np(window_size, sigma, window_mode)
                             ).to(device),
            torch.tensor(_MSSSIM_WEIGHTS, device=device))


def _depthwise_filter(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """The window over each channel of an NCHW map, 'SAME' padding."""
    c = x.shape[1]
    k = window.to(x.dtype).expand(c, 1, *window.shape)
    return F.conv2d(x, k, padding="same", groups=c)


def _batch_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the global batch of a data-parallel step."""
    return sum_batch(torch.sum(t)) / (t.numel() * batch_world())


def _ssim(img1: torch.Tensor, img2: torch.Tensor, window: torch.Tensor):
    mu1 = _depthwise_filter(img1, window)
    mu2 = _depthwise_filter(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_filter(img1 * img1, window) - mu1_sq
    sigma2_sq = _depthwise_filter(img2 * img2, window) - mu2_sq
    sigma12 = _depthwise_filter(img1 * img2, window) - mu1_mu2

    C1, C2 = 0.01 ** 2, 0.03 ** 2
    v1 = 2.0 * sigma12 + C2
    v2 = sigma1_sq + sigma2_sq + C2
    cs = _batch_mean(v1 / v2)
    ssim_map = ((2 * mu1_mu2 + C1) * v1) / ((mu1_sq + mu2_sq + C1) * v2)
    return _batch_mean(ssim_map), cs


def mssim_loss(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
               sigma: float = 1.5, normalize: bool = True,
               window_mode: str = "gaussian") -> torch.Tensor:
    """``1 - MS-SSIM(img1, img2)`` of two NHWC image batches (a scalar)."""
    img1 = upcast32(img1).permute(0, 3, 1, 2)
    img2 = upcast32(img2).permute(0, 3, 1, 2)
    window, weights = _constants(window_size, sigma, window_mode,
                                 img1.device)
    mssim, mcs = [], []
    for _ in range(len(_MSSSIM_WEIGHTS)):
        sim, cs = _ssim(img1, img2, window)
        mssim.append(sim)
        mcs.append(cs)
        img1 = F.avg_pool2d(img1, 2)
        img2 = F.avg_pool2d(img2, 2)
    mssim = torch.stack(mssim)
    mcs = torch.stack(mcs)
    if normalize:
        mssim = (mssim + 1) / 2
        mcs = (mcs + 1) / 2
    pow1 = mcs ** weights
    pow2 = mssim ** weights
    terms = pow1[:-1] * pow2[-1]
    # the product as plain multiplies: torch.prod's backward counts zeros
    # on the host, which a CUDA graph cannot hold
    output = terms[0]
    for t in terms[1:]:
        output = output * t
    return 1.0 - output
