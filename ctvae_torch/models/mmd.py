"""The MMD of InfoVAE and WAE-MMD.

Counterpart of ``ctvae_tpu/models/mmd.py``, with its kernels' asymmetry:
the RBF kernel returns the [N, N] matrix (then averaged), the IMQ kernel
the sum of its off-diagonal entries (a scalar). The prior's ``z`` is one
``normal`` draw of the loss's ``Draws`` per call, where JAX draws from its
``noise`` stream. In a data-parallel step the MMD pairs the rows of the
global batch: ``z`` is gathered from the ranks and the prior drawn at the
global shape (``parallel/mesh.py::gather_batch``).
"""

from __future__ import annotations

import torch

from ..ops.common import upcast32
from ..parallel.mesh import gather_batch
from .base import Draws, unsharded


def _pairwise(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    return x1[:, None, :] - x2[None, :, :]                  # [N, N, D]


def rbf_kernel(x1: torch.Tensor, x2: torch.Tensor, z_var: float
               ) -> torch.Tensor:
    sigma = 2.0 * x2.shape[-1] * z_var
    return torch.exp(-torch.mean(torch.square(_pairwise(x1, x2)), dim=-1)
                     / sigma)


def imq_kernel(x1: torch.Tensor, x2: torch.Tensor, z_var: float,
               eps: float = 1e-7) -> torch.Tensor:
    C = 2.0 * x2.shape[-1] * z_var
    k = C / (eps + C + torch.sum(torch.square(_pairwise(x1, x2)), dim=-1))
    return torch.sum(k) - torch.sum(torch.diagonal(k))


def compute_kernel(x1: torch.Tensor, x2: torch.Tensor, kernel_type: str,
                   z_var: float) -> torch.Tensor:
    if kernel_type == "rbf":
        return rbf_kernel(x1, x2, z_var)
    if kernel_type == "imq":
        return imq_kernel(x1, x2, z_var)
    raise ValueError("Undefined kernel type.")


def compute_mmd(draws: Draws, z: torch.Tensor, kernel_type: str,
                z_var: float) -> torch.Tensor:
    """MMD(q(z) || N(0, I)), the prior one ``normal`` draw of ``draws``,
    over the global batch's ``z``."""
    z = gather_batch(upcast32(z))
    prior_z = unsharded(draws).normal(z.shape).to(z)
    pp = compute_kernel(prior_z, prior_z, kernel_type, z_var)
    zz = compute_kernel(z, z, kernel_type, z_var)
    pz = compute_kernel(prior_z, z, kernel_type, z_var)
    return torch.mean(pp) + torch.mean(zz) - 2.0 * torch.mean(pz)
