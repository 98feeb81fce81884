"""flax's ``Dense``, ``Conv`` and ``ConvTranspose`` with a compute dtype.

A flax layer built with ``dtype=bfloat16`` keeps its kernel and bias in
float32 (``param_dtype``) and casts its input and both parameters to
``dtype`` before the product, whose result stays in ``dtype``. These
subclasses of torch's layers do the same with ``compute_dtype`` (float32
unless ``set_compute_dtype`` changes it): the parameters stay as they
were created, and every call casts them (a copy at bfloat16, nothing at
float32, where the layer is torch's own). The gradient of a parameter
flows back through the cast, so it arrives in the parameter's dtype, as
JAX's does. ``torch.autocast`` does not do this: it picks its casts op by
op and knows no split of storage and compute dtypes.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """flax's ``Dense``: ``x @ W + b`` in ``compute_dtype``. ``weight`` /
    ``bias`` stand in for the layer's own (a parameter entered into a
    sequence-parallel region: ``parallel/sequence.py``)."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor, weight=None, bias=None
                ) -> torch.Tensor:
        dt = self.compute_dtype
        weight = self.weight if weight is None else weight
        bias = self.bias if bias is None else bias
        return F.linear(x.to(dt), weight.to(dt), _cast(bias, dt))


class Conv2d(nn.Conv2d):
    """flax's ``Conv`` (NCHW inside the backbones) in ``compute_dtype``."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    """flax's ``ConvTranspose`` (NCHW inside the backbones) in
    ``compute_dtype``."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Give every submodule of ``module`` that has a ``compute_dtype``
    (these layers, ``models/backbones.py::BatchNorm``,
    ``models/ct_vae.py::CausalTransition``, ``ops/gat.py::
    DenseGATv2Layer``) the compute dtype ``dtype``. Every model of the
    registry and TwoStageVAE calls it at the end of its constructor (a
    member that adds layers after its base's constructor, as JointVAE,
    VampVAE, FactorVAE and TwoStageVAE do, calls it again at the end of
    its own): it is the one place a compute dtype is set. DFCVAE's frozen
    VGG has no ``compute_dtype`` and stays float32, as JAX's takes no
    ``dtype``."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
