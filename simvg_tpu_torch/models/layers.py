"""The two layer types every port module shares.

The JAX package keeps every parameter in float32 and picks a compute
dtype per module: ``nn.Dense(dtype=...)`` casts its input, kernel and
bias to that dtype, and every LayerNorm computes in float32.  These two
classes do the same, so a float32 state dict drives a bf16 forward.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    """``nn.Linear`` on float32 parameters, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed and returned in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)
