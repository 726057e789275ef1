"""The layer types every port module shares.

The JAX package keeps every parameter in float32 and picks a compute
dtype per module: ``nn.Dense(dtype=...)`` casts its input, kernel and
bias to that dtype, and every LayerNorm computes in float32.  ``Linear``
and ``LayerNorm`` do the same, so a float32 state dict drives a bf16
forward.

Train-mode randomness (dropout, drop-path) draws from an explicit
``torch.Generator``, as the JAX package draws from its "dropout" rng:
every ``Stochastic`` module reads ``self.generator``, which the train
step sets with ``set_generator`` and seeds each step.
"""

from __future__ import annotations

from typing import Optional, Sequence

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


class Stochastic(nn.Module):
    """A module whose train-mode randomness draws from ``self.generator``
    (a ``torch.Generator`` on the activations' device; None draws from
    torch's default generator)."""

    generator: Optional[torch.Generator] = None


def set_generator(model: nn.Module,
                  generator: Optional[torch.Generator]) -> None:
    """Points every ``Stochastic`` module of ``model`` at ``generator``."""
    for module in model.modules():
        if isinstance(module, Stochastic):
            module.generator = generator


def keep_mask(shape: Sequence[int], keep: float,
              generator: Optional[torch.Generator],
              device: torch.device) -> torch.Tensor:
    """Bernoulli(keep) booleans of ``shape``, drawn from ``generator``."""
    return torch.rand(tuple(shape), generator=generator, device=device) < keep


class Dropout(Stochastic):
    """Elementwise dropout, ``where(keep, x / keep_prob, 0)`` as flax's
    ``nn.Dropout``; identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = keep_mask(x.shape, keep, self.generator, x.device)
        return torch.where(mask, x / keep, 0.0)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed and returned in float32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)
