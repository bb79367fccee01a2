"""Flax's default initialisers on torch tensors, for modules whose fresh
runs must draw their weights as the JAX package's ``Module.init`` does (the
distributions, not the draws)."""

from __future__ import annotations

import torch
from torch import nn

# std of a unit normal truncated at +-2, which flax divides out
TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator,
                  scale: float = 1.0) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``
    (``lecun_normal`` at scale 1): normal(0, sqrt(scale / fan_in) /
    TRUNC_STD) truncated at two standard deviations."""
    std = (scale / fan_in) ** 0.5 / TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)
