"""Seeded weights, made on the device in a few large calls and handed to
the program and to the reference alike.

The names and shapes come from the reference modules' state dicts, which
are the program's.  Every tensor is ``mean + std * z`` of one normal draw
for the whole module from a ``torch.Generator`` on the device:

- conv and linear kernels: std 1/sqrt(fan_in) (LeCun), fan_in = in x k,
  a transposed conv's in x k / stride (the taps one output meets);
- embedding tables: std dim^-1/2 (flax's ``nn.Embed``);
- biases: std 0.05; norm scales 1 + 0.1 z, norm shifts 0.1 z, learned
  positional scales 1 + 0.1 z; BatchNorm running means 0.1 z and
  variances 1 + 0.1 z;
- ``overrides`` set (mean, std) by name, such as the duration head.

Unlike the program's ``init_like_flax`` the denoiser's output projection
is not zero, so that the denoiser reaches the mel.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_FAN_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d)
_NORMS = (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)


def stream_seed(seed: int, salt: int) -> int:
    """A generator seed for one module's draw: the run seed and a salt
    mixed, below 2**63."""
    return (seed * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9) % (2 ** 63)


def tensor_moments(module: nn.Module, overrides: dict | None = None):
    """[(name, shape, mean, std)] for every float entry of the state dict,
    and the integer entries' names."""
    owner = {}
    for mname, m in module.named_modules():
        for pname, _ in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            owner[f"{mname}.{pname}" if mname else pname] = m
    out, ints = [], []
    for name, t in module.state_dict().items():
        if not t.is_floating_point():
            ints.append(name)
            continue
        m, leaf = owner[name], name.rsplit(".", 1)[-1]
        if isinstance(m, _NORMS):
            mean, std = {"weight": (1.0, 0.1), "bias": (0.0, 0.1),
                         "running_mean": (0.0, 0.1),
                         "running_var": (1.0, 0.1)}[leaf]
        elif isinstance(m, nn.Embedding):
            mean, std = 0.0, t.shape[1] ** -0.5
        elif leaf == "bias":
            mean, std = 0.0, 0.05
        elif isinstance(m, nn.ConvTranspose1d):
            mean, std = 0.0, 1.0 / math.sqrt(
                t.shape[0] * t.shape[2] / m.stride[0])
        elif isinstance(m, _FAN_MODULES):
            mean, std = 0.0, 1.0 / math.sqrt(t[0].numel())
        else:   # learned scalars such as a positional alpha
            mean, std = 1.0, 0.1
        if overrides and name in overrides:
            mean, std = overrides[name]
        out.append((name, tuple(t.shape), mean, std))
    return out, ints


def seeded_state_dict(module: nn.Module, seed: int, salt: int,
                      device: str, overrides: dict | None = None) -> dict:
    """The state dict of ``module`` drawn from ``seed``: one normal draw on
    ``device``, scaled and shifted per tensor in one call, then cut into
    views.  ``module`` may live on the meta device."""
    moments, ints = tensor_moments(module, overrides)
    counts = [math.prod(s) for _, s, _, _ in moments]
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, salt))
    flat = torch.randn(sum(counts), generator=gen, device=device)
    reps = torch.tensor(counts, device=device)
    std = torch.tensor([m[3] for m in moments], device=device)
    mean = torch.tensor([m[2] for m in moments], device=device)
    flat = torch.addcmul(mean.repeat_interleave(reps), flat,
                         std.repeat_interleave(reps))
    sd = {name: part.view(shape) for (name, shape, _, _), part in
          zip(moments, torch.split(flat, counts))}
    for name in ints:
        sd[name] = torch.zeros((), dtype=torch.long, device=device)
    return sd
