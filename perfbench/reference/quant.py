"""Operand rounding for the control: the reference with the parts that
the configuration computes in bfloat16 (the denoiser, the vocoder's MRF
stages and head) computed one precision lower.

``fp8`` rounds each operand of those matmuls and convolutions (weights
once, activations on every call) to float8 e4m3 with a per-tensor scale
(amax to 448), accumulating in float32, the step a later change might
take; ``bf16`` rounds them to bfloat16 (the configuration's own type).
"""

from __future__ import annotations

import torch
from torch import nn


def round_to(x: torch.Tensor, fmt: str) -> torch.Tensor:
    if fmt == "f32":
        return x
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if fmt == "fp8":
        scale = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    raise ValueError(f"unknown format {fmt}")


def round_ste(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``round_to`` in the forward pass, the identity in the backward."""
    return x + (round_to(x.detach(), fmt) - x.detach())


def _pre_hook(fmt):
    def hook(module, args):
        return (round_ste(args[0], fmt),) + tuple(args[1:])
    return hook


def round_inputs(modules, fmt: str) -> list:
    """Round the inputs of every Linear and Conv1d under ``modules`` to
    ``fmt`` on each call (straight-through).  Returns the hook handles."""
    return [m.register_forward_pre_hook(_pre_hook(fmt))
            for root in modules for m in root.modules()
            if isinstance(m, (nn.Linear, nn.Conv1d))]


@torch.no_grad()
def lower_precision(modules, fmt: str) -> list:
    """Round the weights of every Linear and Conv1d under ``modules`` to
    ``fmt`` in place and round their inputs on each call.  Returns the
    hook handles."""
    for root in modules:
        for m in root.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                m.weight.copy_(round_to(m.weight, fmt))
    return round_inputs(modules, fmt)
