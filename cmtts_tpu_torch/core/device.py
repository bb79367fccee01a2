"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (the default) and absent,
    so that nothing silently runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def cli_device(device: str | torch.device | None = None) -> torch.device:
    """:func:`resolve_device` for a command-line entry point, which first
    makes float32 convolutions and matmuls compute in float32, as the JAX
    CLIs compute them: PyTorch runs cuDNN's float32 convolutions in TF32
    (10-bit mantissa inputs) unless told otherwise.  Every CLI of
    :mod:`cmtts_tpu_torch.cli` that takes ``--device`` calls this and only
    this (``tests/test_torch_port_precision.py`` holds them to it)."""
    # the legacy flags: torch warns when they and ``fp32_precision`` are
    # mixed in one process, and every release the port runs on takes them
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return resolve_device(device)
