"""Plain PyTorch reference of HiFi-GAN V1 (jik876/hifi-gan ``config_v1.json``
layout: conv_pre 80 -> 512 k7, four transposed-conv upsamplings 8, 8, 2, 2
with kernels 16, 16, 4, 4, each followed by the mean of three ResBlocks of
kernels 3, 7, 11 and dilations 1, 3, 5, then leaky_relu(0.01), conv_post
and tanh).  Written from jik876/hifi-gan's ``Generator`` in float32
``Conv1d`` ops, where the program runs its own MRF kernels, under the
program's parameter names; it imports nothing of the program."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


class ResBlock(nn.Module):
    def __init__(self, channels, kernel_size, dilations):
        super().__init__()
        self.dilations = tuple(dilations)
        half = (kernel_size - 1) // 2
        for i, d in enumerate(self.dilations):
            self.add_module(f"conv1_{i}", nn.Conv1d(
                channels, channels, kernel_size, dilation=d, padding=half * d))
            self.add_module(f"conv2_{i}", nn.Conv1d(
                channels, channels, kernel_size, padding=half))

    def forward(self, x):
        for i in range(len(self.dilations)):
            h = getattr(self, f"conv1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            h = getattr(self, f"conv2_{i}")(F.leaky_relu(h, LRELU_SLOPE))
            x = x + h
        return x


class Generator(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        self.v = v
        width = v["upsample_initial_channel"]
        self.conv_pre = nn.Conv1d(v["num_mels"], width, 7, padding=3)
        ch = width
        for i, (rate, k) in enumerate(zip(v["upsample_rates"],
                                          v["upsample_kernel_sizes"])):
            cin, ch = ch, width // (2 ** (i + 1))
            self.add_module(f"up_{i}", nn.ConvTranspose1d(
                cin, ch, k, stride=rate, padding=(k - rate) // 2))
            for j, (ks, ds) in enumerate(zip(v["resblock_kernel_sizes"],
                                             v["resblock_dilation_sizes"])):
                self.add_module(f"res_{i}_{j}", ResBlock(ch, ks, ds))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel):
        """mel (B, T, n_mels) -> waveform (B, T * hop)."""
        v = self.v
        x = self.conv_pre(mel.transpose(1, 2))
        n_res = len(v["resblock_kernel_sizes"])
        for i in range(len(v["upsample_rates"])):
            x = getattr(self, f"up_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            acc = None
            for j in range(n_res):
                h = getattr(self, f"res_{i}_{j}")(x)
                acc = h if acc is None else acc + h
            x = acc / n_res
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))[:, 0]
