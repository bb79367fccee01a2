"""HiFi-GAN V1 generator (port of ``cmtts_tpu/models/hifigan.py``).

conv_pre (80 -> 512, k7) -> 4 transposed-conv upsample stages (rates
8, 8, 2, 2 / kernels 16, 16, 4, 4), each followed by a multi-receptive-field
fusion (mean of 3 ResBlocks, k 3/7/11, dilations 1/3/5 interleaved with
dilation-1 convs) -> leaky_relu(0.01) -> conv_post -> tanh; 256x upsampling.

``HiFiGANGenerator.forward`` is the plain generator (``Conv1d`` ResBlock
stack).  :func:`hifigan_apply_fused` is the synthesis path: on the card
every MRF stage runs the port's CUDA kernels (the C = 256 stage the
streamed one, C <= 128 stages the fused one, with the head fused into the
last stage); transposed convs and ``conv_pre`` stay ordinary torch ops, as
the JAX package leaves them to XLA.  Layout is channels-first inside; the
public layouts stay JAX's: mel (B, T, n_mels) in, wav (B, T * 256) out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cmtts_tpu_torch.ops.mrf import (
    fused_mrf_stage,
    fused_mrf_stage_streamed,
    pack_mrf_params,
    pack_post_params,
)

LRELU_SLOPE = 0.1
FUSED_MAX_C = 128  # wider stages run the streamed kernel


@dataclass(frozen=True)
class HiFiGANConfig:
    upsample_rates: tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_mels: int = 80
    sampling_rate: int = 22050

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out


class ResBlock(nn.Module):
    """MRF residual block; convs named ``conv1_{i}`` / ``conv2_{i}`` like
    the flax module's."""

    def __init__(self, channels: int, kernel_size: int,
                 dilations: tuple[int, ...]):
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


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: HiFiGANConfig | None = None):
        super().__init__()
        c = cfg or HiFiGANConfig()
        self.cfg = c
        self.conv_pre = nn.Conv1d(c.num_mels, c.upsample_initial_channel, 7,
                                  padding=3)
        ch = c.upsample_initial_channel
        for i, (rate, kernel) in enumerate(
                zip(c.upsample_rates, c.upsample_kernel_sizes)):
            cin, ch = ch, c.upsample_initial_channel // (2 ** (i + 1))
            self.add_module(f"up_{i}", nn.ConvTranspose1d(
                cin, ch, kernel, stride=rate, padding=(kernel - rate) // 2))
            for j, (ks, ds) in enumerate(zip(c.resblock_kernel_sizes,
                                             c.resblock_dilation_sizes)):
                self.add_module(f"res_{i}_{j}", ResBlock(ch, ks, ds))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def stage_channels(self, i: int) -> int:
        return self.cfg.upsample_initial_channel // (2 ** (i + 1))

    def forward(self, mel):
        """mel (B, T, n_mels) -> waveform (B, T * 256), plain torch ops."""
        c = self.cfg
        x = self.conv_pre(mel.transpose(1, 2))
        n_res = len(c.resblock_kernel_sizes)
        for i in range(len(c.upsample_rates)):
            x = getattr(self, f"up_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            acc = None
            for j in range(n_res):
                h = getattr(self, f"res_{i}_{j}")(x)
                acc = h if acc is None else acc + h
            x = acc / n_res
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]


def pack_generator(gen: HiFiGANGenerator, compute_dtype=torch.bfloat16):
    """Per-stage packed weights for :func:`hifigan_apply_fused`: a list of
    :func:`pack_mrf_params` packs ``(w, b, w_frag)``, plus the packed
    head."""
    packs = [pack_mrf_params(gen, i, compute_dtype)
             for i in range(len(gen.cfg.upsample_rates))]
    return packs, pack_post_params(gen, compute_dtype)


@torch.no_grad()
def hifigan_apply_fused(gen: HiFiGANGenerator, mel: torch.Tensor,
                        packed=None, compute_dtype=torch.bfloat16):
    """HiFi-GAN forward with every MRF stage in the port's kernels.

    mel (B, T, n_mels) -> wav (B, T * 256) float32.  Inside the stages the
    activations and conv operands are ``compute_dtype`` with float32
    accumulation; the torch ops around them run in float32.  ``packed``
    is :func:`pack_generator`'s output (packed here when not given).
    """
    c = gen.cfg
    if packed is None:
        packed = pack_generator(gen, compute_dtype)
    stages, post = packed
    ks = tuple(c.resblock_kernel_sizes)
    ds = tuple(c.resblock_dilation_sizes[0])
    if any(tuple(d) != ds for d in c.resblock_dilation_sizes):
        raise NotImplementedError("the MRF kernels take one dilation tuple")
    x = gen.conv_pre(mel.float().transpose(1, 2))
    n_stages = len(c.upsample_rates)
    for i in range(n_stages):
        x = getattr(gen, f"up_{i}")(F.leaky_relu(x, LRELU_SLOPE)).contiguous()
        last = i == n_stages - 1
        if gen.stage_channels(i) > FUSED_MAX_C:
            x = fused_mrf_stage_streamed(x, stages[i], ks, ds, compute_dtype)
        else:
            x = fused_mrf_stage(x, stages[i], ks, ds, compute_dtype,
                                post=post if last else None)
            if last:
                return x  # the fused head already applied tanh
    x = gen.conv_post(F.leaky_relu(x, 0.01))
    return torch.tanh(x)[:, 0]


def unflatten_npz(path: str) -> dict:
    """`a/b/c` flat npz keys -> nested dict of numpy arrays (a flax tree)."""
    params: dict = {}
    with np.load(path) as data:
        for k in data.files:
            node = params
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[k]
    return params


def vocoder_infer(wav, mel_lens, hop_length: int = 256,
                  max_wav_value: float = 32768.0):
    """Scale to the int16 range and report per-sample lengths in samples."""
    wavs = np.asarray(wav) * max_wav_value
    wavs = np.clip(wavs, -32768, 32767).astype(np.int16)
    return wavs, np.asarray(mel_lens) * hop_length
