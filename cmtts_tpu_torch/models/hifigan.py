"""HiFi-GAN V1 generator (port of ``cmtts_tpu/models/hifigan.py``).

conv_pre (80 -> 512, k7) -> 4 transposed-conv upsample stages (rates
8, 8, 2, 2 / kernels 16, 16, 4, 4), each followed by a multi-receptive-field
fusion (mean of 3 ResBlocks, k 3/7/11, dilations 1/3/5 interleaved with
dilation-1 convs) -> leaky_relu(0.01) -> conv_post -> tanh; 256x upsampling.
Other widths (``upsample_initial_channel``, 128 for V2) keep the layout.

``HiFiGANGenerator.forward`` is the plain generator (``Conv1d`` ResBlock
stack).  :func:`hifigan_apply_fused` is the synthesis path: on the card
each MRF stage whose shape the port's CUDA kernels take runs them (the
C = 256 stage the streamed one, C <= 128 stages the fused one, with the head
fused into the last stage); a stage they do not take (C = 8 in bfloat16, at
the V2 width) runs the plain stage.  The route of each stage is fixed when
the weights are packed (:func:`stage_routes`).  Transposed convs and
``conv_pre`` stay ordinary torch ops, as the JAX package leaves them to XLA.
Layout is channels-first inside; the public layouts stay JAX's: mel
(B, T, n_mels) in, wav (B, T * 256) out.

Checkpoints: a flat ``a/b/c`` npz of flax params, or the reference's torch
``generator_*.pth.tar`` (``["generator"]``, weight norm folded) through the
numpy converter copied from the JAX module (:func:`convert_torch_hifigan`).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cmtts_tpu_torch.convert import load_flax_params
from cmtts_tpu_torch.ops.mrf import (
    fused_mrf_stage,
    fused_mrf_stage_streamed,
    kernel_takes,
    mrf_stage_plain,
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


class GeneratorPack(NamedTuple):
    """:func:`pack_generator`'s output: per stage the :func:`pack_mrf_params`
    pack ``(w, b, w_frag)`` and the route it takes, and the packed head."""

    stages: list
    post: tuple
    routes: list


def stage_routes(gen: HiFiGANGenerator, compute_dtype=torch.bfloat16):
    """The route of each MRF stage in ``compute_dtype``, decided from the
    shapes alone: ``fused`` or ``streamed`` (C > FUSED_MAX_C) where
    :func:`~cmtts_tpu_torch.ops.mrf.kernel_takes` holds, else ``plain``
    (``mrf_stage_plain``); the last stage carries the head (``+head``).
    Width 512 gives [streamed, fused, fused, fused+head]; width 128 (V2) in
    bfloat16 [fused, fused, fused, plain+head], whose C = 8 is not a
    multiple of the k16 step."""
    c = gen.cfg
    ks, ds = tuple(c.resblock_kernel_sizes), tuple(c.resblock_dilation_sizes[0])
    n = len(c.upsample_rates)
    routes = []
    for i in range(n):
        last = i == n - 1
        C = gen.stage_channels(i)
        post_k = gen.conv_post.kernel_size[0] if last else 0
        if not kernel_takes(C, compute_dtype, ks, ds, post_k):
            route = "plain"
        elif C > FUSED_MAX_C and not last:
            route = "streamed"
        else:
            route = "fused"
        routes.append(route + ("+head" if last else ""))
    return routes


def pack_generator(gen: HiFiGANGenerator, compute_dtype=torch.bfloat16):
    """Per-stage packed weights and routes for :func:`hifigan_apply_fused`
    (a :class:`GeneratorPack`)."""
    packs = [pack_mrf_params(gen, i, compute_dtype)
             for i in range(len(gen.cfg.upsample_rates))]
    return GeneratorPack(packs, pack_post_params(gen, compute_dtype),
                         stage_routes(gen, compute_dtype))


@torch.no_grad()
def hifigan_apply_fused(gen: HiFiGANGenerator, mel: torch.Tensor,
                        packed=None, compute_dtype=torch.bfloat16):
    """HiFi-GAN forward with each MRF stage on the route
    :func:`stage_routes` fixed for it: the port's kernels, or the plain
    stage where they do not take the stage's shape.

    mel (B, T, n_mels) -> wav (B, T * 256) float32.  Inside the stages the
    activations and conv operands are ``compute_dtype`` with float32
    accumulation; the torch ops around them run in float32.  ``packed``
    is :func:`pack_generator`'s output (packed here when not given).
    """
    c = gen.cfg
    if packed is None:
        packed = pack_generator(gen, compute_dtype)
    ks = tuple(c.resblock_kernel_sizes)
    ds = tuple(c.resblock_dilation_sizes[0])
    if any(tuple(d) != ds for d in c.resblock_dilation_sizes):
        raise NotImplementedError("the MRF kernels take one dilation tuple")
    x = gen.conv_pre(mel.float().transpose(1, 2))
    for i, (pack, route) in enumerate(zip(packed.stages, packed.routes)):
        x = getattr(gen, f"up_{i}")(F.leaky_relu(x, LRELU_SLOPE)).contiguous()
        post = packed.post if route.endswith("+head") else None
        if route.startswith("streamed"):
            x = fused_mrf_stage_streamed(x, pack, ks, ds, compute_dtype)
        elif route.startswith("fused"):
            x = fused_mrf_stage(x, pack, ks, ds, compute_dtype, post=post)
        else:
            x = mrf_stage_plain(x, pack[0], pack[1], ks, ds, compute_dtype,
                                post)
    return x  # the last stage applied the head (tanh included)


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


def _fold_weight_norm(g, v):
    """weight_norm fold: w = g * v / ||v|| over all but the first axis
    (torch semantics), the norm floored at 1e-12."""
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
    return g.reshape(norm.shape) * v / np.maximum(norm, 1e-12)


def torch_conv_getters(state_dict: dict):
    """(get, conv_w, convT_w) over a torch vocoder state dict: weight-norm
    fold + torch->flax kernel layout.  Conv1d (out,in,k)->(k,in,out);
    ConvTranspose1d (in,out,k)->(k,in,out) with flipped taps."""

    def get(name):
        w = state_dict.get(name)
        return None if w is None else np.asarray(w)

    def conv_w(prefix):
        g, v = get(prefix + ".weight_g"), get(prefix + ".weight_v")
        w = _fold_weight_norm(g, v) if g is not None else get(prefix + ".weight")
        return np.transpose(w, (2, 1, 0))

    def convT_w(prefix):
        g, v = get(prefix + ".weight_g"), get(prefix + ".weight_v")
        w = _fold_weight_norm(g, v) if g is not None else get(prefix + ".weight")
        w = np.transpose(w, (2, 0, 1))
        return w[::-1].copy()

    return get, conv_w, convT_w


# Copied from cmtts_tpu/models/hifigan.py::convert_torch_hifigan (numpy).
def convert_torch_hifigan(state_dict: dict, cfg: HiFiGANConfig) -> dict:
    """Convert a reference HiFi-GAN generator torch state dict
    (hifigan/generator_*.pth.tar ["generator"]) into flax params (the tree
    the bridge loads).  Torch Conv1d kernels are (out, in, k); flax wants
    (k, in, out).  Torch ConvTranspose1d kernels are (in, out, k) -> flax
    (k, in, out) with flipped taps (transpose conv kernel-flip convention)."""
    get, conv_w, convT_w = torch_conv_getters(state_dict)

    params: dict = {
        "conv_pre": {"kernel": conv_w("conv_pre"), "bias": get("conv_pre.bias")},
        "conv_post": {"kernel": conv_w("conv_post"), "bias": get("conv_post.bias")},
    }
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        params[f"up_{i}"] = {"kernel": convT_w(f"ups.{i}"),
                             "bias": get(f"ups.{i}.bias")}
        for j in range(n_k):
            r = i * n_k + j
            block: dict = {}
            for c, d in enumerate(cfg.resblock_dilation_sizes[j]):
                block[f"conv1_{c}"] = {
                    "kernel": conv_w(f"resblocks.{r}.convs1.{c}"),
                    "bias": get(f"resblocks.{r}.convs1.{c}.bias")}
                block[f"conv2_{c}"] = {
                    "kernel": conv_w(f"resblocks.{r}.convs2.{c}"),
                    "bias": get(f"resblocks.{r}.convs2.{c}.bias")}
            params[f"res_{i}_{j}"] = block
    return params


def load_hifigan_params(path: str) -> dict:
    """HiFi-GAN flax params from a flat ``a/b/c`` npz, or from the
    reference's torch ``.pt`` / ``.pth.tar`` (the state dict under
    ``"generator"``, or the bare state dict), converted (the conversion
    depends on the stage and ResBlock counts, not on the widths)."""
    if path.endswith(".npz"):
        return unflatten_npz(path)
    if path.endswith((".pt", ".pth.tar")):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("generator", ckpt)
        sd = {k: v.detach().cpu().numpy() for k, v in sd.items()
              if torch.is_tensor(v)}
        return convert_torch_hifigan(sd, HiFiGANConfig())
    raise ValueError(f"unknown HiFi-GAN checkpoint format: {path}")


def load_hifigan(path: str | None, cfg=None) -> HiFiGANGenerator:
    """A HiFi-GAN generator from :func:`load_hifigan_params`'s formats, its
    width and mel channels read from ``conv_pre`` (in-repo-trained
    generators of other widths load without a config override), at the
    sampling rate of the CM config ``cfg``; random weights of the config's
    mel channels, with a warning, when no path is given."""
    sr = {} if cfg is None else {"sampling_rate": cfg.stft.sampling_rate}
    if not path:
        warnings.warn("no vocoder checkpoint given; using a random-init "
                      "HiFi-GAN")
        mels = {} if cfg is None else {"num_mels": cfg.stft.n_mel_channels}
        return HiFiGANGenerator(HiFiGANConfig(**mels, **sr))
    tree = load_hifigan_params(path)
    _, num_mels, width = tree["conv_pre"]["kernel"].shape
    return load_flax_params(HiFiGANGenerator(HiFiGANConfig(
        upsample_initial_channel=int(width), num_mels=int(num_mels), **sr)),
        tree).eval()


def vocoder_infer(wav, mel_lens, hop_length: int = 256,
                  max_wav_value: float = 32768.0):
    """Scale to the int16 range and report per-sample lengths in samples."""
    wavs = np.asarray(wav) * max_wav_value
    wavs = np.clip(wavs, -32768, 32767).astype(np.int16)
    return wavs, np.asarray(mel_lens) * hop_length
