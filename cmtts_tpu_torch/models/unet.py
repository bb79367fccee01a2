"""ADM image UNet for the image-domain consistency model (port of
``cmtts_tpu/models/unet.py``).

Re-design of the reference ``model/cm_tool/unet.py`` (inherited from
openai/consistency_models): timestep-conditioned ResBlocks with optional
FiLM (scale-shift) conditioning, attention at configured downsample rates,
skip-cat decoder, class conditioning.

NCHW activations.  Submodules carry the flax module names
(``input_{i}_{j}`` / ``middle__{j}`` / ``output_{i}_{j}``, ``time_0`` /
``time_2``, ``label_emb``, ``out_norm_f`` / ``out_conv_f``; inside a
ResBlock ``in_norm``, ``in_conv``, ``emb_proj``, ``out_norm``, ``out_conv``,
``skip``; inside an attention block ``norm``, ``qkv``, ``proj_out``), so
that :mod:`cmtts_tpu_torch.convert` maps a flax tree onto them
mechanically.  GroupNorm groups consecutive channels in both layouts, and
the attention keeps the flax channel layout of its qkv projection.

:func:`convert_torch_unet` is a numpy copy of the JAX package's converter
(reference UNetModel state dict -> flax tree).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cmtts_tpu_torch.models.init import lecun_normal_

NUM_CLASSES = 1000  # reference script_util.py NUM_CLASSES


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """[cos | sin] sinusoidal embedding (cm_tool/nn.py:121-139 — the image
    path puts cos FIRST, unlike the TTS denoiser's [sin | cos])."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


@dataclass(frozen=True)
class UNetConfig:
    """Mirrors the reference UNetModel constructor (unet.py:549-570)."""

    image_size: int = 64
    in_channels: int = 3
    model_channels: int = 128
    out_channels: int = 3
    num_res_blocks: int = 2
    attention_resolutions: tuple[int, ...] = (8, 16)  # downsample rates
    dropout: float = 0.0
    channel_mult: tuple[float, ...] = (1, 2, 3, 4)
    conv_resample: bool = True
    num_classes: int | None = None
    num_heads: int = 1
    num_head_channels: int = -1
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_new_attention_order: bool = False

    def heads_for(self, ch: int, upsample: bool = False) -> int:
        if self.num_head_channels != -1:
            assert ch % self.num_head_channels == 0
            return ch // self.num_head_channels
        if upsample and self.num_heads_upsample != -1:
            return self.num_heads_upsample
        return self.num_heads


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32, C, eps 1e-5) computed in float32 (cm_tool/nn.py:19-21,
    111-118)."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-5)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).type_as(x)


def _conv3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1)


def _upsample_nearest(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _dropout(x, rate: float, generator, deterministic: bool):
    """flax ``nn.Dropout``: keep with 1 - rate and scale by 1 / (1 - rate),
    the mask drawn from ``generator``."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class ImageResBlock(nn.Module):
    """ResBlock with optional FiLM conditioning and fused up/down
    resampling (reference unet.py:143-256)."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, dropout: float,
                 use_scale_shift_norm: bool, up: bool = False,
                 down: bool = False):
        super().__init__()
        self.dropout = dropout
        self.use_scale_shift_norm = use_scale_shift_norm
        self.up, self.down = up, down
        self.in_norm = GroupNorm32(in_ch)
        self.in_conv = _conv3(in_ch, out_ch)
        self.emb_proj = nn.Linear(
            emb_dim, 2 * out_ch if use_scale_shift_norm else out_ch)
        self.out_norm = GroupNorm32(out_ch)
        self.out_conv = _conv3(out_ch, out_ch)
        if out_ch != in_ch:
            self.skip = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, emb, generator=None, deterministic: bool = True):
        h = F.silu(self.in_norm(x))
        if self.up:
            h, x = _upsample_nearest(h), _upsample_nearest(x)
        elif self.down:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.in_conv(h)
        emb_out = self.emb_proj(F.silu(emb))[:, :, None, None]
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out, 2, dim=1)
            h = self.out_norm(h) * (1.0 + scale) + shift
        else:
            h = self.out_norm(h + emb_out)
        h = F.silu(h)
        h = _dropout(h, self.dropout, generator, deterministic)
        h = self.out_conv(h)
        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class ImageAttention(nn.Module):
    """Spatial self-attention (reference unet.py:259-329) in the flax
    channel layout: the width-1 qkv projection's 3C channels split into q,
    k and v (C each), then each into (heads, d); q and k are each scaled
    by d^-1/4 and the softmax is taken in float32."""

    def __init__(self, channels: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x):
        B, C, H, W = x.shape
        nh, d = self.num_heads, C // self.num_heads
        qkv = self.qkv(self.norm(x).reshape(B, C, H * W))
        # (B, 3, heads, d, HW) -> q, k, v as (B, heads, HW, d)
        q, k, v = qkv.reshape(B, 3, nh, d, H * W).transpose(-1, -2).unbind(1)
        scale = 1.0 / math.sqrt(math.sqrt(d))
        a = F.scaled_dot_product_attention(
            (q * scale).float(), (k * scale).float(), v.float(),
            scale=1.0).type_as(x)
        a = self.proj_out(a.transpose(-1, -2).reshape(B, C, H * W))
        return x + a.reshape(B, C, H, W)


class ImageUNet(nn.Module):
    """The full UNet (reference unet.py:518-787), NCHW.

    forward(x (B, C_in, H, W), timesteps (B,), y (B,) or None)
    -> (B, C_out, H, W).
    """

    def __init__(self, cfg: UNetConfig | None = None):
        super().__init__()
        c = self.cfg = cfg or UNetConfig()
        time_dim = c.model_channels * 4
        self.time_0 = nn.Linear(c.model_channels, time_dim)
        self.time_2 = nn.Linear(time_dim, time_dim)
        if c.num_classes is not None:
            self.label_emb = nn.Embedding(c.num_classes, time_dim)

        def res(name, cin, cout, up=False, down=False):
            self.add_module(name, ImageResBlock(
                cin, cout, time_dim, c.dropout, c.use_scale_shift_norm,
                up=up, down=down))
            return ("res", name)

        def attn(name, ch, upsample=False):
            self.add_module(name, ImageAttention(
                ch, c.heads_for(ch, upsample=upsample)))
            return ("attn", name)

        def conv(name, cin, cout, stride=1):
            self.add_module(name, _conv3(cin, cout, stride))
            return ("conv", name)

        # each block a list of (kind, name) layers applied in order
        ch = int(c.channel_mult[0] * c.model_channels)
        self.input_plan = [[conv("input_0_0", c.in_channels, ch)]]
        chans = [ch]
        ds, i = 1, 1
        for level, mult in enumerate(c.channel_mult):
            for _ in range(c.num_res_blocks):
                out = int(mult * c.model_channels)
                block = [res(f"input_{i}_0", ch, out)]
                ch = out
                if ds in c.attention_resolutions:
                    block.append(attn(f"input_{i}_1", ch))
                self.input_plan.append(block)
                chans.append(ch)
                i += 1
            if level != len(c.channel_mult) - 1:
                if c.resblock_updown:
                    block = [res(f"input_{i}_0", ch, ch, down=True)]
                elif c.conv_resample:
                    block = [conv(f"input_{i}_0", ch, ch, stride=2)]
                else:
                    block = [("pool", None)]
                self.input_plan.append(block)
                chans.append(ch)
                ds *= 2
                i += 1

        self.middle_plan = [res("middle__0", ch, ch), attn("middle__1", ch),
                            res("middle__2", ch, ch)]

        self.output_plan = []
        i = 0
        for level, mult in list(enumerate(c.channel_mult))[::-1]:
            for j in range(c.num_res_blocks + 1):
                out = int(mult * c.model_channels)
                block = [res(f"output_{i}_0", ch + chans.pop(), out)]
                ch = out
                nxt = 1
                if ds in c.attention_resolutions:
                    block.append(attn(f"output_{i}_1", ch, upsample=True))
                    nxt = 2
                if level and j == c.num_res_blocks:
                    if c.resblock_updown:
                        block.append(res(f"output_{i}_{nxt}", ch, ch,
                                         up=True))
                    else:
                        block.append(("up", None))
                        if c.conv_resample:
                            block.append(conv(f"output_{i}_{nxt}", ch, ch))
                    ds //= 2
                self.output_plan.append(block)
                i += 1

        self.out_norm_f = GroupNorm32(ch)
        self.out_conv_f = _conv3(ch, c.out_channels)

    def _run(self, block, h, emb, generator, deterministic):
        for kind, name in block:
            if kind == "res":
                h = getattr(self, name)(h, emb, generator, deterministic)
            elif kind in ("attn", "conv"):
                h = getattr(self, name)(h)
            elif kind == "pool":
                h = F.avg_pool2d(h, 2)
            else:
                h = _upsample_nearest(h)
        return h

    def forward(self, x, timesteps, y=None, generator=None,
                deterministic: bool = True):
        c = self.cfg
        assert (y is not None) == (c.num_classes is not None), \
            "y iff class-conditional"
        emb = self.time_0(timestep_embedding(timesteps, c.model_channels)
                          .to(x.dtype))
        emb = self.time_2(F.silu(emb))
        if c.num_classes is not None:
            emb = emb + self.label_emb(y)
        hs = []
        h = x
        for block in self.input_plan:
            h = self._run(block, h, emb, generator, deterministic)
            hs.append(h)
        h = self._run(self.middle_plan, h, emb, generator, deterministic)
        for block in self.output_plan:
            h = self._run(block, torch.cat([h, hs.pop()], dim=1), emb,
                          generator, deterministic)
        return self.out_conv_f(F.silu(self.out_norm_f(h)))


def create_image_unet(image_size: int, num_channels: int,
                      num_res_blocks: int, channel_mult: str = "",
                      learn_sigma: bool = False, class_cond: bool = False,
                      attention_resolutions: str = "16", num_heads: int = 1,
                      num_head_channels: int = -1,
                      num_heads_upsample: int = -1,
                      use_scale_shift_norm: bool = False, dropout: float = 0.0,
                      resblock_updown: bool = False,
                      use_new_attention_order: bool = False) -> ImageUNet:
    """Factory mirroring reference ``create_model`` (script_util.py:129-183):
    per-size default channel multipliers, attention ds from resolution
    strings, 3-channel RGB in, 3 or 6 (learn_sigma) out."""
    if channel_mult == "":
        mults = {512: (0.5, 1, 1, 2, 2, 4, 4), 256: (1, 1, 2, 2, 4, 4),
                 128: (1, 1, 2, 3, 4), 64: (1, 2, 3, 4)}
        if image_size not in mults:
            raise ValueError(f"unsupported image size: {image_size}")
        mult = mults[image_size]
    else:
        mult = tuple(int(m) for m in channel_mult.split(","))
    attn_ds = tuple(image_size // int(r)
                    for r in str(attention_resolutions).split(","))
    cfg = UNetConfig(
        image_size=image_size,
        in_channels=3,
        model_channels=num_channels,
        out_channels=6 if learn_sigma else 3,
        num_res_blocks=num_res_blocks,
        attention_resolutions=attn_ds,
        dropout=dropout,
        channel_mult=mult,
        num_classes=NUM_CLASSES if class_cond else None,
        num_heads=num_heads,
        num_head_channels=num_head_channels,
        num_heads_upsample=num_heads_upsample,
        use_scale_shift_norm=use_scale_shift_norm,
        resblock_updown=resblock_updown,
        use_new_attention_order=use_new_attention_order,
    )
    return ImageUNet(cfg)


ZERO_INIT = ("out_conv", "proj_out", "out_conv_f")


def init_like_flax(unet: ImageUNet, generator: torch.Generator) -> ImageUNet:
    """Re-initialise ``unet`` in place with the distributions the JAX
    module's ``init`` draws from (the draws themselves differ): LeCun-normal
    kernels truncated at two standard deviations for every conv and dense,
    zero kernels for the layers flax zero-inits (each ResBlock's
    ``out_conv``, each attention's ``proj_out`` and the head's
    ``out_conv_f``), zero biases, unit GroupNorm scales, and the class
    table normal(features^-0.5) as flax's default ``Embed`` draws it."""
    with torch.no_grad():
        for name, m in unet.named_modules():
            leaf = name.rpartition(".")[2]
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                if leaf in ZERO_INIT:
                    nn.init.zeros_(m.weight)
                else:
                    lecun_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, m.weight.shape[1] ** -0.5,
                                generator=generator)
    return unet


# ---------------------------------------------------------------------------
# torch checkpoint conversion (numpy copy of the JAX package's)
# ---------------------------------------------------------------------------

def convert_torch_unet(state_dict: dict, cfg: UNetConfig) -> dict:
    """Reference UNetModel state dict -> ImageUNet flax params.

    Walks the torch key space (``input_blocks.{i}.{j}.*`` etc.) and maps
    each layer kind onto the mirrored flax names; conv kernels
    (O, I, kh, kw) -> (kh, kw, I, O), linears (O, I) -> (I, O), GroupNorm
    weight/bias -> scale/bias.  The qkv/proj_out 1x1 convs are stored as
    width-1 convs in both frameworks.
    """
    params: dict = {}

    def put(path, leaf, value):
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value

    def conv_k(w):
        w = np.asarray(w)
        if w.ndim == 4:
            return np.transpose(w, (2, 3, 1, 0))
        return np.transpose(w, (2, 1, 0))  # conv1d (O,I,k)->(k,I,O)

    sub_map = {
        "in_layers.0": ("in_norm", "norm"),
        "in_layers.2": ("in_conv", "conv"),
        "emb_layers.1": ("emb_proj", "dense"),
        "out_layers.0": ("out_norm", "norm"),
        "out_layers.3": ("out_conv", "conv"),
        "skip_connection": ("skip", "conv"),
        "norm": ("norm", "norm"),
        # torch stores these as 2-D 1x1 convs; the flax attention runs on
        # the flattened (B, HW, C) sequence with width-1 1-D convs
        "qkv": ("qkv", "conv1"),
        "proj_out": ("proj_out", "conv1"),
        "conv": (None, "conv"),   # Upsample.conv -> the block itself
        "op": (None, "conv"),     # Downsample conv -> the block itself
    }

    for key, w in state_dict.items():
        w = np.asarray(w)
        parts = key.split(".")
        if parts[0] == "time_embed":
            put([f"time_{parts[1]}"],
                "kernel" if parts[2] == "weight" else "bias",
                w.T if parts[2] == "weight" else w)
            continue
        if parts[0] == "label_emb":
            put(["label_emb"], "embedding", w)
            continue
        if parts[0] == "out":
            name = "out_norm_f" if parts[1] == "0" else "out_conv_f"
            if parts[1] == "0":
                put([name], "scale" if parts[2] == "weight" else "bias", w)
            else:
                put([name], "kernel" if parts[2] == "weight" else "bias",
                    conv_k(w) if parts[2] == "weight" else w)
            continue
        if parts[0] in ("input_blocks", "middle_block", "output_blocks"):
            if parts[0] == "middle_block":
                i, j, rest = "", parts[1], parts[2:]
                flax_block = f"middle_{i}_{j}"
            else:
                stem = "input" if parts[0] == "input_blocks" else "output"
                i, j, rest = parts[1], parts[2], parts[3:]
                flax_block = f"{stem}_{i}_{j}"
            if rest[0] == "weight" or rest[0] == "bias":
                # plain conv block (input_blocks.0.0, conv up/downsample)
                put([flax_block], "kernel" if rest[0] == "weight" else "bias",
                    conv_k(w) if rest[0] == "weight" else w)
                continue
            sub = ".".join(rest[:-1])
            leafk = rest[-1]
            if sub not in sub_map:
                raise KeyError(f"unmapped torch key {key}")
            flax_sub, kind = sub_map[sub]
            path = [flax_block] + ([flax_sub] if flax_sub else [])
            if kind == "norm":
                put(path, "scale" if leafk == "weight" else "bias", w)
            elif kind == "dense":
                put(path, "kernel" if leafk == "weight" else "bias",
                    w.T if leafk == "weight" else w)
            elif kind == "conv1":
                if leafk == "weight":
                    # (O, I, 1, 1) or (O, I, 1) -> (1, I, O)
                    w = w.reshape(w.shape[0], w.shape[1], 1)
                    w = np.transpose(w, (2, 1, 0))
                put(path, "kernel" if leafk == "weight" else "bias", w)
            else:
                put(path, "kernel" if leafk == "weight" else "bias",
                    conv_k(w) if leafk == "weight" else w)
            continue
        raise KeyError(f"unmapped torch key {key}")

    return params
