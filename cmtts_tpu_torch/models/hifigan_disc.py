"""HiFi-GAN discriminators (MPD + MSD) and the LSGAN losses for training the
vocoder (port of ``cmtts_tpu/models/hifigan_disc.py``).

- MPD: one sub-discriminator per period p in (2, 3, 5, 7, 11).  The
  waveform (B, T) is reflect-padded to a multiple of p and viewed as
  (B, 1, T/p, p); 2-D convs of kernel (5, 1) and stride (3, 1), then a
  (3, 1) conv to one logit channel.
- MSD: three sub-discriminators on x, avgpool(x) and avgpool^2(x), grouped
  1-D convs of kernel up to 41 and stride up to 4.

Every conv is a :class:`WNConv`: the kernel is ``v * g / ||v||`` over all
but the out-channel axis, with ``v``, ``g`` and ``bias`` its own
parameters (the flax module's three leaves), and its padding is XLA's
"SAME": asymmetric at stride > 1, which neither torch's ``padding="same"``
(it refuses stride > 1) nor a symmetric pad gives.

A discriminator returns one ``(features, logits)`` pair per
sub-discriminator, MPD first; features are channels-first (the JAX
package's are channels-last), the last feature is the logit map, and the
logits flatten as the JAX package's do (time-major, then p).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from cmtts_tpu_torch.models.init import lecun_normal_

DISC_LRELU_SLOPE = 0.1


@dataclass(frozen=True)
class HiFiGANDiscConfig:
    periods: tuple[int, ...] = (2, 3, 5, 7, 11)
    # width multiplier: 1.0 = paper scale; tests shrink it
    mpd_channels: tuple[int, ...] = (32, 128, 512, 1024, 1024)
    msd_channels: tuple[int, ...] = (128, 128, 256, 512, 1024, 1024, 1024)
    msd_groups: tuple[int, ...] = (1, 4, 16, 16, 16, 16, 1)
    msd_kernels: tuple[int, ...] = (15, 41, 41, 41, 41, 41, 5)
    msd_strides: tuple[int, ...] = (1, 2, 2, 4, 4, 1, 1)
    n_scales: int = 3


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of an axis of n at kernel k and stride s:
    ceil(n / s) outputs, the odd sample of the pad after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class WNConv(nn.Module):
    """Conv (1-D or 2-D by the rank of ``kernel_size``) with the weight-norm
    reparameterisation w = g * v / sqrt(sum(v^2) + 1e-12).  ``g`` starts at
    ||v||, so a fresh WNConv is a plain conv with kernel ``v``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: tuple[int, ...],
                 strides: tuple[int, ...] | None = None, groups: int = 1):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides or (1,) * len(self.kernel_size))
        self.groups = groups
        self.v = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                          *self.kernel_size))
        self.g = nn.Parameter(torch.empty(out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        nn.init.kaiming_uniform_(self.v, a=5 ** 0.5)
        self.reset_g()

    @torch.no_grad()
    def reset_g(self):
        self.g.copy_(self.v.flatten(1).norm(dim=1))

    def weight(self) -> torch.Tensor:
        axes = tuple(range(1, self.v.ndim))
        norm = torch.sqrt((self.v ** 2).sum(dim=axes, keepdim=True) + 1e-12)
        return self.v * (self.g.view(-1, *(1,) * len(axes)) / norm)

    def forward(self, x):
        pads = []
        for n, k, s in zip(reversed(x.shape[2:]), reversed(self.kernel_size),
                           reversed(self.strides)):
            pads += same_pads(n, k, s)   # F.pad lists the last axis first
        conv = F.conv1d if len(self.kernel_size) == 1 else F.conv2d
        return conv(F.pad(x, pads), self.weight(), self.bias, self.strides,
                    groups=self.groups)


class PeriodDiscriminator(nn.Module):
    """One MPD branch at a fixed period p."""

    def __init__(self, period: int, channels: tuple[int, ...]):
        super().__init__()
        self.period = period
        self.n = len(channels)
        cin = 1
        for i, ch in enumerate(channels):
            stride = (3, 1) if i < self.n - 1 else (1, 1)
            self.add_module(f"conv_{i}", WNConv(cin, ch, (5, 1), stride))
            cin = ch
        self.conv_post = WNConv(cin, 1, (3, 1))

    def forward(self, wav):
        """wav (B, T) -> (features, logits (B, T' * p))."""
        p = self.period
        B, T = wav.shape
        pad = (-T) % p
        x = F.pad(wav[:, None], (0, pad), mode="reflect") if pad \
            else wav[:, None]
        x = x.view(B, 1, (T + pad) // p, p)
        feats = []
        for i in range(self.n):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), DISC_LRELU_SLOPE)
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        return feats, x.reshape(B, -1)


class ScaleDiscriminator(nn.Module):
    """One MSD branch."""

    def __init__(self, channels, groups, kernels, strides):
        super().__init__()
        self.n = len(channels)
        cin = 1
        for i, ch in enumerate(channels):
            self.add_module(f"conv_{i}", WNConv(
                cin, ch, (kernels[i],), (strides[i],), groups[i]))
            cin = ch
        self.conv_post = WNConv(cin, 1, (3,))

    def forward(self, wav):
        """wav (B, T) -> (features, logits (B, T'))."""
        x = wav[:, None]
        feats = []
        for i in range(self.n):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), DISC_LRELU_SLOPE)
            feats.append(x)
        x = self.conv_post(x)
        feats.append(x)
        return feats, x[:, 0]


def avg_pool1d(x):
    """torch AvgPool1d(4, 2, padding=2) over (B, T), the padded zeros
    counted."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2)[:, 0]


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, cfg: HiFiGANDiscConfig = HiFiGANDiscConfig()):
        super().__init__()
        self.periods = tuple(cfg.periods)
        for p in self.periods:
            self.add_module(f"p{p}", PeriodDiscriminator(p, cfg.mpd_channels))

    def forward(self, wav):
        return [getattr(self, f"p{p}")(wav) for p in self.periods]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, cfg: HiFiGANDiscConfig = HiFiGANDiscConfig()):
        super().__init__()
        self.n_scales = cfg.n_scales
        for s in range(cfg.n_scales):
            self.add_module(f"s{s}", ScaleDiscriminator(
                cfg.msd_channels, cfg.msd_groups, cfg.msd_kernels,
                cfg.msd_strides))

    def forward(self, wav):
        outs, x = [], wav
        for s in range(self.n_scales):
            if s > 0:
                x = avg_pool1d(x)
            outs.append(getattr(self, f"s{s}")(x))
        return outs


class HiFiGANDiscriminators(nn.Module):
    """MPD + MSD: one call returns every sub-discriminator's output."""

    def __init__(self, cfg: HiFiGANDiscConfig | None = None):
        super().__init__()
        self.cfg = cfg or HiFiGANDiscConfig()
        self.mpd = MultiPeriodDiscriminator(self.cfg)
        self.msd = MultiScaleDiscriminator(self.cfg)

    def forward(self, wav):
        return self.mpd(wav) + self.msd(wav)


@torch.no_grad()
def init_like_flax(disc: nn.Module,
                   generator: torch.Generator) -> nn.Module:
    """Re-initialise every :class:`WNConv` of ``disc`` in place as the JAX
    module's ``init`` draws it: ``v`` LeCun-normal (fan-in k x in/groups),
    ``g`` = ||v||, ``bias`` zero."""
    for m in disc.modules():
        if isinstance(m, WNConv):
            lecun_normal_(m.v, m.v[0].numel(), generator)
            m.reset_g()
            nn.init.zeros_(m.bias)
    return disc


# ---------------------------------------------------------------------------
# HiFi-GAN training losses (LSGAN form)
# ---------------------------------------------------------------------------

def discriminator_loss(real_outs, fake_outs):
    """sum_k mean((1 - D_k(y))^2) + mean(D_k(y_hat)^2)."""
    loss = 0.0
    for (_, dr), (_, df) in zip(real_outs, fake_outs):
        loss = loss + ((1.0 - dr) ** 2).mean() + (df ** 2).mean()
    return loss


def generator_adv_loss(fake_outs):
    """sum_k mean((1 - D_k(y_hat))^2)."""
    loss = 0.0
    for _, df in fake_outs:
        loss = loss + ((1.0 - df) ** 2).mean()
    return loss


def feature_matching_loss(real_outs, fake_outs):
    """Sum over discriminators and layers of mean |f_real - f_fake| (the
    trainer's ``lambda_fm`` carries the official factor 2)."""
    loss = 0.0
    for (fr, _), (ff, _) in zip(real_outs, fake_outs):
        for r, f in zip(fr, ff):
            loss = loss + (r - f).abs().mean()
    return loss
