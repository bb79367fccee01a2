"""Variance adaptor, inference path (port of
``cmtts_tpu/models/variance.py``): duration, phoneme-level energy, the
static-shape ``mel2ph`` length regulator and the CWT pitch branch with uv.

Pitch types ``frame`` and ``ph`` and frame-level energy are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from cmtts_tpu_torch.audio.pitch import cwt2f0_norm, denorm_f0, f0_to_coarse
from cmtts_tpu_torch.core.config import (
    EnergyConfig,
    PitchConfig,
    TransformerConfig,
    VarianceEmbeddingConfig,
    VariancePredictorConfig,
)
from cmtts_tpu_torch.models.encoder import (
    PositionalEmbedding,
    positions_from_mask,
)


def dur_to_mel2ph(dur: torch.Tensor, pad_mask: torch.Tensor,
                  t_mel: int) -> torch.Tensor:
    """Durations (B, T_txt) -> mel2ph (B, t_mel), 1-indexed, 0 = padding;
    frames beyond sum(dur) get 0."""
    dur = torch.round(dur.float()).long() * (~pad_mask).long()
    cumsum = torch.cumsum(dur, dim=1)
    cumsum_prev = torch.cat([torch.zeros_like(cumsum[:, :1]),
                             cumsum[:, :-1]], dim=1)
    pos = torch.arange(t_mel, device=dur.device)[None, None, :]
    token_idx = torch.arange(1, dur.shape[1] + 1,
                             device=dur.device)[None, :, None]
    member = (pos >= cumsum_prev[:, :, None]) & (pos < cumsum[:, :, None])
    return (token_idx * member.long()).sum(dim=1)


def gather_by_mel2ph(x_ph: torch.Tensor, mel2ph: torch.Tensor) -> torch.Tensor:
    """x[b, t] = x_ph[b, mel2ph - 1], zeros where mel2ph == 0; indices are
    clipped to the last phone."""
    B, T, C = x_ph.shape
    padded = torch.cat([x_ph.new_zeros(B, 1, C), x_ph], dim=1)
    idx = torch.clamp(mel2ph, 0, T)[:, :, None].expand(-1, -1, C)
    return torch.gather(padded, 1, idx)


class ConvPredictorStack(nn.Module):
    """conv -> ReLU -> LayerNorm tower shared by the predictors."""

    def __init__(self, n_layers: int, in_dim: int, n_chans: int,
                 kernel_size: int, mask_between_layers: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.mask_between_layers = mask_between_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", nn.Conv1d(
                in_dim if i == 0 else n_chans, n_chans, kernel_size,
                padding=(kernel_size - 1) // 2))
            self.add_module(f"ln_{i}", nn.LayerNorm(n_chans, eps=1e-12))

    def forward(self, x, pad_mask):
        nonpad = (~pad_mask).to(x.dtype)[..., None]
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = getattr(self, f"ln_{i}")(torch.relu(x))
            if self.mask_between_layers:
                x = x * nonpad
        return x


class DurationPredictor(nn.Module):
    def __init__(self, in_dim: int, vp: VariancePredictorConfig):
        super().__init__()
        self.stack = ConvPredictorStack(
            vp.dur_predictor_layers, in_dim, vp.filter_size,
            vp.dur_predictor_kernel, mask_between_layers=True)
        self.proj = nn.Linear(vp.filter_size, 1)

    def forward(self, x, pad_mask):
        out = self.proj(self.stack(x, pad_mask))
        out = out * (~pad_mask).to(out.dtype)[..., None]
        return out[..., 0]  # (B, T) log-durations


class VariancePredictor(nn.Module):
    """Pitch/energy predictor: its own positional embedding with a learned
    alpha, conv stack, linear head.  A position counts as padding iff its
    first feature channel is exactly 0 (reference semantics)."""

    def __init__(self, in_dim: int, vp: VariancePredictorConfig, odim: int):
        super().__init__()
        self.pos = PositionalEmbedding(in_dim, 4096, learned_alpha=True)
        self.stack = ConvPredictorStack(
            vp.predictor_layers, in_dim, vp.filter_size, vp.predictor_kernel)
        self.proj = nn.Linear(vp.filter_size, odim)

    def forward(self, x, pad_mask):
        x = x + self.pos(positions_from_mask(x[..., 0] != 0))
        return self.proj(self.stack(x, pad_mask))


class VarianceAdaptor(nn.Module):
    """Duration -> phoneme-level energy -> length regulation -> CWT pitch."""

    def __init__(self, tc: TransformerConfig, vp: VariancePredictorConfig,
                 ve: VarianceEmbeddingConfig, pitch_cfg: PitchConfig,
                 energy_cfg: EnergyConfig):
        super().__init__()
        if ve.use_pitch_embed and pitch_cfg.pitch_type != "cwt":
            raise NotImplementedError(
                f"pitch_type {pitch_cfg.pitch_type!r} is not ported yet")
        if ve.use_energy_embed and energy_cfg.feature != "phoneme_level":
            raise NotImplementedError(
                f"energy feature {energy_cfg.feature!r} is not ported yet")
        H = tc.encoder_hidden
        self.vp = vp
        self.ve = ve
        self.pitch_cfg = pitch_cfg
        self.duration_predictor = DurationPredictor(H, vp)
        if ve.use_pitch_embed:
            cwt_out = 10 + (1 if pitch_cfg.use_uv else 0)
            hc = vp.cwt_hidden_size
            self.cwt_in = nn.Linear(H, hc)
            self.cwt_predictor = VariancePredictor(hc, vp, cwt_out)
            self.cwt_stats = nn.Sequential(OrderedDict([
                ("layers_0", nn.Linear(H, hc)), ("layers_1", nn.ReLU()),
                ("layers_2", nn.Linear(hc, hc)), ("layers_3", nn.ReLU()),
                ("layers_4", nn.Linear(hc, 2)),
            ]))
            self.pitch_embed = nn.Embedding(ve.pitch_n_bins, H)
        if ve.use_energy_embed:
            self.energy_predictor = VariancePredictor(H, vp, 1)
            if ve.energy_quantization == "log":
                bins = np.exp(np.linspace(
                    np.log(max(energy_cfg.energy_min, 1e-8)),
                    np.log(max(energy_cfg.energy_max, 1e-7)),
                    ve.energy_n_bins - 1))
            else:
                bins = np.linspace(energy_cfg.energy_min,
                                   energy_cfg.energy_max,
                                   ve.energy_n_bins - 1)
            self.register_buffer(
                "energy_bins", torch.tensor(bins, dtype=torch.float32),
                persistent=False)
            self.energy_embed = nn.Embedding(ve.energy_n_bins, H)

    def _energy(self, x, control: float):
        """Phoneme-level energy: no padding mask (reference semantics);
        bucketed with searchsorted(side='left')."""
        pad = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
        pred = self.energy_predictor(x, pad)[..., 0]
        idx = torch.searchsorted(self.energy_bins, (pred * control).contiguous())
        return pred, self.energy_embed(idx)

    def _pitch_cwt(self, x_mel, encoder_out, mel2ph, control: float):
        pc = self.pitch_cfg
        pad = torch.zeros(x_mel.shape[:2], dtype=torch.bool,
                          device=x_mel.device)
        cwt_out = self.cwt_predictor(self.cwt_in(x_mel), pad) * control
        stats = self.cwt_stats(encoder_out[:, 0, :])
        f0_mean, f0_std = stats[:, 0], stats[:, 1]
        cwt_mask = (mel2ph > 0) if pc.cwt_masked_std else None
        f0 = cwt2f0_norm(
            cwt_out[..., :10], f0_mean, f0_std * self.vp.cwt_std_scale,
            mel2ph.shape[1], pc.pitch_norm, pc.f0_mean, pc.f0_std,
            pc.pitch_norm_eps, mask=cwt_mask)
        uv = (cwt_out[..., -1] > 0) if pc.use_uv else None
        f0_denorm = denorm_f0(f0, uv, pc.pitch_norm, pc.f0_mean, pc.f0_std,
                              pc.use_uv)
        pred = {"f0_denorm": f0_denorm, "cwt": cwt_out,
                "f0_mean": f0_mean, "f0_std": f0_std}
        return pred, self.pitch_embed(f0_to_coarse(f0_denorm))

    def forward(self, x, src_pad_mask, t_mel: int, p_control: float = 1.0,
                e_control: float = 1.0, d_control: float = 1.0) -> dict:
        log_d_pred = self.duration_predictor(x, src_pad_mask)
        e_pred = None
        if self.ve.use_energy_embed:
            e_pred, e_embed = self._energy(x, e_control)
            x = x + e_embed
        encoder_out = x  # post energy, pre length-regulation

        d_rounded = torch.clamp(
            torch.round(torch.exp(log_d_pred) - 1.0) * d_control, min=0)
        mel2ph = dur_to_mel2ph(d_rounded, src_pad_mask, t_mel)
        mel_lens = torch.clamp(
            torch.round(d_rounded * (~src_pad_mask)).sum(-1).long(),
            max=t_mel)

        x_mel = gather_by_mel2ph(x, mel2ph)
        p_pred = None
        if self.ve.use_pitch_embed:
            p_pred, p_embed = self._pitch_cwt(x_mel, encoder_out, mel2ph,
                                              p_control)
            x_mel = x_mel + p_embed
        return {
            "cond": x_mel,
            "log_d_pred": log_d_pred,
            "d_rounded": d_rounded,
            "p_pred": p_pred,
            "e_pred": e_pred,
            "mel2ph": mel2ph,
            "mel_lens": mel_lens,
            "mel_pad_mask": (torch.arange(t_mel, device=x.device)[None, :]
                             >= mel_lens[:, None]),
        }
