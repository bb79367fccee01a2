"""Variance adaptor (port of ``cmtts_tpu/models/variance.py``): speaker
add, duration, phoneme- or frame-level energy, the static-shape ``mel2ph``
length regulator and the pitch branch (CWT with uv, frame-level f0 with uv,
or phoneme-level f0).

Given targets (training) it is teacher-forced: durations, ``mel2ph``, pitch
and energy embeddings come from the targets, the predictors' inputs carry
the ``predictor_grad`` gradient scale, and the predictor stacks drop out
when a ``generator`` is given.
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
    dropout,
    positions_from_mask,
)


def grad_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Forward identity, backward scaled by ``scale`` (the reference's
    predictor_grad).  Outside autograd it returns ``x`` as it is."""
    if not x.requires_grad:
        return x
    d = x.detach()
    return d + scale * (x - d)


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
                 kernel_size: int, rate: float = 0.0,
                 mask_between_layers: bool = False):
        super().__init__()
        self.n_layers = n_layers
        self.rate = rate
        self.mask_between_layers = mask_between_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", nn.Conv1d(
                in_dim if i == 0 else n_chans, n_chans, kernel_size,
                padding=(kernel_size - 1) // 2))
            self.add_module(f"ln_{i}", nn.LayerNorm(n_chans, eps=1e-12))

    def forward(self, x, pad_mask, generator=None):
        nonpad = (~pad_mask).to(x.dtype)[..., None]
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = getattr(self, f"ln_{i}")(torch.relu(x))
            x = dropout(x, self.rate, generator)
            if self.mask_between_layers:
                x = x * nonpad
        return x


class DurationPredictor(nn.Module):
    def __init__(self, in_dim: int, vp: VariancePredictorConfig):
        super().__init__()
        self.stack = ConvPredictorStack(
            vp.dur_predictor_layers, in_dim, vp.filter_size,
            vp.dur_predictor_kernel, vp.dropout, mask_between_layers=True)
        self.proj = nn.Linear(vp.filter_size, 1)

    def forward(self, x, pad_mask, generator=None):
        out = self.proj(self.stack(x, pad_mask, generator))
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
            vp.predictor_layers, in_dim, vp.filter_size, vp.predictor_kernel,
            vp.dropout)
        self.proj = nn.Linear(vp.filter_size, odim)

    def forward(self, x, pad_mask, generator=None):
        x = x + self.pos(positions_from_mask(x[..., 0] != 0))
        return self.proj(self.stack(x, pad_mask, generator))


class VarianceAdaptor(nn.Module):
    """Speaker add -> duration -> (phoneme-level energy) -> length
    regulation -> pitch -> (frame-level energy)."""

    def __init__(self, tc: TransformerConfig, vp: VariancePredictorConfig,
                 ve: VarianceEmbeddingConfig, pitch_cfg: PitchConfig,
                 energy_cfg: EnergyConfig):
        super().__init__()
        H = tc.encoder_hidden
        self.vp = vp
        self.ve = ve
        self.pitch_cfg = pitch_cfg
        self.energy_feature = energy_cfg.feature
        self.duration_predictor = DurationPredictor(H, vp)
        if ve.use_pitch_embed:
            if pitch_cfg.pitch_type == "cwt":
                cwt_out = 10 + (1 if pitch_cfg.use_uv else 0)
                hc = vp.cwt_hidden_size
                self.cwt_in = nn.Linear(H, hc)
                self.cwt_predictor = VariancePredictor(hc, vp, cwt_out)
                self.cwt_stats = nn.Sequential(OrderedDict([
                    ("layers_0", nn.Linear(H, hc)), ("layers_1", nn.ReLU()),
                    ("layers_2", nn.Linear(hc, hc)), ("layers_3", nn.ReLU()),
                    ("layers_4", nn.Linear(hc, 2)),
                ]))
            else:
                # "frame" predicts f0 and uv per mel frame, "ph" one f0 per
                # phoneme, gathered to frames through mel2ph
                odim = 2 if pitch_cfg.pitch_type == "frame" else 1
                self.pitch_predictor = VariancePredictor(H, vp, odim)
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

    def _energy(self, x, target, control: float, generator):
        """Energy at x's level (phonemes or frames): no padding mask
        (reference semantics); the target (training) or the prediction is
        bucketed with searchsorted(side='left').  The predictor's input
        takes the full gradient, as the reference's does."""
        pad = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
        pred = self.energy_predictor(x, pad, generator)[..., 0]
        src = target if target is not None else pred * control
        idx = torch.searchsorted(self.energy_bins, src.contiguous())
        return pred, self.energy_embed(idx)

    def _pitch_cwt(self, x_mel, encoder_out, mel2ph, p_targets,
                   control: float, generator):
        pc = self.pitch_cfg
        pad = torch.zeros(x_mel.shape[:2], dtype=torch.bool,
                          device=x_mel.device)
        x_in = grad_scale(x_mel, self.vp.predictor_grad)
        cwt_out = self.cwt_predictor(self.cwt_in(x_in), pad,
                                     generator) * control
        # the stats head takes the first phoneme's state with no gradient
        # scale, as the reference's does
        stats = self.cwt_stats(encoder_out[:, 0, :])
        f0_mean, f0_std = stats[:, 0], stats[:, 1]
        cwt_mask = (mel2ph > 0) if pc.cwt_masked_std else None
        if p_targets is not None:
            f0 = cwt2f0_norm(
                p_targets["cwt_spec"], p_targets["f0_mean"],
                p_targets["f0_std"], mel2ph.shape[1], pc.pitch_norm,
                pc.f0_mean, pc.f0_std, pc.pitch_norm_eps, mask=cwt_mask)
            uv = p_targets["uv"]
        else:
            f0 = cwt2f0_norm(
                cwt_out[..., :10], f0_mean, f0_std * self.vp.cwt_std_scale,
                mel2ph.shape[1], pc.pitch_norm, pc.f0_mean, pc.f0_std,
                pc.pitch_norm_eps, mask=cwt_mask)
            uv = (cwt_out[..., -1] > 0) if pc.use_uv else None
        f0_denorm = denorm_f0(f0, uv, pc.pitch_norm, pc.f0_mean, pc.f0_std,
                              pc.use_uv)
        pred = {"pitch_pred": None, "f0_denorm": f0_denorm, "cwt": cwt_out,
                "f0_mean": f0_mean, "f0_std": f0_std}
        return pred, self.pitch_embed(f0_to_coarse(f0_denorm))

    def _pitch_ph(self, encoder_out, mel2ph, p_targets, control: float,
                  generator):
        """Phoneme-level f0 on the pre-regulation states; the coarse ids
        are gathered to frames through mel2ph (0 = padding row)."""
        pc = self.pitch_cfg
        pad = torch.zeros(encoder_out.shape[:2], dtype=torch.bool,
                          device=encoder_out.device)
        x_in = grad_scale(encoder_out, self.vp.predictor_grad)
        pitch_pred = self.pitch_predictor(x_in, pad, generator) * control
        if p_targets is not None and p_targets.get("f0") is not None:
            f0 = p_targets["f0"]   # phoneme-level targets
        else:
            f0 = pitch_pred[..., 0]
        f0_denorm = denorm_f0(f0, None, pc.pitch_norm, pc.f0_mean, pc.f0_std,
                              use_uv=False)
        coarse = f0_to_coarse(f0_denorm)
        padded = torch.cat([torch.zeros_like(coarse[:, :1]), coarse], dim=1)
        pred = {"pitch_pred": pitch_pred, "f0_denorm": f0_denorm,
                "cwt": None, "f0_mean": None, "f0_std": None}
        return pred, self.pitch_embed(torch.gather(padded, 1, mel2ph))

    def _pitch_frame(self, x_mel, mel2ph, p_targets, control: float,
                     generator):
        """Frame-level f0 (and uv); frames past the utterance get f0 = 0."""
        pc = self.pitch_cfg
        pad = torch.zeros(x_mel.shape[:2], dtype=torch.bool,
                          device=x_mel.device)
        x_in = grad_scale(x_mel, self.vp.predictor_grad)
        pitch_pred = self.pitch_predictor(x_in, pad, generator) * control
        if p_targets is not None:
            f0, uv = p_targets["f0"], p_targets["uv"]
        else:
            f0 = pitch_pred[..., 0]
            uv = (pitch_pred[..., 1] > 0) if pc.use_uv else None
        f0_denorm = denorm_f0(f0, uv, pc.pitch_norm, pc.f0_mean, pc.f0_std,
                              pc.use_uv, pitch_padding=mel2ph == 0)
        pred = {"pitch_pred": pitch_pred, "f0_denorm": f0_denorm,
                "cwt": None, "f0_mean": None, "f0_std": None}
        return pred, self.pitch_embed(f0_to_coarse(f0_denorm))

    def forward(self, x, src_pad_mask, t_mel: int, speaker_emb=None,
                p_control: float = 1.0, e_control: float = 1.0,
                d_control: float = 1.0, mel2ph=None, d_targets=None,
                p_targets=None, e_targets=None, generator=None) -> dict:
        """``mel2ph`` (B, t_mel), ``d_targets`` (B, T_txt), ``p_targets``
        (dict) and ``e_targets`` teacher-force the adaptor; ``generator``
        turns on the predictors' dropout."""
        if speaker_emb is not None:
            x = x + speaker_emb[:, None, :]
        log_d_pred = self.duration_predictor(
            grad_scale(x, self.vp.predictor_grad), src_pad_mask, generator)
        e_pred = None
        use_energy = self.ve.use_energy_embed
        if use_energy and self.energy_feature == "phoneme_level":
            e_pred, e_embed = self._energy(x, e_targets, e_control, generator)
            x = x + e_embed
        encoder_out = x  # post speaker and energy, pre length-regulation

        if d_targets is not None:
            d_rounded = d_targets
            if mel2ph is None:
                mel2ph = dur_to_mel2ph(d_targets, src_pad_mask, t_mel)
            mel_lens = torch.clamp(
                (d_targets * (~src_pad_mask)).sum(-1).long(), max=t_mel)
        else:
            d_rounded = torch.clamp(
                torch.round(torch.exp(log_d_pred) - 1.0) * d_control, min=0)
            mel2ph = dur_to_mel2ph(d_rounded, src_pad_mask, t_mel)
            mel_lens = torch.clamp(
                torch.round(d_rounded * (~src_pad_mask)).sum(-1).long(),
                max=t_mel)

        x_mel = gather_by_mel2ph(x, mel2ph)
        p_pred = None
        if self.ve.use_pitch_embed:
            pitch_type = self.pitch_cfg.pitch_type
            if pitch_type == "cwt":
                p_pred, p_embed = self._pitch_cwt(
                    x_mel, encoder_out, mel2ph, p_targets, p_control,
                    generator)
            elif pitch_type == "ph":
                p_pred, p_embed = self._pitch_ph(
                    encoder_out, mel2ph, p_targets, p_control, generator)
            else:
                p_pred, p_embed = self._pitch_frame(
                    x_mel, mel2ph, p_targets, p_control, generator)
            x_mel = x_mel + p_embed
        if use_energy and self.energy_feature == "frame_level":
            e_pred, e_embed = self._energy(x_mel, e_targets, e_control,
                                           generator)
            x_mel = x_mel + e_embed
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
