"""Pitch math (port of ``cmtts_tpu/audio/pitch.py``): the in-graph half
(f0 bucketing, f0 de/normalisation and the inverse CWT used by the variance
adaptor) and the host numpy helpers the data feed uses, copied.  The
extraction half (f0 tracking, forward CWT) belongs to preprocessing and is
not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

# f0 coarse-bucketing constants (reference utils/pitch_tools.py:19-23)
F0_BIN = 256
F0_MAX = 1100.0
F0_MIN = 50.0
F0_MEL_MIN = 1127.0 * np.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * np.log(1.0 + F0_MAX / 700.0)


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Bucketize f0 (Hz) into [1, 255] mel-spaced bins; 0 Hz maps to bin 1.
    Rounds as floor(x + 0.5), like the reference's ``(x + 0.5).long()``."""
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = ((f0_mel - F0_MEL_MIN) * (F0_BIN - 2)
              / (F0_MEL_MAX - F0_MEL_MIN) + 1.0)
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = torch.clamp(f0_mel, 1.0, F0_BIN - 1)
    return torch.floor(f0_mel + 0.5).long()


def norm_f0(f0, uv, pitch_norm: str, f0_mean: float, f0_std: float,
            eps: float, use_uv: bool):
    """Normalize f0 ('standard' or 'log'); zero unvoiced if use_uv."""
    if pitch_norm == "standard":
        f0 = (f0 - f0_mean) / f0_std
    elif pitch_norm == "log":
        f0 = torch.log2(f0 + eps)
    if uv is not None and use_uv:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    return f0


def denorm_f0(f0, uv, pitch_norm: str, f0_mean: float, f0_std: float,
              use_uv: bool, pitch_padding=None):
    """Inverse of :func:`norm_f0` (reference utils/pitch_tools.py:64-78)."""
    if pitch_norm == "standard":
        f0 = f0 * f0_std + f0_mean
    elif pitch_norm == "log":
        f0 = 2.0 ** f0
    if uv is not None and use_uv:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    if pitch_padding is not None:
        f0 = torch.where(pitch_padding, torch.zeros_like(f0), f0)
    return f0


def inverse_cwt(cwt_spec: torch.Tensor, mask=None) -> torch.Tensor:
    """Normalized log-f0 (B, T) from a CWT spectrogram (B, T, n_scales):
    weighted sum over scales with (i + 3.5)^-2.5 weights, then per-sequence
    standardisation over T.

    ``mask=None`` standardises over the whole (padded) length with Bessel's
    N-1, as the reference does; a ``mask`` (B, T; True = valid) standardises
    over valid frames only (n >= 2, +1e-12 under the root).
    """
    n_scales = cwt_spec.shape[-1]
    b = (torch.arange(n_scales, dtype=cwt_spec.dtype, device=cwt_spec.device)
         + 1.0 + 2.5) ** (-2.5)
    rec = (cwt_spec * b[None, None, :]).sum(-1)
    if mask is None:
        mean = rec.mean(-1, keepdim=True)
        n = rec.shape[-1]
        var = ((rec - mean) ** 2).sum(-1, keepdim=True) / max(n - 1, 1)
        return (rec - mean) / torch.sqrt(var)
    m = mask.to(rec.dtype)
    n = torch.clamp(m.sum(-1, keepdim=True), min=2.0)
    mean = (rec * m).sum(-1, keepdim=True) / n
    var = (((rec - mean) ** 2) * m).sum(-1, keepdim=True) / (n - 1.0)
    return (rec - mean) / torch.sqrt(var + 1e-12)


def cwt2f0(cwt_spec, mean, std, mask=None):
    """CWT spec (B,T,10) + per-utterance stats -> f0 in Hz (B,T)."""
    f0 = inverse_cwt(cwt_spec, mask)
    f0 = f0 * std[:, None] + mean[:, None]
    return torch.exp(f0)


def cwt2f0_norm(cwt_spec, mean, std, t_mel: int, pitch_norm: str,
                f0_mean: float, f0_std: float, eps: float, mask=None):
    """cwt2f0, then re-normalise and pad to ``t_mel`` frames by repeating
    the last frame (or truncate)."""
    f0 = cwt2f0(cwt_spec, mean, std, mask)
    t = f0.shape[1]
    if t < t_mel:
        f0 = torch.cat([f0, f0[:, -1:].expand(-1, t_mel - t)], dim=1)
    elif t > t_mel:
        f0 = f0[:, :t_mel]
    return norm_f0(f0, None, pitch_norm, f0_mean, f0_std, eps, use_uv=False)


# -- host side (numpy), copied from cmtts_tpu/audio/pitch.py ----------------

def f0_to_coarse_np(f0: np.ndarray) -> np.ndarray:
    f0_mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    pos = f0_mel > 0
    f0_mel[pos] = (f0_mel[pos] - F0_MEL_MIN) * (F0_BIN - 2) / (F0_MEL_MAX - F0_MEL_MIN) + 1
    f0_mel[f0_mel <= 1] = 1
    f0_mel[f0_mel > F0_BIN - 1] = F0_BIN - 1
    coarse = np.rint(f0_mel).astype(np.int64)
    assert coarse.max() <= 255 and coarse.min() >= 1, (coarse.max(), coarse.min())
    return coarse


def norm_f0_np(f0, uv, pitch_norm, f0_mean, f0_std, eps, use_uv):
    if pitch_norm == "standard":
        f0 = (f0 - f0_mean) / f0_std
    elif pitch_norm == "log":
        f0 = np.log2(f0 + eps)
    if uv is not None and use_uv:
        f0[uv > 0] = 0
    return f0


def norm_interp_f0(f0: np.ndarray, pitch_cfg) -> tuple[np.ndarray, np.ndarray]:
    """Normalize then linearly interpolate through unvoiced gaps.

    Parity: reference ``norm_interp_f0`` (utils/pitch_tools.py:50-61).
    ``pitch_cfg`` is a :class:`cmtts_tpu_torch.core.config.PitchConfig`.
    """
    f0 = f0.astype(np.float64).copy()
    uv = (f0 == 0).astype(np.float32)
    f0 = norm_f0_np(
        f0, uv, pitch_cfg.pitch_norm, pitch_cfg.f0_mean, pitch_cfg.f0_std,
        pitch_cfg.pitch_norm_eps, pitch_cfg.use_uv,
    )
    n_uv = int(uv.sum())
    if n_uv == len(f0):
        f0[:] = 0
    elif n_uv > 0:
        voiced = np.where(uv == 0)[0]
        f0[uv > 0] = np.interp(np.where(uv > 0)[0], voiced, f0[voiced])
    return f0.astype(np.float32), uv


def convert_continuous_f0(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uv flags + gap-interpolated continuous f0 (reference :138-169)."""
    f0 = np.copy(f0).astype(np.float64)
    uv = np.float32(f0 != 0)
    if (f0 == 0).all():
        return uv, f0
    nz = np.where(f0 != 0)[0]
    f0[: nz[0]] = f0[nz[0]]
    f0[nz[-1]:] = f0[nz[-1]]
    nz = np.where(f0 != 0)[0]
    cont = np.interp(np.arange(len(f0)), nz, f0[nz])
    return uv, cont
