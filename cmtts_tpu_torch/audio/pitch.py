"""Pitch math (port of ``cmtts_tpu/audio/pitch.py``): the in-graph half
(f0 bucketing, f0 de/normalisation and the inverse CWT used by the variance
adaptor) and the host numpy half, copied: the helpers the data feed uses
and the extraction functions preprocessing uses (continuous log-f0, the
Mexican-hat CWT, the autocorrelation f0 tracker, ``get_pitch``).
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


def get_cont_lf0(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    uv, cont = convert_continuous_f0(f0)
    return uv, np.log(cont)


# -- Mexican-hat CWT (pycwt-compatible) -------------------------------------

_MEXHAT_FOURIER_FACTOR = 2.0 * np.pi / np.sqrt(2.5)  # m=2 DOG wavelet


def cwt_mexican_hat(signal: np.ndarray, dt: float = 0.005, dj: float = 1.0,
                    s0: float = 0.01, J: int = 9) -> tuple[np.ndarray, np.ndarray]:
    """Continuous wavelet transform with the Mexican-hat (DOG m=2) mother.

    FFT-based implementation matching pycwt's conventions, so outputs are
    interchangeable with the reference's ``get_lf0_cwt``
    (utils/pitch_tools.py:179-195: dt=0.005, dj=1, s0=2*dt, J=9 → 10
    scales).  Returns (W real part, (J+1, N) transposed to (N, J+1)
    by the caller) and the scale array s0 * 2^(j*dj).
    """
    x = np.asarray(signal, dtype=np.float64)
    n = len(x)
    # zero-pad to next power of two (pycwt default)
    n_fft = int(2 ** np.ceil(np.log2(n)))
    x_hat = np.fft.fft(x - x.mean(), n=n_fft)
    omega = 2.0 * np.pi * np.fft.fftfreq(n_fft, d=dt)
    scales = s0 * 2.0 ** (dj * np.arange(J + 1))
    W = np.empty((J + 1, n), dtype=np.complex128)
    m = 2
    from math import gamma as _gamma

    # DOG(m=2) in Fourier space: -(i^m)/sqrt(gamma(m+1/2)) * (s w)^m exp(-(s w)^2/2)
    norm_const = -((1j) ** m) / np.sqrt(_gamma(m + 0.5))
    for j, s in enumerate(scales):
        sw = s * omega
        psi_hat = norm_const * (sw ** m) * np.exp(-0.5 * sw ** 2)
        # pycwt energy normalization: sqrt(2 pi s / dt)
        psi_hat = psi_hat * np.sqrt(2.0 * np.pi * s / dt)
        W[j] = np.fft.ifft(x_hat * np.conj(psi_hat), n=n_fft)[:n]
    return W, scales


def get_lf0_cwt(lf0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N,) log-f0 -> ((N, 10) real CWT, scales).  Reference :179-195."""
    W, scales = cwt_mexican_hat(lf0, dt=0.005, dj=1.0, s0=0.01, J=9)
    return np.real(W).T, scales


def norm_scale(cwt: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Standardize each scale over time (reference :198-203)."""
    mean = cwt.mean(0)[None, :]
    std = cwt.std(0)[None, :]
    return (cwt - mean) / std, mean, std


def get_lf0_cwt_norm(f0s, mean, std):
    """Batch CWT of normalized continuous log-f0 (reference :215-241)."""
    out_specs, out_scales, means, stds = [], [], [], []
    for f0 in f0s:
        _, cont_lf0 = get_cont_lf0(f0)
        cont_norm = (cont_lf0 - mean) / std
        cwt, scales = get_lf0_cwt(cont_norm)
        cwt_norm, m, s = norm_scale(cwt)
        out_specs.append(cwt_norm)
        out_scales.append(scales)
        means.append(m)
        stds.append(s)
    return out_specs, out_scales, means, stds


# -- Autocorrelation pitch tracker (Praat to_pitch_ac substitute) -----------

def estimate_f0_acf(
    wav: np.ndarray,
    sr: int,
    hop_length: int,
    f0_floor: float = 80.0,
    f0_ceil: float = 750.0,
    voicing_threshold: float = 0.45,
) -> np.ndarray:
    """Frame-wise f0 via windowed normalized autocorrelation.

    Substitute for parselmouth's ``to_pitch_ac``
    (reference utils/pitch_tools.py:102-104); returns 0 for unvoiced
    frames.  Good enough for preprocessing parity at corpus scale; a
    dedicated tracker can be swapped in via the same signature.
    """
    frame_len = int(3 * sr / f0_floor)
    frame_len = min(frame_len, len(wav))
    n_frames = max(1 + (len(wav) - frame_len) // hop_length, 1) if len(wav) >= frame_len else 1
    lag_min = int(sr / f0_ceil)
    lag_max = min(int(sr / f0_floor), frame_len - 1)
    f0 = np.zeros(n_frames, dtype=np.float64)
    window = np.hanning(frame_len)
    for i in range(n_frames):
        start = i * hop_length
        frame = wav[start : start + frame_len]
        if len(frame) < frame_len:
            break
        frame = (frame - frame.mean()) * window
        power = float(np.dot(frame, frame))
        if power < 1e-9:
            continue
        ac = np.correlate(frame, frame, mode="full")[frame_len - 1 :]
        ac = ac / (ac[0] + 1e-12)
        seg = ac[lag_min : lag_max + 1]
        if seg.size == 0:
            continue
        k = int(np.argmax(seg)) + lag_min
        if ac[k] < voicing_threshold:
            continue
        # parabolic interpolation around the peak
        if 1 <= k < len(ac) - 1:
            denom = ac[k - 1] - 2 * ac[k] + ac[k + 1]
            delta = 0.5 * (ac[k - 1] - ac[k + 1]) / denom if abs(denom) > 1e-12 else 0.0
            k = k + float(np.clip(delta, -1, 1))
        f0[i] = sr / k
    return f0


def get_pitch(wav: np.ndarray, n_mel_frames: int, sr: int, hop_length: int):
    """f0 + coarse pitch aligned to the mel frames.

    Mirrors the reference alignment dance (utils/pitch_tools.py:81-118):
    pad the tracker output to the mel length with a small left pad.
    """
    f0 = estimate_f0_acf(wav, sr, hop_length)
    f0 = f0[: max(n_mel_frames - 8, 0)]
    pad_size = 2 if hop_length == 256 else 4
    lpad = pad_size * 2
    rpad = max(n_mel_frames - len(f0) - lpad, 0)
    f0 = np.pad(f0, (lpad, rpad), mode="constant")
    if len(f0) < n_mel_frames:
        f0 = np.concatenate([f0, np.full(n_mel_frames - len(f0), f0[-1] if len(f0) else 0.0)])
    f0 = f0[:n_mel_frames]
    return f0, f0_to_coarse_np(f0.copy())
