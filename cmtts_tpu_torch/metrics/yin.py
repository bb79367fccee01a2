# Copied from cmtts_tpu/metrics/yin.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""YIN pitch tracker (de Cheveigné & Kawahara 2002) — replaces the
reference's ``metrics/pitchTracking.py`` (same algorithm: difference
function, cumulative-mean normalization, absolute threshold, parabolic
interpolation).  Pure numpy, FFT-based difference function.
"""

from __future__ import annotations

import numpy as np


def _difference_function(x: np.ndarray, tau_max: int) -> np.ndarray:
    """d(tau) = sum_j (x_j - x_{j+tau})^2 via autocorrelation."""
    n = len(x)
    tau_max = min(tau_max, n)
    # cumulative energy
    x = x.astype(np.float64)
    w = n
    x_cum = np.concatenate([[0.0], np.cumsum(x * x)])
    size = w + tau_max
    nfft = 1 << (size - 1).bit_length()
    fx = np.fft.rfft(x, nfft)
    acf = np.fft.irfft(fx * np.conj(fx))[:tau_max]
    d = x_cum[w - np.arange(tau_max)] - x_cum[0] + x_cum[w] - x_cum[np.arange(tau_max)] - 2 * acf
    # first term: sum_{j=0}^{w-tau-1} x_j^2  = x_cum[w-tau]
    return d


def _cmndf(d: np.ndarray) -> np.ndarray:
    """Cumulative mean normalized difference."""
    tau = np.arange(1, len(d))
    csum = np.cumsum(d[1:])
    out = np.ones_like(d)
    out[1:] = d[1:] * tau / np.maximum(csum, 1e-12)
    return out


def _parabolic(d: np.ndarray, tau: int) -> float:
    if tau <= 0 or tau >= len(d) - 1:
        return float(tau)
    s0, s1, s2 = d[tau - 1], d[tau], d[tau + 1]
    denom = 2 * (2 * s1 - s2 - s0)
    if abs(denom) < 1e-12:
        return float(tau)
    return tau + (s2 - s0) / denom


def compute_yin(wav: np.ndarray, sr: int, w_len: int = 1024,
                w_step: int = 256, f0_min: float = 70.0,
                f0_max: float = 800.0, harmo_thresh: float = 0.1):
    """Frame-wise YIN. Returns (pitches, harmonic_rates, argmins, times);
    pitch 0 = unvoiced (reference pitchTracking.py:6-168 contract)."""
    tau_min = int(sr / f0_max)
    tau_max = int(sr / f0_min)
    wav = np.asarray(wav, np.float64)
    frames = range(0, max(1, len(wav) - w_len), w_step)
    pitches, rates, argmins, times = [], [], [], []
    for t in frames:
        x = wav[t: t + w_len]
        if len(x) < w_len:
            x = np.pad(x, (0, w_len - len(x)))
        d = _difference_function(x, tau_max)
        cm = _cmndf(d)
        # first tau below threshold
        tau = -1
        for k in range(tau_min, min(tau_max, len(cm))):
            if cm[k] < harmo_thresh:
                while k + 1 < len(cm) and cm[k + 1] < cm[k]:
                    k += 1
                tau = k
                break
        if tau != -1:
            tau_refined = _parabolic(cm, tau)
            pitches.append(sr / max(tau_refined, 1e-9))
            rates.append(float(cm[tau]))
        else:
            pitches.append(0.0)
            k = int(np.argmin(cm[tau_min:min(tau_max, len(cm))])) + tau_min \
                if len(cm) > tau_min else 0
            rates.append(float(cm[k]) if len(cm) > k else 1.0)
        argmins.append(0.0)
        times.append(t / sr)
    return (np.asarray(pitches), np.asarray(rates),
            np.asarray(argmins), np.asarray(times))
