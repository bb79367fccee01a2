"""Mel-spectrogram front-end and Griffin-Lim inversion (port of
``cmtts_tpu/audio/stft.py``).

``mel_filterbank`` (the librosa/Slaney basis) and ``stft_magnitudes`` (the
speaker embedders' host STFT) are host numpy, copied verbatim.
``MelSpectrogram`` and ``GriffinLim`` compute with torch on their device:
``cuda`` unless the caller asks for another.  ``MelSpectrogram.mel_frames``
is the batched, differentiable log-mel that the vocoder trainer's loss
takes (the JAX trainer's vmapped ``make_mel_fn``).
"""

from __future__ import annotations

import numpy as np
import torch

from cmtts_tpu_torch.core.device import resolve_device


def _hz_to_mel_slaney(f: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    mel = f / (200.0 / 3)
    above = f >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz_slaney(mel: np.ndarray) -> np.ndarray:
    mel = np.asarray(mel, dtype=np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    f = (200.0 / 3) * mel
    above = mel >= min_log_mel
    return np.where(above, min_log_hz * np.exp(logstep * (mel - min_log_mel)), f)


def mel_filterbank(
    sr: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1+n_fft//2).

    Matches librosa.filters.mel(htk=False, norm='slaney'), which is what
    the upstream FastSpeech2 ``audio`` package uses.
    """
    if fmax is None:
        fmax = sr / 2.0
    n_bins = 1 + n_fft // 2
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney normalization: each filter integrates to ~2/bandwidth.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def stft_magnitudes(wav: np.ndarray, n_fft: int, win_length: int,
                    hop_length: int, center: bool = True) -> np.ndarray:
    """Generic |STFT| on host numpy, frames-major: (T_frames, 1+n_fft//2).

    Periodic Hann window of ``win_length`` zero-padded to ``n_fft``
    (librosa/torch semantics) — used by the speaker-embedder front-ends.
    """
    wav = np.asarray(wav, np.float32)
    n = np.arange(win_length)
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    if center:
        pad = n_fft // 2
        wav = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = max(1, 1 + (len(wav) - n_fft) // hop_length)
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(n_fft)[None, :])
    frames = wav[np.minimum(idx, len(wav) - 1)] * window[None, :]
    return np.abs(np.fft.rfft(frames, n=n_fft, axis=-1)).astype(np.float32)


class MelSpectrogram:
    """The FastSpeech2 ``TacotronSTFT`` contract: centred (reflect-padded)
    periodic-Hann STFT, mel = ln(clamp(basis @ |STFT|, 1e-5)), energy = L2
    norm of each magnitude frame."""

    def __init__(
        self,
        sampling_rate: int = 22050,
        filter_length: int = 1024,
        hop_length: int = 256,
        win_length: int = 1024,
        n_mel_channels: int = 80,
        mel_fmin: float = 0.0,
        mel_fmax: float | None = 8000.0,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.sampling_rate = sampling_rate
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mel_channels = n_mel_channels
        # periodic Hann (torch.hann_window default)
        n = np.arange(win_length)
        window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
        if win_length < filter_length:
            pad = (filter_length - win_length) // 2
            window = np.pad(window, (pad, filter_length - win_length - pad))
        self.window = torch.tensor(window, dtype=torch.float32,
                                   device=self.device)
        self.mel_basis = mel_filterbank(
            sampling_rate, filter_length, n_mel_channels, mel_fmin, mel_fmax
        )
        self._basis = torch.from_numpy(self.mel_basis).to(self.device)

    def frame_index(self, n_frames: int) -> torch.Tensor:
        """(n_frames, filter_length) sample index of each frame."""
        return (torch.arange(n_frames, device=self.device)[:, None]
                * self.hop_length
                + torch.arange(self.filter_length, device=self.device)[None])

    def linear_magnitude(self, wav: torch.Tensor) -> torch.Tensor:
        """|STFT| of a mono waveform, shape (1+n_fft//2, T_frames)."""
        pad = self.filter_length // 2
        wav = torch.nn.functional.pad(wav[None, None], (pad, pad),
                                      mode="reflect")[0, 0]
        n_frames = 1 + (wav.shape[0] - self.filter_length) // self.hop_length
        frames = wav[self.frame_index(n_frames)] * self.window[None, :]
        spec = torch.fft.rfft(frames, n=self.filter_length, dim=-1)
        return spec.abs().T

    def mel_and_energy(self, wav: torch.Tensor):
        """(mel [n_mels, T], energy [T]) with log dynamic-range compression."""
        mag = self.linear_magnitude(wav)
        mel = torch.log(torch.clamp(self._basis @ mag, min=1e-5))
        return mel, torch.linalg.vector_norm(mag, dim=0)

    def mel_frames(self, wavs: torch.Tensor, n_frames: int) -> torch.Tensor:
        """The log-mel of a batch, frames-major and cropped: wavs (B, T) ->
        (B, n_frames, n_mels), the first ``n_frames`` frames of each
        utterance's :meth:`mel_and_energy` mel, differentiable in
        ``wavs``."""
        pad = self.filter_length // 2
        wavs = torch.nn.functional.pad(wavs[:, None], (pad, pad),
                                       mode="reflect")[:, 0]
        frames = wavs[:, self.frame_index(n_frames)] * self.window
        mag = torch.fft.rfft(frames, n=self.filter_length, dim=-1).abs()
        return torch.log(torch.clamp(mag @ self._basis.T, min=1e-5))

    def __call__(self, wav) -> tuple[np.ndarray, np.ndarray]:
        """numpy in, numpy out: (mel [n_mels, T], energy [T])."""
        mel, energy = self.mel_and_energy(
            torch.as_tensor(np.asarray(wav, np.float32), device=self.device))
        return mel.cpu().numpy(), energy.cpu().numpy()


class GriffinLim:
    """Mel -> waveform without a neural vocoder: log-mel -> linear
    magnitude through the mel basis' pseudo-inverse (host), then
    ``n_iters`` Griffin-Lim passes from zero phase with the front-end's
    STFT, on the front-end's device.  Overlap-add is ``index_add_`` over
    the flat sample index, normalised by the summed squared window."""

    def __init__(self, stft: MelSpectrogram, n_iters: int = 60):
        self.stft = stft
        self.n_iters = n_iters
        # regularized pseudo-inverse of the mel basis (513 x 80)
        mb = stft.mel_basis.astype(np.float64)
        self.inv_basis = np.linalg.pinv(mb, rcond=1e-8).astype(np.float32)

    def _gl(self, mag: torch.Tensor) -> torch.Tensor:
        """mag: (F, T) target linear magnitudes -> waveform (padded)."""
        st = self.stft
        nfft, n_frames = st.filter_length, mag.shape[1]
        n = (n_frames - 1) * st.hop_length + nfft
        idx = st.frame_index(n_frames)
        flat = idx.reshape(-1)
        w = st.window
        wsum = torch.zeros(n, device=mag.device).index_add_(
            0, flat, (w * w).expand(n_frames, -1).reshape(-1))
        norm = torch.clamp(wsum, min=1e-8)

        def wav_of(spec):
            frames = torch.fft.irfft(spec.T, n=nfft) * w[None, :]
            out = torch.zeros(n, device=mag.device).index_add_(
                0, flat, frames.reshape(-1))
            return out / norm

        def spec_of(wav):
            return torch.fft.rfft(wav[idx] * w[None, :], n=nfft, dim=-1).T

        spec = mag.to(torch.complex64)  # zero phase init
        for _ in range(self.n_iters):
            s = spec_of(wav_of(spec))
            spec = mag * (s / torch.clamp(s.abs(), min=1e-8))
        return wav_of(spec)

    def __call__(self, log_mel: np.ndarray) -> np.ndarray:
        """log_mel (T, n_mels) [the stored feature layout] -> wav np."""
        m = np.exp(np.asarray(log_mel, np.float32)).T  # (n_mels, T)
        mag = np.maximum(self.inv_basis @ m, 0.0)
        n_frames = mag.shape[1]
        wav = self._gl(torch.from_numpy(mag).to(self.stft.device)).cpu().numpy()
        pad = self.stft.filter_length // 2
        wav = wav[pad: pad + n_frames * self.stft.hop_length]
        peak = np.abs(wav).max()
        if peak > 1.0:
            wav = wav / peak * 0.95
        return wav.astype(np.float32)
