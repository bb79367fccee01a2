"""Plain reference of the DeepSpeaker ResCNN speaker embedder (Li et al.
2017; the CM-TTS VCTK config's ``speaker_embedder: DeepSpeaker``): a
python_speech_features-style 64-fbank front end in numpy (25 ms window,
10 ms hop, per-utterance standardisation, the first 160 frames or the
frames tiled to 160), then four stages of (5x5 stride-2 conv with TF
"SAME" padding, BatchNorm, clipped ReLU, three identity blocks), the
temporal mean, Dense(512) and L2 normalisation.

Written from DeepSpeaker's definition (``deepspeaker/audio_ds.py``,
``conv_models.py``) under the program's parameter names; it imports
nothing of the program, and the tests hold it to the JAX package's
embedder (``perfbench/tests/test_perfbench_pinned.py``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NUM_FRAMES, NUM_FBANKS, BN_EPS = 160, 64, 1e-3
FILTERS = (64, 128, 256, 512)


def _hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    min_log_mel = 1000.0 / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / logstep, f / (200.0 / 3))


def _mel_to_hz(mel):
    mel = np.asarray(mel, dtype=np.float64)
    min_log_mel = 1000.0 / (200.0 / 3)
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel,
                    1000.0 * np.exp(logstep * (mel - min_log_mel)),
                    (200.0 / 3) * mel)


def mel_filterbank(sr, n_fft, n_mels, fmin=0.0, fmax=None):
    """Slaney-normalised triangular filters (librosa ``htk=False``)."""
    fmax = sr / 2.0 if fmax is None else fmax
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                   ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2: n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


def stft_magnitudes(wav, n_fft, win_length, hop_length):
    """Centred (reflect-padded) periodic-Hann |STFT|, frames-major."""
    wav = np.asarray(wav, np.float32)
    n = np.arange(win_length)
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
        np.float32)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    wav = np.pad(wav, (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = max(1, 1 + (len(wav) - n_fft) // hop_length)
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(n_fft)[None, :])
    frames = wav[np.minimum(idx, len(wav) - 1)] * window[None, :]
    return np.abs(np.fft.rfft(frames, n=n_fft, axis=-1)).astype(np.float32)


def fbank_slice(wav, sr: int) -> np.ndarray:
    """(160, 64) standardised log-fbank frames of one utterance."""
    hop, win = int(sr * 0.01), int(sr * 0.025)
    n_fft = 1 << (win - 1).bit_length()
    mag = stft_magnitudes(wav.astype(np.float32), n_fft, win, hop)
    feat = (mag ** 2) @ mel_filterbank(sr, n_fft, NUM_FBANKS, 0.0, sr / 2).T
    feat = np.log(np.maximum(feat, 1e-10))
    feat = ((feat - feat.mean(axis=0)) / (feat.std(axis=0) + 1e-9)).astype(
        np.float32)
    if len(feat) >= NUM_FRAMES:
        return feat[:NUM_FRAMES]
    reps = int(np.ceil(NUM_FRAMES / len(feat)))
    return np.tile(feat, (reps, 1))[:NUM_FRAMES]


def clipped_relu(x):
    return torch.clamp(x, 0.0, 20.0)


def same_pad(x, k: int, stride: int):
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class IdentityBlock(nn.Module):
    def __init__(self, f):
        super().__init__()
        self.conv_a = nn.Conv2d(f, f, 3, padding=1)
        self.bn_a = nn.BatchNorm2d(f, eps=BN_EPS)
        self.conv_b = nn.Conv2d(f, f, 3, padding=1)
        self.bn_b = nn.BatchNorm2d(f, eps=BN_EPS)

    def forward(self, x):
        h = clipped_relu(self.bn_a(self.conv_a(x)))
        h = clipped_relu(self.bn_b(self.conv_b(h)))
        return clipped_relu(h + x)


class ConvResStage(nn.Module):
    def __init__(self, cin, f):
        super().__init__()
        self.conv = nn.Conv2d(cin, f, 5, stride=2)
        self.bn = nn.BatchNorm2d(f, eps=BN_EPS)
        for i in range(3):
            self.add_module(f"res_{i}", IdentityBlock(f))

    def forward(self, x):
        x = clipped_relu(self.bn(self.conv(same_pad(x, 5, 2))))
        for i in range(3):
            x = getattr(self, f"res_{i}")(x)
        return x


class ResCNN(nn.Module):
    """Evaluated in ``eval()`` mode (BatchNorm on its running stats)."""

    def __init__(self, embedding: int = 512):
        super().__init__()
        cin = 1
        for i, f in enumerate(FILTERS):
            self.add_module(f"stage_{i}", ConvResStage(cin, f))
            cin = f
        self.affine = nn.Linear(FILTERS[-1] * NUM_FBANKS // 16, embedding)

    def forward(self, fbanks):
        """(B, 160, 64) -> (B, 512), L2-normalised."""
        x = fbanks[:, None]
        for i in range(len(FILTERS)):
            x = getattr(self, f"stage_{i}")(x)
        x = x.permute(0, 2, 3, 1)
        x = self.affine(x.reshape(x.shape[0], x.shape[1], -1).mean(dim=1))
        return x * torch.rsqrt(torch.clamp((x * x).sum(1, keepdim=True),
                                           min=1e-12))
