"""Speaker embedders for multi-speaker and zero-shot synthesis (port of
``cmtts_tpu/models/speaker.py``, inference half):

- GE2E: 3-layer LSTM(40 -> 256) -> last hidden -> Linear(256) -> ReLU ->
  L2 norm; partial-utterance inference over overlapping 160-frame windows.
- DeepSpeaker: ResCNN — 4 stages of (Conv2D 5x5 stride 2 + BatchNorm +
  clipped ReLU + 3 identity blocks), temporal mean over (T/16, F/16 * 512)
  features, Dense(512), L2 norm; 64-fbank 160-frame input slices.

Both are ordinary torch modules (cuDNN runs the convs and the LSTM on the
card).  The host front-ends are numpy, copied verbatim.  A checkpoint is a
flat ``a/b/c`` npz of the flax variables, loaded through the bridge: the
GE2E params, or DeepSpeaker's ``params/...`` and ``batch_stats/...``.
Without one the embedders warn and use random weights from a seed.  The
GE2E loss and the Keras ``.h5`` DeepSpeaker loader are not ported here.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cmtts_tpu_torch.audio.stft import mel_filterbank, stft_magnitudes
from cmtts_tpu_torch.convert import load_flax_params
from cmtts_tpu_torch.core.device import resolve_device
from cmtts_tpu_torch.models.hifigan import unflatten_npz

GE2E_MEL_CHANNELS = 40
GE2E_PARTIAL_FRAMES = 160
GE2E_SAMPLING_RATE = 22050
GE2E_WINDOW_MS = 25
GE2E_STEP_MS = 10

DS_NUM_FRAMES = 160
DS_NUM_FBANKS = 64
DS_BN_EPS = 1e-3  # keras BatchNormalization's default


# --------------------------------------------------------------------------
# GE2E
# --------------------------------------------------------------------------
class GE2EEncoder(nn.Module):
    """3-layer LSTM speaker encoder."""

    def __init__(self, hidden: int = 256, embedding: int = 256,
                 num_layers: int = 3):
        super().__init__()
        self.lstm = nn.LSTM(GE2E_MEL_CHANNELS, hidden, num_layers,
                            batch_first=True)
        self.proj = nn.Linear(hidden, embedding)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        """(B, T, 40) mel frames -> (B, 256) L2-normalised embeddings."""
        _, (h, _) = self.lstm(mels)
        emb = torch.relu(self.proj(h[-1]))
        return emb / (torch.linalg.vector_norm(emb, dim=1, keepdim=True)
                      + 1e-5)


def compute_partial_slices(n_samples: int, partial_frames: int = GE2E_PARTIAL_FRAMES,
                           min_pad_coverage: float = 0.75, overlap: float = 0.5):
    """Overlapping partial-utterance windows
    (ge2e_encoder/inference.py:58-108)."""
    assert 0 <= overlap < 1 and 0 < min_pad_coverage <= 1
    samples_per_frame = int(GE2E_SAMPLING_RATE * GE2E_STEP_MS / 1000)
    n_frames = int(np.ceil((n_samples + 1) / samples_per_frame))
    frame_step = max(int(np.round(partial_frames * (1 - overlap))), 1)

    wav_slices, mel_slices = [], []
    steps = max(1, n_frames - partial_frames + frame_step + 1)
    for i in range(0, steps, frame_step):
        mel_range = np.array([i, i + partial_frames])
        wav_range = mel_range * samples_per_frame
        mel_slices.append(slice(*mel_range))
        wav_slices.append(slice(*wav_range))

    last = wav_slices[-1]
    coverage = (n_samples - last.start) / (last.stop - last.start)
    if coverage < min_pad_coverage and len(mel_slices) > 1:
        mel_slices, wav_slices = mel_slices[:-1], wav_slices[:-1]
    return wav_slices, mel_slices


def ge2e_mel_frames(wav: np.ndarray, sr: int = GE2E_SAMPLING_RATE) -> np.ndarray:
    """40-channel mel POWER spectrogram frames, 25 ms window / 10 ms hop —
    librosa.feature.melspectrogram semantics (power=2, no log), as the
    reference feeds the encoder (ge2e_encoder/audio.py:53-65)."""
    n_fft = int(sr * GE2E_WINDOW_MS / 1000)
    hop = int(sr * GE2E_STEP_MS / 1000)
    mag = stft_magnitudes(wav.astype(np.float32), n_fft=n_fft,
                          win_length=n_fft, hop_length=hop, center=True)
    basis = mel_filterbank(sr, n_fft, GE2E_MEL_CHANNELS, fmin=0.0, fmax=sr / 2)
    return np.asarray((mag ** 2) @ basis.T, dtype=np.float32)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def normalize_volume(wav: np.ndarray, target_dBFS: float = -30.0,
                     increase_only=False, decrease_only=False) -> np.ndarray:
    """(ge2e_encoder/audio.py:111-120)"""
    rms = np.sqrt(np.mean((wav * 32767) ** 2)) + 1e-9
    dBFS_change = target_dBFS - 20 * np.log10(rms / 32767 + 1e-12)
    if (dBFS_change < 0 and increase_only) or (dBFS_change > 0 and decrease_only):
        return wav
    return wav * (10 ** (dBFS_change / 20))


def trim_silences_energy(wav: np.ndarray, sr: int = GE2E_SAMPLING_RATE,
                         threshold_db: float = -40.0,
                         window_ms: int = 30) -> np.ndarray:
    """Energy-threshold VAD. The reference uses webrtcvad
    (ge2e_encoder/audio.py:68-108), unavailable in this environment;
    this moving-average energy gate is a documented approximation."""
    win = max(1, int(sr * window_ms / 1000))
    n = (len(wav) // win) * win
    if n == 0:
        return wav
    frames = wav[:n].reshape(-1, win)
    rms = np.sqrt((frames ** 2).mean(axis=1)) + 1e-12
    db = 20 * np.log10(rms / (np.abs(wav).max() + 1e-9) + 1e-12)
    voiced = db > threshold_db
    # smooth with a width-8 moving average (reference vad_moving_average_width)
    # NB np.convolve(mode="same") returns max(len(input), len(kernel)) —
    # skip smoothing when the clip has fewer windows than the kernel
    kernel = np.ones(8) / 8
    if len(voiced) >= len(kernel):
        voiced = np.convolve(voiced.astype(np.float32), kernel,
                             mode="same") > 0.5
    mask = np.repeat(voiced, win)
    out = wav[:n][mask]
    return out if len(out) > 0 else wav


class GE2EInference:
    """Partial-utterance embedding on ``device`` (``cuda`` unless asked
    otherwise); ``model`` moves there."""

    def __init__(self, model: GE2EEncoder,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def embed_frames_batch(self, frames: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(frames, np.float32), device=self.device)
        return self.model(x).cpu().numpy()

    def embed_utterance(self, wav: np.ndarray, using_partials: bool = True,
                        preprocess: bool = True) -> np.ndarray:
        if preprocess:
            wav = normalize_volume(np.asarray(wav, np.float32), -30.0,
                                   increase_only=True)
            wav = trim_silences_energy(wav)
        if not using_partials:
            frames = ge2e_mel_frames(wav)
            return self.embed_frames_batch(frames[None])[0]
        wav_slices, mel_slices = compute_partial_slices(len(wav))
        max_len = wav_slices[-1].stop
        if max_len >= len(wav):
            wav = np.pad(wav, (0, max_len - len(wav)))
        frames = ge2e_mel_frames(wav)
        batch = np.stack([frames[s] for s in mel_slices])
        partials = self.embed_frames_batch(batch)
        raw = partials.mean(axis=0)
        return raw / (np.linalg.norm(raw) + 1e-12)


# --------------------------------------------------------------------------
# DeepSpeaker
# --------------------------------------------------------------------------
def clipped_relu(x):
    return torch.clamp(x, 0.0, 20.0)


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """TF "SAME" padding of an NCHW map's two spatial axes: the odd pad
    goes after (at 160 x 64 and stride 2 that is (1, 2), not (2, 2))."""
    pads = []
    for n in (x.shape[3], x.shape[2]):   # F.pad lists the last axis first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class DSIdentityBlock(nn.Module):
    def __init__(self, filters: int):
        super().__init__()
        self.conv_a = nn.Conv2d(filters, filters, 3, padding=1)
        self.bn_a = nn.BatchNorm2d(filters, eps=DS_BN_EPS)
        self.conv_b = nn.Conv2d(filters, filters, 3, padding=1)
        self.bn_b = nn.BatchNorm2d(filters, eps=DS_BN_EPS)

    def forward(self, x):
        h = clipped_relu(self.bn_a(self.conv_a(x)))
        h = clipped_relu(self.bn_b(self.conv_b(h)))
        return clipped_relu(h + x)


class DSConvResStage(nn.Module):
    def __init__(self, in_ch: int, filters: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, filters, 5, stride=2)
        self.bn = nn.BatchNorm2d(filters, eps=DS_BN_EPS)
        for i in range(3):
            self.add_module(f"res_{i}", DSIdentityBlock(filters))

    def forward(self, x):
        x = clipped_relu(self.bn(self.conv(_same_pad(x, 5, 2))))
        for i in range(3):
            x = getattr(self, f"res_{i}")(x)
        return x


class DeepSpeakerResCNN(nn.Module):
    """ResCNN speaker embedder; evaluate it in ``eval()`` mode (BatchNorm
    on its running statistics)."""

    FILTERS = (64, 128, 256, 512)

    def __init__(self, embedding: int = 512):
        super().__init__()
        cin = 1
        for i, f in enumerate(self.FILTERS):
            self.add_module(f"stage_{i}", DSConvResStage(cin, f))
            cin = f
        self.affine = nn.Linear(self.FILTERS[-1] * DS_NUM_FBANKS // 16,
                                embedding)

    def forward(self, fbanks: torch.Tensor) -> torch.Tensor:
        """(B, 160, 64, 1) fbank slices (the JAX layout) -> (B, 512)
        L2-normalised."""
        x = fbanks.permute(0, 3, 1, 2)
        for i in range(len(self.FILTERS)):
            x = getattr(self, f"stage_{i}")(x)
        # flatten as the NHWC original does: (T', F' * C), C fastest
        x = x.permute(0, 2, 3, 1)
        x = x.reshape(x.shape[0], x.shape[1], -1).mean(dim=1)
        x = self.affine(x)
        return x * torch.rsqrt(torch.clamp((x * x).sum(1, keepdim=True),
                                           min=1e-12))


def ds_fbank_frames(wav: np.ndarray, sr: int = 22050,
                    win_length: int = 551) -> np.ndarray:
    """64-fbank features a la python_speech_features
    (deepspeaker/audio_ds.py:118-124): 25 ms window, 10 ms hop,
    per-utterance mean/std normalization."""
    hop = int(sr * 0.01)
    win = int(sr * 0.025)
    n_fft = _next_pow2(win)
    mag = stft_magnitudes(wav.astype(np.float32), n_fft=n_fft, win_length=win,
                          hop_length=hop, center=True)
    basis = mel_filterbank(sr, n_fft, DS_NUM_FBANKS, fmin=0.0, fmax=sr / 2)
    feat = (mag ** 2) @ basis.T
    feat = np.log(np.maximum(feat, 1e-10))
    mu, sigma = feat.mean(axis=0), feat.std(axis=0) + 1e-9
    return ((feat - mu) / sigma).astype(np.float32)


def ds_sample_frames(frames: np.ndarray, num_frames: int = DS_NUM_FRAMES,
                     rng: np.random.RandomState | None = None) -> np.ndarray:
    """Pad or crop to a fixed 160-frame slice
    (deepspeaker/audio_ds.py:126-136)."""
    if len(frames) >= num_frames:
        start = 0 if rng is None else rng.randint(0, len(frames) - num_frames + 1)
        return frames[start: start + num_frames]
    reps = int(np.ceil(num_frames / len(frames)))
    return np.tile(frames, (reps, 1))[:num_frames]


class DeepSpeakerInference:
    """One fixed 160-frame slice per utterance -> embedding, on ``device``
    (``cuda`` unless asked otherwise); ``model`` moves there."""

    def __init__(self, model: DeepSpeakerResCNN,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def predict_embedding(self, wav: np.ndarray, sr: int = 22050) -> np.ndarray:
        frames = ds_sample_frames(ds_fbank_frames(wav, sr))
        x = torch.as_tensor(frames[None, :, :, None], device=self.device)
        return self.model(x)[0].cpu().numpy()


# --------------------------------------------------------------------------
# Checkpoints and the unified wrapper
# --------------------------------------------------------------------------
def _seeded(cls, what: str):
    """``cls()`` with random weights from seed 0, leaving the global RNG
    as it was."""
    warnings.warn(f"no {what} checkpoint given; using random weights "
                  "(seed 0)")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return cls()


def ge2e_from_checkpoint(ckpt_path: str | None = None) -> GE2EEncoder:
    """GE2EEncoder from a flat npz of its flax params, else random."""
    if not ckpt_path:
        return _seeded(GE2EEncoder, "GE2E")
    return load_flax_params(GE2EEncoder(), unflatten_npz(ckpt_path))


def deepspeaker_from_checkpoint(ckpt_path: str | None = None
                                ) -> DeepSpeakerResCNN:
    """DeepSpeakerResCNN from a flat npz of its flax variables
    (``params/...`` and ``batch_stats/...``), else random."""
    if not ckpt_path:
        return _seeded(DeepSpeakerResCNN, "DeepSpeaker")
    tree = unflatten_npz(ckpt_path)
    return load_flax_params(DeepSpeakerResCNN(), tree["params"],
                            tree.get("batch_stats"))


class PreDefinedEmbedder:
    """Speaker embedder selected by the config
    (``preprocess.yaml speaker_embedder: DeepSpeaker | GE2E``)."""

    def __init__(self, cfg, ckpt_path: str | None = None,
                 device: str | torch.device | None = None):
        self.embedder_type = cfg.model.speaker_embedder
        self.sampling_rate = cfg.stft.sampling_rate
        if self.embedder_type == "DeepSpeaker":
            self._impl = DeepSpeakerInference(
                deepspeaker_from_checkpoint(ckpt_path), device)
        elif self.embedder_type == "GE2E":
            self._impl = GE2EInference(ge2e_from_checkpoint(ckpt_path), device)
        else:
            raise ValueError(f"unknown speaker embedder {self.embedder_type}")

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        if self.embedder_type == "DeepSpeaker":
            return self._impl.predict_embedding(wav, self.sampling_rate)
        return self._impl.embed_utterance(wav)


def get_deep_speaker_emb(wav: np.ndarray, cfg, ckpt_path: str | None = None,
                         device: str | torch.device | None = None):
    """On-the-fly embedding of a reference wav for zero-shot synthesis."""
    return PreDefinedEmbedder(cfg, ckpt_path, device)(wav)
