"""Speaker embedders for multi-speaker and zero-shot synthesis (port of
``cmtts_tpu/models/speaker.py``):

- GE2E: 3-layer LSTM(40 -> 256) -> last hidden -> Linear(256) -> ReLU ->
  L2 norm; partial-utterance inference over overlapping 160-frame windows.
- DeepSpeaker: ResCNN — 4 stages of (Conv2D 5x5 stride 2 + BatchNorm +
  clipped ReLU + 3 identity blocks), temporal mean over (T/16, F/16 * 512)
  features, Dense(512), L2 norm; 64-fbank 160-frame input slices.

Both are ordinary torch modules (cuDNN runs the convs and the LSTM on the
card).  The host front-ends are numpy, copied verbatim.  A checkpoint is a
flat ``a/b/c`` npz of the flax variables, loaded through the bridge: the
GE2E params, or DeepSpeaker's ``params/...`` and ``batch_stats/...``.
The reference formats load too, through numpy converters copied from the
JAX module: GE2E's torch ``encoder.pt`` (``model_state``) and the in-repo
GE2E trainer's ``.npy`` blob, DeepSpeaker's Keras ``.h5`` (``h5py``,
imported on use).  Without a checkpoint the embedders warn and use random
weights from a seed.  The GE2E loss, which ``train/ge2e_trainer.py``
trains the encoder with, is here too, and ``init_ge2e_like_flax``, its
fresh weights as flax draws them.
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
from cmtts_tpu_torch.core.trace import span
from cmtts_tpu_torch.models.hifigan import unflatten_npz
from cmtts_tpu_torch.models.init import lecun_normal_

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


def ge2e_similarity_matrix(embeds: torch.Tensor, weight, bias) -> torch.Tensor:
    """Scaled GE2E similarity matrix (ge2e_encoder/model.py:63-105),
    vectorised: each utterance against every speaker's centroid, its own
    speaker's centroid taken without it.

    embeds: (S, U, E) L2-normalised -> (S, U, S)
    """
    S, U, _ = embeds.shape
    incl = embeds.mean(dim=1)
    incl = incl / (torch.linalg.vector_norm(incl, dim=1, keepdim=True)
                   + 1e-5)
    excl = (embeds.sum(dim=1, keepdim=True) - embeds) / (U - 1)
    excl = excl / (torch.linalg.vector_norm(excl, dim=2, keepdim=True)
                   + 1e-5)
    sim = torch.einsum("sue,ke->suk", embeds, incl)
    own = torch.einsum("sue,sue->su", embeds, excl)
    eye = torch.eye(S, dtype=torch.bool, device=embeds.device)[:, None, :]
    sim = torch.where(eye, own[:, :, None], sim)
    return sim * weight + bias


def ge2e_loss(embeds: torch.Tensor, weight, bias) -> torch.Tensor:
    """GE2E softmax loss (ge2e_encoder/model.py:107-123)."""
    S, U, _ = embeds.shape
    sim = ge2e_similarity_matrix(embeds, weight, bias).reshape(S * U, S)
    target = torch.arange(S, device=embeds.device).repeat_interleave(U)
    logp = torch.log_softmax(sim, dim=-1)
    return -logp[torch.arange(S * U, device=embeds.device), target].mean()


@torch.no_grad()
def init_ge2e_like_flax(enc: GE2EEncoder,
                        generator: torch.Generator) -> GE2EEncoder:
    """Re-initialise ``enc`` in place as flax's ``OptimizedLSTMCell`` and
    ``Dense`` draw the JAX encoder: each gate's input kernel LeCun-normal,
    each gate's hidden kernel orthogonal (H x H), the projection
    LeCun-normal, every bias zero."""
    lstm = enc.lstm
    H = lstm.hidden_size
    for k in range(lstm.num_layers):
        w_ih = getattr(lstm, f"weight_ih_l{k}")
        w_hh = getattr(lstm, f"weight_hh_l{k}")
        for gate in range(4):
            rows = slice(gate * H, (gate + 1) * H)
            lecun_normal_(w_ih[rows], w_ih.shape[1], generator)
            nn.init.orthogonal_(w_hh[rows], generator=generator)
        nn.init.zeros_(getattr(lstm, f"bias_ih_l{k}"))
        nn.init.zeros_(getattr(lstm, f"bias_hh_l{k}"))
    lecun_normal_(enc.proj.weight, enc.proj.in_features, generator)
    nn.init.zeros_(enc.proj.bias)
    return enc


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
        with span("embed.fbank"):
            frames = ds_sample_frames(ds_fbank_frames(wav, sr))
        with span("embed.rescnn"):
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


# Copied from cmtts_tpu/models/speaker.py::convert_torch_ge2e (numpy).
def convert_torch_ge2e(state_dict: dict, hidden=256, embedding=256,
                       num_layers=3) -> dict:
    """torch ``SpeakerEncoder.state_dict()`` (ge2e_encoder/model.py;
    ``encoder.pt`` checkpoint key 'model_state') -> GE2EEncoder flax params.

    torch LSTM packs gates (i, f, g, o) rows in weight_ih_l{k} (4H, in);
    the flax OptimizedLSTMCell keeps one Dense per gate and source (``ii``..
    input kernels, ``hi``.. hidden kernels with the bias), so
    ``bias_ih + bias_hh`` folds into the ``h*`` biases (the bridge gives it
    back as ``bias_ih`` with ``bias_hh`` = 0).
    """
    params: dict = {}
    for k in range(num_layers):
        w_ih = np.asarray(state_dict[f"lstm.weight_ih_l{k}"])   # (4H, in)
        w_hh = np.asarray(state_dict[f"lstm.weight_hh_l{k}"])   # (4H, H)
        b = (np.asarray(state_dict[f"lstm.bias_ih_l{k}"])
             + np.asarray(state_dict[f"lstm.bias_hh_l{k}"]))    # (4H,)
        H = hidden
        gates = {"i": slice(0, H), "f": slice(H, 2 * H),
                 "g": slice(2 * H, 3 * H), "o": slice(3 * H, 4 * H)}
        cell: dict = {}
        for gname, sl in gates.items():
            cell[f"i{gname}"] = {"kernel": w_ih[sl].T}
            cell[f"h{gname}"] = {"kernel": w_hh[sl].T, "bias": b[sl]}
        params[f"lstm_{k}"] = cell
    params["proj"] = {"kernel": np.asarray(state_dict["linear.weight"]).T,
                      "bias": np.asarray(state_dict["linear.bias"])}
    return params


def load_torch_ge2e(path: str) -> dict:
    """GE2E flax params from the reference's torch checkpoint."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state", ckpt)
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()
          if torch.is_tensor(v)}
    return convert_torch_ge2e(sd)


def load_ge2e_params(ckpt_path: str) -> dict:
    """GE2E encoder flax params from the in-repo GE2E trainer's ``.npy``
    (a pickled one-element object array ``[{"encoder": params,
    "sim_weight", "sim_bias"}]``), a torch ``.pt`` or a flat npz."""
    if ckpt_path.endswith(".npy"):
        return np.load(ckpt_path, allow_pickle=True)[0]["encoder"]
    if ckpt_path.endswith(".npz"):
        return unflatten_npz(ckpt_path)
    return load_torch_ge2e(ckpt_path)


# Copied from cmtts_tpu/models/speaker.py::convert_keras_deepspeaker_h5
# (h5py imported on use, failing closed without it).
def convert_keras_deepspeaker_h5(h5_path: str) -> tuple[dict, dict]:
    """Keras ResCNN .h5 checkpoint -> (params, batch_stats).

    Keras Conv2D kernel (kh, kw, in, out) matches flax; BN stores
    gamma/beta/moving_mean/moving_variance.
    """
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading a Keras .h5 DeepSpeaker checkpoint needs "
                          "h5py, which is not installed; convert it to a "
                          "flat npz where h5py is") from e

    f = h5py.File(h5_path, "r")
    root = f["model_weights"] if "model_weights" in f else f

    def g(layer, name):
        grp = root[layer]
        while not isinstance(grp, h5py.Dataset) and name not in grp:
            keys = list(grp.keys())
            if len(keys) != 1:
                break
            grp = grp[keys[0]]
        return np.asarray(grp[name])

    params: dict = {}
    stats: dict = {}
    stage_filters = (64, 128, 256, 512)
    for i, filt in enumerate(stage_filters):
        conv_name = f"conv{filt}-s"
        sp: dict = {"conv": {"kernel": g(conv_name, "kernel:0"),
                             "bias": g(conv_name, "bias:0")}}
        sb: dict = {}
        bn = conv_name + "_bn"
        sp["bn"] = {"scale": g(bn, "gamma:0"), "bias": g(bn, "beta:0")}
        sb["bn"] = {"mean": g(bn, "moving_mean:0"),
                    "var": g(bn, "moving_variance:0")}
        for b in range(3):
            base = f"res{i+1}_{b}_branch"
            rp = {
                "conv_a": {"kernel": g(base + "_2a", "kernel:0"),
                           "bias": g(base + "_2a", "bias:0")},
                "bn_a": {"scale": g(base + "_2a_bn", "gamma:0"),
                         "bias": g(base + "_2a_bn", "beta:0")},
                "conv_b": {"kernel": g(base + "_2b", "kernel:0"),
                           "bias": g(base + "_2b", "bias:0")},
                "bn_b": {"scale": g(base + "_2b_bn", "gamma:0"),
                         "bias": g(base + "_2b_bn", "beta:0")},
            }
            rb = {
                "bn_a": {"mean": g(base + "_2a_bn", "moving_mean:0"),
                         "var": g(base + "_2a_bn", "moving_variance:0")},
                "bn_b": {"mean": g(base + "_2b_bn", "moving_mean:0"),
                         "var": g(base + "_2b_bn", "moving_variance:0")},
            }
            sp[f"res_{b}"] = rp
            sb[f"res_{b}"] = rb
        params[f"stage_{i}"] = sp
        stats[f"stage_{i}"] = sb
    params["affine"] = {"kernel": g("affine", "kernel:0"),
                        "bias": g("affine", "bias:0")}
    f.close()
    return params, stats


def ge2e_from_checkpoint(ckpt_path: str | None = None) -> GE2EEncoder:
    """GE2EEncoder from :func:`load_ge2e_params`'s formats, else random."""
    if not ckpt_path:
        return _seeded(GE2EEncoder, "GE2E")
    return load_flax_params(GE2EEncoder(), load_ge2e_params(ckpt_path))


def deepspeaker_from_checkpoint(ckpt_path: str | None = None
                                ) -> DeepSpeakerResCNN:
    """DeepSpeakerResCNN from a flat npz of its flax variables
    (``params/...`` and ``batch_stats/...``) or a Keras ``.h5``, else
    random."""
    if not ckpt_path:
        return _seeded(DeepSpeakerResCNN, "DeepSpeaker")
    if ckpt_path.endswith(".h5"):
        params, stats = convert_keras_deepspeaker_h5(ckpt_path)
    else:
        tree = unflatten_npz(ckpt_path)
        params, stats = tree["params"], tree.get("batch_stats")
    return load_flax_params(DeepSpeakerResCNN(), params, stats)


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
