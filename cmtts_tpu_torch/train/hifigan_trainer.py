"""HiFi-GAN vocoder trainer (port of ``cmtts_tpu/train/hifigan_trainer.py``):
the generator against the MPD + MSD discriminators (Kong et al. 2020,
arXiv 2010.05646).

    L_D = sum_k E[(1 - D_k(y))^2] + E[D_k(G(s))^2]
    L_G = sum_k E[(1 - D_k(G(s)))^2] + lambda_fm L_FM + lambda_mel L_mel
    lambda_fm = 2, lambda_mel = 45, AdamW(2e-4, b1=0.8, b2=0.99, wd=0.01),
    lr decay 0.999 every 500 steps, random fixed-length waveform crops.

One step, in the JAX step's order: y_hat = G(mel); the D loss on the real
crop and the detached y_hat, then the D update; the G loss through the
*updated* D, then the G update.  Params are dicts ``{name: tensor}``
applied with ``torch.func.functional_call``; a step returns a new state
and leaves the one it was given as it was.  The generator trains in
float32 through its plain ``forward`` (the JAX trainer trains the flax
generator, not the fused synthesis path).

Files: ``hifigan_gen_<step>.npz`` is the generator in the flax key layout
(a flat ``a/b/c`` npz), which both this package's ``load_hifigan`` and the
JAX package's ``load_hifigan_params`` read.  ``hifigan_train_state.pt`` is
this trainer's own resume file (params, AdamW moments and counts, the crop
sampler's RNG state); the JAX trainer's pickled ``hifigan_train_state.npy``
holds optax classes and is refused.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import functional_call

from cmtts_tpu_torch.audio.stft import MelSpectrogram
from cmtts_tpu_torch.audio.wavio import read_wav, resample_linear
from cmtts_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from cmtts_tpu_torch.core.device import resolve_device
from cmtts_tpu_torch.models import hifigan_disc
from cmtts_tpu_torch.models.hifigan import (
    HiFiGANConfig,
    HiFiGANGenerator,
    init_like_flax,
    unflatten_npz,
)
from cmtts_tpu_torch.models.hifigan_disc import (
    HiFiGANDiscConfig,
    HiFiGANDiscriminators,
    discriminator_loss,
    feature_matching_loss,
    generator_adv_loss,
)
from cmtts_tpu_torch.train.state import AdamW, exponential_decay

STATE_FILE = "hifigan_train_state.pt"


@dataclass(frozen=True)
class HiFiGANTrainConfig:
    segment_size: int = 8192
    batch_size: int = 16
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    weight_decay: float = 0.01
    lr_decay: float = 0.999
    lr_decay_steps: int = 500     # official decays per epoch; ~500 steps here
    lambda_mel: float = 45.0
    lambda_fm: float = 2.0
    seed: int = 0


def make_optims(cfg: HiFiGANTrainConfig) -> tuple[AdamW, AdamW]:
    """(generator's, discriminators') AdamW."""
    def mk():
        return AdamW(exponential_decay(cfg.learning_rate, cfg.lr_decay_steps,
                                       cfg.lr_decay),
                     b1=cfg.adam_b1, b2=cfg.adam_b2,
                     weight_decay=cfg.weight_decay)
    return mk(), mk()


def _params(module: torch.nn.Module) -> dict:
    return {k: v.detach() for k, v in module.named_parameters()}


def init_hifigan_train(cfg: HiFiGANTrainConfig,
                       gen_cfg: HiFiGANConfig | None = None,
                       disc_cfg: HiFiGANDiscConfig | None = None,
                       device: str | torch.device | None = None):
    """-> (state dict, generator, discriminators) on ``device`` (``cuda``
    unless asked otherwise), both modules drawn as flax draws them from
    ``cfg.seed``."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(cfg.seed)
    gen = init_like_flax(HiFiGANGenerator(gen_cfg), g).to(device)
    disc = hifigan_disc.init_like_flax(HiFiGANDiscriminators(disc_cfg),
                                       g).to(device)
    tx_g, tx_d = make_optims(cfg)
    gp, dp = _params(gen), _params(disc)
    state = {"gen": gp, "disc": dp, "opt_g": tx_g.init(gp),
             "opt_d": tx_d.init(dp), "step": 0}
    return state, gen, disc


def make_hifigan_train_step(gen: HiFiGANGenerator,
                            disc: HiFiGANDiscriminators,
                            stft: MelSpectrogram,
                            cfg: HiFiGANTrainConfig,
                            paired: bool = False):
    """D-then-G update: ``step(state, wavs[, in_mels]) -> (state,
    metrics)``.

    ``paired=False`` (from scratch): G's input mel is the crop's own.
    ``paired=True`` (fine-tuning, HiFi-GAN paper sec. 4.2): ``in_mels``
    (B, segment // hop, n_mels) are external mels aligned to the crop; the
    mel loss still targets the ground-truth crop's mel."""
    tx_g, tx_d = make_optims(cfg)
    hop = gen.cfg.hop_length

    def mel_fn(wavs):
        return stft.mel_frames(wavs, wavs.shape[1] // hop)

    def step(state, wavs, in_mels=None):
        with torch.no_grad():
            target_mels = mel_fn(wavs)
        mels = in_mels if paired else target_mels
        gp = {k: v.detach().requires_grad_(True)
              for k, v in state["gen"].items()}
        y_hat = functional_call(gen, gp, (mels,))

        dp = {k: v.detach().requires_grad_(True)
              for k, v in state["disc"].items()}
        real = functional_call(disc, dp, (wavs,))
        fake = functional_call(disc, dp, (y_hat.detach(),))
        d_loss = discriminator_loss(real, fake)
        d_grads = torch.autograd.grad(d_loss, list(dp.values()))
        del real, fake
        disc_params, opt_d = tx_d.update(dict(zip(dp, d_grads)),
                                         state["opt_d"], state["disc"])

        # G through the updated D; D's params take no gradient
        with torch.no_grad():
            real = functional_call(disc, disc_params, (wavs,))
        fake = functional_call(disc, disc_params, (y_hat,))
        adv = generator_adv_loss(fake)
        fm = feature_matching_loss(real, fake)
        mel_l1 = (mel_fn(y_hat) - target_mels).abs().mean()
        g_loss = adv + cfg.lambda_fm * fm + cfg.lambda_mel * mel_l1
        g_grads = torch.autograd.grad(g_loss, list(gp.values()))
        gen_params, opt_g = tx_g.update(dict(zip(gp, g_grads)),
                                        state["opt_g"], state["gen"])
        new_state = {"gen": gen_params, "disc": disc_params,
                     "opt_g": opt_g, "opt_d": opt_d,
                     "step": state["step"] + 1}
        metrics = {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                   "g_adv": adv.detach(), "g_fm": fm.detach(),
                   "mel_l1": mel_l1.detach()}
        return new_state, metrics

    return step


# Copied from cmtts_tpu/train/hifigan_trainer.py::WaveSegmentSampler.
class WaveSegmentSampler:
    """Random fixed-length segments from a directory tree of wavs
    (recursively); short files are cyclically tiled.  Host numpy: the
    device only sees (B, segment) float32."""

    def __init__(self, wav_root: str, segment_size: int,
                 sampling_rate: int = 22050, max_files: int | None = None):
        self.segment = segment_size
        self.wavs: list[np.ndarray] = []
        paths = []
        for dirpath, _, names in sorted(os.walk(wav_root)):
            for n in sorted(names):
                if n.endswith(".wav"):
                    paths.append(os.path.join(dirpath, n))
        if max_files:
            paths = paths[:max_files]
        for p in paths:
            wav, sr = read_wav(p)
            if sr != sampling_rate:
                wav = resample_linear(wav, sr, sampling_rate)
            w = np.asarray(wav, np.float32)
            if len(w) < segment_size:
                reps = int(np.ceil(segment_size / max(len(w), 1)))
                w = np.tile(w, reps)
            self.wavs.append(w)
        if not self.wavs:
            raise ValueError(f"no wavs under {wav_root}")

    def sample(self, rng: np.random.RandomState, batch: int) -> np.ndarray:
        out = np.empty((batch, self.segment), np.float32)
        idx = rng.randint(0, len(self.wavs), batch)
        for i, j in enumerate(idx):
            w = self.wavs[j]
            off = rng.randint(0, len(w) - self.segment + 1)
            out[i] = w[off: off + self.segment]
        return out


# Copied from cmtts_tpu/train/hifigan_trainer.py::MelWavPairSampler.
class MelWavPairSampler:
    """Aligned (mel, waveform) segment pairs for vocoder fine-tuning on
    external mels (e.g. teacher-forced TTS-predicted mels, HiFi-GAN paper
    sec. 4.2).

    ``mel_dir`` holds ``<spk>-mel-<base>.npy`` (preprocessor layout) or
    ``<base>-mel.npy`` (synthesize-CLI layout) files of shape (frames,
    n_mels) or (n_mels, frames); ``wav_root`` is searched recursively for
    ``<base>.wav``.  Pairs whose lengths disagree by more than
    ``tolerance_frames`` are skipped with a warning."""

    def __init__(self, mel_dir: str, wav_root: str, segment_frames: int,
                 hop: int = 256, sampling_rate: int = 22050,
                 n_mels: int = 80, tolerance_frames: int = 20):
        self.hop, self.F = hop, segment_frames
        wav_by_base = {}
        for dirpath, _, names in sorted(os.walk(wav_root)):
            for n in sorted(names):
                if n.endswith(".wav"):
                    wav_by_base[n[:-4]] = os.path.join(dirpath, n)
        self.pairs: list[tuple[np.ndarray, np.ndarray]] = []
        skipped = 0
        for n in sorted(os.listdir(mel_dir)):
            if not n.endswith(".npy"):
                continue
            stem = n[:-4]
            if "-mel-" in stem:                      # <spk>-mel-<base>
                base = stem.split("-mel-", 1)[1]
            elif stem.endswith("-mel"):              # <base>-mel
                base = stem[:-4]
            else:
                base = stem
            path = wav_by_base.get(base)
            if path is None:
                skipped += 1
                continue
            mel = np.load(os.path.join(mel_dir, n)).astype(np.float32)
            if mel.ndim != 2:
                skipped += 1
                continue
            if mel.shape[0] == n_mels and mel.shape[1] != n_mels:
                mel = mel.T                          # (frames, n_mels)
            wav, sr = read_wav(path)
            if sr != sampling_rate:
                wav = resample_linear(wav, sr, sampling_rate)
            wav = np.asarray(wav, np.float32)
            frames = min(mel.shape[0], len(wav) // hop)
            if abs(mel.shape[0] - len(wav) / hop) > tolerance_frames \
                    or frames < 1:
                skipped += 1
                continue
            mel, wav = mel[:frames], wav[: frames * hop]
            if frames < segment_frames:
                reps = int(np.ceil(segment_frames / frames))
                mel = np.tile(mel, (reps, 1))
                wav = np.tile(wav, reps)
            self.pairs.append((mel, wav))
        if skipped:
            warnings.warn(f"MelWavPairSampler: skipped {skipped} "
                          f"unmatched/misaligned mel files")
        if not self.pairs:
            raise ValueError(
                f"no aligned (mel, wav) pairs between {mel_dir} and "
                f"{wav_root}")

    def sample(self, rng: np.random.RandomState, batch: int):
        """-> (wavs (B, F*hop), mels (B, F, n_mels))."""
        n_mels = self.pairs[0][0].shape[1]
        wavs = np.empty((batch, self.F * self.hop), np.float32)
        mels = np.empty((batch, self.F, n_mels), np.float32)
        idx = rng.randint(0, len(self.pairs), batch)
        for i, j in enumerate(idx):
            mel, wav = self.pairs[j]
            f0 = rng.randint(0, mel.shape[0] - self.F + 1)
            mels[i] = mel[f0: f0 + self.F]
            wavs[i] = wav[f0 * self.hop: (f0 + self.F) * self.hop]
        return wavs, mels


def flatten_params(tree, prefix="") -> dict:
    """Nested params -> flat ``a/b/c`` keys (inverse of
    ``hifigan.unflatten_npz``)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _rng_to_tensors(rng: np.random.RandomState) -> dict:
    kind, keys, pos, has_gauss, cached = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _rng_from_tensors(saved: dict) -> np.random.RandomState:
    rng = np.random.RandomState()
    keys = saved["keys"].cpu().numpy().astype(np.uint32)
    rng.set_state(("MT19937", keys, saved["pos"], saved["has_gauss"],
                   saved["cached_gaussian"]))
    return rng


def save_hifigan(state: dict, gen: HiFiGANGenerator, out_dir: str,
                 step: int, rng: np.random.RandomState) -> str:
    """Write the generator npz (flax layout), the resume file and a small
    json of the step; -> the npz's path."""
    os.makedirs(out_dir, exist_ok=True)
    gen_path = os.path.join(out_dir, f"hifigan_gen_{step:08d}.npz")
    np.savez(gen_path, **flatten_params(state_dict_to_flax(gen,
                                                           state["gen"])))

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return tree.detach().cpu() if torch.is_tensor(tree) else tree

    torch.save({**cpu(state), "rng": _rng_to_tensors(rng)},
               os.path.join(out_dir, STATE_FILE))
    with open(os.path.join(out_dir, "hifigan_train_meta.json"), "w") as f:
        json.dump({"step": int(step), "generator_npz": gen_path}, f)
    return gen_path


def load_hifigan_train_state(out_dir: str, device):
    """-> (state on ``device``, the crop sampler's RandomState)."""
    saved = torch.load(os.path.join(out_dir, STATE_FILE),
                       map_location=device, weights_only=True)
    return ({k: v for k, v in saved.items() if k != "rng"},
            _rng_from_tensors(saved["rng"]))


def train_hifigan(wav_root: str, out_dir: str, total_steps: int,
                  cfg: HiFiGANTrainConfig | None = None,
                  gen_cfg: HiFiGANConfig | None = None,
                  disc_cfg: HiFiGANDiscConfig | None = None,
                  log_every: int = 50, save_every: int = 2000,
                  resume: bool = False, max_files: int | None = None,
                  finetune_mel_dir: str | None = None,
                  init_gen_npz: str | None = None,
                  log_fn=print, device: str | torch.device | None = None):
    """The training loop on ``device`` (``cuda`` unless asked
    otherwise); -> the final state.  ``finetune_mel_dir`` switches to
    paired fine-tuning on external mels; ``init_gen_npz`` warm-starts the
    generator from an exported npz; ``resume`` continues from
    ``out_dir``'s resume file when there is one."""
    cfg = cfg or HiFiGANTrainConfig()
    gen_cfg = gen_cfg or HiFiGANConfig()
    device = resolve_device(device)
    state, gen, disc = init_hifigan_train(cfg, gen_cfg, disc_cfg, device)
    if init_gen_npz:
        state["gen"] = {k: v.to(device) for k, v in flax_to_state_dict(
            unflatten_npz(init_gen_npz), gen).items()}
        log_fn(f"generator warm-started from {init_gen_npz}")
    rng = np.random.RandomState(cfg.seed)
    if resume:
        if os.path.exists(os.path.join(out_dir, STATE_FILE)):
            state, rng = load_hifigan_train_state(out_dir, device)
            log_fn(f"resumed hifigan trainer at step {int(state['step'])}")
        elif os.path.exists(os.path.join(out_dir,
                                         "hifigan_train_state.npy")):
            raise ValueError(
                f"{out_dir} holds the JAX trainer's hifigan_train_state.npy "
                f"(pickled optax state), which this trainer cannot resume "
                f"from; warm-start the generator with init_gen_npz= one of "
                f"its hifigan_gen_*.npz instead")
    stft = MelSpectrogram(sampling_rate=gen_cfg.sampling_rate,
                          n_mel_channels=gen_cfg.num_mels, device=device)
    paired = finetune_mel_dir is not None
    step_fn = make_hifigan_train_step(gen, disc, stft, cfg, paired=paired)
    if paired:
        sampler = MelWavPairSampler(
            finetune_mel_dir, wav_root,
            cfg.segment_size // gen_cfg.hop_length, gen_cfg.hop_length,
            gen_cfg.sampling_rate, gen_cfg.num_mels)
    else:
        sampler = WaveSegmentSampler(wav_root, cfg.segment_size,
                                     gen_cfg.sampling_rate, max_files)
    for step in range(int(state["step"]) + 1, total_steps + 1):
        if paired:
            wavs, in_mels = sampler.sample(rng, cfg.batch_size)
            state, metrics = step_fn(
                state, torch.from_numpy(wavs).to(device),
                torch.from_numpy(in_mels).to(device))
        else:
            wavs = sampler.sample(rng, cfg.batch_size)
            state, metrics = step_fn(state, torch.from_numpy(wavs).to(device))
        if step % log_every == 0 or step == total_steps:
            m = {k: float(v) for k, v in metrics.items()}
            log_fn(f"hifigan step {step}: " +
                   " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())))
        if step % save_every == 0 or step == total_steps:
            path = save_hifigan(state, gen, out_dir, step, rng)
            log_fn(f"saved {path}")
    return state
