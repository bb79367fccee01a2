"""GE2E speaker-encoder trainer (port of ``cmtts_tpu/train/ge2e_trainer.py``;
reference ``ge2e_encoder/train.py``): sample S speakers x U partial
utterances, minimise the GE2E softmax loss over the scaled similarity
matrix.

One step: loss -> grads -> the similarity scale's and bias's grads x 0.01
-> global norm -> clip to norm 3 -> Adam, as the reference's
``do_gradient_ops`` (ge2e_encoder/model.py:33-39) and the JAX step do.

Params are one flat dict: the encoder's under ``encoder.<name>``, then
``sim_weight`` and ``sim_bias``.  flax's LSTM cell has one bias per gate
where ``nn.LSTM`` has two; the bridge puts flax's into ``bias_ih`` and
``bias_hh`` stays 0, outside the params (trained too, it would take the
same Adam step as ``bias_ih`` and move the summed bias at twice flax's
rate).  ``ge2e_params.npy`` is the JAX trainer's format, a pickled
``[{"encoder": flax tree, "sim_weight", "sim_bias"}]`` of numpy arrays,
which both packages' ``load_ge2e_params`` read.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import functional_call

from cmtts_tpu_torch.audio.wavio import read_wav
from cmtts_tpu_torch.convert import state_dict_to_flax
from cmtts_tpu_torch.core.device import resolve_device
from cmtts_tpu_torch.models.speaker import (
    GE2E_PARTIAL_FRAMES,
    GE2EEncoder,
    ge2e_loss,
    ge2e_mel_frames,
    init_ge2e_like_flax,
)
from cmtts_tpu_torch.train.state import Adam, AdamW

ENC = "encoder."


@dataclass
class GE2ETrainConfig:
    speakers_per_batch: int = 64          # params_model.py
    utterances_per_speaker: int = 10
    learning_rate: float = 1e-4
    clip_norm: float = 3.0
    sim_grad_scale: float = 0.01


# Copied from cmtts_tpu/train/ge2e_trainer.py::SpeakerVerificationDataset.
class SpeakerVerificationDataset:
    """<root>/<speaker>/*.npy partial-frame files, each (160, 40).

    ``prepare_from_wavs`` builds the cache from raw wav folders
    (reference encoder_preprocess path)."""

    def __init__(self, root: str, speakers: list[str] | None = None):
        self.root = root
        self.speakers = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        if speakers is not None:
            self.speakers = [s for s in self.speakers if s in set(speakers)]
        self.files = {
            s: sorted(f for f in os.listdir(os.path.join(root, s))
                      if f.endswith(".npy"))
            for s in self.speakers}
        self.speakers = [s for s in self.speakers if len(self.files[s]) > 0]
        if not self.speakers:
            raise ValueError(f"no speaker partials under {root}")

    @staticmethod
    def prepare_from_wavs(wav_root: str, out_root: str, sr: int = 22050):
        """Slice each <wav_root>/<speaker>/*.wav into 160-frame partials."""
        n = 0
        for spk in sorted(os.listdir(wav_root)):
            sdir = os.path.join(wav_root, spk)
            if not os.path.isdir(sdir):
                continue
            odir = os.path.join(out_root, spk)
            os.makedirs(odir, exist_ok=True)
            for name in sorted(os.listdir(sdir)):
                if not name.endswith(".wav"):
                    continue
                wav, wav_sr = read_wav(os.path.join(sdir, name))
                frames = ge2e_mel_frames(wav, wav_sr)
                for i in range(0, len(frames) - GE2E_PARTIAL_FRAMES + 1,
                               GE2E_PARTIAL_FRAMES // 2):
                    part = frames[i: i + GE2E_PARTIAL_FRAMES]
                    np.save(os.path.join(
                        odir, f"{name[:-4]}_{i:06d}.npy"), part)
                    n += 1
        return n

    def sample_batch(self, rng: np.random.RandomState, S: int, U: int):
        """(S*U, 160, 40) batch; speakers drawn without replacement,
        utterances with replacement when a speaker has < U partials."""
        S = min(S, len(self.speakers))
        spk_idx = rng.choice(len(self.speakers), S, replace=False)
        mels = []
        for si in spk_idx:
            s = self.speakers[si]
            files = self.files[s]
            pick = rng.choice(len(files), U, replace=len(files) < U)
            for fi in pick:
                mels.append(np.load(os.path.join(self.root, s, files[fi])))
        return np.stack(mels).astype(np.float32), S, U


def encoder_params(params: dict) -> dict:
    """The encoder's entries of ``params``, by their module names."""
    return {k[len(ENC):]: v for k, v in params.items() if k.startswith(ENC)}


def make_ge2e_train_step(model: GE2EEncoder, tx: AdamW, S: int, U: int,
                         cfg: GE2ETrainConfig):
    """``step(params, opt_state, mels (S*U, 160, 40)) -> (params,
    opt_state, loss, grad norm before the clip)``."""

    def step(params, opt_state, mels):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        embeds = functional_call(model, encoder_params(p), (mels,))
        loss = ge2e_loss(embeds.reshape(S, U, -1), p["sim_weight"],
                         p["sim_bias"])
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        for k in ("sim_weight", "sim_bias"):
            grads[k] = grads[k] * cfg.sim_grad_scale
        g = list(grads.values())
        gnorm = torch.sqrt(sum((x * x).sum() for x in g))
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-6), max=1.0)
        grads = dict(zip(grads, torch._foreach_mul(g, scale)))
        params, opt_state = tx.update(grads, opt_state, params)
        return params, opt_state, loss.detach(), gnorm

    return step


@torch.no_grad()
def ge2e_verification_eer(model: GE2EEncoder, params: dict,
                          ds: SpeakerVerificationDataset,
                          max_per_speaker: int = 20,
                          seed: int = 0) -> float:
    """Unseen-speaker verification EER over partial embeddings, the
    embeddings computed on the params' device.

    Every same-speaker pair is scored against every cross-speaker pair by
    cosine; the equal-error rate is where false accept == false reject.
    The scoring is a host copy of the JAX trainer's."""
    device = params["sim_weight"].device
    rng = np.random.RandomState(seed)
    enc = encoder_params(params)
    embeds, labels = [], []
    for si, s in enumerate(ds.speakers):
        files = ds.files[s]
        if not files:
            print(f"ge2e_verification_eer: speaker {s!r} has no partial "
                  f"files under {ds.root} — skipped")
            continue
        pick = rng.choice(len(files), min(max_per_speaker, len(files)),
                          replace=False)
        mels = np.stack([np.load(os.path.join(ds.root, s, files[i]))
                         for i in pick]).astype(np.float32)
        e = functional_call(model, enc, (torch.from_numpy(mels).to(device),))
        e = e.cpu().numpy()
        e /= np.linalg.norm(e, axis=1, keepdims=True) + 1e-12
        embeds.append(e)
        labels.extend([si] * len(e))
    if len(embeds) < 2:
        raise ValueError(
            "ge2e_verification_eer needs >= 2 validation speakers with "
            f"partial files; got {len(embeds)} (root={ds.root})")
    return eer_of(np.concatenate(embeds), np.asarray(labels))


# Copied from cmtts_tpu/train/ge2e_trainer.py::ge2e_verification_eer.
def eer_of(E: np.ndarray, y: np.ndarray) -> float:
    """EER of L2-normalised embeddings ``E`` with speaker labels ``y``."""
    sim = E @ E.T
    iu = np.triu_indices(len(E), k=1)
    scores = sim[iu]
    same = (y[iu[0]] == y[iu[1]])
    pos = np.sort(scores[same])
    neg = np.sort(scores[~same])
    # EER: threshold sweep over the union of scores
    thr = np.unique(scores)
    far = 1.0 - np.searchsorted(neg, thr, side="right") / max(len(neg), 1)
    frr = np.searchsorted(pos, thr, side="left") / max(len(pos), 1)
    k = int(np.argmin(np.abs(far - frr)))
    return float((far[k] + frr[k]) / 2.0)


def init_ge2e_train(seed: int = 0, lr: float = 1e-4,
                    device: str | torch.device | None = None):
    """-> (model, params, Adam, its state) on ``device`` (``cuda`` unless
    asked otherwise); the encoder drawn as flax draws it from ``seed``."""
    device = resolve_device(device)
    model = init_ge2e_like_flax(GE2EEncoder(),
                                torch.Generator().manual_seed(seed))
    model = model.to(device)
    params = {}
    for k, v in model.named_parameters():
        if k.startswith("lstm.bias_hh_l"):
            v.requires_grad_(False)          # stays 0: see the module doc
        else:
            params[ENC + k] = v.detach()
    # fixed initial scaling (ge2e_encoder/model.py:27-28)
    params["sim_weight"] = torch.tensor(10.0, device=device)
    params["sim_bias"] = torch.tensor(-5.0, device=device)
    tx = Adam(lr)
    return model, params, tx, tx.init(params)


def save_ge2e_params(model: GE2EEncoder, params: dict, path: str):
    """``ge2e_params.npy`` in the JAX trainer's format."""
    blob = {"encoder": state_dict_to_flax(model, encoder_params(params)),
            "sim_weight": params["sim_weight"].detach().cpu().numpy(),
            "sim_bias": params["sim_bias"].detach().cpu().numpy()}
    np.save(path, np.asarray([blob], dtype=object), allow_pickle=True)


def train_ge2e(data_root: str, out_dir: str | None, total_steps: int = 100,
               cfg: GE2ETrainConfig | None = None, seed: int = 0,
               log_every: int = 10, val_speakers: int = 0,
               eval_every: int = 500, patience: int = 4,
               device: str | torch.device | None = None):
    """The training loop on ``device`` (``cuda`` unless asked
    otherwise); -> the final (or best-EER) params.

    ``val_speakers`` > 0 reserves the LAST N speakers of ``data_root`` for
    unseen-speaker verification EER: they are left out of the training
    batches, evaluated every ``eval_every`` steps, and the params with the
    best EER are kept (early stop after ``patience`` evaluations without
    improvement)."""
    cfg = cfg or GE2ETrainConfig()
    all_spk = SpeakerVerificationDataset(data_root).speakers
    val_ds = None
    train_spk = None
    if val_speakers > 0:
        if val_speakers < 2:
            # EER needs cross-speaker (negative) pairs
            raise ValueError(
                f"val_speakers={val_speakers}: verification EER needs "
                ">=2 held-out speakers (no negative pairs otherwise)")
        if val_speakers >= len(all_spk) - 1:
            raise ValueError(
                f"val_speakers={val_speakers} leaves <2 train speakers "
                f"(corpus has {len(all_spk)})")
        train_spk = all_spk[:-val_speakers]
        val_ds = SpeakerVerificationDataset(data_root, all_spk[-val_speakers:])
    ds = SpeakerVerificationDataset(data_root, train_spk)
    S = min(cfg.speakers_per_batch, len(ds.speakers))
    U = cfg.utterances_per_speaker
    model, params, tx, opt_state = init_ge2e_train(seed, cfg.learning_rate,
                                                   device)
    device = params["sim_weight"].device
    step_fn = make_ge2e_train_step(model, tx, S, U, cfg)
    rng = np.random.RandomState(seed)
    best_eer, best_params, stale = float("inf"), None, 0
    for step in range(1, total_steps + 1):
        mels, _, _ = ds.sample_batch(rng, S, U)
        params, opt_state, loss, gnorm = step_fn(
            params, opt_state, torch.from_numpy(mels).to(device))
        if step % log_every == 0 or step == total_steps:
            print(f"ge2e step {step}: loss={float(loss):.4f} "
                  f"gnorm={float(gnorm):.3f}", flush=True)
        if val_ds is not None and (step % eval_every == 0
                                   or step == total_steps):
            eer = ge2e_verification_eer(model, params, val_ds)
            marker = ""
            if eer < best_eer - 1e-4:
                best_eer, stale = eer, 0
                best_params = dict(params)
                marker = "  (best)"
            else:
                stale += 1
            print(f"ge2e step {step}: val_eer={eer:.4f}{marker}", flush=True)
            if stale >= patience:
                print(f"ge2e early stop at {step} "
                      f"(best val_eer={best_eer:.4f})", flush=True)
                break
    if best_params is not None:
        params = best_params
        print(f"ge2e: keeping best-EER params (val_eer={best_eer:.4f})",
              flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        save_ge2e_params(model, params, os.path.join(out_dir,
                                                     "ge2e_params.npy"))
    return params
