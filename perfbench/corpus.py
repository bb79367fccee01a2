"""A seeded training corpus in the preprocessed layout that
``data/dataset.py::FeatureDataset`` reads (``train.txt``,
``speakers.json`` and one ``<speaker>-<kind>-<basename>.npy`` a feature
kind), written by the benchmark from a mix's parameters.

Utterance lengths are the same for every seed: the phoneme counts are the
quantiles of the mix's truncated normal, and each utterance's phoneme
durations are the quantiles of a lognormal around ``frames`` (at least 1
frame), so the mel lengths depend on the count alone; the seed shuffles
which utterance gets which count and draws the phonemes, the order of the
durations and the features.  Features: a log-mel of N(-4, 1.5) per bin,
f0 a voiced track around 120-220 Hz with unvoiced runs (0 Hz), its coarse
pitch, the CWT spectrogram N(0, 1) with the f0's log-mean and std,
phoneme-level energy N(0, 1), durations and mel2ph.
"""

from __future__ import annotations

import json
import os
import shutil
from statistics import NormalDist

import numpy as np

from perfbench.traffic import run_rng, truncnorm_quantiles

SPEAKER = "LJSpeech"
DONE = "written"
KINDS = ("mel", "pitch", "f0", "energy", "duration", "mel2ph", "cwt_spec",
         "f0cwt_mean_std")


def durations(n: int, frames: float, log_sd: float) -> np.ndarray:
    """The n quantiles of frames x exp(N(0, log_sd)), rounded, >= 1."""
    nd = NormalDist(0.0, log_sd)
    q = [frames * np.exp(nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.maximum(np.rint(q), 1).astype(np.int64)


def utterance_lengths(mix: dict) -> list[tuple[int, int]]:
    """(phonemes, mel frames) of each utterance, before the seed's
    shuffle."""
    ph = mix["phonemes"]
    counts = truncnorm_quantiles(mix["utterances"], ph["mean"], ph["sd"],
                                 ph["min"], ph["max"])
    d = mix["durations"]
    return [(int(n), int(durations(int(n), d["frames"], d["log_sd"]).sum()))
            for n in counts]


def f0_to_coarse(f0: np.ndarray) -> np.ndarray:
    lo, hi = 1127.0 * np.log(1.0 + 50.0 / 700.0), \
        1127.0 * np.log(1.0 + 1100.0 / 700.0)
    mel = 1127.0 * np.log(1.0 + f0 / 700.0)
    mel = np.where(mel > 0, (mel - lo) * 254 / (hi - lo) + 1, mel)
    return np.rint(np.clip(mel, 1, 255)).astype(np.int64)


def write(root: str, mix: dict, seed: int, n_mels: int = 80,
          write: bool = True) -> list[dict]:
    """Write the corpus under ``root`` (replacing what is there, and
    marking it ``DONE`` last); returns [{basename, phonemes (ids into
    ``phoneme_set``), frames}] in ``train.txt`` order.  ``write=False``
    returns the same without writing."""
    if write:
        shutil.rmtree(root, ignore_errors=True)
        for k in KINDS:
            os.makedirs(os.path.join(root, k))
    rng = run_rng(seed, 5)
    lengths = utterance_lengths(mix)
    order = rng.permutation(len(lengths))
    phones = mix["phoneme_set"]
    d = mix["durations"]
    meta, lines = [], []
    for u, j in enumerate(order):
        n, _ = lengths[j]
        name = f"pb{u:05d}"
        ids = rng.integers(0, len(phones), n)
        dur = rng.permutation(durations(n, d["frames"], d["log_sd"]))
        T = int(dur.sum())
        mel2ph = np.repeat(np.arange(1, n + 1), dur)
        voiced = np.repeat(rng.random(n) < mix["voiced_share"], dur)
        base = rng.uniform(120.0, 220.0)
        f0 = base * np.exp(0.1 * rng.standard_normal(T).cumsum()
                           / np.sqrt(T))
        f0 = np.where(voiced, f0, 0.0)
        logf0 = np.log(f0[voiced]) if voiced.any() else np.log([base])
        feats = {
            "mel": (-4.0 + 1.5 * rng.standard_normal((T, n_mels))).astype(
                np.float32),
            "pitch": f0_to_coarse(f0),
            "f0": f0.astype(np.float32),
            "energy": rng.standard_normal(n).astype(np.float32),
            "duration": dur.astype(np.int64),
            "mel2ph": mel2ph.astype(np.int64),
            "cwt_spec": rng.standard_normal((T, 10)).astype(np.float32),
            "f0cwt_mean_std": np.array([logf0.mean(), logf0.std() + 1e-3],
                                       np.float32),
        }
        if write:
            for k, v in feats.items():
                np.save(os.path.join(root, k, f"{SPEAKER}-{k}-{name}.npy"), v)
        text = "{" + " ".join(phones[i] for i in ids) + "}"
        lines.append(f"{name}|{SPEAKER}|{text}|{name}")
        meta.append({"basename": name, "phonemes": ids, "frames": T})
    if write:
        with open(os.path.join(root, "train.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        with open(os.path.join(root, "speakers.json"), "w") as f:
            json.dump({SPEAKER: 0}, f)
        open(os.path.join(root, DONE), "w").close()
    return meta


def batch_order(meta: list[dict], batch_size: int, group_size: int,
                seed: int, n_batches: int) -> list[list[int]]:
    """The rows of the first ``n_batches`` batches that a length-sorted
    mega-batch feed (CM-TTS ``train_cm.py``: a permutation a epoch from
    ``np.random.RandomState(seed)``, mega-batches of batch x group sorted
    by text length, longest first) makes of the corpus."""
    rng = np.random.RandomState(seed)
    n, mega = len(meta), batch_size * group_size
    out = []
    while len(out) < n_batches:
        order = rng.permutation(n)
        for start in range(0, n - mega + 1, mega):
            chunk = order[start:start + mega]
            lens = np.asarray([len(meta[i]["phonemes"]) for i in chunk])
            idx = np.argsort(-lens)
            for g in range(group_size):
                out.append([int(chunk[i]) for i in
                            idx[g * batch_size:(g + 1) * batch_size]])
    return out[:n_batches]
