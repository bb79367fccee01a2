"""A seeded feature corpus in the preprocessed layout that
:class:`cmtts_tpu_torch.data.dataset.FeatureDataset` reads, for smoke runs
and tests where no preprocessed LJSpeech is at hand.

``<root>/{mel,pitch,f0,energy,duration,mel2ph,cwt_spec,f0cwt_mean_std}/
LJSpeech-<kind>-<basename>.npy``, ``speakers.json``, ``stats.json`` and the
metadata files ``train.txt`` / ``val.txt`` (``basename|speaker|{phones}|raw
text``).  Utterances have a random number of ARPAbet phonemes, each lasting a
random number of frames; f0 is a voiced contour with unvoiced gaps, and the
features derived from it (coarse pitch, CWT stand-in, per-utterance log-f0
mean and std) are consistent with it.
"""

from __future__ import annotations

import json
import os

import numpy as np

from cmtts_tpu_torch.audio.pitch import f0_to_coarse_np
from cmtts_tpu_torch.text.symbols import arpabet_symbols

KINDS = ("mel", "pitch", "f0", "energy", "duration", "mel2ph", "cwt_spec",
         "f0cwt_mean_std")


def write_feature_corpus(root: str, n_train: int, n_val: int, seed: int,
                         n_mels: int = 80, phonemes=(50, 130),
                         frames=(1, 12), speaker: str = "LJSpeech") -> dict:
    """Write ``n_train + n_val`` utterances of ``phonemes`` (inclusive
    range) phonemes at ``frames`` (inclusive range) frames per phoneme
    under ``root``; returns the stats written to ``stats.json``."""
    rs = np.random.RandomState(seed)
    for kind in KINDS:
        os.makedirs(os.path.join(root, kind), exist_ok=True)
    lines, all_f0, all_energy = [], [], []
    for i in range(n_train + n_val):
        base = f"LJ{seed:03d}-{i:04d}"
        n_ph = rs.randint(phonemes[0], phonemes[1] + 1)
        dur = rs.randint(frames[0], frames[1] + 1, n_ph)
        phones = [arpabet_symbols[j]
                  for j in rs.randint(0, len(arpabet_symbols), n_ph)]
        T = int(dur.sum())
        mel2ph = np.repeat(np.arange(1, n_ph + 1), dur).astype(np.int64)
        t = np.arange(T)
        f0 = (rs.uniform(100, 180) + 20 * np.sin(2 * np.pi * t
                                                   / rs.uniform(40, 90)))
        f0[rs.rand(T) < 0.2] = 0.0          # unvoiced frames
        f0[:2] = 0.0
        lf0 = np.log(f0[f0 > 0])
        cwt = rs.randn(T, 10).astype(np.float32)
        mel = (rs.randn(T, n_mels) * 0.8 - 5.0).astype(np.float32)
        energy = rs.uniform(-1.0, 2.0, n_ph).astype(np.float32)
        feats = {
            "mel": mel, "pitch": f0_to_coarse_np(f0.copy()), "f0": f0,
            "energy": energy, "duration": dur.astype(np.int64),
            "mel2ph": mel2ph, "cwt_spec": cwt,
            "f0cwt_mean_std": np.array([lf0.mean(), lf0.std()]),
        }
        for kind, arr in feats.items():
            np.save(os.path.join(root, kind, f"{speaker}-{kind}-{base}.npy"),
                    arr)
        all_f0.append(f0[f0 > 0])
        all_energy.append(energy)
        lines.append(f"{base}|{speaker}|{{{' '.join(phones)}}}|utterance {i}")
    f0s, es = np.concatenate(all_f0), np.concatenate(all_energy)
    stats = {"pitch": [float(f0s.min()), float(f0s.max()),
                       float(f0s.mean()), float(f0s.std())],
             "f0": [float(f0s.mean()), float(f0s.std())],
             "energy": [float(es.min()), float(es.max()), float(es.mean()),
                        float(es.std())]}
    with open(os.path.join(root, "stats.json"), "w") as f:
        json.dump(stats, f)
    with open(os.path.join(root, "speakers.json"), "w") as f:
        json.dump({speaker: 0}, f)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(lines[:n_train]) + "\n")
    with open(os.path.join(root, "val.txt"), "w") as f:
        f.write("\n".join(lines[n_train:]) + "\n")
    return stats
