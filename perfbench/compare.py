"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, each number held to the limit the cell's file
gives it (set from the program's readings and the control's).

Synthesis numbers, over the sampled calls, the worst row:

- ``len_mismatch``: rows whose mel length differs from the reference's
  (the conditioning's durations); exact, limit 0;
- ``mel_err``: ||mel - mel_ref|| / ||mel_ref|| over the row's frames (the
  conditioning, the sampler and the bf16 denoiser);
- ``voc_ratio``: the vocoder stage by itself: the program's waveform
  against the float32 reference vocoder run on the program's own mel, as
  a multiple of the same gap of the reference vocoder with its MRF
  operands rounded to bf16 (the configuration's precision) on that mel.
  Random weights amplify bf16 rounding differently from seed to seed (4x
  between seeds), the same in the program and in the bf16 reference, so
  the ratio is what stays put;
- ``embed_err``: the speaker embedding, where the call embeds one.
"""

from __future__ import annotations

import math

import numpy as np


def rel_err(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return math.inf
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def synthesis_gaps(cand: dict, want: dict, voc32: np.ndarray,
                   voc16: np.ndarray, hop: int) -> dict:
    """``voc32``/``voc16``: the reference vocoder in float32 and with bf16
    MRF operands, on ``cand``'s mel."""
    out = {}
    if cand["mel"].shape != want["mel"].shape:
        return {"len_mismatch": len(want["mel_lens"]), "mel_err": math.inf,
                "voc_ratio": math.inf}
    lens_c = np.asarray(cand["mel_lens"]).astype(np.int64)
    lens_w = np.asarray(want["mel_lens"]).astype(np.int64)
    out["len_mismatch"] = int((lens_c != lens_w).sum())
    mel, voc = [], []
    for i, n in enumerate(lens_w):
        n, m = int(min(n, lens_c[i])), int(lens_c[i]) * hop
        mel.append(rel_err(cand["mel"][i, :n], want["mel"][i, :n]))
        voc.append(rel_err(cand["wav"][i, :m], voc32[i, :m])
                   / max(rel_err(voc16[i, :m], voc32[i, :m]), 1e-12))
    out["mel_err"], out["voc_ratio"] = max(mel), max(voc)
    if want.get("embeds") is not None:
        out["embed_err"] = max(rel_err(e, w) for e, w in
                               zip(cand["embeds"], want["embeds"]))
    return out


def worst(per_call: list) -> dict:
    """Each number's worst value over the calls."""
    out = {}
    for g in per_call:
        for k, v in g.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def judge(per_call: list, limits: dict):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit fails."""
    w = worst(per_call)
    numbers = [(k, w[k], limits.get(k)) for k in sorted(w)]
    ok = bool(per_call) and all(lim is not None and v <= lim
                                for _, v, lim in numbers)
    return ok, numbers
