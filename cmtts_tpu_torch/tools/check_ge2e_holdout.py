"""Gate: does the trained GE2E encoder generalize to truly-unseen
speakers?  Port of ``tools/check_ge2e_holdout.py`` (GE2E through
``models/speaker.py`` on ``--device``).  The question the zero-shot eval needs answered is a RANKING
one: does an unseen speaker's utterance embed closer to its own
speaker's centroid than to every training-speaker centroid?  So the
gate measures exactly that, like-for-like:

  * top-1 rate: fraction of holdout utterances whose cos to their own
    leave-one-out centroid beats the max cos to any train centroid
  * margin: mean of (cos-to-own - max-cos-to-train) over utterances

Two earlier criteria proved misleading and were replaced:
  - comparing utterance->own-centroid cos against CENTROID->centroid
    cos mixes noise-deflated and noise-free quantities (centroid cos
    runs ~0.1 higher for everyone);
  - absolute thresholds ignore how crowded the embedding space is, so
    the report also carries the inter-train centroid cos distribution
    as a calibration diagnostic (a holdout landing at 0.92 means
    nothing if train speakers also sit at 0.92 from each other).

Round-4 history: a 10-speaker GE2E memorized (holdout at cos 0.99 on a
train centroid); 32 speakers separated cleanly in-domain (val EER
0.009) but the embedding space had ~zero correlation with voice-profile
similarity — holdouts projected onto arbitrary train directions
(utterance top-1 ~0.4).  Dense speaker coverage is what forces a
smooth voice map; this gate is what proves it happened.

Exits non-zero when the thresholds fail, so chip-side CT training never
runs on an embedder that cannot express the zero-shot target.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _embed_speaker(inf, sdir: str, limit: int = 12):
    from cmtts_tpu_torch.audio.wavio import read_wav

    wavs = [n for n in sorted(os.listdir(sdir)) if n.endswith(".wav")]
    embs = []
    for n in wavs[:limit]:  # filter BEFORE slicing: .lab files sort first
        wav, _ = read_wav(os.path.join(sdir, n))
        if len(wav) >= 1024:
            embs.append(inf.embed_utterance(wav))
    if not embs:
        raise ValueError(f"no usable wavs under {sdir}")
    return np.stack(embs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--embedder_ckpt", required=True)
    ap.add_argument("--holdout_root", required=True)
    ap.add_argument("--train_root", required=True)
    ap.add_argument("--min_top1", type=float, default=0.75,
                    help="min fraction of holdout utterances ranking "
                         "their own centroid above every train centroid")
    ap.add_argument("--min_margin", type=float, default=0.0,
                    help="min mean (cos_own - max cos_train) margin")
    ap.add_argument("--train_limit", type=int, default=8,
                    help="utterances per train speaker for the centroid "
                         "(more = less estimator noise in max cos_train)")
    ap.add_argument("--holdout_limit", type=int, default=12,
                    help="holdout utterances per speaker to rank (more = "
                         "tighter leave-one-out centroid and more "
                         "statistical power at the top-1 threshold)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.models.speaker import (
        GE2EInference,
        ge2e_from_checkpoint,
    )

    inf = GE2EInference(ge2e_from_checkpoint(args.embedder_ckpt),
                        cli_device(args.device))

    train_cent = {}
    for spk in sorted(os.listdir(args.train_root)):
        sdir = os.path.join(args.train_root, spk)
        if not os.path.isdir(sdir):
            continue
        c = _embed_speaker(inf, sdir, limit=args.train_limit).mean(axis=0)
        train_cent[spk] = c / (np.linalg.norm(c) + 1e-12)
    names = list(train_cent)
    T = np.stack([train_cent[s] for s in names])

    # calibration: how crowded is the train space itself?
    inter = T @ T.T
    iu = np.triu_indices(len(names), 1)
    report: dict = {"inter_train_cos": {
        "mean": round(float(inter[iu].mean()), 4),
        "p90": round(float(np.percentile(inter[iu], 90)), 4),
        "max": round(float(inter[iu].max()), 4),
    }, "speakers": {}}

    ok = True
    for spk in sorted(os.listdir(args.holdout_root)):
        sdir = os.path.join(args.holdout_root, spk)
        if not os.path.isdir(sdir):
            continue
        E = _embed_speaker(inf, sdir, limit=args.holdout_limit)
        n = len(E)
        top1, margins = 0, []
        for i in range(n):
            own = E[np.arange(n) != i].mean(axis=0)
            own /= np.linalg.norm(own) + 1e-12
            cos_own = float(E[i] @ own)
            cos_tr = T @ E[i]
            m = cos_own - float(cos_tr.max())
            margins.append(m)
            top1 += m > 0
        rate = top1 / n
        margin = float(np.mean(margins))
        nearest_spk = names[int(np.argmax(T @ (E.mean(0) /
                                               np.linalg.norm(E.mean(0)))))]
        passed = rate >= args.min_top1 and margin >= args.min_margin
        ok &= passed
        report["speakers"][spk] = {
            "top1_rate": round(rate, 4),
            "margin_mean": round(margin, 4),
            "margin_min": round(float(np.min(margins)), 4),
            "nearest_train_spk": nearest_spk,
            "n_utts": n,
            "pass": passed,
        }
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    if not ok:
        raise SystemExit(
            f"GE2E holdout gate FAILED (min_top1={args.min_top1}, "
            f"min_margin={args.min_margin})")
    print("GE2E holdout gate: PASS")
    return report


if __name__ == "__main__":
    main()
