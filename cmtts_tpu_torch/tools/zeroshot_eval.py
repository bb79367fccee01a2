"""Zero-shot identity-transfer evaluation.  Port of
``tools/zeroshot_eval.py`` (GE2E through ``models/speaker.py`` on
``--device``, the metrics through ``metrics/core.py``).

Scores synthesized utterances of a held-out speaker against (a) that
speaker's real recordings and (b) every training speaker's recordings,
using a trained GE2E encoder — the TPU-framework analogue of the
reference's Resemblyzer speaker-cos protocol (all_metrics.py:561-601)
extended with a negative-control ranking: identity transfer is shown by
``cos(syn, target) > cos(syn, other)`` for every other speaker, not by
the absolute cosine alone.

Also reports MCD/FFE of syn vs the target's ground-truth recording of
the same utterance (basename match).

    python -m cmtts_tpu_torch.tools.zeroshot_eval \
        --syn_dir .../step_8000_T1_zeroshot_v10 \
        --target_raw /tmp/zscorp/raw_holdout/v10 \
        --others_root /tmp/zscorp/raw \
        --embedder_ckpt /tmp/ge2e50/ge2e_params.npy \
        --out zs_eval.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _embed_dir(inf, root: str, limit: int | None = None) -> np.ndarray:
    from cmtts_tpu_torch.audio.wavio import read_wav

    names = sorted(f for f in os.listdir(root) if f.endswith(".wav"))
    if limit:
        names = names[:limit]
    embs = []
    for n in names:
        wav, _ = read_wav(os.path.join(root, n))
        if len(wav) < 1024:
            continue
        embs.append(inf.embed_utterance(wav))
    if not embs:
        raise ValueError(f"no usable wavs under {root}")
    return np.stack(embs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--syn_dir", required=True,
                    help="synthesized wavs of ONE held-out speaker")
    ap.add_argument("--target_raw", required=True,
                    help="that speaker's real recordings")
    ap.add_argument("--others_root", required=True,
                    help="<root>/<speaker>/*.wav of the training speakers "
                         "(negative controls)")
    ap.add_argument("--embedder_ckpt", default=None,
                    help="GE2E .npy (cli/train_ge2e.py) or torch .pt")
    ap.add_argument("--ref_utts_per_speaker", type=int, default=8)
    ap.add_argument("--out", default=None, help="write JSON here")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from cmtts_tpu_torch.audio.wavio import read_wav
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.metrics import core
    from cmtts_tpu_torch.models.speaker import (
        GE2EInference,
        ge2e_from_checkpoint,
    )

    inf = GE2EInference(ge2e_from_checkpoint(args.embedder_ckpt),
                        cli_device(args.device))

    syn_names = sorted(f for f in os.listdir(args.syn_dir)
                       if f.endswith(".wav"))
    syn_embs, mcds, ffes, used = [], [], [], []
    for n in syn_names:
        syn, _ = read_wav(os.path.join(args.syn_dir, n))
        if len(syn) < 1024:
            continue
        syn_embs.append(inf.embed_utterance(syn))
        used.append(n)
        raw_path = os.path.join(args.target_raw, n)
        if os.path.exists(raw_path):
            raw, _ = read_wav(raw_path)
            mcds.append(core.mcd_dtw(syn, raw))
            # ffe counts errors over REFERENCE-voiced frames: (ref, syn)
            ffes.append(core.ffe(raw, syn))
    if not syn_embs:
        raise SystemExit(f"no usable synthesized wavs in {args.syn_dir}")
    syn_embs = np.stack(syn_embs)

    # speaker centroids: target + every training speaker
    tgt = _embed_dir(inf, args.target_raw,
                     args.ref_utts_per_speaker).mean(axis=0)
    tgt /= np.linalg.norm(tgt) + 1e-12
    others = {}
    for spk in sorted(os.listdir(args.others_root)):
        sdir = os.path.join(args.others_root, spk)
        if not os.path.isdir(sdir):
            continue
        c = _embed_dir(inf, sdir, args.ref_utts_per_speaker).mean(axis=0)
        others[spk] = c / (np.linalg.norm(c) + 1e-12)

    cos_tgt = syn_embs @ tgt                      # (N,)
    cos_oth = {s: syn_embs @ c for s, c in others.items()}
    oth_mat = np.stack(list(cos_oth.values()))    # (S, N)
    # per-utterance rank-1 accuracy: target centroid beats every other
    top1 = float(np.mean(cos_tgt > oth_mat.max(axis=0)))

    report = {
        "n_synth": len(used),
        "cos_to_target_mean": round(float(cos_tgt.mean()), 4),
        "cos_to_target_min": round(float(cos_tgt.min()), 4),
        "cos_to_others_mean": round(float(oth_mat.mean()), 4),
        "cos_to_others_max": round(float(oth_mat.max()), 4),
        "target_top1_accuracy": round(top1, 4),
        "per_other_speaker_mean": {
            s: round(float(v.mean()), 4) for s, v in cos_oth.items()},
        "mcd_vs_target_gt": round(float(np.mean(mcds)), 4) if mcds else None,
        "ffe_vs_target_gt": round(float(np.mean(ffes)), 4) if ffes else None,
    }
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
