"""Deterministically extend a generate_multispeaker_corpus zero-shot
holdout set, without touching the train split or retraining anything.
Port of ``tools/extend_holdout.py`` (host only: numpy, no device), over
the port's copy of ``data/synthcorpus.py``.

Two extensions, both statistical-power fixes for the GE2E holdout gate
(``cmtts_tpu_torch.tools.check_ge2e_holdout``), whose top-1 criterion at
threshold 0.75 is far too noisy at n=12..20 utterances per speaker (a
true-0.75 embedder fails a 12-utterance gate ~half the time):

  * more utterances for the EXISTING holdout voices (same profile,
    new deterministic utterance indices), and
  * additional NOVEL holdout voices sampled under the same
    min-profile-distance protocol (``data/synthcorpus.py``
    holdout_speaker_profile), so the gate measures the embedder over
    more than two arbitrary draws of the voice space.

The corpus generator is deterministic per (seed, speaker_index,
utt_index) -- see synthcorpus.generate_multispeaker_corpus: profile rng
is RandomState(seed*31 + si), utterance rng RandomState(seed +
si*100003 + ui).  This script replays that stream; before writing
anything it regenerates one EXISTING holdout utterance and requires it
to be byte-identical to the file on disk (proof the reconstruction
matches the original generation).

    python -m cmtts_tpu_torch.tools.extend_holdout --out R --speakers 12 \\
        --holdout 2 --utts_per_speaker 50 [--extend_utts_to 60 --extra_speakers 4]
"""

from __future__ import annotations

import argparse
import filecmp
import os
import tempfile

import numpy as np

from cmtts_tpu_torch.data.synthcorpus import (
    _write_utterance,
    holdout_speaker_profile,
    speaker_profile,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="corpus root (gen_corpus --out)")
    ap.add_argument("--speakers", type=int, required=True,
                    help="original total speaker count (gen_corpus --speakers)")
    ap.add_argument("--holdout", type=int, required=True,
                    help="original holdout count (gen_corpus --holdout)")
    ap.add_argument("--utts_per_speaker", type=int, required=True,
                    help="original utts per speaker")
    ap.add_argument("--seed", type=int, default=7777)
    ap.add_argument("--extend_utts_to", type=int, default=60,
                    help="target utterance count per holdout speaker")
    ap.add_argument("--extra_speakers", type=int, default=4,
                    help="additional novel holdout voices to add")
    args = ap.parse_args(argv)

    raw_hold = args.out + "/raw_holdout"
    pre_hold = args.out + "/pre_holdout"
    n_train = args.speakers - args.holdout

    # replay the profile stream exactly as generate_multispeaker_corpus
    train_profiles = [speaker_profile(np.random.RandomState(args.seed * 31 + si))
                      for si in range(n_train)]

    def utt_rng(si: int, ui: int):
        return np.random.RandomState(args.seed + si * 100003 + ui)

    def gen_utt(spk_dir, tg_dir, spk, si, ui, profile):
        rng = utt_rng(si, ui)
        base = f"{spk}_{ui:03d}"
        # same draw order as generate_multispeaker_corpus: f0 jitter first
        f0_base = profile["f0_base"] * rng.uniform(0.95, 1.05)
        return base, _write_utterance(
            spk_dir, os.path.join(tg_dir, f"{base}.TextGrid"),
            base, rng, (3, 7), f0_base, profile=profile)

    # ---- determinism self-check: regenerate an existing holdout utt ----
    si0 = n_train
    spk0 = f"v{si0:02d}"
    prof0 = holdout_speaker_profile(
        np.random.RandomState(args.seed * 31 + si0), train_profiles)
    with tempfile.TemporaryDirectory() as td:
        base0, _ = gen_utt(td, td, spk0, si0, 0, prof0)
        ref = os.path.join(raw_hold, spk0, f"{base0}.wav")
        if not filecmp.cmp(os.path.join(td, f"{base0}.wav"), ref, shallow=False):
            raise SystemExit(
                f"determinism check FAILED: regenerated {base0}.wav differs "
                f"from {ref} — refusing to extend a corpus I can't replay")
    print(f"==> determinism check ok ({spk0}_{0:03d} byte-identical)")

    src_lines = []
    for k in range(args.holdout + args.extra_speakers):
        si = n_train + k
        spk = f"v{si:02d}"
        profile = holdout_speaker_profile(
            np.random.RandomState(args.seed * 31 + si), train_profiles)
        spk_dir = os.path.join(raw_hold, spk)
        tg_dir = os.path.join(pre_hold, "TextGrid", spk)
        os.makedirs(spk_dir, exist_ok=True)
        os.makedirs(tg_dir, exist_ok=True)
        start = args.utts_per_speaker if k < args.holdout else 0
        for ui in range(start, args.extend_utts_to):
            base, phones = gen_utt(spk_dir, tg_dir, spk, si, ui, profile)
            core = [p for p in phones if p != "sil"]
            while core and core[0] == "sp":
                core = core[1:]
            while core and core[-1] == "sp":
                core = core[:-1]
            src_lines.append(f"{base}|v00|{{{' '.join(core)}}}|syn")
        print(f"==> {spk}: utts {start}..{args.extend_utts_to - 1} written")

    with open(os.path.join(args.out, "zeroshot_source.txt"), "a") as f:
        f.write("\n".join(src_lines) + "\n")
    print(f"==> appended {len(src_lines)} lines to zeroshot_source.txt")


if __name__ == "__main__":
    main()
