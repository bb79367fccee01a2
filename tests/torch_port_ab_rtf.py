"""A/B timing of the port's LJSpeech synthesis on one CUDA card: two
checkouts of the repository, each timed in its own process, in the order
A, B, B, A, so that drift of the card or its host shows up as A differing
from itself.

    python3 tests/torch_port_ab_rtf.py <root A> <root B> [--reps 20]

Each process builds its checkout's kernels, then times
``Synthesizer.__call__`` (host clock, ending in a device synchronise;
median and minimum of ``--reps`` calls after 2 warm-ups) at B=1 from text
(T=1) and at B=8 x 96 tokens, mel bucket 1024 (T=1 and T=2), with random
weights from a seed; then at B=8 alone: ``hifigan_apply_fused``, the
device-side ``Synthesizer.synthesize``, ``CMTTS.condition`` and one bf16
denoiser pass.  Prints the card's name and power limit, one JSON line a
process, then a table.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

TEXT = ("Printing, in the only sense with which we are at present "
        "concerned, differs from most if not from all the arts.")

_CHILD = r"""
import json, statistics, sys, time
import numpy as np, torch
root, reps, text = sys.argv[1], int(sys.argv[2]), sys.argv[3]
sys.path.insert(0, root)
from cmtts_tpu_torch.cli.synthesize import preprocess_english, random_cmtts
from cmtts_tpu_torch.core.config import load_configs
from cmtts_tpu_torch.models.hifigan import HiFiGANGenerator, hifigan_apply_fused
from cmtts_tpu_torch.ops import mrf
from cmtts_tpu_torch.pipeline import Synthesizer
mrf.build_kernels()
cfg = load_configs("LJSpeech")
model = random_cmtts(cfg, seed=1)
torch.manual_seed(2)
vocoder = HiFiGANGenerator()
tokens = preprocess_english(text, cfg.data.lexicon_path,
                            list(cfg.data.text_cleaners))
batch = [np.random.RandomState(i).randint(13, 140, 96).astype(np.int32)
         for i in range(8)]

def walls(fn):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(out), "min_ms": min(out)}

res = {"root": root}
s1 = Synthesizer(cfg, model, vocoder, T=1)
s2 = Synthesizer(cfg, model, vocoder, T=2)
res["B1_T1"] = walls(lambda: s1([tokens]))
res["B8_T1"] = walls(lambda: s1(batch, mel_bucket=1024))
res["B8_T2"] = walls(lambda: s2(batch, mel_bucket=1024))
mel8 = torch.randn(8, 1024, 80, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(4))
res["B8_vocoder"] = walls(
    lambda: hifigan_apply_fused(s1.vocoder, mel8, s1.vocoder_packed))
texts = torch.from_numpy(np.stack(batch)).cuda()
lens = torch.full((8,), 96, dtype=torch.int32, device="cuda")
with torch.no_grad():
    res["B8_core"] = walls(lambda: s1.synthesize(texts, lens, 1024))
    res["B8_condition"] = walls(lambda: s1.model.condition(texts, lens, 1024))
    cond = s1.model.condition(texts, lens, 1024)["cond"]
    x = (mel8 * 0.5).to(torch.bfloat16)
    t = torch.full((8,), 500.0, device="cuda")
    res["B8_denoiser"] = walls(lambda: s1.denoiser(x, t, cond))
print("AB " + json.dumps(res), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    runs = []
    for label, root in (("A", args.root_a), ("B", args.root_b),
                        ("B", args.root_b), ("A", args.root_a)):
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, os.path.abspath(root),
             str(args.reps), TEXT], capture_output=True, text=True,
            timeout=600, check=True)
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("AB "))
        res = json.loads(line[3:])
        res["label"] = label
        print(json.dumps(res), flush=True)
        runs.append(res)
    keys = ("B1_T1", "B8_T1", "B8_T2", "B8_vocoder", "B8_core",
            "B8_condition", "B8_denoiser")
    print("| run | " + " | ".join(f"{k} median / min ms" for k in keys)
          + " |")
    print("|---" * (len(keys) + 1) + "|")
    for r in runs:
        print(f"| {r['label']} {os.path.relpath(r['root'])} | " + " | ".join(
            f"{r[k]['median_ms']:.2f} / {r[k]['min_ms']:.2f}" for k in keys)
            + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
