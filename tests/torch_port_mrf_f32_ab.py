"""A/B timing of the MRF routes on one CUDA card: two checkouts of the
repository, each timed in its own process, in the order A, B, B, A, so
that drift of the card or its host shows up as A differing from itself.

    python3 tests/torch_port_mrf_f32_ab.py <root A> <root B> [--reps 5]

Each process builds its checkout's kernels (TF32 off, as the port's
entry points set it), then, with HiFi-GAN V1's weights drawn from a seed,
times with CUDA events (the mean of ``--reps`` calls after one warm-up)
the four MRF stages of a batch-8, 1024-frame mel and of a 768-frame mel
at B=1 through the wrappers, in float32 and in bfloat16, each held to its
plain version (float32 at rtol = atol = 2e-4, bfloat16 at rtol = 2^-6,
atol = 1e-2 as chip_smoke.py holds it), and the whole
``hifigan_apply_fused`` at B=8, mel 1024, in both types and at B=1, mel
768, in bfloat16.  Prints the card's name and power limit, one JSON line
a process, then a table.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, sys
import torch
root, reps = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, root)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from cmtts_tpu_torch.models.hifigan import (HiFiGANGenerator,
                                            hifigan_apply_fused,
                                            pack_generator)
from cmtts_tpu_torch.ops import mrf
mrf.build_kernels()
KS, DS = (3, 7, 11), (1, 3, 5)
f32 = torch.float32
torch.manual_seed(0)
gen = HiFiGANGenerator().cuda().eval()

def ms(fn):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

res = {"root": root}
tols = {f32: dict(rtol=2e-4, atol=2e-4),
        torch.bfloat16: dict(rtol=2 ** -6, atol=1e-2)}
with torch.no_grad():
    for dt in (f32, torch.bfloat16):
        packs = [mrf.pack_mrf_params(gen, i, dt) for i in range(4)]
        post = mrf.pack_post_params(gen, dt)
        name = str(dt).split(".")[-1]
        for B, frames in ((8, 1024), (1, 768)):
            rows = []
            for i, (C, up) in enumerate(((256, 8), (128, 64), (64, 128),
                                         (32, 256))):
                g = torch.Generator(device="cuda").manual_seed(i)
                x = torch.randn(B, C, frames * up, device="cuda",
                                generator=g) * 0.3
                p = post if i == 3 else None
                if i == 0:
                    kern = lambda: mrf.fused_mrf_stage_streamed(
                        x, packs[0], KS, DS, dt)
                else:
                    kern = lambda: mrf.fused_mrf_stage(x, packs[i], KS, DS,
                                                       dt, post=p)
                ref = mrf.mrf_stage_plain(x, packs[i][0], packs[i][1], KS, DS,
                                          dt, p)
                out = kern()
                torch.testing.assert_close(out, ref, **tols[dt])
                rows.append({"C": C, "ms": ms(kern),
                             "err": float((out - ref).abs().max())})
            res[f"{name}_B{B}_mel{frames}"] = rows
    for dt, B, frames in ((f32, 8, 1024), (torch.bfloat16, 8, 1024),
                          (torch.bfloat16, 1, 768)):
        mel = torch.randn(B, frames, 80, device="cuda",
                          generator=torch.Generator(device="cuda")
                          .manual_seed(4))
        pk = pack_generator(gen, dt)
        res[f"vocoder_B{B}_{str(dt).split('.')[-1]}"] = ms(
            lambda: hifigan_apply_fused(gen, mel, pk, dt))
print("AB " + json.dumps(res), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root_a")
    ap.add_argument("root_b")
    ap.add_argument("--reps", type=int, default=5)
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
             str(args.reps)], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("AB "))
        res = json.loads(line[3:])
        res["label"] = label
        print(json.dumps(res), flush=True)
        runs.append(res)
    print("| run | type | B=8 mel 1024 ms, C = 256 / 128 / 64 / 32 (sum) | "
          "B=1 mel 768 ms (sum) |")
    print("|---|---|---|---|")
    for r in runs:
        for name in ("float32", "bfloat16"):
            cols = []
            for key in ("B8_mel1024", "B1_mel768"):
                t = [row["ms"] for row in r[f"{name}_{key}"]]
                cols.append(" / ".join(f"{v:.3f}" for v in t)
                            + f" ({sum(t):.3f})")
            print(f"| {r['label']} {os.path.relpath(r['root'])} | {name} | "
                  + " | ".join(cols) + " |")
    print("| run | vocoder B=8 f32 ms | B=8 bf16 ms | B=1 mel 768 bf16 ms |")
    print("|---|---|---|---|")
    for r in runs:
        print(f"| {r['label']} {os.path.relpath(r['root'])} | "
              f"{r['vocoder_B8_float32']:.3f} | {r['vocoder_B8_bfloat16']:.3f}"
              f" | {r['vocoder_B1_bfloat16']:.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
