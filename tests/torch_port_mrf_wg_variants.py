"""Design sweep and time split of the bf16 MRF kernel (csrc/mrf_wg.cu) on
one CUDA card.

    python3 tests/torch_port_mrf_wg_variants.py [--reps 5] [--out FILE]

Builds the kernel as it stands and variants of it, each from a copy of
``csrc/`` with one edit (``VARIANTS``; an edit whose text is not found in
the source fails the run, so the sweep cannot drift from the kernel):

- ``stages3`` / ``stages6``: 3 or 6 weight tiles in the ring, not 4;
- ``groups2``: 2 MMA commit groups kept in flight, not 1;
- ``bm256``: MT = 2 m64 tiles a warpgroup at BN >= 64 too (BM = 256 at
  C >= 64, as at C <= 32);
- ``nopersist``: one window slot, a block a position tile, everywhere;
- ``box128``: window planes copied in tensor copies of at most 128 rows,
  not 256;
- ``occ1``: one block an SM at BN <= 64 too (the launch bound that lets
  ptxas use more registers than two blocks leave);
- ``mt1``: MT = 1 at BN <= 32 too (BM = 128 everywhere);
- ``nowin`` / ``nolrelu`` / ``noepi`` / ``nomma``: the window's tensor
  copies (the producer arrives on each chunk's barrier with none), conv1's
  lrelu pass, the epilogue or the wgmma instructions left out
  (diagnostics: their outputs are not the stage's);
- ``prof``: the kernel with clock64 probes, whose counters split the time
  of consumer thread 0 of every block into the issue of conv2's residual
  rows, the waits for the window's chunks (their barriers and, in conv1,
  the consumers' barrier after the lrelu pass), conv1's lrelu pass (the A
  preparation), the waits on the ring's full barrier, the MMAs' issue
  (their descriptors and ``wgmma`` instructions), the waits for their
  commit groups (``wgmma.wait_group``, the drains before a chunk
  included) and the epilogue; the rest (the steps' counters and
  addresses, the slots' release, the residual rows' wait) is what the
  table's shares leave.

Then, in one process and with HiFi-GAN V1's weights drawn from a seed,
times with CUDA events (the mean of ``--reps`` calls after one warm-up)
the four bf16 MRF stages at B=8, mel 1024 and at B=1, mel 768 through
``fused_mrf_stage``/``fused_mrf_stage_streamed`` with each variant's
library, in the order of ``VARIANTS`` and then back, holding every variant
but the diagnostics to the plain bf16 stage (rtol = 2^-6, atol =
1e-2, as chip_smoke.py).  A stage a variant cannot launch (its shared
memory does not fit) is recorded as null.  Prints the card's name and
power limit, each variant's ptxas faults, the tables and one JSON line.
Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from cmtts_tpu_torch.ops import mrf  # noqa: E402

SRC = "mrf_wg.cu"
_EPI = ("    epilogue<BN, MT, CONV1>(a, acc, smem + (win - raw),\n"
        "                            smem + (win - raw) + area, b, p0, nb);\n")
_NOPERSIST = (
    "a.persist = wg_smem_bytes(BN, a.Cp, a.k, a.d, CONV1, 1) <= kMaxSmem;",
    "a.persist = 0;")
_EXPECT = "          mbar_expect_tx(bar, ppc * nbox * box * 16);\n"
_PROF_READ = r"""
extern "C" int mrf_wg_prof(unsigned long long* out) {
  int e = (int)cudaMemcpyFromSymbol(out, mrf::g_prof, sizeof(mrf::g_prof));
  unsigned long long z[9] = {};
  if (e == 0) e = (int)cudaMemcpyToSymbol(mrf::g_prof, z, sizeof(z));
  return e;
}
"""
# the probes' counters: consumer thread 0's clock64 cycles a block
PROF_KEYS = ("all", "window_wait", "full_wait", "mma_issue", "epilogue",
             "a_prep", "residual_issue", "mma_wait", "blocks")
# (old text, new text) edits of csrc/mrf_wg.cu a variant
VARIANTS = {
    "base": [],
    "stages3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "stages6": [("constexpr int kStages = 4;", "constexpr int kStages = 6;")],
    "groups2": [("constexpr int kMmaGroups = 1;",
                 "constexpr int kMmaGroups = 2;")],
    "bm256": [("return bn >= 64 ? 1 : 2;", "return 2;")],
    "nopersist": [_NOPERSIST],
    "box128": [("constexpr int kMaxBox = 256;", "constexpr int kMaxBox = 128;")],
    "occ1": [("return bn <= 64 ? 2 : 1;", "return 1;")],
    "mt1": [("return bn >= 64 ? 1 : 2;", "return 1;")],
    # the producer arrives on a chunk's barrier with no copies: the windows
    # keep what they held (a diagnostic of the copies' cost)
    "nowin": [(_EXPECT, "          mbar_expect_tx(bar, 0);\n"
                        "          continue;\n")],
    "nolrelu": [("    if (CONV1) {\n      const uint32_t base",
                 "    if (false) {\n      const uint32_t base")],
    "noepi": [(_EPI, "")],
    "nomma": [("Wgmma<BN>::mma(acc[m], da, db);", "")],
    "prof": [
        ("template <int BN, bool CONV1>\n__global__",
         "__device__ unsigned long long g_prof[9];\n\n"
         "template <int BN, bool CONV1>\n__global__"),
        ("  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n\n"
         "  if (threadIdx.x == 0) {",
         "  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;\n"
         "  long long pr[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
         "  const long long pr_start = clock64();\n"
         "  long long pr_t = pr_start;\n\n"
         "  if (threadIdx.x == 0) {"),
        ("    if (!a.persist) {\n      load_residual(t, win0);",
         "    pr_t = clock64();\n"
         "    if (!a.persist) {\n      load_residual(t, win0);"),
        ("      cp_async_commit();\n    }\n    float acc",
         "      cp_async_commit();\n    }\n"
         "    pr[6] += clock64() - pr_t;\n    float acc"),
        ("        wg_wait<0>();\n        for (; rel < tile; ++rel) {",
         "        pr_t = clock64();\n        wg_wait<0>();\n"
         "        pr[7] += clock64() - pr_t;\n"
         "        for (; rel < tile; ++rel) {"),
        ("    mbar_wait(bar, parity);\n    if (CONV1) {",
         "    const long long w0 = clock64();\n"
         "    mbar_wait(bar, parity);\n"
         "    pr[1] += clock64() - w0;\n"
         "    const long long w1 = clock64();\n    if (CONV1) {"),
        ("      fence_proxy_async();\n      consumer_sync();\n    }\n  };",
         "      fence_proxy_async();\n"
         "      pr[5] += clock64() - w1;\n"
         "      const long long w2 = clock64();\n"
         "      consumer_sync();\n"
         "      pr[1] += clock64() - w2;\n    }\n  };"),
        ("      mbar_wait(full + 8 * slot, (n / kStages) & 1);\n",
         "      pr_t = clock64();\n"
         "      mbar_wait(full + 8 * slot, (n / kStages) & 1);\n"
         "      pr[2] += clock64() - pr_t;\n      pr_t = clock64();\n"),
        ("      wg_commit();\n      wg_wait<kMmaGroups>();\n",
         "      wg_commit();\n      pr[3] += clock64() - pr_t;\n"
         "      pr_t = clock64();\n      wg_wait<kMmaGroups>();\n"
         "      pr[7] += clock64() - pr_t;\n"),
        ("    wg_wait<0>();\n    for (; rel < tiles; ++rel) {",
         "    pr_t = clock64();\n    wg_wait<0>();\n"
         "    pr[7] += clock64() - pr_t;\n"
         "    for (; rel < tiles; ++rel) {"),
        (_EPI, "    pr_t = clock64();\n" + _EPI
         + "    pr[4] += clock64() - pr_t;\n"),
        ("    mbar_arrive_if(wempty + 8 * s, lane == 0);\n  }\n}\n",
         "    mbar_arrive_if(wempty + 8 * s, lane == 0);\n  }\n"
         "  if (threadIdx.x == 0) {\n"
         "    pr[0] = clock64() - pr_start;\n"
         "    for (int i = 0; i < 8; ++i) {\n"
         "      atomicAdd(&g_prof[i], (unsigned long long)pr[i]);\n"
         "    }\n"
         "    atomicAdd(&g_prof[8], 1ull);\n"
         "  }\n}\n"),
    ],
}
DIAGNOSTIC = ("nowin", "nolrelu", "noepi", "nomma")
KS, DS = (3, 7, 11), (1, 3, 5)
STAGES = ((256, 8), (128, 64), (64, 128), (32, 256))


def variant_source(name: str, text: str) -> str:
    """csrc/mrf_wg.cu's ``text`` with variant ``name``'s edits; raises if
    an edit's text is not found exactly once."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:60]!r} is not in "
                             f"{SRC} exactly once")
        text = text.replace(old, new)
    if name == "prof":
        text += _PROF_READ
    return text


def build_variant(name: str, out_dir: str) -> tuple:
    """Build variant ``name`` of csrc/mrf_wg.cu as a library of its own;
    returns (path, the ptxas faults of its conv kernels)."""
    src_dir = os.path.join(out_dir, name)
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(mrf._CSRC, src_dir)
    with open(os.path.join(mrf._CSRC, SRC)) as f:
        text = variant_source(name, f.read())
    with open(os.path.join(src_dir, SRC), "w") as f:
        f.write(text)
    lib = os.path.join(out_dir, f"libmrf_wg_{name}.so")
    res = subprocess.run(
        [mrf._nvcc(), *mrf.NVCC_FLAGS, "-shared",
         os.path.join(src_dir, SRC), "-o", lib],
        capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{res.stderr}")
    log = res.stdout + res.stderr
    faults = [ln.strip() for ln in log.splitlines()
              if ("wgmma" in ln and "serialized" in ln)
              or re.search(r"[1-9]\d* bytes spill (stores|loads)", ln)]
    return lib, faults


def load_variant(path: str):
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mrf_stage_bf16.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                   i, i, i, i, i, ctypes.POINTER(i),
                                   ctypes.POINTER(i), i, p]
    lib.mrf_stage_bf16.restype = i
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="also write the JSON line to this file")
    args = ap.parse_args()
    import torch
    from cmtts_tpu_torch.models.hifigan import HiFiGANGenerator

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    out_dir = os.path.join(_ROOT, "build", "wg_variants")
    os.makedirs(out_dir, exist_ok=True)
    names = list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: build_variant(n, out_dir), names)))
    for n in names:
        print(f"ptxas {n}: {built[n][1] or 'no spill, no serialised wgmma'}",
              flush=True)
    libs = {n: load_variant(built[n][0]) for n in names}

    bf = torch.bfloat16
    torch.manual_seed(0)
    gen = HiFiGANGenerator().cuda().eval()
    packs = [mrf.pack_mrf_params(gen, i, bf) for i in range(4)]
    post = mrf.pack_post_params(gen, bf)
    cases = []
    for B, frames in ((8, 1024), (1, 768)):
        for i, (C, up) in enumerate(STAGES):
            g = torch.Generator(device="cuda").manual_seed(i)
            x = torch.randn(B, C, frames * up, device="cuda",
                            generator=g) * 0.3
            p = post if i == 3 else None
            ref = mrf.mrf_stage_plain(x, packs[i][0], packs[i][1], KS, DS,
                                      bf, p)
            cases.append((f"B{B}_mel{frames}", i, x, p, ref))

    def call(i, x, p):
        if i == 0:
            return mrf.fused_mrf_stage_streamed(x, packs[0], KS, DS, bf)
        return mrf.fused_mrf_stage(x, packs[i], KS, DS, bf, post=p)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    times = {n: {} for n in names}
    prof = {}
    with torch.no_grad():
        for n in names + names[::-1]:
            mrf._lib = libs[n]
            for key, i, x, p, ref in cases:
                try:
                    out = call(i, x, p)
                except RuntimeError:          # does not fit: not launched
                    times[n].setdefault(key, [[None] * 4, [None] * 4])
                    continue
                if n not in DIAGNOSTIC:
                    torch.testing.assert_close(out, ref, rtol=2 ** -6,
                                               atol=1e-2)
                t = ms(lambda: call(i, x, p))
                runs = times[n].setdefault(key, [[None] * 4, [None] * 4])
                runs[0 if runs[0][i] is None else 1][i] = t
        # the time split: one call a stage after the timing's warm-ups
        mrf._lib = libs["prof"]
        buf = (ctypes.c_ulonglong * len(PROF_KEYS))()
        for key, i, x, p, _ in cases:
            libs["prof"].mrf_wg_prof(buf)          # clears the counters
            call(i, x, p)
            torch.cuda.synchronize()
            if libs["prof"].mrf_wg_prof(buf) != 0:
                raise RuntimeError("reading the probes failed")
            prof.setdefault(key, []).append(dict(zip(PROF_KEYS, list(buf))))
    mrf._lib = None

    def fmt(v):
        return "n/a" if v is None else f"{v:.3f}"

    for key in (c[0] for c in cases[::4]):
        print(f"\n| variant | {key}: C = 256 / 128 / 64 / 32 ms, first run; "
              f"second run | sum |")
        print("|---|---|---|")
        for n in names:
            a, b = times[n][key]
            s = [sum(r) if None not in r else None for r in (a, b)]
            print(f"| {n} | {' / '.join(map(fmt, a))}; "
                  f"{' / '.join(map(fmt, b))} | {fmt(s[0])}; {fmt(s[1])} |")
    print("\n| probes | stage C | blocks | kcycles a block | residual issue | "
          "window wait | A prep | full wait | MMA issue | MMA wait | "
          "epilogue |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for key, rows in prof.items():
        for (C, _), r in zip(STAGES, rows):
            allc = max(r["all"], 1)

            def pct(k):
                return f"{100 * r[k] / allc:.1f}%"

            print(f"| {key} | {C} | {r['blocks']} | "
                  f"{r['all'] / max(r['blocks'], 1) / 1e3:.1f} | "
                  f"{pct('residual_issue')} | {pct('window_wait')} | "
                  f"{pct('a_prep')} | {pct('full_wait')} | "
                  f"{pct('mma_issue')} | {pct('mma_wait')} | "
                  f"{pct('epilogue')} |")
    res = {"times_ms": times, "probes": prof,
           "ptxas_faults": {n: built[n][1] for n in names}}
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
