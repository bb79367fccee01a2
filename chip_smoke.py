#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build the MRF kernels,
hold each against its plain PyTorch version on the card, then synthesise
at full LJSpeech width through the port's ``Synthesizer``.

    python3 chip_smoke.py

Phases (none catches its own failure; any mismatch raises and the script
exits non-zero):
  1. device, power limit, torch/CUDA versions, kernel build time;
  2. kernel vs plain version on the card: edge shapes in float32 (tight)
     and bfloat16, the shapes of a 768-frame mel, and the shapes of the
     batch-8, 1024-frame main path (timed: kernel, plain, bound);
  3. synthesis (random weights from a seed): B=1 from text at T=1, checked
     against the float32 acoustic model on the CPU and the plain vocoder on
     the card; B=8 at 96 tokens (mel bucket 1024) at T=1 and T=2, with the
     real-time factor.  Launch counters are zeroed before this phase.
  4. a ``{"kernels": [...]}`` line, the card's name and power limit, and
     a last line ``{"ok": true, "device": {...}}``.

Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

KS, DS = (3, 7, 11), (1, 3, 5)
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
F32_TOL = dict(rtol=2e-4, atol=2e-4)    # reassociation only
BF16_TOL = dict(rtol=0.1, atol=0.05)    # the JAX suite's bf16 tolerance
TEXT = ("Printing, in the only sense with which we are at present "
        "concerned, differs from most if not from all the arts.")


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    import torch

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


def stage_bound(B, C, L, head: bool):
    """(ms, "operations" | "bytes"): the least time for one stage, the
    larger of its bf16 FLOP at the tensor-core peak and its bytes (x read
    once, output written once, bf16 weights and f32 biases read once) at
    the memory rate."""
    flop = 252 * C * C * L * B + (14 * C * L * B if head else 0)
    nbytes = (C * L * B * 4 + (L * B if head else C * L * B) * 4
              + 126 * C * C * 2 + 18 * C * 4)
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check(name, out, ref, tol):
    import torch

    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(out, ref, **tol, msg=lambda m: f"{name}: {m}")
    return float((out - ref).abs().max())


def run_stage(mrf, x, packs, dtype, post, streamed):
    w, b = packs[dtype]
    if streamed:
        return lambda: mrf.fused_mrf_stage_streamed(x, w, b, KS, DS, dtype)
    p = None if post is None else post[dtype]
    return lambda: mrf.fused_mrf_stage(x, (w, b), KS, DS, dtype, post=p)


def plain_stage(mrf, x, packs, dtype, post):
    w, b = packs[dtype]
    p = None if post is None else post[dtype]
    return lambda: mrf.mrf_stage_plain(x, w, b, KS, DS, dtype, p)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cmtts_tpu_torch.cli.synthesize import preprocess_english, random_cmtts
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.masks import DEFAULT_MEL_BUCKETS, pick_bucket
    from cmtts_tpu_torch.models.hifigan import HiFiGANGenerator
    from cmtts_tpu_torch.ops import mrf
    from cmtts_tpu_torch.pipeline import Synthesizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # -- phase 1 -----------------------------------------------------------
    log(f"# device: {torch.cuda.get_device_name(0)} | {smi}")
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    build_s = mrf.build_kernels(force=True)
    log(f"# kernel build: {build_s:.1f} s (nvcc, sm_90a)")

    # -- phase 2: kernel vs plain ------------------------------------------
    torch.manual_seed(0)
    gen = HiFiGANGenerator().to(dev).eval()
    chans = {gen.stage_channels(i): i for i in range(4)}
    dtypes = (torch.float32, torch.bfloat16)
    packs = {C: {dt: mrf.pack_mrf_params(gen, i, dt) for dt in dtypes}
             for C, i in chans.items()}
    posts = {}
    for C in chans:
        g = torch.Generator(device=dev).manual_seed(C)
        wp = torch.randn(7, C, device=dev, generator=g) * 0.1
        bp = torch.full((1,), 0.05, device=dev)
        posts[C] = {dt: (wp.to(dt).contiguous(), bp) for dt in dtypes}

    def case(label, B, C, L, head, dtype, timed=False, seed=0):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(B, C, L, device=dev, generator=g) * 0.3
        streamed = C > 128
        post = posts[C] if head else None
        kern = run_stage(mrf, x, packs[C], dtype, post, streamed)
        plain = plain_stage(mrf, x, packs[C], dtype, post)
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err = check(f"{label} B={B} C={C} L={L} head={head} {dtype}",
                    out, ref, tol)
        bound_ms, bound_by = stage_bound(B, C, L, head)
        res = {"err": err, "bound_ms": bound_ms, "bound_by": bound_by}
        if timed:
            res["ms"] = cuda_ms(kern)
            res["plain_ms"] = cuda_ms(plain)
        log(f"  {label:9s} {'streamed' if streamed else 'fused':8s} B={B} "
            f"C={C:3d} L={L:6d} head={int(head)} "
            f"{str(dtype).split('.')[-1]:8s} max|err|={err:.3e} "
            + (f"kernel {res['ms']:.3f} ms plain {res['plain_ms']:.3f} ms "
               if timed else "")
            + f"bound {res['bound_ms']:.4f} ms")
        return res

    log("# phase 2: kernel vs plain version (f32 tol "
        f"{F32_TOL}, bf16 tol {BF16_TOL})")
    for dtype in dtypes:
        for C in (32, 64, 128, 256):
            for L in (40, 50, 300, 1237):
                for head in ((False,) if C > 128 else (False, True)):
                    case("edge", 2, C, L, head, dtype)
    for dtype in dtypes:   # the stages of a 768-frame mel, B=1
        for i, (C, up) in enumerate(((256, 8), (128, 64), (64, 128),
                                     (32, 256))):
            case("mel768", 1, C, 768 * up, i == 3, dtype)
    timing = {"fused": [], "streamed": []}
    for i, (C, up) in enumerate(((256, 8), (128, 64), (64, 128), (32, 256))):
        res = case("main", 8, C, 1024 * up, i == 3, torch.bfloat16,
                   timed=True, seed=i)
        timing["streamed" if C > 128 else "fused"].append(res)

    # -- phase 3: synthesis at full LJSpeech width -------------------------
    cfg = load_configs("LJSpeech")
    torch.manual_seed(1)
    model = random_cmtts(cfg, seed=1)
    torch.manual_seed(2)
    vocoder = HiFiGANGenerator()
    tokens = preprocess_english(TEXT, cfg.data.lexicon_path,
                                list(cfg.data.text_cleaners))
    hop, sr = cfg.stft.hop_length, cfg.stft.sampling_rate
    counters = (mrf.fused_mrf_stage, mrf.fused_mrf_stage_streamed)
    for fn in counters:
        fn.launches = 0
    log("# phase 3: synthesis (LJSpeech config, random weights, bf16)")

    def counted_call(synth, seqs, **kw):
        before = [fn.launches for fn in counters]
        mel, lens, wav = synth(seqs, **kw)
        rose = [fn.launches - b for fn, b in zip(counters, before)]
        if rose != [3, 1]:
            raise AssertionError(f"kernel launches per call {rose} != [3, 1]")
        t_mel = mel.shape[1]
        if wav.shape != (len(seqs), t_mel * hop) or not (
                torch.from_numpy(wav).isfinite().all()
                and torch.from_numpy(mel).isfinite().all()):
            raise AssertionError(f"bad output: wav {wav.shape} mel {mel.shape}")
        return mel, lens, wav

    # B=1 from text, T=1
    synth1 = Synthesizer(cfg, model, vocoder, T=1)
    # the pipeline's own mel-bucket estimate, so that x_T can be shared
    # with the CPU reference
    t_mel = pick_bucket(min(len(tokens) * 10, cfg.model.max_seq_len),
                        DEFAULT_MEL_BUCKETS)
    x_T = torch.randn(1, t_mel, cfg.stft.n_mel_channels,
                      generator=torch.Generator().manual_seed(3)) \
        * synth1.sched.sigma_max
    mel, lens, wav = counted_call(synth1, [tokens], x_T=x_T)
    with torch.no_grad():
        wav_plain = vocoder(torch.from_numpy(mel).to(dev)).cpu()
    err_voc = check("B=1 vocoder kernels vs plain f32 vocoder",
                    torch.from_numpy(wav), wav_plain, BF16_TOL)
    cpu_synth = Synthesizer(cfg, random_cmtts(cfg, seed=1), None, T=1,
                            compute_dtype=torch.float32, device="cpu")
    mel_cpu, lens_cpu, _ = cpu_synth([tokens], x_T=x_T)
    if not (lens_cpu == lens).all():
        raise AssertionError(f"mel_lens {lens} != CPU f32 {lens_cpu}")
    err_mel = check("B=1 mel (bf16 denoiser on the card) vs CPU f32",
                    torch.from_numpy(mel), torch.from_numpy(mel_cpu),
                    BF16_TOL)
    log(f"  B=1 T=1: {len(tokens)} tokens, mel bucket {t_mel}, mel_len "
        f"{int(lens[0])}; max|err| mel vs CPU f32 {err_mel:.3e}, "
        f"wav vs plain vocoder {err_voc:.3e}")

    def rtf(synth, seqs, reps=5, **kw):
        counted_call(synth, seqs, **kw)            # warm-up
        times, audio = [], None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, lens_, _ = counted_call(synth, seqs, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            audio = float(lens_.sum()) * hop / sr
        wall = statistics.median(times)
        return wall / audio, wall, audio

    results = {}
    r, wall, audio = rtf(synth1, [tokens])
    results["B1_T1"] = r
    log(f"  RTF B=1 T=1: {r:.6f} (median wall {wall * 1e3:.2f} ms for "
        f"{audio:.3f} s of audio)")
    batch = [np.random.RandomState(i).randint(13, 140, 96).astype(np.int32)
             for i in range(8)]
    for T in (1, 2):
        synth = synth1 if T == 1 else Synthesizer(cfg, model, vocoder, T=2)
        r, wall, audio = rtf(synth, batch, mel_bucket=1024)
        results[f"B8_T{T}"] = r
        log(f"  RTF B=8 T={T} (mel bucket 1024): {r:.6f} (median wall "
            f"{wall * 1e3:.2f} ms for {audio:.3f} s of audio)")
    launches = {fn.__name__: fn.launches for fn in counters}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    log(f"# main-path launches: {launches}")

    # -- phase 4: summary lines --------------------------------------------
    src = "cmtts_tpu_torch/csrc/mrf.cu"
    kernels = []
    for name, key, replaces in (
            ("fused_mrf_stage", "fused", "cmtts_tpu/ops/mrf_pallas.py:234"),
            ("fused_mrf_stage_streamed", "streamed",
             "cmtts_tpu/ops/mrf_pallas.py:374")):
        rows = timing[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r_["err"] for r_ in rows),
            "ms": sum(r_["ms"] for r_ in rows),
            "plain_ms": sum(r_["plain_ms"] for r_ in rows),
            "bound_ms": sum(r_["bound_ms"] for r_ in rows),
            "bound_by": ("operations" if all(
                r_["bound_by"] == "operations" for r_ in rows) else "bytes"),
            "library_ms": None})
    print(json.dumps({"rtf": results, "build_s": build_s}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
