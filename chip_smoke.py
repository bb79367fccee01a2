#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build the MRF kernels,
hold each against its plain PyTorch version on the card, then synthesise
at full LJSpeech width through the port's ``Synthesizer``, and zero-shot
at full VCTK width with both speaker embedders and every sampler.

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --kernels   # phases 1 and 2 only

Phases (none catches its own failure; any mismatch raises and the script
exits non-zero):
  1. device, power limit, torch/CUDA versions, kernel build time, each
     kernel's registers and stack (``cuobjdump -res-usage``), the ptxas
     log of the bf16 conv kernels (no spill, no serialised wgmma) and the
     count of warpgroup tensor-core (HGMMA) instructions in the SASS: not
     0 in the bf16 conv kernels; no HMMA or HGMMA in any float32 one;
  2. kernel vs plain version on the card: edge shapes at every width of
     the kernels (C = 8, V2's last stage, which the bf16 route pads to 16
     channels, to 256) in float32 (the SIMT conv kernels) and bfloat16
     (the wgmma conv kernels), each held to its plain version within about
     a rounding of its type, the shapes of a 768-frame mel at B=1 and of
     the batch-8, 1024-frame main path in both types (timed: kernel,
     plain, the bound at the type's own peak, the share of it reached,
     TFLOP/s of useful work and, in bf16, of the MMA work the kernel's
     tiling issues, and beside each B=8 bf16 stage a cuDNN yardstick: the
     18 ``F.conv1d`` in bf16 with the same elementwise ops, timed only);
  3. synthesis (random weights from a seed): B=1 from text at T=1, checked
     against the float32 acoustic model on the CPU and the plain vocoder on
     the card; B=8 at 96 tokens (mel bucket 1024) at T=1 and T=2, with the
     real-time factor; B=1 in float32 (the float32 kernels' users), its
     wav against the plain float32 vocoder.  Launch counters are zeroed
     before this phase.
  5. zero-shot and samplers at full VCTK width (random weights from a
     seed): a 3 s reference wav embedded by DeepSpeaker and by GE2E on the
     card, each against the same embedder on the CPU (float32, TF32 off);
     B=1 synthesis with that embedding against the CPU float32 port and
     the plain vocoder, and a second voice must move the mel; B=1 and
     B=8 x 96 tokens (mel 1024, 8 voices) RTF; every ODE sampler and
     our_multistep in float32 against the CPU on the same injected noise;
     heun with 18 levels at B=8 in bf16; ``synthesize_long`` over three
     chunks; the zero-shot CLI from a reference wav.  Launch counters are
     zeroed before its synthesis calls and must all rise again.
  6. consistency training at full LJSpeech width (random init from a
     seed, a seeded feature corpus of 128 + 8 utterances written under
     ``build/``): one f32 CT step at B=2 on the card against the same step
     on the CPU (dropout zeroed, TF32 off); timed B=32 CT steps on the
     corpus's bucketed batches in f32 and bf16 with the loss-second-moment
     sampler (median ms, steps/s, peak memory, the denoiser's TFLOP/s, and
     one step split into student forward, target forward, backward and
     optimizer); one CD, progdist and EDM step each; then the CLIs:
     train, auto-resume (the restored state must equal the saved one) and
     synthesis from the trained checkpoint with HiFi-GAN on random weights,
     whose MRF kernel launches are counted.  Its numbers go on a
     ``{"train": {...}}`` line.
  7. the data journey at full LJSpeech width through the CLIs, under
     ``build/chip_smoke_data/`` (removed at the end): a 72-utterance
     formant corpus; ``cli.preprocess`` on the card, then the same
     TextGrids preprocessed on the card, on the CPU and on the card with 2
     workers (card vs CPU: the alignment, f0, pitch and CWT features, the
     split and speakers.json equal, mel, energy and stats.json within
     tolerance; 2 workers bit-identical to serial), with utterances/s and
     per-utterance front-end (CUDA events) against host ms; 4 bf16 CT
     steps; ``cli.synthesize --mode batch --restore_step 0`` of the 8 val
     utterances with HiFi-GAN on random weights (MRF launches counted);
     ``cli.all_metrics`` synthesized vs raw and raw vs raw (MCD 0), in two
     subprocesses beside ``cli.evaluate`` (then card vs CPU on one x_T) and
     ``cli.get_mel_cache`` (one file vs the CPU).  Its numbers go on a
     ``{"data": {...}}`` line.
  8. serving and reference checkpoints at full LJSpeech width under
     ``build/chip_smoke_serve/`` (removed at the end): HiFi-GAN V1 and V2
     (width 128) ``.pth.tar`` files with weight norm and a melgan-neurips
     ``best_netG.pt`` written from seeded random port modules; V1 through
     ``cli.convert_checkpoint`` and back, against its source in f32; the
     HTTP server over a bf16 ``Synthesizer`` with that V1: warm-up of
     batches 1-8, ``/healthz``, 10 sequential requests (median latency and
     RTF; the served wav against the direct call), 8 concurrent ones
     through a 20 ms batching window, a stream over three sentences (time
     to first byte), a long text through the chunked path, MRF launches 3
     fused and 1 streamed per device call; ``cli.p_rtf_cm`` over 16
     utterances at batch 8; ``cli.synthesize`` with the V2 file (4 fused
     launches, its C = 8 last stage padded to 16 channels, against the
     plain V2 generator),
     with MelGAN (card vs CPU) and with ``--lang zh``.  Its numbers go on
     a ``{"serve": {...}}`` line.
  9. the vocoder and speaker-encoder trainers under
     ``build/chip_smoke_trainers/`` (removed at the end): an 8-speaker
     formant corpus from ``cli.gen_corpus`` (6 under ``raw/``); one f32
     HiFi-GAN GAN step (B=2 x 8192, generator width 128, discriminators
     / 4) and one GE2E step (S=4 x U=4) on the card against the CPU;
     timed f32 steps at the published sizes (HiFi-GAN V1 with the paper's
     MPD + MSD at B=16 x 8192: median ms, the D and G halves, peak
     memory, TFLOP/s of its convolutions, a ``torch.profiler`` busy
     share; GE2E at 64 x 10 partials of 160 x 40); ``cli.train_hifigan``
     to step 4, ``--resume`` to 6 (the saved state equal to the run's),
     2 paired fine-tuning steps from the exported generator; that
     generator through ``load_hifigan`` into a bf16 ``Synthesizer`` at
     B=8 (MRF launches [3, 1], the wav against its plain path);
     ``cli.train_ge2e`` with 2 held-out speakers and its
     ``ge2e_params.npy`` through ``PreDefinedEmbedder``.  Its numbers go
     on a ``{"trainers": {...}}`` line.
  10. ranks and the MOS metric nets under ``build/chip_smoke_parallel/``
     (removed at the end): ``cli.train_cm`` as a one-rank NCCL run under
     ``torch.distributed.run`` with ``--steps_per_call 2 --profile_dir``
     (the trace must exist), beside two ranks on the one card over gloo
     (CUDA tensors through host copies): a dp=2 f32 CT step at B=32 (the
     16 longest rows on rank 0, the 16 shortest on rank 1) against the
     one-process step on the card, the 20 x 256 denoiser at tp=2 against
     the whole one, dp=2 B=8 synthesis through the MRF kernels ([3, 1] on
     each rank) against the one-process call; MBNet at its published
     widths on three 3 s wavs and both LDNet test configurations, card
     against CPU, with MBNet's ms an utterance; ``cli.all_metrics
     --metrics mb_mos ld_mos`` on reference-format MBNet and LDNet files
     written from seeded modules.  Its numbers go on a ``{"parallel":
     {...}}`` line.
  11. the image-domain consistency model, the legacy GAN objectives and
     the native npy loader under ``build/chip_smoke_image/`` (removed at
     the end): the ImageNet-64 UNet of openai/consistency_models'
     ``cd_imagenet64_l2`` (296M params, random weights from a seed) — a
     B=2 forward and a onestep sample card against CPU with its zero-init
     layers redrawn; the B=16 forward (ms, TFLOP/s) and images/s of
     onestep, multistep (0, 22, 39 of 40) and heun-40; colorization,
     inpainting and super-resolution at B=4, each output held to its
     measurement, and card against CPU at a narrower width; one f32 CT step
     card against CPU (narrow), timed CT steps at B=16, one CD step;
     ``cli.image_sample`` from an ``.npz`` and from a reference ``.pt``
     of the same weights, one after the other (both loaders bit-equal to
     the weights, equal images); the JCU discriminator at the
     LJSpeech plan on a B=16 x 1024 pair and each GAN loss card against
     CPU; the native loader's build and a B=32 batch byte-equal to
     ``np.load``, with ms against serial ``np.load``.  No MRF kernel runs
     here.  Its numbers, with the card's name and power limit, go on an
     ``{"image": {...}}`` line.
  12. the quality loop and the quality and bench tools under
     ``build/chip_smoke_quality/`` (removed at the end): a
     ``cli.synthesize`` subprocess, started with TF32 on, reads both TF32
     flags False after its device setup; ``cmtts_tpu_torch/tools/
     run_quality_pipeline.sh`` at full LJSpeech width and a few steps
     (40-utterance corpus, 8 CT steps at B=8, T=1/2/4 Griffin-Lim
     synthesis of the 2 val utterances and their metrics with 8
     preprocess workers on the card, HiFi-GAN V1 for 4 steps and the
     vocoder protocol; ``RUN_CD=0`` as the next quality run sets it, the
     CD CLIs being held on the CPU), then again, starting no stage; ``vocode_dir`` on the card against the
     CPU; ``cli.train_ge2e`` and ``run_zeroshot_quality.sh`` on a
     6-speaker corpus (2 held out); ``extend_holdout`` with its
     determinism check; ``check_ge2e_holdout``; ``diag_pitch`` on the CT
     checkpoint; ``bench_train`` (B=32 x 768, K=1 and K=8);
     ``run_serve_bench.sh`` against ``cli.serve`` with the trained
     HiFi-GAN at concurrency 1 and 8.  Its numbers, with the card's name
     and power limit, go on a ``{"quality": {...}}`` line.
  4. a ``{"kernels": [...]}`` line, an entry for each entry point and
     type (bf16: launches of phases 3, 5, 6, 7, 8, 9, 10, 11 and 12, the
     last in-process only; float32: phase 3's float32 call),
     the card's name and power limit, and a last line
     ``{"ok": true, "device": {...}}``.

Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

KS, DS = (3, 7, 11), (1, 3, 5)
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 on CUDA cores (the same)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
F32_TOL = dict(rtol=2e-4, atol=2e-4)    # reassociation only
# a bf16 kernel makes its plain version's roundings, so the two differ by
# summation order: an output a bf16 ulp or two apart
BF16_STAGE_TOL = dict(rtol=2 ** -6, atol=1e-2)
BF16_TOL = dict(rtol=0.1, atol=0.05)    # the JAX suite's: bf16 vs f32
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


def stage_flop(B, C, L, head: bool) -> int:
    """Useful FLOP of one stage: 18 convs of 2 k C^2 per position, k in
    {3, 7, 11}, and the head's conv_post (2 * 7 * C per position)."""
    return 252 * C * C * L * B + (14 * C * L * B if head else 0)


def issued_flop(mrf, B, C, L, head: bool) -> int:
    """FLOP of the MMAs the bf16 route issues for one stage: each conv
    over whole blocks of BM positions (csrc/mrf_wg.cu's tiling, BM = 128
    MT) and whole weight tiles of 64 K values, with its channels padded
    to Cp, plus the head's useful work.  Over stage_flop, it is the work
    the tiling adds: the last block's positions past L, the zero steps
    that fill a conv's last tile (C <= 32) and, at C = 8, the padded
    channels."""
    Cp = mrf.padded_channels(C)
    _, mt = mrf.wg_tiling(Cp)
    rows = -(-L // (128 * mt)) * 128 * mt
    k_padded = sum(mrf.wg_tile_count(Cp, k) * mrf.WG_TILE_K for k in KS)
    return (2 * len(DS) * 2 * rows * Cp * k_padded * B
            + (14 * C * L * B if head else 0))


def stage_bound(B, C, L, head: bool, dtype):
    """(ms, "operations" | "bytes"): the least time for one stage in
    ``dtype``, the larger of its FLOP at that type's peak (bf16 on the
    tensor cores; float32 on the CUDA cores, since the port computes
    strict float32, no TF32) and its bytes at the memory rate (x read
    once, output written once, the weights in ``dtype`` and the f32
    biases read once)."""
    import torch

    f32 = dtype == torch.float32
    flop = stage_flop(B, C, L, head)
    wbytes = 4 if f32 else 2
    nbytes = (C * L * B * 4 + (L * B if head else C * L * B) * 4
              + (126 * C * C + (7 * C if head else 0)) * wbytes + 18 * C * 4)
    t_ops = flop / (PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check(name, out, ref, tol):
    import torch

    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(out, ref, **tol, msg=lambda m: f"{name}: {m}")
    return float((out - ref).abs().max())


def run_stage(mrf, x, packs, dtype, post, streamed):
    if streamed:
        return lambda: mrf.fused_mrf_stage_streamed(x, packs[dtype], KS, DS,
                                                    dtype)
    p = None if post is None else post[dtype]
    return lambda: mrf.fused_mrf_stage(x, packs[dtype], KS, DS, dtype, post=p)


def cudnn_stage(x, pack, dtype, post):
    """The bf16 yardstick of one stage: its 18 convs as ``F.conv1d`` on
    bf16 tensors (cuDNN's bf16 kernels) with the same elementwise ops in
    bf16 and the ResBlock sum in f32.  Timed beside the kernel only; the
    port never calls it."""
    import torch
    import torch.nn.functional as F

    w, b, _ = pack
    C = x.shape[1]
    convs, off = [], 0
    for k in KS:
        for _ in range(2 * len(DS)):
            n = len(convs)
            convs.append((w[off: off + k * C * C].view(k, C, C)
                          .permute(2, 1, 0).contiguous(),
                          b[n * C: (n + 1) * C].to(dtype)))
            off += k * C * C

    def lrelu(v, s=0.1):
        return torch.maximum(v, v * s)

    def run():
        acc, i = None, 0
        for k in KS:
            y = x.to(dtype)
            for d in DS:
                (w1, b1), (w2, b2) = convs[i], convs[i + 1]
                i += 2
                h = lrelu(F.conv1d(lrelu(y), w1, b1, padding=(k - 1) // 2 * d,
                                   dilation=d))
                y = y + F.conv1d(h, w2, b2, padding=(k - 1) // 2)
            acc = y.float() if acc is None else acc + y.float()
        out = acc / len(KS)
        if post is None:
            return out
        wp, bp = post[dtype]
        wav = F.conv1d(lrelu(out.to(dtype), 0.01), wp.t()[None],
                       bp.to(dtype), padding=(wp.shape[0] - 1) // 2)
        return torch.tanh(wav.float())[:, 0]

    return run


def plain_stage(mrf, x, packs, dtype, post):
    w, b, _ = packs[dtype]
    p = None if post is None else post[dtype]
    return lambda: mrf.mrf_stage_plain(x, w, b, KS, DS, dtype, p)


def cuda_tool(name: str) -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", name)
    return path if os.path.exists(path) else name


def kernel_sections(text: str):
    """{mangled kernel name: its lines} of ``cuobjdump`` output."""
    out, name = {}, None
    for line in text.splitlines():
        if "Function" in line and ":" in line:
            name = line.split(":", 1)[1].strip() or line.split()[-1]
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def wg_ptxas_faults(text: str) -> list:
    """Faults of the bf16 conv kernels (``mrf_conv_wg``) in an ``nvcc
    -Xptxas -v`` log: a spill store or load, and any wgmma that ptxas
    serialised (its C7515-style performance warning names the function)."""
    faults, fn = [], None
    for line in text.splitlines():
        m = (re.search(r"entry function '([^']+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            fn = m.group(1)
        if "wgmma" in line and "serialized" in line:
            faults.append(line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn and "mrf_conv_wg" in fn and (int(m.group(1))
                                                  or int(m.group(2))):
            faults.append(f"{fn}: {line.strip()}")
    return faults


def inspect_library(path: str) -> int:
    """Log each kernel's registers, stack and spills and return the count
    of HGMMA instructions in the SASS of the bf16 conv kernels; raise if
    ptxas spilled or serialised wgmma in them, if they hold none, or if
    any float32 kernel holds an HMMA or HGMMA."""
    with open(path + ".log") as f:   # nvcc -Xptxas -v, kept by the build
        text = f.read()
    for line in text.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "wgmma")):
            log(f"  ptxas: {line.strip()}")
    faults = wg_ptxas_faults(text)
    if faults:
        raise AssertionError("ptxas, bf16 conv kernels: " + "; ".join(faults))
    usage = subprocess.run([cuda_tool("cuobjdump"), "-res-usage", path],
                           capture_output=True, text=True, check=True).stdout
    for name, lines in kernel_sections(usage).items():
        log(f"  {name}: "
            + " ".join(ln.strip() for ln in lines if "REG" in ln))
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", path],
                          capture_output=True, text=True, check=True).stdout
    mma = {name: (sum("HGMMA" in ln for ln in lines),
                  sum("HMMA" in ln for ln in lines))
           for name, lines in kernel_sections(sass).items()}
    log(f"  (HGMMA, HMMA) instructions per kernel: {mma}")
    wg = {name: n for name, n in mma.items() if "mrf_conv_wg" in name}
    f32 = {name: n for name, n in mma.items() if "f32" in name}
    if (not wg or any(n[0] == 0 for n in wg.values()) or not f32
            or any(sum(n) for n in f32.values())):
        raise AssertionError(f"(HGMMA, HMMA): bf16 conv kernels {wg}, "
                             f"float32 kernels {f32}")
    return sum(n[0] for n in wg.values())


def counted_synthesis(synth, seqs, counters, hop, **kw):
    """One synthesis call that must launch each MRF kernel as a synthesis
    call does (3 fused stages, 1 streamed) and return finite outputs."""
    import torch

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


def timed_rtf(synth, seqs, counters, hop, sr, reps=5, **kw):
    """(RTF, median wall s, s of audio) over ``reps`` counted calls after a
    warm-up, each ending in a device synchronise."""
    import torch

    counted_synthesis(synth, seqs, counters, hop, **kw)     # warm-up
    times, audio = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lens_, _ = counted_synthesis(synth, seqs, counters, hop, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        audio = float(lens_.sum()) * hop / sr
    wall = statistics.median(times)
    return wall / audio, wall, audio


def reference_wav(seed: int, seconds: float = 3.0, sr: int = 22050):
    """A voiced-looking reference recording from a seed: five harmonics of
    a random f0 with random phases and weights, gated at a syllable rate,
    over a little noise."""
    import numpy as np

    rs = np.random.RandomState(seed)
    n = int(seconds * sr)
    tt = np.arange(n) / sr
    f0 = rs.uniform(90, 220)
    tone = sum(np.sin(2 * np.pi * f0 * h * tt + rs.uniform(0, 2 * np.pi))
               * rs.uniform(0.2, 1.0) / h for h in range(1, 6))
    gate = np.sin(2 * np.pi * rs.uniform(2, 4) * tt) > -0.3
    return (0.2 * tone * gate + 0.01 * rs.randn(n)).astype(np.float32)


def zero_shot_phase(counters, vocoder, root: str) -> dict:
    """Phase 5 at full VCTK width (random weights from a seed): embedders
    on the card against the CPU, zero-shot synthesis (checked, then timed),
    every new sampler against the CPU, long-form synthesis and the
    zero-shot CLI.  Returns the readings and the kernel launches of the
    zero-shot path; raises on any mismatch."""
    import copy

    import numpy as np
    import torch

    from cmtts_tpu_torch.cli.synthesize import preprocess_english, random_cmtts
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.masks import DEFAULT_MEL_BUCKETS, pick_bucket
    from cmtts_tpu_torch.models.speaker import (
        DeepSpeakerInference,
        GE2EInference,
        deepspeaker_from_checkpoint,
        ge2e_from_checkpoint,
    )
    from cmtts_tpu_torch.pipeline import Synthesizer, synthesize_long

    dev = torch.device("cuda")
    cfg = load_configs("VCTK")
    hop, sr = cfg.stft.hop_length, cfg.stft.sampling_rate
    out = {}
    log("# phase 5: zero-shot and samplers (VCTK config, random weights)")

    # 1. embedders: the card (cuDNN convs and LSTM, TF32 off) vs the CPU
    wav_ref = reference_wav(0)
    embed = {}
    for name, make, infer, run in (
            ("DeepSpeaker", deepspeaker_from_checkpoint, DeepSpeakerInference,
             lambda e, w: e.predict_embedding(w, sr)),
            ("GE2E", ge2e_from_checkpoint, GE2EInference,
             lambda e, w: e.embed_utterance(w))):
        model = make()
        on_cpu = infer(copy.deepcopy(model), "cpu")
        on_gpu = infer(model, dev)
        emb = run(on_gpu, wav_ref)
        err = check(f"{name} embedding, card vs CPU", torch.from_numpy(emb),
                    torch.from_numpy(run(on_cpu, wav_ref)),
                    dict(rtol=0, atol=1e-4))
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(on_gpu, wav_ref)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if name == "DeepSpeaker":
            x = torch.randn(1, 160, 64, 1, device=dev)
        else:   # the partials of a 3 s utterance
            x = torch.rand(3, 160, 40, device=dev)
        with torch.no_grad():
            fwd = cuda_ms(lambda: on_gpu.model(x), reps=10)
            # PyTorch's default lets cuDNN convs (not the LSTM) use TF32
            torch.backends.cudnn.allow_tf32 = True
            fwd_tf32 = cuda_ms(lambda: on_gpu.model(x), reps=10)
            torch.backends.cudnn.allow_tf32 = False
        out[f"{name}_ms_per_utterance"] = statistics.median(times) * 1e3
        out[f"{name}_forward_ms"] = fwd
        out[f"{name}_forward_ms_cudnn_tf32"] = fwd_tf32
        log(f"  {name}: {emb.shape[0]} features, max|err| card vs CPU "
            f"{err:.3e}; {out[f'{name}_ms_per_utterance']:.2f} ms per 3 s "
            f"utterance (host features included), forward {fwd:.3f} ms, "
            f"{fwd_tf32:.3f} ms with cuDNN TF32 (input {tuple(x.shape)})")
        embed[name] = (emb, on_gpu)
    emb, ds = embed["DeepSpeaker"]
    if emb.shape[0] != cfg.model.external_speaker_dim:
        raise AssertionError(f"DeepSpeaker width {emb.shape[0]}")

    for fn in counters:
        fn.launches = 0

    def counted(synth, seqs, **kw):
        return counted_synthesis(synth, seqs, counters, hop, **kw)

    # 2. B=1, T=1 with that embedding: mel vs the CPU f32 port, wav vs the
    # plain vocoder, and another voice changes the mel
    model = random_cmtts(cfg, seed=3)
    synth1 = Synthesizer(cfg, model, vocoder, T=1)
    tokens = preprocess_english(TEXT, cfg.data.lexicon_path,
                                list(cfg.data.text_cleaners))
    t_mel = pick_bucket(min(len(tokens) * 10, cfg.model.max_seq_len),
                        DEFAULT_MEL_BUCKETS)
    x_T = torch.randn(1, t_mel, cfg.stft.n_mel_channels,
                      generator=torch.Generator().manual_seed(5)) \
        * synth1.sched.sigma_max
    mel, lens, wav = counted(synth1, [tokens], spker_embeds=emb[None],
                             x_T=x_T)
    with torch.no_grad():
        wav_plain = vocoder(torch.from_numpy(mel).to(dev)).cpu()
    err_voc = check("zero-shot B=1 vocoder kernels vs plain f32 vocoder",
                    torch.from_numpy(wav), wav_plain, BF16_TOL)
    cpu_model = random_cmtts(cfg, seed=3)
    cpu_synth = Synthesizer(cfg, cpu_model, None, T=1,
                            compute_dtype=torch.float32, device="cpu")
    mel_cpu, lens_cpu, _ = cpu_synth([tokens], spker_embeds=emb[None],
                                     x_T=x_T)
    if not (lens_cpu == lens).all():
        raise AssertionError(f"mel_lens {lens} != CPU f32 {lens_cpu}")
    err_mel = check("zero-shot B=1 mel vs CPU f32", torch.from_numpy(mel),
                    torch.from_numpy(mel_cpu), BF16_TOL)
    emb2 = ds.predict_embedding(reference_wav(1), sr)
    mel2, _, _ = counted(synth1, [tokens], spker_embeds=emb2[None], x_T=x_T)
    moved = float(np.abs(mel2 - mel).max())
    if moved <= 1e-3:
        raise AssertionError(f"another voice moved the mel by {moved}")
    log(f"  B=1 T=1: {len(tokens)} tokens, mel bucket {t_mel}, mel_len "
        f"{int(lens[0])}; max|err| mel vs CPU f32 {err_mel:.3e}, wav vs "
        f"plain vocoder {err_voc:.3e}; another voice moves the mel by "
        f"{moved:.3e}")
    out["err_mel_B1"], out["err_wav_B1"] = err_mel, err_voc

    # 3. RTF: B=1 from text, and B=8 x 96 tokens at mel 1024 with 8 voices
    r, wall, audio = timed_rtf(synth1, [tokens], counters, hop, sr,
                               spker_embeds=emb[None])
    out["B1_T1_rtf"], out["B1_T1_wall_ms"] = r, wall * 1e3
    log(f"  zero-shot RTF B=1 T=1: {r:.6f} (median wall {wall * 1e3:.2f} ms "
        f"for {audio:.3f} s of audio)")
    voices = np.stack([ds.predict_embedding(reference_wav(10 + i, 1.5), sr)
                       for i in range(8)])
    batch = [np.random.RandomState(i).randint(13, 140, 96).astype(np.int32)
             for i in range(8)]
    r, wall, audio = timed_rtf(synth1, batch, counters, hop, sr,
                               spker_embeds=voices, mel_bucket=1024)
    out["B8_T1_rtf"], out["B8_T1_wall_ms"] = r, wall * 1e3
    log(f"  zero-shot RTF B=8 T=1 (mel bucket 1024, 8 voices): {r:.6f} "
        f"(median wall {wall * 1e3:.2f} ms for {audio:.3f} s of audio)")

    # 4. every new sampler at B=1 in float32 on the card vs the CPU, the
    # same injected noise; then heun with 18 levels at B=8 in bf16
    short = tokens[:24]
    t_mel_s = pick_bucket(len(short) * 10, DEFAULT_MEL_BUCKETS)
    shape = (1, t_mel_s, cfg.stft.n_mel_channels)
    g = torch.Generator().manual_seed(6)
    x_T = torch.randn(shape, generator=g) * synth1.sched.sigma_max
    noise = [torch.randn(shape, generator=g) for _ in range(8)]
    for sampler, T, steps in (("our_multistep", 2, 2), ("euler", 1, 4),
                              ("heun", 1, 4), ("dpm", 1, 4),
                              ("ancestral", 1, 4)):
        kw = dict(T=T, sampler=sampler, sample_steps=steps,
                  compute_dtype=torch.float32)
        res = []
        for m, device in ((model, None), (cpu_model, "cpu")):
            s_ = Synthesizer(cfg, m, None, device=device, **kw)
            res.append(s_([short], spker_embeds=emb[None], x_T=x_T,
                          noise=noise, mel_bucket=t_mel_s)[:2])
        if not (res[0][1] == res[1][1]).all():
            raise AssertionError(f"{sampler}: mel_lens {res[0][1]} != CPU "
                                 f"{res[1][1]}")
        err = check(f"{sampler} (steps {steps}) f32 card vs CPU",
                    torch.from_numpy(res[0][0]), torch.from_numpy(res[1][0]),
                    dict(rtol=0, atol=1e-3))
        out[f"err_{sampler}"] = err
        log(f"  {sampler:13s} T={T} steps={steps}: max|err| card vs CPU "
            f"{err:.3e}")
    heun = Synthesizer(cfg, model, vocoder, sampler="heun", sample_steps=18)
    r, wall, audio = timed_rtf(heun, batch, counters, hop, sr, reps=3,
                               spker_embeds=voices, mel_bucket=1024)
    out["B8_heun18_rtf"], out["B8_heun18_wall_ms"] = r, wall * 1e3
    log(f"  heun, 18 levels (35 denoiser passes), B=8 bf16: RTF {r:.6f} "
        f"(median wall {wall * 1e3:.2f} ms)")

    # 5. long-form synthesis over three chunks, then the zero-shot CLI
    chunks = [tokens[:30], tokens[30:55], tokens[55:]]
    before = [fn.launches for fn in counters]
    wav_l, mels_l, lens_l = synthesize_long(synth1, chunks, spker_embed=emb,
                                            gap_ms=150.0)
    if [fn.launches - b for fn, b in zip(counters, before)] != [3, 1]:
        raise AssertionError("synthesize_long: not one batched call")
    gap = int(sr * 0.15)
    if (len(mels_l) != 3 or not np.isfinite(wav_l).all()
            or len(wav_l) != int(lens_l.sum()) * hop + 2 * gap):
        raise AssertionError(f"synthesize_long: {len(mels_l)} chunks, "
                             f"{len(wav_l)} samples, lens {lens_l}")
    log(f"  synthesize_long: 3 chunks, mel_lens "
        f"{lens_l.tolist()}, {len(wav_l) / sr:.3f} s spliced")
    launches = {fn.__name__: fn.launches for fn in counters}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the zero-shot path: "
                             f"{launches}")
    log(f"# zero-shot path launches: {launches}")

    from cmtts_tpu_torch.audio.wavio import read_wav, write_wav

    work = os.path.join(root, "build", "chip_smoke_zeroshot")
    os.makedirs(work, exist_ok=True)
    write_wav(os.path.join(work, "ref.wav"), wav_ref, sr)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "cmtts_tpu_torch.cli.synthesize_zeroshot",
         "--ref_wav", os.path.join(work, "ref.wav"), "--text", TEXT,
         "--out_dir", work], cwd=root, capture_output=True, text=True,
        timeout=300)
    if cli.returncode != 0:
        raise AssertionError(f"zero-shot CLI failed:\n{cli.stderr[-3000:]}")
    mel_cli = np.load(os.path.join(work, "zeroshot_single-mel.npy"))
    wav_cli, _ = read_wav(os.path.join(work, "zeroshot_single.wav"))
    if (mel_cli.shape[1] != cfg.stft.n_mel_channels
            or not np.isfinite(mel_cli).all()
            or len(wav_cli) != len(mel_cli) * hop):
        raise AssertionError(f"zero-shot CLI output: mel {mel_cli.shape}, "
                             f"wav {len(wav_cli)}")
    log(f"  zero-shot CLI (--ref_wav, DeepSpeaker, Griffin-Lim) on the card: "
        f"{len(mel_cli)} frames, {len(wav_cli)} samples, "
        f"{time.perf_counter() - t0:.1f} s with start-up")
    out["launches"] = launches
    return out


# -- phase 6: consistency training ------------------------------------------

TRAIN_F32_TOL = dict(rtol=2e-4, atol=2e-4)   # losses and grad norm, card vs CPU
# params, target and EMAs after one step of lr 1e-4: updates are 1e-4 x the
# gradient, so card and CPU agree to a rounding of the values
TRAIN_PARAM_TOL = dict(rtol=1e-5, atol=1e-6)


class Tee:
    """A stdout that also keeps what it prints."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def text(self):
        return "".join(self.parts)


def write_training_config(work: str) -> str:
    """A config root over the LJSpeech YAMLs with the corpus, checkpoints
    and logs under ``work``, saves every 2 steps and a log every 2."""
    import yaml

    from cmtts_tpu_torch.core.config import load_yaml_configs

    pre, model, train = load_yaml_configs("LJSpeech")
    pre["path"]["preprocessed_path"] = os.path.join(work, "pre")
    train["path"] = {k: os.path.join(work, k.split("_")[0])
                     for k in ("ckpt_path", "log_path", "result_path")}
    train["step"].update(save_step=2, log_step=2)
    root = os.path.join(work, "config")
    os.makedirs(os.path.join(root, "LJSpeech"), exist_ok=True)
    for name, d in (("preprocess", pre), ("model", model), ("train", train)):
        with open(os.path.join(root, "LJSpeech", f"{name}.yaml"), "w") as f:
            yaml.safe_dump(d, f)
    return root


def unet_flop(cfg, batch: int) -> int:
    """FLOP (2 per multiply-add) of one image-UNet forward at ``batch``,
    from its ``UNetConfig``'s topology: every convolution, dense layer and
    the attention's two products; norms, activations and the softmax are
    left out."""
    H = cfg.image_size
    time_dim = cfg.model_channels * 4
    total = 2 * (cfg.model_channels * time_dim + time_dim * time_dim)

    def conv(cin, cout, hw, k=3):
        return 2 * cin * cout * k * k * hw * hw

    def res(cin, cout, hw_in, up=False, down=False):
        hw = hw_in * 2 if up else hw_in // 2 if down else hw_in
        emb = 2 * time_dim * (2 * cout if cfg.use_scale_shift_norm else cout)
        skip = conv(cin, cout, hw, 1) if cin != cout else 0
        return conv(cin, cout, hw) + conv(cout, cout, hw) + emb + skip

    def attn(ch, hw):
        n = hw * hw
        return 2 * n * ch * 3 * ch + 2 * n * ch * ch + 2 * 2 * n * n * ch

    ch = int(cfg.channel_mult[0] * cfg.model_channels)
    hw = H
    total += conv(cfg.in_channels, ch, hw)
    chans = [ch]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            out = int(mult * cfg.model_channels)
            total += res(ch, out, hw)
            ch = out
            if ds in cfg.attention_resolutions:
                total += attn(ch, hw)
            chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            if cfg.resblock_updown:
                total += res(ch, ch, hw, down=True)
            elif cfg.conv_resample:
                total += conv(ch, ch, hw // 2)
            hw //= 2
            chans.append(ch)
            ds *= 2
    total += 2 * res(ch, ch, hw) + attn(ch, hw)
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for j in range(cfg.num_res_blocks + 1):
            out = int(mult * cfg.model_channels)
            total += res(ch + chans.pop(), out, hw)
            ch = out
            if ds in cfg.attention_resolutions:
                total += attn(ch, hw)
            if level and j == cfg.num_res_blocks:
                if cfg.resblock_updown:
                    total += res(ch, ch, hw, up=True)
                elif cfg.conv_resample:
                    total += conv(ch, ch, hw * 2)
                hw *= 2
                ds //= 2
    total += conv(ch, cfg.out_channels, hw)
    return total * batch


def instrumented_step(model, cfg, opt, state, batch, probs, gen, cdt):
    """One CT step composed of the train step's own pieces with CUDA events
    between them: (ms by part, loss, indices, noise, the generator's state
    before the dropout draws), so that the caller can check the loss
    against the train step's on the same draws."""
    import torch

    from cmtts_tpu_torch.cm.karras import append_dims, schedule_from_config
    from cmtts_tpu_torch.cm.losses import make_denoise_fn, variance_loss
    from cmtts_tpu_torch.text import sil_phonemes_ids
    from cmtts_tpu_torch.train.loop import make_apply_fn
    from cmtts_tpu_torch.train.state import tree_ema

    sched = schedule_from_config(cfg)
    denoise = make_denoise_fn(make_apply_fn(model, cdt), sched)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    x0 = batch["mels"]
    probs = torch.as_tensor(probs, device=x0.device)
    idx = torch.multinomial(probs, x0.shape[0], replacement=True,
                            generator=gen)
    w = 1.0 / (probs.shape[0] * probs[idx])
    noise = torch.randn(x0.shape, generator=gen, device=x0.device)
    t, t2 = sched.t_of_index(idx, 3), sched.t_of_index(idx + 1, 3)
    x_t = x0 + noise * append_dims(t, 3)
    params = {k: v.detach().requires_grad_(True)
              for k, v in state.params.items()}
    gstate = gen.get_state()
    ev[0].record()
    student, cond = denoise(params, x_t, t, batch, gen, False)
    tts, _ = variance_loss(cond, batch, cfg, tuple(sil_phonemes_ids()))
    ev[1].record()
    with torch.no_grad():
        x_t2 = x_t + (x_t - x0) / append_dims(t, 3) * append_dims(t2 - t, 3)
        gen.set_state(gstate)
        target, _ = denoise(state.target_params, x_t2, t2, batch, gen, False)
    ev[2].record()
    cm = (student - target).abs().mean(dim=(1, 2))
    loss = ((10.0 * cm + tts) * w).mean()
    grads = torch.autograd.grad(loss, list(params.values()))
    ev[3].record()
    new, _ = opt.update(dict(zip(params, grads)), state.opt_state,
                        state.params)
    for e, r in zip(state.ema_params, cfg.train.cm.ema_rate):
        tree_ema(e, new, r)
    tree_ema(state.target_params, new, 0.95)
    ev[4].record()
    torch.cuda.synchronize()
    parts = ("student_forward_and_variance_loss", "target_forward",
             "backward", "optimizer_and_emas")
    return ({p: ev[i].elapsed_time(ev[i + 1]) for i, p in enumerate(parts)},
            loss.item(), idx, noise, gstate)


def device_busy(fn, reps: int = 3, top: int = 0) -> dict:
    """Run ``fn`` ``reps`` times under ``torch.profiler``: the window's
    CUDA-event ms, the summed duration of the device kernels in it, their
    share of the window and kernels per call, and with ``top`` the
    ``top`` kernel names that took the most device time (ms and launches
    a call).  ``busy_share`` is None when the profiler records no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    window = start.elapsed_time(end)
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    out = {"window_ms_per_call": window / reps,
           "kernel_ms_per_call": busy / reps,
           "busy_share": busy / window if kernels else None,
           "kernels_per_call": len(kernels) / reps}
    if top:
        by_name: dict = {}
        for e in kernels:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        out["top_kernels"] = [
            {"name": name[:96], "ms_per_call": ms / reps,
             "launches_per_call": n / reps}
            for name, (ms, n) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][0])[:top]]
    return out


def training_phase(counters, root: str, device: str = "cuda") -> dict:
    """Phase 6 at full LJSpeech width: card vs CPU, timed B=32 steps in
    f32 and bf16, CD / progdist / EDM, and the CLI journey on ``device``.
    Returns the readings and the MRF launches of the journey's synthesis;
    raises on any mismatch."""
    import copy
    import dataclasses
    import shutil
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from cmtts_tpu_torch.audio.wavio import read_wav
    from cmtts_tpu_torch.cm.karras import schedule_from_config
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.data.dataset import (
        FeatureDataset,
        batch_iterator,
        collate_batch,
    )
    from cmtts_tpu_torch.data.feature_corpus import write_feature_corpus
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from cmtts_tpu_torch.models.denoiser import denoiser_flop
    from cmtts_tpu_torch.train.loop import batch_to_device, make_train_step
    from cmtts_tpu_torch.train.resample import create_schedule_sampler
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    log("# phase 6: consistency training (LJSpeech config, random init)")
    dev = torch.device(device)
    out = {}
    work = os.path.join(root, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    write_feature_corpus(os.path.join(work, "pre"), 128, 8, seed=0)
    config_root = write_training_config(work)
    cfg = load_configs("LJSpeech", config_root)
    dataset = FeatureDataset("train.txt", cfg)
    out["corpus_s"] = time.perf_counter() - t0
    log(f"  corpus: {len(dataset)} train utterances written and config "
        f"root ready in {out['corpus_s']:.1f} s")

    # 1. one f32 step at B=2, card vs CPU: same params, indices and noise
    mc = cfg.model
    cfg0 = dataclasses.replace(cfg, model=dataclasses.replace(
        mc, transformer=dataclasses.replace(mc.transformer,
                                            encoder_dropout=0.0),
        variance_predictor=dataclasses.replace(mc.variance_predictor,
                                               dropout=0.0)))
    cpu_model = init_like_flax(CMTTS(cfg0), torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(dev)
    lens = [len(dataset[i]["text"]) for i in range(len(dataset))]
    pair = [dataset[i] for i in np.argsort(lens)[:2]]
    host = collate_batch(pair, cfg0)
    idx = torch.tensor([0, 1])
    noise = torch.randn(host["mels"].shape,
                        generator=torch.Generator().manual_seed(1))
    res = {}
    for name, model, on in (("cpu", cpu_model, "cpu"),
                            ("card", gpu_model, dev)):
        opt = RAdam(cfg0.train.cm.lr)
        st = create_train_state(
            {k: v.detach() for k, v in model.named_parameters()}, opt, 3)
        step = make_train_step(model, cfg0, opt, 3)
        res[name] = step(st, batch_to_device(host, on),
                         np.asarray([0.5, 0.5], np.float32), 0.95,
                         indices=idx, noise=noise)
    (s_cpu, m_cpu), (s_gpu, m_gpu) = res["cpu"], res["card"]
    errs = {}
    for k in ("loss", "loss_per_sample", "grad_norm", "tts_loss"):
        errs[k] = check(f"train step {k}, card vs CPU", m_gpu[k].cpu(),
                        m_cpu[k], TRAIN_F32_TOL)
    for what, a, b in (("params", s_gpu.params, s_cpu.params),
                       ("target", s_gpu.target_params, s_cpu.target_params),
                       *((f"ema_{i}", e, f) for i, (e, f) in enumerate(
                           zip(s_gpu.ema_params, s_cpu.ema_params)))):
        errs[what] = max(check(f"train step {what} {k}, card vs CPU",
                               a[k].cpu(), b[k], TRAIN_PARAM_TOL)
                         for k in b)
    out["card_vs_cpu_max_abs_err"] = errs
    out["card_vs_cpu_shapes"] = {"B": 2, "mel": host["mels"].shape[1],
                                 "text": host["texts"].shape[1]}
    log(f"  f32 step B=2 (mel {host['mels'].shape[1]}), card vs CPU, max "
        f"|err|: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    del cpu_model, gpu_model, res, s_cpu, s_gpu

    # 2. timed B=32 CT steps on the corpus's bucketed batches, LSM sampler
    model = init_like_flax(CMTTS(cfg), torch.Generator().manual_seed(0)).to(
        dev)
    feed = batch_iterator(dataset, 32, 4, seed=0)
    batches = [batch_to_device(next(feed), dev) for _ in range(12)]
    gen = torch.Generator(device=dev).manual_seed(0)
    timing = {}
    for label, cdt in (("f32", None), ("bf16", torch.bfloat16)):
        opt = RAdam(cfg.train.cm.lr)
        state = create_train_state(
            {k: v.detach() for k, v in model.named_parameters()}, opt, 3)
        sampler = create_schedule_sampler("loss-second-moment", 3)
        step = make_train_step(model, cfg, opt, 3, compute_dtype=cdt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, flop, losses, probs_seen = [], 0, [], []
        for i, b in enumerate(batches):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            probs = sampler.probs()
            probs_seen.append(probs)
            start.record()
            state, m = step(state, b, probs, 0.95, gen)
            end.record()
            sampler.update(m["indices"].cpu().numpy(),
                           m["loss_per_sample"].cpu().numpy())
            torch.cuda.synchronize()
            losses.append(float(m["loss"]))
            if i >= 2:       # two warm-ups
                ms.append(start.elapsed_time(end))
                B, L = b["mels"].shape[:2]
                # the denoiser runs forward for the student and the
                # target, and backward (two forwards' worth) once
                flop += 4 * denoiser_flop(cfg, B, L)
        if not np.isfinite(losses).all():
            raise AssertionError(f"{label} train losses {losses}")
        if not any(np.abs(p - 0.5).max() > 1e-3 for p in probs_seen[1:]):
            raise AssertionError("the LSM sampler's probs stayed uniform")
        med = statistics.median(ms)
        timing[label] = {
            "median_ms": med, "steps_per_s": 1e3 / med, "ms": ms,
            "mel_buckets": [int(b["mels"].shape[1]) for b in batches[2:]],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "denoiser_tflops": flop / sum(ms) / 1e9,
            "losses": losses, "lsm_probs_last": probs_seen[-1].tolist()}
        timing[label]["share_of_bf16_peak"] = (
            timing[label]["denoiser_tflops"] * 1e12 / PEAK_BF16_FLOPS)
        split, loss_i, idx, noise, gstate = instrumented_step(
            model, cfg, opt, state, batches[-1], probs_seen[-1], gen, cdt)
        gen.set_state(gstate)
        _, m_ref = step(state, batches[-1], probs_seen[-1], 0.95, gen,
                        indices=idx, noise=noise)
        check(f"{label} instrumented step loss", torch.tensor(loss_i),
              m_ref["loss"].cpu(), dict(rtol=1e-3, atol=1e-3))
        timing[label]["split_ms"] = split
        timing[label]["profile"] = device_busy(
            lambda: step(state, batches[-1], probs_seen[-1], 0.95, gen))
        t = timing[label]
        log(f"  CT B=32 {label}: median {med:.2f} ms/step ({t['steps_per_s']:.2f}"
            f" steps/s) over {len(ms)} steps, mel buckets "
            f"{sorted(set(t['mel_buckets']))}; peak {t['peak_mem_gib']:.2f} "
            f"GiB; denoiser {t['denoiser_tflops']:.1f} TFLOP/s "
            f"({t['share_of_bf16_peak']:.1%} of the bf16 peak); split "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
            + f"; LSM probs after warm-up {np.round(t['lsm_probs_last'], 4)}"
            f"; profiled: {t['profile']}")
    out["timed"] = timing

    # 3. one CD, progdist and EDM step each, the CT params as teacher
    teacher = {k: v.detach().clone() for k, v in state.params.items()}
    for mode in ("consistency_distillation", "progdist", "edm"):
        cfg_m = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, cm=dataclasses.replace(cfg.train.cm,
                                              training_mode=mode)))
        if mode == "edm" and schedule_from_config(cfg_m).distillation:
            raise AssertionError("edm must train with plain EDM scalings")
        opt = RAdam(cfg.train.cm.lr)
        st = create_train_state(teacher, opt, 3)
        scales = 4 if mode == "progdist" else 3
        step = make_train_step(model, cfg_m, opt, scales,
                               teacher_params=None if mode == "edm"
                               else teacher, compute_dtype=torch.bfloat16)
        probs = np.full(scales - 1 + (mode == "progdist"),
                        1.0 / (scales - 1 + (mode == "progdist")),
                        np.float32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, m = step(st, batches[3], probs, 0.95, gen)
        loss = float(m["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"{mode} loss {loss}")
        out[f"{mode}_loss"] = loss
        out[f"{mode}_step_ms"] = (time.perf_counter() - t1) * 1e3
        log(f"  {mode} bf16 B=32 step"
            + (" (plain EDM scalings)" if mode == "edm" else "")
            + f": loss {loss:.4f}, "
            f"{out[f'{mode}_step_ms']:.1f} ms with its first call")
    del model, batches, state, teacher

    # 4. the journey through the CLIs on the card
    from cmtts_tpu_torch.cli.synthesize import main as synthesize
    from cmtts_tpu_torch.cli.train_cm import main as train

    base = ["--model", "consistency_training", "--dataset", "LJSpeech",
            "--config_root", config_root, "--schedule_sampler",
            "loss-second-moment", "--device", device]
    walls = {}
    t1 = time.perf_counter()
    r1 = train(base + ["--total_step", "4"])
    walls["train_to_4_s"] = time.perf_counter() - t1
    tee = Tee(sys.stdout)
    t1 = time.perf_counter()
    with redirect_stdout(tee):
        r2 = train(base + ["--total_step", "6", "--restore_step", "-1"])
    walls["resume_to_6_s"] = time.perf_counter() - t1
    if "auto-resume: step 4" not in tee.text() or r2["start_step"] != 4:
        raise AssertionError("the CLI did not resume from step 4")
    a, b = r1["state"], r2["restored"]
    trees = [(a.params, b.params), (a.target_params, b.target_params),
             (a.opt_state["mu"], b.opt_state["mu"]),
             (a.opt_state["nu"], b.opt_state["nu"]),
             *zip(a.ema_params, b.ema_params)]
    if (a.step != b.step or a.opt_state["count"] != b.opt_state["count"]
            or not all(torch.equal(x[k], y[k]) for x, y in trees for k in x)
            or not all(np.array_equal(v, r2["restored_sampler"][k])
                       for k, v in r1["sampler"].state_dict().items())):
        raise AssertionError("the restored state differs from the saved one")
    losses = r1["losses"] + r2["losses"]
    if len(losses) != 6 or not np.isfinite(losses).all():
        raise AssertionError(f"CLI losses {losses}")
    del r1, r2, a, b, trees
    for fn in counters:
        fn.launches = 0
    out_dir = os.path.join(work, "synth")
    t1 = time.perf_counter()
    synthesize(["--mode", "single", "--text", TEXT, "--dataset", "LJSpeech",
                "--config_root", config_root, "--restore_step", "6", "--T",
                "1", "--out_dir", out_dir, "--device", device])
    walls["synthesize_s"] = time.perf_counter() - t1
    launches = {fn.__name__: fn.launches for fn in counters}
    if [fn.launches for fn in counters] != [3, 1]:
        raise AssertionError(f"synthesis from the checkpoint launched "
                             f"{launches}, not [3, 1]")
    mel = np.load(os.path.join(out_dir, "single-mel.npy"))
    wav, _ = read_wav(os.path.join(out_dir, "single.wav"))
    if (not np.isfinite(mel).all() or not np.isfinite(wav).all()
            or len(wav) != len(mel) * cfg.stft.hop_length):
        raise AssertionError(f"synthesis output: mel {mel.shape}, wav "
                             f"{len(wav)}")
    out["cli_walls_s"] = walls
    out["cli_losses"] = losses
    out["launches"] = launches
    log(f"  CLIs on the card: train to step 4 {walls['train_to_4_s']:.1f} s, "
        f"auto-resume to 6 {walls['resume_to_6_s']:.1f} s (restored state "
        f"equal to the saved one), synthesize --restore_step 6 "
        f"{walls['synthesize_s']:.1f} s ({len(mel)} frames, MRF launches "
        f"{launches}); losses {np.round(losses, 3).tolist()}")
    shutil.rmtree(work, ignore_errors=True)
    return out


# phase 7: the card's log-mel front-end against the CPU's, MEL_TOL
# (tests/test_torch_port_audio.py) where the mel power is above e^-4, and
# exp(mel) within MEL_LIN_TOL everywhere: below e^-4 an FFT's float32
# rounding (~1e-7 of the mel power whatever the bin's level) grows under the
# log, up to ~2e-3 at the 1e-5 floor (tests/torch_port_helpers.py)
MEL_TOL = dict(rtol=1e-5, atol=1e-5)
MEL_LIN_TOL = dict(rtol=1e-5, atol=2e-7)
ENERGY_TOL = dict(rtol=1e-5, atol=1e-4)   # L2 norms summed in another order
EVAL_TOL = dict(rtol=2e-4, atol=0.0)      # f32 validation losses, card vs CPU
METRICS = ["mcd", "mcd_dctmel", "f0_rmse", "ffe", "ssim", "si_sdr",
           "mfcc_cos"]
EQUAL_KINDS = ("duration", "mel2ph", "f0", "pitch", "cwt_spec", "cwt_scales",
               "f0cwt_mean_std")


def mel_errors(name, a, b) -> dict:
    """Max |err| of log-mel ``a`` against ``b`` on the bins above e^-4 and
    of exp(mel) on every bin; raises beyond MEL_TOL / MEL_LIN_TOL."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    loud = b > -4.0
    errs = {"log_loud": float(np.abs(a - b)[loud].max(initial=0.0)),
            "log_all": float(np.abs(a - b).max()),
            "linear": float(np.abs(np.exp(a) - np.exp(b)).max())}
    np.testing.assert_allclose(a[loud], b[loud], **MEL_TOL, err_msg=name)
    np.testing.assert_allclose(np.exp(a), np.exp(b), **MEL_LIN_TOL,
                               err_msg=name)
    return errs


class FrontEndTimer:
    """Wraps a Preprocessor's mel front-end, pitch tracker and CWT to time
    them per utterance: the front-end by CUDA events (on the card) and the
    host clock, the rest by the host clock."""

    def __init__(self, pre, module, cuda: bool):
        self.stft, self.cuda, self.module = pre.stft, cuda, module
        self.rows, self.cur = [], None
        pre.stft = self
        utt, cwt = pre.process_utterance, pre.get_f0cwt
        self.get_pitch = module.get_pitch

        def timed(fn, key):
            def run(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                self.cur[key] += (time.perf_counter() - t0) * 1e3
                return out
            return run

        def utterance(*a, **k):
            self.cur = {"frontend_ms": 0.0, "frontend_device_ms": 0.0,
                        "pitch_ms": 0.0, "cwt_ms": 0.0}
            t0 = time.perf_counter()
            out = utt(*a, **k)
            self.cur["utterance_ms"] = (time.perf_counter() - t0) * 1e3
            self.rows.append(self.cur)
            return out

        pre.process_utterance = utterance
        pre.get_f0cwt = timed(cwt, "cwt_ms")
        module.get_pitch = timed(self.get_pitch, "pitch_ms")

    def __call__(self, wav):
        import torch

        t0 = time.perf_counter()
        if self.cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        out = self.stft(wav)     # host -> card, STFT + mel, card -> host
        if self.cuda:
            ev1.record()
            ev1.synchronize()
            self.cur["frontend_device_ms"] += ev0.elapsed_time(ev1)
        self.cur["frontend_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def restore(self):
        self.module.get_pitch = self.get_pitch

    def summary(self) -> dict:
        rows = self.rows
        out = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        out["host_ms"] = statistics.median(
            r["utterance_ms"] - r["frontend_ms"] for r in rows)
        out["utterances"] = len(rows)
        return {f"median_{k}" if k != "utterances" else k: v
                for k, v in out.items()}


def compare_preprocessed(a: str, b: str, exact: bool) -> dict:
    """Compare two preprocessed dirs: bit for bit (``exact``), or the
    card-vs-CPU contract (EQUAL_KINDS, the split and speakers.json equal;
    mel, energy and stats.json within tolerance).  Returns max errors."""
    import numpy as np

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    names = files(a)
    if names != files(b):
        raise AssertionError(f"{a} and {b} hold other files")
    errs = {"mel_log_loud": 0.0, "mel_log_all": 0.0, "mel_linear": 0.0,
            "energy": 0.0, "stats": 0.0}
    for rel in names:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            same = fa.read() == fb.read()
        kind = rel.split(os.sep)[0]
        if same:
            continue
        if exact or kind in EQUAL_KINDS or kind == "TextGrid" or rel in (
                "train.txt", "val.txt", "filtered_out.txt", "speakers.json"):
            raise AssertionError(f"{rel} differs between {a} and {b}")
        if kind == "mel":
            e = mel_errors(rel, np.load(pa), np.load(pb))
            for k in ("log_loud", "log_all", "linear"):
                errs[f"mel_{k}"] = max(errs[f"mel_{k}"], e[k])
        elif kind == "energy":
            x, y = np.load(pa), np.load(pb)
            np.testing.assert_allclose(x, y, **ENERGY_TOL, err_msg=rel)
            errs["energy"] = max(errs["energy"], float(np.abs(x - y).max()))
        elif rel == "stats.json":
            with open(pa) as fa, open(pb) as fb:
                sa, sb = json.load(fa), json.load(fb)
            if sa["f0"] != sb["f0"] or sa["max_seq_len"] != sb["max_seq_len"]:
                raise AssertionError(f"stats.json: {sa} vs {sb}")
            np.testing.assert_allclose(sa["energy"], sb["energy"],
                                       **ENERGY_TOL, err_msg="stats energy")
            for k in ("spec_min", "spec_max"):
                mel_errors(f"stats {k}", sa[k], sb[k])
                errs["stats"] = max(errs["stats"], float(np.abs(
                    np.asarray(sa[k]) - np.asarray(sb[k])).max()))
        else:
            raise AssertionError(f"{rel} differs between {a} and {b}")
    return errs


def data_phase(counters, root: str, device: str = "cuda", n_utts: int = 72,
               val_size: int = 8, batch_size: int = 16,
               tiny: bool = False) -> dict:
    """Phase 7, wav -> features -> train -> synthesize -> score through the
    port's CLIs at full LJSpeech width: the formant corpus, preprocessing on
    the card (against the CPU and against 2 workers), 4 bf16 CT steps, batch
    synthesis of the val set with HiFi-GAN on random weights, the metrics
    (two CLI subprocesses beside the rest), validation losses card vs CPU
    and the mel cache.  Works under ``build/chip_smoke_data``, removed at
    the end.  Returns the readings and the MRF launches of the synthesis;
    raises on any failure."""
    import dataclasses
    import random
    import shutil

    import numpy as np
    import torch

    import cmtts_tpu_torch.data.preprocessor as pp_mod
    from cmtts_tpu_torch.audio.stft import MelSpectrogram
    from cmtts_tpu_torch.audio.wavio import read_wav
    from cmtts_tpu_torch.cli.evaluate import evaluate_cm
    from cmtts_tpu_torch.cli.evaluate import main as evaluate
    from cmtts_tpu_torch.cli.gen_corpus import main as gen_corpus
    from cmtts_tpu_torch.cli.get_mel_cache import main as get_mel_cache
    from cmtts_tpu_torch.cli.preprocess import main as preprocess
    from cmtts_tpu_torch.cli.synthesize import main as synthesize
    from cmtts_tpu_torch.cli.train_cm import main as train
    from cmtts_tpu_torch.cm.karras import schedule_from_config
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.data.dataset import FeatureDataset, batch_iterator
    from cmtts_tpu_torch.metrics.features import load_wav
    from cmtts_tpu_torch.train.checkpoint import restore_checkpoint

    log("# phase 7: data journey (formant corpus, preprocess, train, batch "
        "synthesis, metrics, evaluate; LJSpeech config)")
    cuda = torch.device(device).type == "cuda"
    work = os.path.join(root, "build", "chip_smoke_data")
    shutil.rmtree(work, ignore_errors=True)
    out, walls = {}, {}

    # 1. the corpus and its config root
    t0 = time.perf_counter()
    cfg_root = gen_corpus(["--out", work, "--n", str(n_utts), "--val_size",
                           str(val_size), "--batch_size", str(batch_size),
                           "--seed", "1234"] + (["--tiny"] if tiny else []))
    walls["gen_corpus_s"] = time.perf_counter() - t0
    pre = os.path.join(work, "pre")
    raw = os.path.join(work, "raw", "SYN")

    # 2. preprocess: the CLI on the card, then card / CPU / card x 2 workers
    random.seed(0)
    t0 = time.perf_counter()
    tr, va = preprocess(["--dataset", "LJSpeech", "--config_root", cfg_root,
                         "--device", device])
    walls["preprocess_cli_s"] = time.perf_counter() - t0
    if (len(tr), len(va)) != (n_utts - val_size, val_size):
        raise AssertionError(f"preprocess split {len(tr)} / {len(va)}")
    cfg = load_configs("LJSpeech", cfg_root)
    runs, timers = {}, {}
    for name, dev_, workers in (("card", device, 1), ("cpu", "cpu", 1),
                                ("card_workers2", device, 2)):
        d = os.path.join(work, f"pre_{name}")
        shutil.copytree(os.path.join(pre, "TextGrid"),
                        os.path.join(d, "TextGrid"))
        c = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, preprocessed_path=d))
        p = pp_mod.Preprocessor(c, device=dev_)
        timer = (FrontEndTimer(p, pp_mod, cuda and dev_ != "cpu")
                 if workers == 1 else None)
        random.seed(0)
        t0 = time.perf_counter()
        try:
            p.build_from_path(workers=workers)
        finally:
            if timer is not None:
                timer.restore()
        wall = time.perf_counter() - t0
        runs[name] = {"wall_s": wall, "utterances_per_s": n_utts / wall}
        if timer is not None:
            runs[name].update(timer.summary())
        msg = f"  preprocess {name}: {n_utts} utterances in {wall:.2f} s " \
            f"({n_utts / wall:.2f} utt/s)"
        if timer is not None:
            s = runs[name]
            msg += (f"; per utterance (median): front-end "
                    f"{s['median_frontend_ms']:.3f} ms host clock"
                    + (f", {s['median_frontend_device_ms']:.3f} ms CUDA "
                       f"events" if timer.cuda else "")
                    + f"; host {s['median_host_ms']:.2f} ms (pitch tracker "
                    f"{s['median_pitch_ms']:.2f}, CWT {s['median_cwt_ms']:.2f}"
                    f", the rest reads, alignment and npy writes)")
        log(msg)
    d = {k: os.path.join(work, f"pre_{k}") for k in runs}
    errs = compare_preprocessed(d["card"], d["cpu"], exact=False)
    compare_preprocessed(d["card_workers2"], d["card"], exact=True)
    out["preprocess"] = runs
    out["card_vs_cpu_max_abs_err"] = errs
    log(f"  card vs CPU features: equal {list(EQUAL_KINDS)}, split and "
        f"speakers.json; max |err| " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items())
        + "; workers=2 bit-identical to serial on the card")

    # 3. four bf16 CT steps on the preprocessed corpus
    common = ["--dataset", "LJSpeech", "--config_root", cfg_root,
              "--device", device]
    t0 = time.perf_counter()
    r = train(["--model", "consistency_training", "--total_step", "4",
               "--bf16"] + common)
    walls["train_s"] = time.perf_counter() - t0
    if len(r["losses"]) != 4 or not np.isfinite(r["losses"]).all():
        raise AssertionError(f"train losses {r['losses']}")
    out["train_losses"] = r["losses"]
    del r

    # 4. batch synthesis of the val set from the latest checkpoint
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    syn_dir = synthesize(["--mode", "batch", "--source",
                          os.path.join(pre, "val.txt"), "--restore_step",
                          "0"] + common)
    walls["synthesize_s"] = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    if cuda and [fn.launches for fn in counters] != [3, 1]:
        raise AssertionError(f"batch synthesis launched {launches}, not "
                             f"[3, 1]")
    with open(os.path.join(pre, "val.txt")) as f:
        val = [line.split("|")[0] for line in f if line.strip()]
    names = sorted(os.listdir(syn_dir))
    if names != sorted([f"{b}.wav" for b in val]
                       + [f"{b}-mel.npy" for b in val]):
        raise AssertionError(f"batch synthesis wrote {names}")
    frames = []
    for b in val:
        mel = np.load(os.path.join(syn_dir, f"{b}-mel.npy"))
        wav, _ = read_wav(os.path.join(syn_dir, f"{b}.wav"))
        if (not len(wav) or len(wav) != len(mel) * cfg.stft.hop_length
                or not np.isfinite(mel).all() or not np.isfinite(wav).all()):
            raise AssertionError(f"{b}: mel {mel.shape}, wav {len(wav)}")
        frames.append(len(mel))
    out["synth_frames"] = frames
    out["launches"] = launches
    log(f"  batch synthesis of {len(val)} val utterances (restore_step 0): "
        f"frames {frames}, MRF launches {launches}")

    # 5. the metrics: two CLI subprocesses while the card works on 6 and 7
    def metrics_cmd(syn_root):
        return [sys.executable, "-m", "cmtts_tpu_torch.cli.all_metrics",
                "--single", "--syn_root", syn_root, "--raw_folder", raw,
                "--metrics", *METRICS, "--device", device]

    t_metrics = time.perf_counter()
    procs = {k: subprocess.Popen(metrics_cmd(s), cwd=root, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, s in (("syn_vs_raw", syn_dir), ("raw_vs_raw", raw))}
    try:
        # 6. validation losses: the CLI on the card, then card vs CPU on one
        # injected x_T
        t0 = time.perf_counter()
        summary = evaluate(common)
        walls["evaluate_cli_s"] = time.perf_counter() - t0
        if not np.isfinite(list(summary.values())).all():
            raise AssertionError(f"evaluate: {summary}")
        params = restore_checkpoint(cfg.train.ckpt_path)["target_model"]
        batch = next(batch_iterator(
            FeatureDataset("val.txt", cfg, sort=False, cache_in_ram=False),
            min(cfg.train.batch_size, val_size), group_size=1, shuffle=False,
            epochs=1))
        x_T = torch.randn(batch["mels"].shape,
                          generator=torch.Generator().manual_seed(5)) \
            * schedule_from_config(cfg).sigma_max
        on_card = evaluate_cm(cfg, params, device=device, x_T=[x_T])
        on_cpu = evaluate_cm(cfg, params, device="cpu", x_T=[x_T])
        rel = {}
        for k, v in on_cpu.items():
            np.testing.assert_allclose(on_card[k], v, **EVAL_TOL,
                                       err_msg=f"evaluate {k}, card vs CPU")
            rel[k] = abs(on_card[k] - v) / max(abs(v), 1e-30)
        out["evaluate_cli"] = summary
        out["evaluate_card_vs_cpu_rel_err"] = rel
        log(f"  evaluate --restore_step 0 on the card: {summary}; card vs "
            f"CPU on one x_T {tuple(x_T.shape)}, max rel err "
            f"{max(rel.values()):.3e}")

        # 7. the mel cache of the raw corpus, one file against the CPU
        cache = os.path.join(work, "mel_cache")
        t0 = time.perf_counter()
        if get_mel_cache(["--wav_dir", raw, "--out_dir", cache,
                          "--device", device]) != n_utts:
            raise AssertionError("get_mel_cache skipped files")
        walls["get_mel_cache_s"] = time.perf_counter() - t0
        wav = load_wav(os.path.join(raw, "syn0000.wav"))
        cpu_mel = MelSpectrogram(device="cpu")(wav)[0].T
        out["mel_cache_vs_cpu"] = mel_errors(
            "mel cache syn0000", np.load(os.path.join(
                cache, "syn0000-mel.npy")), cpu_mel)
        log(f"  get_mel_cache: {n_utts} files in "
            f"{walls['get_mel_cache_s']:.2f} s; syn0000 vs CPU "
            f"{out['mel_cache_vs_cpu']}")

        # 5, continued
        scores = {}
        for k, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"all_metrics {k}: {stderr[-2000:]}")
            vals = dict(line.split(": ") for line in stdout.splitlines()
                        if line.split(":")[0] in METRICS)
            scores[k] = {m: float(vals[m]) for m in METRICS}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    walls["metrics_s"] = time.perf_counter() - t_metrics
    if not all(np.isfinite(v) for s in scores.values() for v in s.values()):
        raise AssertionError(f"non-finite metrics: {scores}")
    if scores["raw_vs_raw"]["mcd"] != 0.0:
        raise AssertionError(f"raw vs raw MCD {scores['raw_vs_raw']['mcd']}")
    out["metrics"] = scores
    log(f"  all_metrics over {len(val)} pairs: synthesized vs raw "
        f"{scores['syn_vs_raw']}; raw vs raw {scores['raw_vs_raw']} "
        f"({walls['metrics_s']:.1f} s, beside steps 6-7)")
    out["walls_s"] = walls
    shutil.rmtree(work, ignore_errors=True)
    return out


# -- phase 8: serving and reference checkpoints ----------------------------

# three LJSpeech sentences (LJ001-0001, -0003, -0004), one chunk each
SENTENCES = (TEXT, "For although the Chinese took impressions from wood "
             "blocks engraved in relief for centuries before the "
             "woodcutters of the Netherlands, by a similar process.",
             "It produced the block books, which were the immediate "
             "predecessors of the true printed book.")
ARPABET = ("AA1 AE1 AH0 AO1 AW1 AY1 B CH D DH EH1 ER0 EY1 F G HH IH0 IY1 JH "
           "K L M N NG OW1 P R S SH T TH UW1 V W Y Z").split()


class CountingSynth:
    """A ``Synthesizer`` that counts its calls, each one device call, so
    that the MRF launches can be held to 3 fused and 1 streamed a call."""

    def __init__(self, synth):
        self._synth, self.calls = synth, 0

    def __getattr__(self, name):
        return getattr(self._synth, name)

    def __call__(self, *a, **k):
        self.calls += 1
        return self._synth(*a, **k)


def write_serve_config(work: str, tiny: bool) -> str:
    """``write_training_config`` under ``work``, with a narrow acoustic
    model when ``tiny`` (a CPU rehearsal), and the corpus's
    ``speakers.json``."""
    import yaml

    root = write_training_config(work)
    if tiny:
        path = os.path.join(root, "LJSpeech", "model.yaml")
        with open(path) as f:
            model = yaml.safe_load(f)
        model["transformer"].update(encoder_layer=1, encoder_hidden=32)
        model["denoiser"].update(residual_layers=2, residual_channels=32)
        model["variance_predictor"].update(filter_size=32, cwt_hidden_size=8)
        with open(path, "w") as f:
            yaml.safe_dump(model, f)
    os.makedirs(os.path.join(work, "pre"), exist_ok=True)
    with open(os.path.join(work, "pre", "speakers.json"), "w") as f:
        json.dump({"LJSpeech": 0}, f)
    return root


def serve_phase(counters, root: str, rtf_b8: float | None = None,
                device: str = "cuda", tiny: bool = False) -> dict:
    """Phase 8 at full LJSpeech width: reference-format vocoder files
    written from seeded random port modules and read back (one through
    ``cli.convert_checkpoint``); the HTTP server over a bf16
    ``Synthesizer`` answering sequential, concurrent, streamed and long
    requests; ``cli.p_rtf_cm``; ``cli.synthesize`` with a V2 HiFi-GAN
    ``.pth.tar``, with MelGAN and with ``--lang zh``.  Works under
    ``build/chip_smoke_serve``, removed at the end.  Returns the readings
    and the MRF launches; raises on any failure."""
    import shutil
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(root, "tests"))
    from torch_port_helpers import (  # numpy and torch only
        hifigan_reference_state_dict,
        melgan_reference_module,
    )

    from cmtts_tpu_torch.cli.convert_checkpoint import main as convert
    from cmtts_tpu_torch.cli.p_rtf_cm import main as p_rtf
    from cmtts_tpu_torch.cli.serve import TTSService, pcm16, serve
    from cmtts_tpu_torch.cli.synthesize import main as synthesize
    from cmtts_tpu_torch.cli.synthesize import random_cmtts
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.masks import DEFAULT_MEL_BUCKETS, pick_bucket
    from cmtts_tpu_torch.models.hifigan import (
        HiFiGANConfig,
        HiFiGANGenerator,
        load_hifigan,
    )
    from cmtts_tpu_torch.models.melgan import MelGANConfig, load_melgan
    from cmtts_tpu_torch.pipeline import Synthesizer
    from cmtts_tpu_torch.train.checkpoint import save_checkpoint
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    log("# phase 8: serving and reference checkpoints (LJSpeech config, "
        "random weights)")
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    work = os.path.join(root, "build", "chip_smoke_serve")
    shutil.rmtree(work, ignore_errors=True)
    cfg_root = write_serve_config(work, tiny)
    cfg = load_configs("LJSpeech", cfg_root)
    hop, sr = cfg.stft.hop_length, cfg.stft.sampling_rate
    out, walls = {}, {}
    for fn in counters:
        fn.launches = 0

    def launches():
        return [fn.launches for fn in counters]

    def expect_launches(what, before, per_call):
        rose = [a - b for a, b in zip(launches(), before)]
        if cuda and rose != per_call:
            raise AssertionError(f"{what}: MRF launches {rose} != {per_call}")
        return rose

    # 1. reference-format files from seeded random port modules
    scale = 8 if tiny else 1
    gens = {}
    for name, width, seed in (("v1", 512, 11), ("v2", 128, 12)):
        torch.manual_seed(seed)
        g = HiFiGANGenerator(HiFiGANConfig(
            upsample_initial_channel=width // scale)).eval()
        path = os.path.join(work, f"generator_{name}.pth.tar")
        torch.save({"generator": hifigan_reference_state_dict(g, seed)}, path)
        gens[name] = (g.to(dev), path)
    mcfg = MelGANConfig()
    melgan_pt = os.path.join(work, "best_netG.pt")
    torch.save(melgan_reference_module(mcfg, seed=13).state_dict(), melgan_pt)
    v1_npz = os.path.join(work, "generator_v1.npz")
    convert(["--dataset", "LJSpeech", "--config_root", cfg_root,
             "--hifigan_pt", gens["v1"][1], "--hifigan_out", v1_npz])
    v1 = load_hifigan(v1_npz, cfg).to(dev)

    # 2. the loaded V1 against the generator it was written from
    mel = torch.randn(2, 64, cfg.stft.n_mel_channels,
                      generator=torch.Generator().manual_seed(8)).to(dev)
    with torch.no_grad():
        out["err_v1_loaded_vs_source"] = check(
            "V1 .pth.tar -> convert_checkpoint -> npz vs its source, f32",
            v1(mel), gens["v1"][0](mel), F32_TOL)
    log(f"  V1 generator_v1.pth.tar -> cli.convert_checkpoint -> npz: "
        f"plain forward vs its source max|err| "
        f"{out['err_v1_loaded_vs_source']:.3e}")

    # 3. the HTTP server over a bf16 Synthesizer with that V1
    model = random_cmtts(cfg, seed=1)
    synth = CountingSynth(Synthesizer(cfg, model, v1, T=1, device=device))
    direct = TTSService(synth, cfg, max_batch=1)
    batched = TTSService(synth, cfg, max_batch=8, batch_window_ms=20.0)
    t0 = time.perf_counter()
    out["warmup_calls"] = batched.warmup(log=lambda m: log("  " + m))
    walls["warmup_B1_to_B8_s"] = time.perf_counter() - t0
    servers = [serve(svc, "127.0.0.1", 0) for svc in (direct, batched)]
    threads = [threading.Thread(target=h.serve_forever, daemon=True)
               for h in servers]
    for t in threads:
        t.start()

    def post(url, body):
        return urllib.request.Request(
            url + "/tts", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})

    try:
        url_d, url_b = (f"http://127.0.0.1:{h.server_address[1]}"
                        for h in servers)
        with urllib.request.urlopen(url_d + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health["status"] != "ok" or set(health["mrf_launches"]) != {
                fn.__name__ for fn in counters}:
            raise AssertionError(f"healthz: {health}")
        out["healthz_device"] = health["device"]

        # 10 sequential requests; then the served wav against the direct
        # path (alone in the batching window, and as served PCM)
        lat, rtfs, client = [], [], []
        for seed in range(10):
            t0 = time.perf_counter()
            with urllib.request.urlopen(post(url_d, {"text": TEXT,
                                                     "seed": seed}),
                                        timeout=300) as r:
                body = r.read()
                lat.append(float(r.headers["X-Latency-Ms"]))
                rtfs.append(float(r.headers["X-RTF"]))
            client.append((time.perf_counter() - t0) * 1e3)
        toks = direct.tokens(TEXT)
        _, lens, wav = synth([toks], seed=9)
        ref = wav[0][: int(lens[0]) * hop]
        served = batched.synthesize(TEXT, seed=9)[0]
        out["err_served_vs_direct"] = check(
            "served wav (alone in the window) vs synth([tokens], seed)",
            torch.from_numpy(served), torch.from_numpy(ref),
            dict(rtol=0, atol=1e-5))
        pcm = np.frombuffer(body[44:], "<i2").astype(np.int32)
        lsb = int(np.abs(pcm - np.frombuffer(pcm16(ref), "<i2")).max())
        if lsb > 1:
            raise AssertionError(f"served PCM differs by {lsb} LSB")
        out["B1_latency_ms_median"] = statistics.median(lat)
        out["B1_rtf_median"] = statistics.median(rtfs)
        out["B1_client_ms_median"] = statistics.median(client)
        out["B1_audio_s"] = len(ref) / sr
        log(f"  10 sequential POST /tts ({len(toks)} tokens, "
            f"{out['B1_audio_s']:.3f} s of audio): median X-Latency-Ms "
            f"{out['B1_latency_ms_median']:.1f}, X-RTF "
            f"{out['B1_rtf_median']:.5f}, client wall "
            f"{out['B1_client_ms_median']:.1f} ms; served vs direct "
            f"{out['err_served_vs_direct']:.3e}, PCM within {lsb} LSB")

        # the same B=1 call without HTTP, in turns: in this thread, in one
        # persistent thread, and in a thread of its own (as the server
        # runs each request)
        def one_call(seed):
            t0 = time.perf_counter()
            synth([toks], seed=seed)
            return (time.perf_counter() - t0) * 1e3

        def own_thread(seed):
            box = []
            t = threading.Thread(target=lambda: box.append(one_call(seed)))
            t.start()
            t.join(timeout=120)
            return box[0]

        calls = {"main_thread": [], "persistent_thread": [],
                 "own_thread": []}
        with ThreadPoolExecutor(1) as pool:
            for seed in range(10):
                calls["main_thread"].append(one_call(seed))
                calls["persistent_thread"].append(
                    pool.submit(one_call, seed).result())
                calls["own_thread"].append(own_thread(seed))
        out["B1_call_ms_median"] = {k: statistics.median(v)
                                    for k, v in calls.items()}
        log("  the B=1 call alone, median ms: " + ", ".join(
            f"{k} {v:.2f}" for k, v in out["B1_call_ms_median"].items()))

        # 8 concurrent requests through the batching window
        bodies = [None] * 8

        def one(i):
            with urllib.request.urlopen(post(url_b, {"text": TEXT,
                                                     "seed": 5}),
                                        timeout=300) as r:
                bodies[i] = r.read()

        workers = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        t0 = time.perf_counter()
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        if any(b is None for b in bodies) or any(t.is_alive()
                                                 for t in workers):
            raise AssertionError("a concurrent request did not complete")
        hist = dict(batched.batch_hist)
        if max(hist) < 2:
            raise AssertionError(f"no coalesced batch: {hist}")
        audio = sum((len(b) - 44) // 2 for b in bodies) / sr
        out["concurrent8_wall_s"] = wall
        out["concurrent8_audio_s_per_wall_s"] = audio / wall
        out["batch_hist"] = {str(k): v for k, v in sorted(hist.items())}
        log(f"  8 concurrent requests (max_batch 8, window 20 ms): wall "
            f"{wall * 1e3:.1f} ms, {audio / wall:.2f} s of audio per s, "
            f"batches {out['batch_hist']}")

        # a stream over three sentences: time to first byte vs the whole
        t0 = time.perf_counter()
        with urllib.request.urlopen(post(url_d, {
                "text": " ".join(SENTENCES), "seed": 3, "stream": 1}),
                timeout=300) as r:
            head = r.read(44)
            ttfb = time.perf_counter() - t0
            rest = r.read()
        total = time.perf_counter() - t0
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE" or not rest:
            raise AssertionError("stream: not a RIFF/WAVE stream")
        out["stream_ttfb_ms"], out["stream_total_ms"] = ttfb * 1e3, total * 1e3
        out["stream_audio_s"] = (len(head) - 44 + len(rest)) / 2 / sr
        log(f"  stream=1, 3 sentences: first byte after {ttfb * 1e3:.1f} ms, "
            f"all {out['stream_audio_s']:.3f} s of audio after "
            f"{total * 1e3:.1f} ms")

        # a text over the token budget takes the chunked path
        taken = []
        long_path = direct._synthesize_long
        direct._synthesize_long = lambda *a: taken.append(1) or long_path(*a)
        wav_l, _, lat_l, _ = direct.synthesize(" ".join(SENTENCES * 2),
                                               seed=2)
        del direct._synthesize_long
        if taken != [1] or not np.isfinite(wav_l).all():
            raise AssertionError("long text did not take the chunked path")
        out["long_latency_ms"], out["long_audio_s"] = lat_l * 1e3, len(
            wav_l) / sr
        log(f"  long text ({len(direct.tokens(' '.join(SENTENCES * 2)))} "
            f"tokens > budget): chunked, {len(wav_l) / sr:.3f} s of audio in "
            f"{lat_l * 1e3:.1f} ms")
        with urllib.request.urlopen(url_d + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        for h in servers:
            h.shutdown()
            h.server_close()
        for t in threads:
            t.join(timeout=30)
    out["healthz"] = health
    out["service_device_calls"] = synth.calls
    n = synth.calls
    expect_launches(f"{n} device calls of the service", [0, 0], [3 * n, n])
    log(f"  service: {n} device calls, MRF launches {launches()}, "
        f"{len(synth.shapes_run)} shapes run; healthz device "
        f"{health['device']}")

    # 4. cli.p_rtf_cm on a 16-line metadata file at batch 8
    state = create_train_state(
        {k: v.detach() for k, v in model.named_parameters()}, RAdam(1e-4),
        len(cfg.train.cm.ema_rate))
    state.step = 1
    save_checkpoint(cfg.train.ckpt_path, state)
    rs = np.random.RandomState(14)
    meta = os.path.join(work, "pre", "rtf16.txt")
    with open(meta, "w") as f:
        for i in range(16):
            phones = " ".join(rs.choice(ARPABET, rs.randint(60, 97)))
            f.write(f"rtf{i:02d}|LJSpeech|{{{phones}}}|raw\n")
    before = launches()
    t0 = time.perf_counter()
    res = p_rtf(["--dataset", "LJSpeech", "--config_root", cfg_root,
                 "--source", meta, "--batch_size", "8", "--vocoder_ckpt",
                 v1_npz, "--out", os.path.join(work, "rtf"), "--device",
                 device])
    walls["p_rtf_cm_s"] = time.perf_counter() - t0
    expect_launches("p_rtf_cm (3 calls)", before, [9, 3])
    if not np.isfinite(res["mean_rtf"]):
        raise AssertionError(f"p_rtf_cm: {res}")
    out["p_rtf_cm"] = res
    log(f"  cli.p_rtf_cm, 16 utterances at batch 8: mean_rtf "
        f"{res['mean_rtf']:.6f} ({res['audio_seconds']:.2f} s of audio); "
        f"phase 3's B=8 T=1 RTF {rtf_b8}")

    # 5. cli.synthesize with the V2 .pth.tar, with MelGAN, with --lang zh
    base = ["--mode", "single", "--dataset", "LJSpeech", "--config_root",
            cfg_root, "--device", device]
    before = launches()
    t0 = time.perf_counter()
    synthesize(base + ["--text", TEXT, "--vocoder_ckpt", gens["v2"][1],
                       "--out_dir", os.path.join(work, "v2")])
    walls["cli_v2_s"] = time.perf_counter() - t0
    out["v2_cli_launches"] = expect_launches("V2 CLI", before, [4, 0])
    v2 = load_hifigan(gens["v2"][1], cfg)
    s2 = Synthesizer(cfg, model, v2, T=1, device=device)
    out["v2_routes"] = s2.vocoder_packed.routes
    t_mel = pick_bucket(min(len(toks) * 10, cfg.model.max_seq_len),
                        DEFAULT_MEL_BUCKETS)
    x_T = torch.randn(1, t_mel, cfg.stft.n_mel_channels,
                      generator=torch.Generator().manual_seed(15)) \
        * s2.sched.sigma_max
    before = launches()
    mel2, _, wav2 = s2([toks], x_T=x_T)
    expect_launches("V2 synthesis", before, [4, 0])
    with torch.no_grad():
        plain = gens["v2"][0](torch.from_numpy(mel2).to(dev)).cpu()
    out["err_v2_vs_plain"] = check(
        "V2 (bf16 kernels, the last stage padded to 16 channels) vs the "
        "plain V2 generator",
        torch.from_numpy(wav2), plain, BF16_TOL)
    log(f"  cli.synthesize --vocoder_ckpt generator_v2.pth.tar: launches "
        f"{out['v2_cli_launches']}, routes {out['v2_routes']}; wav vs the "
        f"plain V2 generator {out['err_v2_vs_plain']:.3e}")

    t0 = time.perf_counter()
    synthesize(base + ["--text", TEXT, "--vocoder", "melgan",
                       "--vocoder_ckpt", melgan_pt, "--out_dir",
                       os.path.join(work, "melgan")])
    walls["cli_melgan_s"] = time.perf_counter() - t0
    mel_m = np.load(os.path.join(work, "melgan", "single-mel.npy"))
    log_mel = torch.from_numpy(mel_m[None] / np.log(10.0))
    with torch.no_grad():
        on_dev = load_melgan(melgan_pt, mcfg).to(dev)(log_mel.to(dev)).cpu()
        on_cpu = load_melgan(melgan_pt, mcfg)(log_mel)
    out["err_melgan_card_vs_cpu"] = check("MelGAN card vs CPU, f32", on_dev,
                                          on_cpu, F32_TOL)
    log(f"  cli.synthesize --vocoder melgan --vocoder_ckpt best_netG.pt: "
        f"{len(mel_m)} frames; MelGAN card vs CPU "
        f"{out['err_melgan_card_vs_cpu']:.3e}")

    before = launches()
    zh = synthesize(base + ["--lang", "zh", "--text", "ni3 hao3 shi4 jie4",
                            "--vocoder_ckpt", v1_npz, "--out_dir",
                            os.path.join(work, "zh")])
    expect_launches("--lang zh", before, [3, 1])
    mel_zh = np.load(os.path.join(zh, "single-mel.npy"))
    if not (mel_zh.size and np.isfinite(mel_zh).all()):
        raise AssertionError(f"--lang zh mel {mel_zh.shape}")
    log(f"  cli.synthesize --lang zh 'ni3 hao3 shi4 jie4': {len(mel_zh)} "
        f"frames")

    out["launches"] = {fn.__name__: fn.launches for fn in counters}
    if cuda and min(out["launches"].values()) == 0:
        raise AssertionError(f"a kernel never ran in phase 8: "
                             f"{out['launches']}")
    walls["phase_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    log(f"# phase 8 launches {out['launches']}, {walls['phase_s']:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    return out


# -- phase 9: the vocoder and speaker-encoder trainers ----------------------

def adam_step_errs(name, got: dict, ref: dict, lr: float) -> dict:
    """Card vs CPU after one Adam step of rate ``lr`` from the same state,
    each side ``{"params", "mu"}`` (dicts of tensors).  The gradients,
    through the first moments (mu = (1 - b1) g): all of them within 1e-2
    of their norm in L2, and each tensor within 1e-1 of its own plus 1e-4
    of all of them (a wrong gradient is off by its whole size).  Single entries differ by up to
    2.5e-3 of their tensor's largest on the H100, and a WNConv's ``g``
    gradient, the dot product of its kernel's gradient with v / ||v||,
    cancels to 1.4e-2 of its norm: cuDNN's f32 algorithms sum otherwise,
    and an argument within a rounding of a kink (leaky ReLU, |.| in the
    L1 losses, the log-mel clamp) may fall on the other side.  The params
    within 2 lr (a step moves an entry by about lr whatever its
    gradient's size, so a near-zero gradient of the other sign puts it
    2 lr away).  -> max |err| of the params, the relative L2 error of all
    of mu and the largest of one tensor's, and how many param entries are
    beyond lr / 100."""
    import torch

    out = {"params": 0.0, "mu_rel_l2": 0.0, "mu_rel_l2_worst_tensor": 0.0,
           "params_beyond_lr_over_100": 0}
    pairs = {k: (got["mu"][k].detach().cpu().double(),
                 r.detach().cpu().double()) for k, r in ref["mu"].items()}
    norm = float(sum((r ** 2).sum() for _, r in pairs.values())) ** 0.5
    err = 0.0
    for k, (g, r) in pairs.items():
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} mu {k}: non-finite")
        e, n = float((g - r).norm()), float(r.norm())
        err += e * e
        # a gradient that is 0 but for rounding (GE2E's sim_bias: the
        # softmax rows sum to 1) is held to the whole gradient's scale
        if e > 1e-1 * n + 1e-4 * norm:
            raise AssertionError(f"{name} mu {k}: L2 error {e} of {n}")
        if n > 1e-4 * norm:
            out["mu_rel_l2_worst_tensor"] = max(
                out["mu_rel_l2_worst_tensor"], e / n)
    out["mu_rel_l2"] = err ** 0.5 / norm
    if out["mu_rel_l2"] > 1e-2:
        raise AssertionError(f"{name} mu: relative L2 error "
                             f"{out['mu_rel_l2']}")
    for k, r in ref["params"].items():
        g, r = got["params"][k].detach().cpu(), r.detach().cpu()
        out["params"] = max(out["params"], check(
            f"{name} params {k}", g, r, dict(rtol=0, atol=2 * lr)))
        out["params_beyond_lr_over_100"] += int(
            ((g - r).abs() > lr / 100).sum())
    return out


def to_device(tree, dev):
    import torch

    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev) if torch.is_tensor(tree) else tree


def timed_steps(fn, batches, warm: int = 2) -> dict:
    """Median ms (CUDA events) of ``fn(batch)`` over ``batches`` after
    ``warm`` warm-ups, steps/s and peak GiB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i, b in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(b)
        end.record()
        torch.cuda.synchronize()
        if i >= warm:
            ms.append(start.elapsed_time(end))
    med = statistics.median(ms)
    return {"median_ms": med, "steps_per_s": 1e3 / med, "ms": ms,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def hifigan_halves(step, gen, disc, stft, cfg, state, wavs) -> dict:
    """One GAN step split with CUDA events into the D half (G forward, D
    on real and detached fake, D update) and the G half (D on real and
    fake through the updated D, the mel loss, G backward and update),
    composed of the step's own pieces; its losses are checked against
    ``step``'s."""
    import torch
    from torch.func import functional_call

    from cmtts_tpu_torch.models.hifigan_disc import (
        discriminator_loss,
        feature_matching_loss,
        generator_adv_loss,
    )
    from cmtts_tpu_torch.train.hifigan_trainer import make_optims

    tx_g, tx_d = make_optims(cfg)
    n = wavs.shape[1] // gen.cfg.hop_length
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    with torch.no_grad():
        mels = stft.mel_frames(wavs, n)
    gp = {k: v.detach().requires_grad_(True) for k, v in state["gen"].items()}
    y_hat = functional_call(gen, gp, (mels,))
    dp = {k: v.detach().requires_grad_(True)
          for k, v in state["disc"].items()}
    d_loss = discriminator_loss(functional_call(disc, dp, (wavs,)),
                                functional_call(disc, dp, (y_hat.detach(),)))
    d_grads = torch.autograd.grad(d_loss, list(dp.values()))
    new_d, _ = tx_d.update(dict(zip(dp, d_grads)), state["opt_d"],
                           state["disc"])
    ev[1].record()
    with torch.no_grad():
        real = functional_call(disc, new_d, (wavs,))
    fake = functional_call(disc, new_d, (y_hat,))
    g_loss = (generator_adv_loss(fake)
              + cfg.lambda_fm * feature_matching_loss(real, fake)
              + cfg.lambda_mel * (stft.mel_frames(y_hat, n) - mels).abs()
              .mean())
    g_grads = torch.autograd.grad(g_loss, list(gp.values()))
    tx_g.update(dict(zip(gp, g_grads)), state["opt_g"], state["gen"])
    ev[2].record()
    torch.cuda.synchronize()
    _, m = step(state, wavs)
    check("split step's losses vs the step's",
          torch.stack([d_loss.detach(), g_loss.detach()]).cpu(),
          torch.stack([m["d_loss"], m["g_loss"]]).cpu(),
          dict(rtol=1e-3, atol=1e-3))
    return {"d_half_ms": ev[0].elapsed_time(ev[1]),
            "g_half_ms": ev[1].elapsed_time(ev[2])}


def hifigan_step_flop(gen, disc, B: int, T: int) -> int:
    """FLOP of the convolutions of one GAN step at B x T samples, from the
    modules' layer shapes, with g and d the FLOP of one G and one D
    forward: G forward (g) and backward (2 g); D on real and fake (2 d)
    and backward into both its weights and inputs (4 d); through the
    updated D, real without grad (d), fake (d) and its input gradient
    (d): 3 g + 9 d."""
    import torch

    from cmtts_tpu_torch.models.hifigan_disc import WNConv

    def conv_flop(module, x):
        total = 0

        def hook(m, inp, out):
            nonlocal total
            if isinstance(m, torch.nn.ConvTranspose1d):
                # each input sample meets the whole (Cin, Cout, k) kernel
                total += 2 * inp[0].numel() // inp[0].shape[1] \
                    * m.weight.numel()
            elif isinstance(m, (torch.nn.Conv1d, WNConv)):
                w = m.v if isinstance(m, WNConv) else m.weight
                total += 2 * out.numel() // out.shape[1] * w.numel()

        hooks = [m.register_forward_hook(hook) for m in module.modules()]
        with torch.no_grad():
            module(x)
        for h in hooks:
            h.remove()
        return total

    dev = next(gen.parameters()).device
    g = conv_flop(gen, torch.zeros(B, T // gen.cfg.hop_length,
                                   gen.cfg.num_mels, device=dev))
    d = conv_flop(disc, torch.zeros(B, T, device=dev))
    return 3 * g + 9 * d


def trainers_phase(counters, root: str, device: str = "cuda",
                   tiny: bool = False) -> dict:
    """Phase 9: the vocoder and speaker-encoder trainers on ``device``,
    under ``build/chip_smoke_trainers`` (removed at the end): a
    multi-speaker formant corpus from ``cli.gen_corpus``; one HiFi-GAN
    GAN step and one GE2E step on the card against the CPU; timed steps
    at the published sizes; ``cli.train_hifigan`` (train, resume, paired
    fine-tuning) and ``cli.train_ge2e``; the trained generator vocoding
    through the MRF kernels, and the trained encoder embedding through
    ``PreDefinedEmbedder``.  ``tiny`` (a CPU rehearsal) narrows every
    model.  Returns the readings and the MRF launches; raises on any
    failure."""
    import dataclasses
    import shutil
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from cmtts_tpu_torch.audio.stft import MelSpectrogram
    from cmtts_tpu_torch.audio.wavio import read_wav
    from cmtts_tpu_torch.cli.gen_corpus import main as gen_corpus
    from cmtts_tpu_torch.cli.synthesize import random_cmtts
    from cmtts_tpu_torch.cli.train_ge2e import main as train_ge2e_cli
    from cmtts_tpu_torch.cli.train_hifigan import disc_config
    from cmtts_tpu_torch.cli.train_hifigan import main as train_hifigan_cli
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, load_hifigan
    from cmtts_tpu_torch.models.speaker import (
        PreDefinedEmbedder,
        ge2e_from_checkpoint,
    )
    from cmtts_tpu_torch.pipeline import Synthesizer
    from cmtts_tpu_torch.train.ge2e_trainer import (
        GE2ETrainConfig,
        SpeakerVerificationDataset,
        init_ge2e_train,
        make_ge2e_train_step,
    )
    from cmtts_tpu_torch.train.hifigan_trainer import (
        HiFiGANTrainConfig,
        WaveSegmentSampler,
        init_hifigan_train,
        load_hifigan_train_state,
        make_hifigan_train_step,
    )

    log("# phase 9: the vocoder and speaker-encoder trainers (formant "
        "corpus, flax-like init)")
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    work = os.path.join(root, "build", "chip_smoke_trainers")
    shutil.rmtree(work, ignore_errors=True)
    out, walls = {}, {}
    for fn in counters:
        fn.launches = 0

    # 1. the corpus: 8 speakers x 12 utterances, 2 held out
    t0 = time.perf_counter()
    gen_corpus(["--out", os.path.join(work, "corpus"), "--speakers", "8",
                "--utts_per_speaker", "12", "--holdout", "2"])
    raw = os.path.join(work, "corpus", "raw")
    speakers = sorted(d for d in os.listdir(raw)
                      if os.path.isdir(os.path.join(raw, d)))
    walls["corpus_s"] = time.perf_counter() - t0
    log(f"  corpus: {len(speakers)} speakers under raw/ "
        f"({sum(len(os.listdir(os.path.join(raw, s))) // 2 for s in speakers)}"
        f" utterances) in {walls['corpus_s']:.1f} s")

    # 2. one f32 GAN step at B=2, card vs CPU, from the same weights/crop
    seg = 2048 if tiny else 8192
    cfg2 = HiFiGANTrainConfig(segment_size=seg, batch_size=2)
    small = HiFiGANConfig(upsample_initial_channel=32 if tiny else 128)
    sampler = WaveSegmentSampler(raw, seg)
    wavs2 = torch.from_numpy(sampler.sample(np.random.RandomState(0), 2))
    res = {}
    for name, on in (("cpu", torch.device("cpu")), ("card", dev)):
        state, gen, disc = init_hifigan_train(
            cfg2, small, disc_config(16 if tiny else 4), "cpu")
        gen, disc, state = gen.to(on), disc.to(on), to_device(state, on)
        step = make_hifigan_train_step(
            gen, disc, MelSpectrogram(device=on), cfg2)
        t0 = time.perf_counter()
        res[name] = step(state, wavs2.to(on))
        if on.type == "cuda":
            torch.cuda.synchronize()
        walls[f"gan_step_b2_{name}_s"] = time.perf_counter() - t0
    (s_cpu, m_cpu), (s_gpu, m_gpu) = res["cpu"], res["card"]
    errs = {k: check(f"GAN step {k}, card vs CPU", m_gpu[k].cpu(), m_cpu[k],
                     TRAIN_F32_TOL) for k in m_cpu}
    for which in ("gen", "disc"):
        errs[which] = adam_step_errs(
            f"GAN step {which}, card vs CPU,",
            *({"params": s[which], "mu": s[f"opt_{which[0]}"]["mu"]}
              for s in (s_gpu, s_cpu)), cfg2.learning_rate)
    out["gan_card_vs_cpu_max_abs_err"] = errs
    log(f"  HiFi-GAN f32 step B=2 x {seg} (generator width "
        f"{small.upsample_initial_channel}, discriminators / "
        f"{16 if tiny else 4}), card vs CPU max |err|: "
        + ", ".join(f"{k} {v}" for k, v in errs.items())
        + f"; CPU {walls['gan_step_b2_cpu_s']:.1f} s")
    del res, s_cpu, s_gpu

    # 3. the published sizes: V1 + paper MPD/MSD, B=16 x 8192, f32
    B = 2 if tiny else 16
    cfg = HiFiGANTrainConfig(segment_size=seg, batch_size=B)
    state, gen, disc = init_hifigan_train(
        cfg, small if tiny else HiFiGANConfig(),
        disc_config(16 if tiny else 1), dev)
    stft = MelSpectrogram(device=dev)
    step = make_hifigan_train_step(gen, disc, stft, cfg)
    rng = np.random.RandomState(1)
    batches = [torch.from_numpy(sampler.sample(rng, B)).to(dev)
               for _ in range(12)]
    hold = {"state": state}

    def gan_step(wavs):
        hold["state"], hold["m"] = step(hold["state"], wavs)

    if cuda:
        t = timed_steps(gan_step, batches)
        t["tflop_per_step"] = hifigan_step_flop(gen, disc, B, seg) / 1e12
        t["tflops"] = t["tflop_per_step"] * 1e3 / t["median_ms"]
        t["split_ms"] = hifigan_halves(step, gen, disc, stft, cfg,
                                       hold["state"], batches[-1])
        t["profile"] = device_busy(lambda: step(hold["state"], batches[-1]))
        losses = {k: float(v) for k, v in hold["m"].items()}
        if not all(np.isfinite(list(losses.values()))):
            raise AssertionError(f"GAN losses {losses}")
        t["last_losses"] = losses
        out["gan_published"] = t
        log(f"  HiFi-GAN V1 + paper MPD/MSD, f32 B={B} x {seg}: median "
            f"{t['median_ms']:.1f} ms/step ({t['steps_per_s']:.2f} steps/s)"
            f" over {len(t['ms'])} steps; D half {t['split_ms']['d_half_ms']:.1f}"
            f" ms, G half {t['split_ms']['g_half_ms']:.1f} ms; peak "
            f"{t['peak_mem_gib']:.2f} GiB; convolutions "
            f"{t['tflop_per_step']:.2f} TFLOP a step = {t['tflops']:.1f} "
            f"TFLOP/s; profiled: {t['profile']}; losses {losses}")
    else:
        gan_step(batches[0])
    del state, gen, disc, step, batches, hold

    # 4. cli.train_hifigan: train to 4, resume to 6, two paired steps
    hw = os.path.join(work, "hifigan")
    flags = ["--wav_root", raw, "--log_every", "1", "--device", device]
    if tiny:
        flags += ["--upsample_initial_channel", "32", "--disc_scale", "16",
                  "--segment_size", str(seg), "--batch_size", "2"]
    t0 = time.perf_counter()
    s4 = train_hifigan_cli(flags + ["--work_dir", hw, "--total_steps", "4",
                                    "--save_every", "2"])
    walls["cli_train_to_4_s"] = time.perf_counter() - t0
    restored, _ = load_hifigan_train_state(hw, dev)
    trees = [(s4[w], restored[w]) for w in ("gen", "disc")] + [
        (s4[o][m], restored[o][m]) for o in ("opt_g", "opt_d")
        for m in ("mu", "nu")]
    if (restored["step"] != 4 or restored["opt_g"]["count"] != 4
            or not all(torch.equal(a[k], b[k]) for a, b in trees for k in a)):
        raise AssertionError("the saved trainer state differs from the run's")
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with redirect_stdout(tee):
        s6 = train_hifigan_cli(flags + ["--work_dir", hw, "--total_steps",
                                        "6", "--save_every", "2",
                                        "--resume"])
    walls["cli_resume_to_6_s"] = time.perf_counter() - t0
    if ("resumed hifigan trainer at step 4" not in tee.text()
            or s6["step"] != 6 or "hifigan step 5:" not in tee.text()):
        raise AssertionError("cli.train_hifigan did not resume from step 4")
    gen_npz = os.path.join(hw, "hifigan_gen_00000006.npz")
    mel_dir = os.path.join(work, "mels")
    os.makedirs(mel_dir)
    front = MelSpectrogram(device=dev)
    names = sorted(n for n in os.listdir(os.path.join(raw, speakers[0]))
                   if n.endswith(".wav"))
    for name in names[:8]:
        wav, _ = read_wav(os.path.join(raw, speakers[0], name))
        mel, _ = front(wav)
        np.save(os.path.join(mel_dir, name[:-4] + "-mel.npy"), mel.T)
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with redirect_stdout(tee):
        s_ft = train_hifigan_cli(flags + [
            "--work_dir", os.path.join(work, "finetune"), "--total_steps",
            "2", "--finetune_mel_dir", mel_dir, "--init_gen_npz", gen_npz])
    walls["cli_finetune_2_s"] = time.perf_counter() - t0
    if "generator warm-started" not in tee.text() or s_ft["step"] != 2:
        raise AssertionError("paired fine-tuning did not run")
    cli_losses = [float(x.split("g_loss=")[1].split()[0])
                  for x in tee.text().splitlines() if "g_loss=" in x]
    if len(cli_losses) != 2 or not np.isfinite(cli_losses).all():
        raise AssertionError(f"fine-tuning losses {cli_losses}")
    log(f"  cli.train_hifigan: train to 4 {walls['cli_train_to_4_s']:.1f} s,"
        f" --resume to 6 {walls['cli_resume_to_6_s']:.1f} s (the saved "
        f"state equal to the run's, resumed at 4), 2 paired fine-tuning "
        f"steps from hifigan_gen_00000006.npz on {len(os.listdir(mel_dir))} "
        f"<base>-mel.npy files {walls['cli_finetune_2_s']:.1f} s (g_loss "
        f"{np.round(cli_losses, 3).tolist()})")
    del s4, s6, s_ft, restored, trees

    # 5. the trained generator through the MRF kernels (phase 3's CM)
    lj = load_configs("LJSpeech")
    trained = load_hifigan(gen_npz, lj)
    cm = random_cmtts(lj, seed=1)
    synth = Synthesizer(lj, cm, trained, T=1, device=device)
    seqs = [np.random.RandomState(i).randint(13, 140, 96 if cuda else 12)
            .astype(np.int32) for i in range(8)]
    before = [fn.launches for fn in counters]
    mel, lens, wav = synth(seqs, mel_bucket=1024 if cuda else 128)
    rose = [fn.launches - b for fn, b in zip(counters, before)]
    if cuda and rose != [3, 1]:
        raise AssertionError(f"trained generator: MRF launches {rose}")
    with torch.no_grad():
        plain = trained.to(dev)(torch.from_numpy(mel).to(dev)).cpu()
    out["trained_vocoder_err_vs_plain"] = check(
        "trained generator, bf16 kernels vs its plain f32 path",
        torch.from_numpy(wav), plain, BF16_TOL)
    out["trained_vocoder_routes"] = synth.vocoder_packed.routes
    log(f"  hifigan_gen_00000006.npz -> load_hifigan -> Synthesizer (bf16) "
        f"B=8 mel {mel.shape[1]}: MRF launches {rose}, routes "
        f"{out['trained_vocoder_routes']}; wav vs the plain generator "
        f"{out['trained_vocoder_err_vs_plain']:.3e}")
    del synth, cm, trained

    # 6. GE2E: one step at S=4, U=4, card vs CPU, on the corpus's partials
    parts = os.path.join(work, "partials")
    n_parts = SpeakerVerificationDataset.prepare_from_wavs(raw, parts)
    ds = SpeakerVerificationDataset(parts)
    mels4 = torch.from_numpy(ds.sample_batch(np.random.RandomState(0), 4,
                                             4)[0])
    lr = GE2ETrainConfig().learning_rate
    res = {}
    for name, on in (("cpu", torch.device("cpu")), ("card", dev)):
        model, params, tx, opt = init_ge2e_train(0, lr, "cpu")
        model, params, opt = (model.to(on), to_device(params, on),
                              to_device(opt, on))
        st = make_ge2e_train_step(model, tx, 4, 4, GE2ETrainConfig())
        res[name] = st(params, opt, mels4.to(on))
    (p_cpu, o_cpu, l_cpu, g_cpu), (p_gpu, o_gpu, l_gpu, g_gpu) = \
        res["cpu"], res["card"]
    gerrs = {"loss": check("GE2E loss, card vs CPU", l_gpu.cpu(), l_cpu,
                           TRAIN_F32_TOL),
             "gnorm": check("GE2E grad norm, card vs CPU", g_gpu.cpu(),
                            g_cpu, TRAIN_F32_TOL),
             **adam_step_errs("GE2E, card vs CPU,",
                              {"params": p_gpu, "mu": o_gpu["mu"]},
                              {"params": p_cpu, "mu": o_cpu["mu"]},
                              lr)}
    out["ge2e_card_vs_cpu_max_abs_err"] = gerrs
    log(f"  GE2E f32 step S=4 x U=4 on {n_parts} corpus partials, card vs "
        f"CPU max |err|: " + ", ".join(f"{k} {v}"
                                        for k, v in gerrs.items()))
    del res

    # 7. the published GE2E step: S=64 x U=10 x 160 x 40 seeded partials
    S, U = (8, 4) if tiny else (64, 10)
    model, params, tx, opt = init_ge2e_train(0, lr, dev)
    st = make_ge2e_train_step(model, tx, S, U, GE2ETrainConfig())
    g = torch.Generator(device=dev).manual_seed(0)
    gbatches = [torch.rand(S * U, 160, 40, device=dev, generator=g)
                for _ in range(12)]
    hold = {"p": params, "o": opt}

    def ge2e_step(mels):
        hold["p"], hold["o"], hold["loss"], _ = st(hold["p"], hold["o"],
                                                   mels)

    if cuda:
        t = timed_steps(ge2e_step, gbatches)
        t["last_loss"] = float(hold["loss"])
        if not np.isfinite(t["last_loss"]):
            raise AssertionError(f"GE2E loss {t['last_loss']}")
        out["ge2e_published"] = t
        log(f"  GE2E S={S} x U={U} x 160 x 40, f32: median "
            f"{t['median_ms']:.2f} ms/step ({t['steps_per_s']:.1f} steps/s) "
            f"over {len(t['ms'])} steps; peak {t['peak_mem_gib']:.2f} GiB; "
            f"loss {t['last_loss']:.4f}")
    else:
        ge2e_step(gbatches[0])
    del model, params, opt, gbatches, hold

    # 8. cli.train_ge2e with 2 held-out speakers, then the embedder
    gw = os.path.join(work, "ge2e")
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with redirect_stdout(tee):
        train_ge2e_cli(["--wav_root", raw, "--work_dir", gw, "--total_steps",
                        "20", "--val_speakers", "2", "--eval_every", "10",
                        "--log_every", "10", "--device", device])
    walls["cli_ge2e_s"] = time.perf_counter() - t0
    text = tee.text()
    g_losses = [float(v) for v in re.findall(r"step \d+: loss=(\S+)", text)]
    eers = [float(v) for v in re.findall(r"step \d+: val_eer=(\S+)", text)]
    if (len(g_losses) != 2 or len(eers) != 2
            or not np.isfinite(g_losses + eers).all()):
        raise AssertionError(f"cli.train_ge2e: losses {g_losses}, EER {eers}")
    ckpt = os.path.join(gw, "ge2e_params.npy")
    ge2e_from_checkpoint(ckpt)
    vctk = load_configs("VCTK")
    vctk = dataclasses.replace(vctk, model=dataclasses.replace(
        vctk.model, speaker_embedder="GE2E"))
    emb = PreDefinedEmbedder(vctk, ckpt, device)(reference_wav(0))
    if emb.shape != (256,) or not np.isfinite(emb).all() \
            or abs(float(np.linalg.norm(emb)) - 1.0) > 1e-3:
        raise AssertionError(f"GE2E embedding {emb.shape}")
    out["ge2e_cli"] = {"losses": g_losses, "val_eer": eers}
    log(f"  cli.train_ge2e --val_speakers 2, 20 steps: "
        f"{walls['cli_ge2e_s']:.1f} s, loss {np.round(g_losses, 4).tolist()},"
        f" val EER {np.round(eers, 4).tolist()}; ge2e_params.npy -> "
        f"ge2e_from_checkpoint and PreDefinedEmbedder (GE2E): a 3 s wav -> "
        f"{emb.shape[0]} features, norm {np.linalg.norm(emb):.4f}")

    out["launches"] = {fn.__name__: fn.launches for fn in counters}
    if cuda and min(out["launches"].values()) == 0:
        raise AssertionError(f"a kernel never ran in phase 9: "
                             f"{out['launches']}")
    walls["phase_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    log(f"# phase 9 launches {out['launches']}, {walls['phase_s']:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    return out


# -- phase 10: ranks and the MOS metric nets --------------------------------

# the phase's card-vs-card and card-vs-CPU checks in float32, TF32 off:
# reassociation only (per-rank partial sums, another conv algorithm)
PAR_F32_TOL = dict(rtol=2e-4, atol=2e-4)
MOS_TOL = dict(rtol=1e-4, atol=1e-4)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_ranks(procs, timeout: float) -> list:
    """Wait for every process; as soon as one fails or the time is up,
    stop the others (which would wait for it in a collective).  -> the
    exit codes."""
    end = time.monotonic() + timeout
    while any(p.is_alive() for p in procs):
        if time.monotonic() > end or any(
                p.exitcode not in (None, 0) for p in procs):
            for p in procs:
                if p.is_alive():
                    p.terminate()
            break
        time.sleep(0.2)
    for p in procs:
        p.join()
    return [p.exitcode for p in procs]


def parallel_config(work: str, tiny: bool) -> str:
    """Phase 6's config root (``write_serve_config``), dropout off, one
    save at the end and a log every 2 steps."""
    import yaml

    root = write_serve_config(work, tiny)
    for name, edit in (
            ("model", lambda d: (d["transformer"].update(encoder_dropout=0.0),
                                 d["variance_predictor"].update(dropout=0.0))),
            ("train", lambda d: d["step"].update(save_step=100,
                                                 log_step=2))):
        path = os.path.join(root, "LJSpeech", f"{name}.yaml")
        with open(path) as f:
            d = yaml.safe_load(f)
        edit(d)
        with open(path, "w") as f:
            yaml.safe_dump(d, f)
    return root


def parallel_models(cfg, tiny: bool):
    """(the CT step's model, the synthesis model, the vocoder), each from
    a seed, so that every rank builds the same ones."""
    import torch

    from cmtts_tpu_torch.cli.synthesize import random_cmtts
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator

    ct = init_like_flax(CMTTS(cfg), torch.Generator().manual_seed(0))
    syn = random_cmtts(cfg, seed=1)
    torch.manual_seed(2)
    voc = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=32)
                           if tiny else HiFiGANConfig())
    return ct, syn, voc.eval()


def parallel_rank(rank: int, world: int, port: int, work: str, device: str,
                  tiny: bool):
    """One of two ranks of phase 10 (b), both on ``device`` over gloo: the
    dp=2 CT step on this rank's 16 rows, the denoiser at tp=2, dp=2
    synthesis.  Each saves its results and MRF launches under ``work``."""
    import copy

    import torch

    from cmtts_tpu_torch.core.device import cli_device

    cli_device(device)          # float32 as the CLIs compute it: TF32 off
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch.distributed as dist

    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.ops import mrf
    from cmtts_tpu_torch.parallel.distributed import (
        init_distributed,
        make_mesh,
        rank_rows,
        shard_module,
    )
    from cmtts_tpu_torch.pipeline import Synthesizer
    from cmtts_tpu_torch.train.loop import batch_to_device, make_train_step
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    _, _, dev = init_distributed(device, backend="gloo")
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        cfg = load_configs("LJSpeech", inp["config_root"])
        ct, syn, voc = parallel_models(cfg, tiny)
        dp_mesh, tp_mesh = make_mesh(1), make_mesh(2)
        out, walls = {}, {}
        # the dp=2 CT step
        ct = ct.to(dev)
        opt = RAdam(cfg.train.cm.lr)
        state = create_train_state(
            {k: v.detach() for k, v in ct.named_parameters()}, opt, 3)
        step = make_train_step(ct, cfg, opt, 3, dp_group=dp_mesh.data)
        local = batch_to_device(rank_rows(inp["batch"], rank, world), dev)
        t0 = time.perf_counter()
        state, m = step(state, local, inp["probs"], 0.95,
                        indices=inp["indices"], noise=inp["noise"])
        out["metrics"] = {k: float(v) for k, v in m.items() if v.ndim == 0}
        walls["dp2_step_s"] = time.perf_counter() - t0
        out["params"] = {k: v.cpu() for k, v in state.params.items()}
        del state, step, ct
        # the denoiser at tp=2 against the whole one
        whole = syn.denoiser.float().to(dev)
        split = copy.deepcopy(whole)
        shard_module(split, tp_mesh.model)
        x, t, cond = (v.to(dev) for v in inp["denoiser_in"])
        with torch.no_grad():
            t0 = time.perf_counter()
            y = split(x, t, cond)
            walls["tp2_denoiser_s"] = time.perf_counter() - t0
            ref = whole(x, t, cond)
        out["tp2_err"] = float((y - ref).abs().max())
        out["tp2_vs_whole_ok"] = bool(torch.allclose(y, ref, **PAR_F32_TOL))
        del whole, split
        # dp=2 synthesis through the kernels
        for fn in (mrf.fused_mrf_stage, mrf.fused_mrf_stage_streamed):
            fn.launches = 0
        synth = Synthesizer(cfg, syn, voc, device=dev, dp_group=dp_mesh.data)
        t0 = time.perf_counter()
        out["synth"] = synth(inp["seqs"], mel_bucket=inp["mel_bucket"],
                             seed=5)
        walls["dp2_synth_s"] = time.perf_counter() - t0
        out["launches"] = [mrf.fused_mrf_stage.launches,
                           mrf.fused_mrf_stage_streamed.launches]
        out["walls_s"] = walls
        torch.save(out, os.path.join(work, f"out_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def parallel_phase(counters, root: str, device: str = "cuda",
                   tiny: bool = False) -> dict:
    """Phase 10 under ``build/chip_smoke_parallel`` (removed at the end):
    (a) ``cli.train_cm`` as a one-rank run under ``torch.distributed.run``
    (NCCL on the card) with ``--steps_per_call 2 --profile_dir``, beside
    the rest; (b) two ranks on the one card over gloo (CUDA tensors
    through host copies): a dp=2 f32 CT step at B=32, the ranks' rows of
    different lengths, against the one-process step on the card; the
    20 x 256 denoiser at tp=2 against the whole one; dp=2 B=8 synthesis
    through the MRF kernels against the one-process call; (c) MBNet at its
    widths on three 3 s wavs, card against CPU, ms an utterance; (d) both
    LDNet configurations, card against CPU; (e) ``cli.all_metrics
    --metrics mb_mos ld_mos`` on reference-format files.  Returns the
    readings and the MRF launches; raises on any failure."""
    import multiprocessing
    import shutil

    import numpy as np
    import torch
    import yaml

    sys.path.insert(0, os.path.join(root, "tests"))
    from torch_port_helpers import (  # numpy and torch only
        LDNET_V2_FFN,
        LDNET_V3_RNN,
        flax_trees,
        ldnet_reference_state_dict,
        mbnet_reference_state_dict,
        seeded_module,
    )

    from cmtts_tpu_torch.audio.wavio import write_wav
    from cmtts_tpu_torch.cli.all_metrics import main as all_metrics
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.data.dataset import FeatureDataset, collate_batch
    from cmtts_tpu_torch.data.feature_corpus import write_feature_corpus
    from cmtts_tpu_torch.metrics.ldnet import LDNet
    from cmtts_tpu_torch.metrics.mos import (
        MBNetMeanNet,
        MOSCal,
        hamming_spectrum,
    )
    from cmtts_tpu_torch.pipeline import Synthesizer
    from cmtts_tpu_torch.train.loop import batch_to_device, make_train_step
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    log("# phase 10: ranks (data and tensor parallelism) and the MOS "
        "metric nets")
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    work = os.path.join(root, "build", "chip_smoke_parallel")
    shutil.rmtree(work, ignore_errors=True)
    cfg_root = parallel_config(work, tiny)
    write_feature_corpus(os.path.join(work, "pre"), 128, 8, seed=0,
                         **(dict(phonemes=(5, 20), frames=(1, 4))
                            if tiny else {}))
    cfg = load_configs("LJSpeech", cfg_root)
    out, walls = {}, {}
    for fn in counters:
        fn.launches = 0

    # (a) the training CLI under torch.distributed.run, in the background
    prof = os.path.join(work, "profile")
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cli_log = open(os.path.join(work, "train_cli.log"), "w")
    t_cli = time.perf_counter()
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "cmtts_tpu_torch.cli.train_cm",
         "--model", "consistency_training", "--dataset", "LJSpeech",
         "--config_root", cfg_root, "--total_step", "8",
         "--steps_per_call", "2", "--profile_dir", prof,
         "--schedule_sampler", "loss-second-moment", "--device", device],
        cwd=root, env=env, stdout=cli_log, stderr=subprocess.STDOUT)
    try:
        # (b) two gloo ranks on the one card against one process
        dataset = FeatureDataset("train.txt", cfg)
        lens = [dataset[i]["mel"].shape[0] for i in range(len(dataset))]
        order = np.argsort(lens)[::-1]
        B = 32
        # rank 0 takes the 16 longest rows, rank 1 the 16 shortest
        picks = np.concatenate([order[:B // 2], order[-(B // 2):]])
        host = collate_batch([dataset[int(i)] for i in picks], cfg)
        host = {k: v for k, v in host.items()
                if k not in ("ids", "raw_texts")}
        g = torch.Generator().manual_seed(11)
        probs = np.asarray([0.5, 0.5], np.float32)
        idx = torch.multinomial(torch.from_numpy(probs), B, replacement=True,
                                generator=g)
        noise = torch.randn(host["mels"].shape, generator=g)
        C = cfg.model.denoiser.residual_channels
        L = 64 if tiny else 512
        x_d = torch.randn(8, L, cfg.stft.n_mel_channels, generator=g)
        t_d = torch.rand(8, generator=g) * 3
        cond_d = torch.randn(8, L, cfg.model.transformer.encoder_hidden,
                             generator=g)
        seqs = [np.random.RandomState(40 + i).randint(13, 140, 96).astype(
            np.int32) for i in range(8)]
        mel_bucket = 128 if tiny else 1024
        torch.save({"config_root": cfg_root, "batch": host, "probs": probs,
                    "indices": idx, "noise": noise,
                    "denoiser_in": (x_d, t_d, cond_d), "seqs": seqs,
                    "mel_bucket": mel_bucket},
                   os.path.join(work, "inputs.pt"))
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        t_ranks = time.perf_counter()
        # both ranks on the one card: an explicit index, not LOCAL_RANK
        rank_dev = "cuda:0" if cuda and dev.index is None else device
        ranks = [ctx.Process(target=parallel_rank,
                             args=(r, 2, port, work, rank_dev, tiny))
                 for r in range(2)]
        for p in ranks:
            p.start()
        try:
            ct, syn, voc = parallel_models(cfg, tiny)
            ct = ct.to(dev)
            opt = RAdam(cfg.train.cm.lr)
            state = create_train_state(
                {k: v.detach() for k, v in ct.named_parameters()}, opt, 3)
            state1, m1 = make_train_step(ct, cfg, opt, 3)(
                state, batch_to_device(host, dev), probs, 0.95, indices=idx,
                noise=noise)
            del state, ct
            synth1 = Synthesizer(cfg, syn, voc, device=dev)
            mel1, lens1, wav1 = synth1(seqs, mel_bucket=mel_bucket, seed=5)
            one_launches = [fn.launches for fn in counters]
        finally:
            codes = join_ranks(ranks, 300)
        walls["ranks_s"] = time.perf_counter() - t_ranks
        if codes != [0, 0]:
            raise AssertionError(f"phase 10 ranks exited {codes}")
        r0, r1 = (torch.load(os.path.join(work, f"out_{r}.pt"),
                             weights_only=False) for r in range(2))
        errs = {}
        for k in ("loss", "grad_norm", "tts_loss", "cm_loss"):
            errs[k] = check(f"dp=2 step {k} vs one process",
                            torch.tensor(r0["metrics"][k]),
                            m1[k].cpu(), PAR_F32_TOL)
        errs["params"] = max(
            check(f"dp=2 step params {k} vs one process", r0["params"][k],
                  v.cpu(), TRAIN_PARAM_TOL)
            for k, v in state1.params.items())
        if not r0["tp2_vs_whole_ok"]:
            raise AssertionError(f"tp=2 denoiser vs whole: max |err| "
                                 f"{r0['tp2_err']:.3e}")
        errs["tp2_denoiser"] = r0["tp2_err"]
        mel2, lens2, wav2 = r0["synth"]
        if not (lens2 == lens1).all():
            raise AssertionError(f"dp=2 mel_lens {lens2} != {lens1}")
        errs["dp2_mel"] = check("dp=2 synthesis mel vs one process",
                                torch.from_numpy(mel2),
                                torch.from_numpy(mel1), BF16_TOL)
        errs["dp2_wav"] = check("dp=2 synthesis wav vs one process",
                                torch.from_numpy(wav2),
                                torch.from_numpy(wav1), BF16_TOL)
        rank_launches = [r0["launches"], r1["launches"]]
        if cuda and (one_launches != [3, 1]
                     or any(rl != [3, 1] for rl in rank_launches)):
            raise AssertionError(f"MRF launches: one process {one_launches},"
                                 f" ranks {rank_launches}, not [3, 1] each")
        out["ranks"] = {"max_abs_err": errs, "B": B,
                        "rank_mel_frames": [int(host["mels"].shape[1])] * 2,
                        "rank_row_frames": [
                            int(host["mel_lens"][:B // 2].sum()),
                            int(host["mel_lens"][B // 2:].sum())],
                        "launches": {"one_process": one_launches,
                                     "ranks": rank_launches},
                        "rank_walls_s": r0["walls_s"]}
        log(f"  two gloo ranks on the {device}: dp=2 f32 CT step B={B} "
            f"(rank frames {out['ranks']['rank_row_frames']}) vs one "
            f"process, tp=2 {C}-channel denoiser vs whole, dp=2 B=8 "
            f"synthesis vs one process (MRF launches {rank_launches}); max "
            f"|err| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f"; {walls['ranks_s']:.1f} s")

        # (c) MBNet and (d) LDNet, card against CPU
        wavs = [reference_wav(s) for s in (0, 1, 2)]
        specs = torch.from_numpy(np.stack([hamming_spectrum(w)
                                           for w in wavs]))
        mb_cpu = seeded_module(MBNetMeanNet(), 3)
        mb_card = seeded_module(MBNetMeanNet(), 3).to(dev)
        with torch.no_grad():
            s_cpu = mb_cpu(specs)
            s_card = mb_card(specs.to(dev))
        mos = {"mbnet_frames": int(specs.shape[1]),
               "mbnet_err": check("MBNet card vs CPU", s_card.cpu(), s_cpu,
                                  MOS_TOL)}
        one = specs[:1].to(dev)
        with torch.no_grad():
            if cuda:
                mos["mbnet_ms_per_utt"] = cuda_ms(lambda: mb_card(one), 5)
            t0 = time.perf_counter()
            for _ in range(3):
                mb_cpu(specs[:1])
            mos["mbnet_cpu_ms_per_utt"] = (time.perf_counter() - t0) / 3e-3
        for name, lcfg in (("v3_rnn_meannet", LDNET_V3_RNN),
                           ("v2_ffn_categorical", LDNET_V2_FFN)):
            ld_cpu = seeded_module(LDNet(lcfg), 4)
            ld_card = seeded_module(LDNet(lcfg), 4).to(dev)
            with torch.no_grad():
                a_cpu, p_cpu = ld_cpu.average_inference(specs)
                a_card, p_card = ld_card.average_inference(specs.to(dev))
            mos[f"ldnet_{name}_err"] = max(
                check(f"LDNet {name} scores card vs CPU", a_card.cpu(), a_cpu,
                      MOS_TOL),
                check(f"LDNet {name} posteriors card vs CPU", p_card.cpu(),
                      p_cpu, MOS_TOL))
        log(f"  MBNet (published widths) on 3 x {specs.shape[1]} frames x "
            f"257: card vs CPU max |err| {mos['mbnet_err']:.3e}, "
            + (f"{mos['mbnet_ms_per_utt']:.2f} ms an utterance on the card "
               if cuda else "")
            + f"({mos['mbnet_cpu_ms_per_utt']:.1f} ms on the CPU); LDNet "
            f"v3_rnn_meannet {mos['ldnet_v3_rnn_meannet_err']:.3e}, "
            f"v2_ffn_categorical {mos['ldnet_v2_ffn_categorical_err']:.3e}")

        # (e) cli.all_metrics on reference-format files
        mos_dir = os.path.join(work, "mos")
        syn_dir, raw_dir = (os.path.join(mos_dir, d) for d in ("syn", "raw"))
        os.makedirs(syn_dir)
        os.makedirs(raw_dir)
        for i, w in enumerate(wavs):
            write_wav(os.path.join(syn_dir, f"utt{i}.wav"), w, 22050)
            write_wav(os.path.join(raw_dir, f"utt{i}.wav"), w[::-1].copy(),
                      22050)
        mb_pt, ld_pt, ld_yml = (os.path.join(mos_dir, n) for n in (
            "model-50000.pt", "model-27000.pt", "config.yml"))
        torch.save(mbnet_reference_state_dict(*flax_trees(mb_cpu)), mb_pt)
        ld_ref = seeded_module(LDNet(LDNET_V3_RNN), 4)
        torch.save(ldnet_reference_state_dict(*flax_trees(ld_ref),
                                              LDNET_V3_RNN), ld_pt)
        with open(ld_yml, "w") as f:
            yaml.safe_dump(LDNET_V3_RNN, f)
        t0 = time.perf_counter()
        vals = all_metrics(["--single", "--syn_root", syn_dir, "--raw_folder",
                            raw_dir, "--metrics", "mb_mos", "ld_mos",
                            "--mos_ckpt", mb_pt, "--ld_ckpt", ld_pt,
                            "--ld_config", ld_yml, "--device", device])
        walls["all_metrics_s"] = time.perf_counter() - t0
        cal = MOSCal(22050, mb_pt, ld_pt, ld_yml, device="cpu")
        want = {"mb_mos": float(np.mean([cal.get_mb_mos(w) for w in wavs])),
                "ld_mos": float(np.mean([cal.get_ld_mos(w) for w in wavs]))}
        for k, v in want.items():
            check(f"cli.all_metrics {k} on the {device} vs MOSCal on the CPU",
                  torch.tensor(vals[k]), torch.tensor(v), MOS_TOL)
        if not 1.0 <= vals["ld_mos"] <= 5.0:
            raise AssertionError(f"range-clipped ld_mos {vals['ld_mos']}")
        mos["all_metrics"] = vals
        out["mos"] = mos
        log(f"  cli.all_metrics --metrics mb_mos ld_mos (reference-format "
            f"MBNet and LDNet files): {vals}, against MOSCal on the CPU; "
            f"{walls['all_metrics_s']:.1f} s")

        # (a) the CLI's run
        rc = cli.wait(timeout=300)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
        cli_log.close()
    walls["train_cli_s"] = time.perf_counter() - t_cli
    with open(os.path.join(work, "train_cli.log")) as f:
        text = f.read()
    trace = os.path.join(prof, "trace_rank0.json")
    if rc != 0 or "rank 0 of 1" not in text or not os.path.isfile(trace):
        raise AssertionError(f"torch.distributed.run cli.train_cm: rc {rc}, "
                             f"trace {os.path.isfile(trace)}\n{text[-3000:]}")
    out["train_cli"] = {"rc": rc, "trace_bytes": os.path.getsize(trace),
                        "backend": "nccl" if cuda else "gloo"}
    log(f"  torch.distributed.run cli.train_cm (1 rank, "
        f"{out['train_cli']['backend']}) --steps_per_call 2 --profile_dir: "
        f"8 steps in {walls['train_cli_s']:.1f} s, trace "
        f"{out['train_cli']['trace_bytes']} bytes")

    out["launches"] = {fn.__name__: fn.launches + sum(
        rl[i] for rl in rank_launches) for i, fn in enumerate(counters)}
    if cuda and min(out["launches"].values()) == 0:
        raise AssertionError(f"a kernel never ran in phase 10: "
                             f"{out['launches']}")
    walls["phase_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    log(f"# phase 10 launches {out['launches']}, {walls['phase_s']:.1f} s")
    shutil.rmtree(work, ignore_errors=True)
    return out


# -- phase 11: the image-domain CM, the GAN objectives, the native loader ----

# cd_imagenet64_l2 as openai/consistency_models' README samples it
# (--attention_resolutions 32,16,8 --class_cond True --use_scale_shift_norm
# True --dropout 0.0 --image_size 64 --num_channels 192 --num_head_channels
# 64 --num_res_blocks 3 --resblock_updown True); the narrow copy is the
# width of the card-vs-CPU editing and training checks
IMAGENET64 = dict(image_size=64, num_channels=192, num_res_blocks=3,
                  attention_resolutions="32,16,8", class_cond=True,
                  use_scale_shift_norm=True, dropout=0.0,
                  num_head_channels=64, resblock_updown=True)
IMAGE_NARROW = dict(IMAGENET64, num_channels=64, num_res_blocks=1,
                    num_head_channels=32)
IMAGE_TS, IMAGE_STEPS = (0, 22, 39), 40
MEASURE_TOL = 1e-5       # an edited image against its projected measurement


def image_phase(counters, root: str, device: str = "cuda",
                tiny: bool = False) -> dict:
    """Phase 11 under ``build/chip_smoke_image`` (removed at the end): the
    ImageNet-64 consistency model (``IMAGENET64``, random weights drawn as
    flax draws them) — a forward at B=2 and a onestep sample card against
    CPU with the zero-init layers redrawn, the timed forward at B=16
    (TFLOP/s), images/s of onestep, multistep (0, 22, 39 of 40) and heun
    40 at B=16, the three editors at B=4 (each output held to its
    measurement; card against CPU at ``IMAGE_NARROW``), one f32 CT step
    card against CPU at ``IMAGE_NARROW``, timed CT steps at B=16 and one
    CD step; ``cli.image_sample`` from a flat ``.npz`` and from a
    reference ``.pt`` of the same weights (equal images); the JCU
    discriminator at the LJSpeech plan on a B=16 x 1024-frame pair and
    each legacy GAN loss card against CPU; the native npy loader on a
    B=32 batch of phase 6's layout against ``np.load``.  ``tiny`` (a CPU
    rehearsal) narrows the UNet and skips the timing.  Returns the
    readings; raises on any failure."""
    import copy
    import shutil

    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(root, "tests"))
    from torch_port_helpers import (  # numpy and torch only
        redraw_zero_layers,
        save_flat_npz,
        unet_reference_state_dict,
    )

    from cmtts_tpu_torch.cli.image_sample import load_unet_params
    from cmtts_tpu_torch.cm import gan_losses
    from cmtts_tpu_torch.cm.image import (
        _gray_orthogonal_matrix,
        _to_patches,
        iterative_colorization,
        iterative_inpainting,
        iterative_superres,
        karras_sample_image,
        make_image_denoise_fn,
    )
    from cmtts_tpu_torch.cm.image_train import make_image_train_step
    from cmtts_tpu_torch.cm.karras import KarrasSchedule
    from cmtts_tpu_torch.convert import state_dict_to_flax
    from cmtts_tpu_torch.core.config import config_from_dicts, load_yaml_configs
    from cmtts_tpu_torch.data import native_loader
    from cmtts_tpu_torch.data.dataset import FeatureDataset
    from cmtts_tpu_torch.data.feature_corpus import write_feature_corpus
    from cmtts_tpu_torch.models.discriminator import (
        JCUDiscriminator,
        init_like_flax as init_jcu,
    )
    from cmtts_tpu_torch.models.unet import create_image_unet, init_like_flax
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    log("# phase 11: image-domain CM (ImageNet-64), GAN objectives, native "
        "loader")
    t_phase = time.perf_counter()
    dev = torch.device(device)
    cpu = torch.device("cpu")
    cuda = dev.type == "cuda"
    work = os.path.join(root, "build", "chip_smoke_image")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = {}
    for fn in counters:
        fn.launches = 0

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def unet_of(widths, seed):
        w = dict(widths)
        return init_like_flax(create_image_unet(**w),
                              torch.Generator().manual_seed(seed)).eval()

    full = (dict(IMAGENET64, num_channels=32, num_res_blocks=1,
                 num_head_channels=16) if tiny else IMAGENET64)
    narrow = (dict(full, num_channels=32) if tiny else IMAGE_NARROW)
    sched = KarrasSchedule(distillation=True)   # consistency_distillation
    S = full["image_size"]

    # 1. the UNet: parameter count, a forward and a onestep sample card vs CPU
    t0 = time.perf_counter()
    unet_cpu = redraw_zero_layers(unet_of(full, 0), 1)
    unet = copy.deepcopy(unet_cpu).to(dev)
    n_params = sum(p.numel() for p in unet.parameters())
    out["unet_params"] = n_params
    out["unet_build_s"] = time.perf_counter() - t0
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 3, S, S, generator=g)
    t = torch.tensor([-500.0, 900.0])
    y = torch.tensor([17, 801])
    with torch.no_grad():
        ref = unet_cpu(x, t, y)
        got = unet(x.to(dev), t.to(dev), y.to(dev)).cpu()
    out["forward_err"] = check("ImageNet-64 UNet forward B=2 vs CPU", got,
                               ref, F32_TOL)
    x_T = torch.randn(2, 3, S, S, generator=g) * sched.sigma_max
    kw = dict(sampler="onestep", x_T=x_T)
    ref = karras_sample_image(unet_cpu, (2, 3, S, S), sched,
                              model_kwargs={"y": y}, device=cpu, **kw)
    got = karras_sample_image(unet, (2, 3, S, S), sched,
                              model_kwargs={"y": y.to(dev)}, device=dev,
                              **kw).cpu()
    out["onestep_err"] = check("onestep sample B=2 vs CPU", got, ref,
                               F32_TOL)
    log(f"  UNet {n_params:,} params (built in {out['unet_build_s']:.1f} s); "
        f"card vs CPU forward {out['forward_err']:.3e}, onestep "
        f"{out['onestep_err']:.3e}")
    del unet_cpu

    # 2. timing at B=16: the forward, then images/s of three samplers
    if cuda:
        B = 16
        xb = torch.randn(B, 3, S, S, device=dev)
        tb = torch.full((B,), 100.0, device=dev)
        yb = torch.arange(B, device=dev) * 61 % 1000
        with torch.no_grad():
            fwd = timed_steps(lambda _: unet(xb, tb, yb), range(12))
        flop = unet_flop(unet.cfg, B)
        out["forward_B16"] = {"median_ms": fwd["median_ms"], "flop": flop,
                              "tflops": flop / fwd["median_ms"] / 1e9,
                              "peak_mem_gib": fwd["peak_mem_gib"]}
        with torch.no_grad():
            busy = device_busy(lambda: unet(xb, tb, yb), reps=2, top=8)
        out["forward_B16"]["profile"] = busy
        log(f"  forward B=16: {fwd['median_ms']:.2f} ms, "
            f"{flop / 1e12:.3f} TFLOP, {flop / fwd['median_ms'] / 1e9:.2f} "
            f"TFLOP/s (f32, TF32 off), peak {fwd['peak_mem_gib']:.2f} GiB; "
            f"profiled: {busy['kernels_per_call']:.0f} kernels, busy "
            f"{busy['busy_share'] or 0:.3f}; top kernels:")
        for k in busy.get("top_kernels", []):
            log(f"    {k['ms_per_call']:8.2f} ms x{k['launches_per_call']:.0f}"
                f"  {k['name']}")
        gs = torch.Generator(dev).manual_seed(3)
        samplers = {}
        for name, kw, n in (
                ("onestep", dict(sampler="onestep"), 12),
                ("multistep_0_22_39", dict(sampler="multistep", ts=IMAGE_TS,
                                           steps=IMAGE_STEPS), 12),
                # 79 forwards a call: one timed call, the forward being
                # warm from the samplers before it
                ("heun_40", dict(sampler="heun", steps=IMAGE_STEPS), 1)):
            res = timed_steps(lambda _: karras_sample_image(
                unet, (B, 3, S, S), sched, model_kwargs={"y": yb},
                generator=gs, device=dev, **kw), range(n),
                warm=0 if n == 1 else 2)
            samplers[name] = {"median_ms": res["median_ms"],
                              "images_per_s": B * 1e3 / res["median_ms"],
                              "timed_calls": len(res["ms"]),
                              "peak_mem_gib": res["peak_mem_gib"]}
            log(f"  {name} B=16: {res['median_ms']:.1f} ms a call, "
                f"{B * 1e3 / res['median_ms']:.1f} images/s "
                f"({len(res['ms'])} timed), peak {res['peak_mem_gib']:.2f} "
                "GiB")
        out["samplers_B16"] = samplers

    # 3. editing: three editors at B=4 on the card, each output held to its
    # measurement (the last sigma is sigma_min), then card vs CPU narrow
    mask = np.zeros((S, S), np.float32)
    mask[S // 4: 3 * S // 4, S // 3: 2 * S // 3] = 1.0
    mask[S // 2 - S // 16: S // 2 + S // 16, :] = 1.0     # an explicit glyph
    ge = torch.Generator().manual_seed(4)
    images = torch.rand(4, 3, S, S, generator=ge) * 2 - 1
    x_e = images + torch.randn(4, 3, S, S, generator=ge) * 2.0
    draws = [torch.randn(4, 3, S, S, generator=ge)
             for _ in range(len(IMAGE_TS) - 1)]
    ye = torch.tensor([1, 2, 3, 4])
    gray = torch.as_tensor(_gray_orthogonal_matrix()[:, 0],
                           dtype=torch.float32)

    def measured(editor, z, meas):
        if editor == "colorization":
            g_ = gray.to(z.device)
            return (torch.einsum("bchw,c->bhw", z, g_),
                    torch.einsum("bchw,c->bhw", meas, g_))
        if editor == "inpainting":
            keep = (meas != -1).float()
            return z * keep, meas * keep
        return _to_patches(z, 8).mean(-1), _to_patches(meas, 8).mean(-1)

    def edit(model, editor, d):
        fn = {"colorization": iterative_colorization,
              "inpainting": iterative_inpainting,
              "superres": iterative_superres}[editor]
        extra = dict(mask=mask) if editor == "inpainting" else {}
        distill = make_image_denoise_fn(model, sched,
                                        model_kwargs={"y": ye.to(d)})
        return fn(distill, images.to(d), x_e.to(d), IMAGE_TS, sched,
                  steps=IMAGE_STEPS, noise=[n.to(d) for n in draws], **extra)

    small_cpu = redraw_zero_layers(unet_of(narrow, 5), 6)
    small = copy.deepcopy(small_cpu).to(dev)
    edits = {}
    for editor in ("colorization", "inpainting", "superres"):
        sync()
        t0 = time.perf_counter()
        res, meas = edit(unet, editor, dev)
        sync()
        wall = time.perf_counter() - t0
        a, b = measured(editor, res, meas)
        meas_err = check(f"{editor} output vs its measurement", a, b,
                         dict(rtol=0, atol=MEASURE_TOL))
        ref = edit(small_cpu, editor, cpu)[0]
        err = check(f"{editor} narrow card vs CPU",
                    edit(small, editor, dev)[0].cpu(), ref, F32_TOL)
        edits[editor] = {"wall_s": wall, "measurement_err": meas_err,
                         "narrow_err": err}
        log(f"  {editor} B=4: {wall:.2f} s, output vs measurement "
            f"{meas_err:.3e}, narrow card vs CPU {err:.3e}")
    out["edits_B4"] = edits

    # 4. training: one f32 CT step card vs CPU (narrow), timed CT at B=16,
    # one CD step
    lr, scales = 1e-4, 18
    opt = RAdam(lr)

    def step_of(model, teacher=None):
        return make_image_train_step(model, sched, scales, opt,
                                     ema_rates=(0.9999,), class_cond=True,
                                     teacher_params=teacher)

    gt = torch.Generator().manual_seed(7)
    batch = {"images": torch.rand(4, 3, S, S, generator=gt) * 2 - 1,
             "labels": torch.tensor([5, 50, 500, 999])}
    idx = torch.randint(0, scales - 1, (4,), generator=gt)
    noise = torch.randn(4, 3, S, S, generator=gt)
    results = []
    for model, d in ((small_cpu, cpu), (small, dev)):
        state = create_train_state(
            {k: v.detach() for k, v in model.named_parameters()}, opt, 1)
        state, m = step_of(model)(state, to_device(batch, d), 0.95,
                                  indices=idx.to(d), noise=noise.to(d))
        results.append((state, m))
    (s_ref, m_ref), (s_got, m_got) = results
    ct = {"loss_err": check("image CT loss card vs CPU",
                            m_got["loss"].cpu(), m_ref["loss"],
                            TRAIN_F32_TOL),
          "grad_norm_err": check("image CT grad norm card vs CPU",
                                 m_got["grad_norm"].cpu(),
                                 m_ref["grad_norm"], TRAIN_F32_TOL)}
    for what, a_, b_ in (("params", s_got.params, s_ref.params),
                         ("ema", s_got.ema_params[0], s_ref.ema_params[0]),
                         ("target", s_got.target_params,
                          s_ref.target_params)):
        ct[f"{what}_err"] = max(
            check(f"image CT {what} {k} card vs CPU", a_[k].cpu(), b_[k],
                  TRAIN_PARAM_TOL) for k in b_)
    log(f"  CT step narrow card vs CPU: loss {ct['loss_err']:.3e}, grad "
        f"norm {ct['grad_norm_err']:.3e}, params {ct['params_err']:.3e}, "
        f"EMA {ct['ema_err']:.3e}, target {ct['target_err']:.3e}")
    out["ct_card_vs_cpu"] = ct
    del small_cpu, small

    params = {k: v.detach() for k, v in unet.named_parameters()}
    if cuda:
        B = 16
        step = step_of(unet)
        state = create_train_state(params, opt, 1)
        gb = torch.Generator(dev).manual_seed(8)
        tb_ = {"images": torch.rand(B, 3, S, S, device=dev) * 2 - 1,
               "labels": torch.arange(B, device=dev) * 37 % 1000}
        box = {"state": state}

        def ct_step(_):
            box["state"], box["m"] = step(box["state"], tb_, 0.95, gb)

        res = timed_steps(ct_step, range(12))
        out["ct_B16"] = {k: res[k] for k in ("median_ms", "steps_per_s",
                                             "peak_mem_gib")}
        out["ct_B16"]["loss"] = float(box["m"]["loss"])
        log(f"  CT step B=16 (f32): {res['median_ms']:.1f} ms, "
            f"{res['steps_per_s']:.2f} steps/s, peak "
            f"{res['peak_mem_gib']:.2f} GiB, last loss "
            f"{out['ct_B16']['loss']:.4e}")
        del box, state
    Bcd = 16 if cuda else 2
    cd_state = create_train_state(params, opt, 1)
    _, m = step_of(unet, teacher=params)(
        cd_state, {"images": torch.rand(Bcd, 3, S, S, device=dev) * 2 - 1,
                   "labels": torch.arange(Bcd, device=dev)}, 0.95,
        torch.Generator(dev).manual_seed(9))
    if not np.isfinite(float(m["loss"])):
        raise AssertionError(f"image CD step: loss {float(m['loss'])}")
    out["cd_loss"] = float(m["loss"])
    log(f"  CD step B={Bcd}: loss {out['cd_loss']:.4e}")
    del cd_state

    # 5. cli.image_sample twice: from a flat .npz and from a reference .pt
    # of the same weights.  Both loaders must give the phase's weights bit
    # for bit; then the two runs must give equal images.
    tree = state_dict_to_flax(unet)
    save_flat_npz(os.path.join(work, "unet.npz"), tree)
    torch.save(unet_reference_state_dict(tree),
               os.path.join(work, "unet.pt"))
    del tree
    want = {k: v.cpu() for k, v in unet.state_dict().items()}
    for src in ("unet.npz", "unet.pt"):
        got = load_unet_params(os.path.join(work, src),
                               create_image_unet(**full), 0).state_dict()
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        if bad or set(got) != set(want):
            raise AssertionError(f"cli.image_sample's loader of {src} "
                                 f"changes {bad[:5]} of {len(want)} tensors")
        del got
    del want
    n_samples, bs = (32, 16) if cuda else (4, 2)
    free_gib = None
    if cuda:
        torch.cuda.empty_cache()      # room for the CLI processes
        free_gib = torch.cuda.mem_get_info()[0] / 2**30
    # One after the other, never at once: cuDNN picks a convolution's
    # algorithm among those whose workspace it can allocate, so two
    # processes that share the card can round differently.
    errs, walls = {}, {}
    for src in ("unet.npz", "unet.pt"):
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-m", "cmtts_tpu_torch.cli.image_sample",
             *[a for k, v in full.items() for a in (f"--{k}", str(v))],
             "--training_mode", "consistency_distillation",
             "--sampler", "multistep", "--ts",
             ",".join(map(str, IMAGE_TS)), "--steps", str(IMAGE_STEPS),
             "--num_samples", str(n_samples), "--batch_size", str(bs),
             "--model_path", os.path.join(work, src), "--device", device,
             "--out_dir", os.path.join(work, src.replace(".", "_"))],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            errs[src] = p.communicate(timeout=600)[1]
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        walls[src] = time.perf_counter() - t0
        if p.returncode != 0:
            raise AssertionError(f"cli.image_sample {src} failed:\n"
                                 f"{errs[src][-3000:]}")
    arrays = []
    for src in ("unet.npz", "unet.pt"):
        path = os.path.join(work, src.replace(".", "_"),
                            f"samples_{n_samples}x{S}x{S}x3.npz")
        with np.load(path) as f:
            arrays.append((f["arr_0"], f["arr_1"]))
    (a_npz, l_npz), (a_pt, l_pt) = arrays
    if a_npz.dtype != np.uint8 or a_npz.shape != (n_samples, S, S, 3) or \
            l_npz.shape != (n_samples,):
        raise AssertionError(f"cli.image_sample wrote {a_npz.dtype} "
                             f"{a_npz.shape} and {l_npz.shape} labels")
    if not (np.array_equal(a_npz, a_pt) and np.array_equal(l_npz, l_pt)):
        raise AssertionError("cli.image_sample: the .npz and .pt runs differ "
                             f"(max |diff| {np.abs(a_npz.astype(int) - a_pt.astype(int)).max()})")
    out["cli"] = {"wall_s": walls, "card_free_gib": free_gib,
                  "samples": n_samples,
                  "distinct_labels": int(len(np.unique(l_npz)))}
    log(f"  cli.image_sample {n_samples} samples (multistep 0,22,39 of 40, "
        f"batch {bs}) from the .npz in {walls['unet.npz']:.1f} s and the "
        f".pt in {walls['unet.pt']:.1f} s: both loaders bit-equal to the "
        "phase's weights, equal images and labels")
    del unet, params
    if cuda:
        torch.cuda.empty_cache()

    # 6. the JCU discriminator at the LJSpeech plan and the GAN losses,
    # card vs CPU
    dicts = load_yaml_configs("LJSpeech")
    cfg = config_from_dicts(*dicts)
    disc_cpu = init_jcu(JCUDiscriminator(cfg),
                        torch.Generator().manual_seed(10)).eval()
    disc = copy.deepcopy(disc_cpu).to(dev)
    Bd, Td = (16, 1024) if cuda else (2, 101)
    gd = torch.Generator().manual_seed(11)
    M = cfg.stft.n_mel_channels
    real, fake, prev = (torch.randn(Bd, Td, M, generator=gd)
                        for _ in range(3))
    steps_ = torch.randint(0, 4, (Bd,), generator=gd)
    with torch.no_grad():
        feats = {}
        for name, model, d in (("cpu", disc_cpu, cpu), ("card", disc, dev)):
            feats[name] = [model(z.to(d), prev.to(d), None, steps_.to(d))
                           for z in (real, fake)]
    d_err = 0.0
    for (rc, ru), (rc_c, ru_c) in zip(feats["card"], feats["cpu"]):
        for a_, b_ in zip(rc + ru, rc_c + ru_c):
            d_err = max(d_err, check("JCU feature card vs CPU", a_.cpu(), b_,
                                     F32_TOL))
    dcfg = cfg.model.discriminator
    losses = {}
    for name in ("cpu", "card"):
        (rc, ru), (fc, fu) = feats[name]
        dl = gan_losses.lsgan_d_loss(rc[-1], ru[-1], fc[-1], fu[-1])
        losses[name] = {
            "d_real": dl[0], "d_fake": dl[1],
            "g": gan_losses.lsgan_g_loss(fc[-1], fu[-1]),
            "fm": gan_losses.feature_matching_loss(
                rc, ru, fc, fu, dcfg.n_layer + dcfg.n_cond_layer),
            "mel_l1": gan_losses.weighted_mel_l1(
                fake.to(rc[0].device), real.to(rc[0].device)),
            "ssim": gan_losses.ssim_loss(fake.to(rc[0].device),
                                         real.to(rc[0].device))}
    loss_err = {k: check(f"GAN loss {k} card vs CPU",
                         losses["card"][k].cpu().reshape(()),
                         losses["cpu"][k].reshape(()), TRAIN_F32_TOL)
                for k in losses["cpu"]}
    out["gan"] = {"batch": [Bd, Td], "feature_err": d_err,
                  "loss_err": loss_err}
    log(f"  JCU discriminator B={Bd} x {Td} frames: features card vs CPU "
        f"{d_err:.3e}; losses {', '.join(f'{k} {v:.1e}' for k, v in loss_err.items())}")
    del disc, disc_cpu, feats

    # 7. the native npy loader: build, one B=32 batch of phase 6's layout
    t0 = time.perf_counter()
    build_s = native_loader.build_library(force=True)
    pre = os.path.join(work, "pre")
    stats = write_feature_corpus(pre, 32, 0, seed=12)
    p_, m_, t_ = load_yaml_configs("LJSpeech")
    p_["path"]["preprocessed_path"] = pre
    ds = FeatureDataset("train.txt", config_from_dicts(p_, m_, t_, stats),
                        cache_in_ram=False)
    idx = list(range(32))
    before = native_loader.native_loads
    bulk = ds.get_many(idx)
    rose = native_loader.native_loads - before
    if rose != 32 * 8:
        raise AssertionError(f"native loads rose by {rose}, not {32 * 8}")
    paths = [ds._feat_path(k, i) for i in idx for k in ds._kinds()]
    raw = ds._native.load(paths)
    for p_i, a_ in zip(paths, raw):
        b_ = np.load(p_i)
        if a_.dtype != b_.dtype or a_.shape != b_.shape or \
                a_.tobytes() != b_.tobytes():
            raise AssertionError(f"native load of {p_i} differs from np.load")
    for i, sample in zip(idx, bulk):
        ref = ds._load_one(i)
        for k, v in ref.items():
            same = (np.array_equal(v, sample[k]) if isinstance(v, np.ndarray)
                    else v == sample[k])
            if not same:
                raise AssertionError(f"get_many sample {i} {k} differs")

    def host_ms(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            t1 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(times)

    loader = {"build_s": build_s, "files": len(paths),
              "native_ms": host_ms(lambda: ds._native.load(paths)),
              "np_load_ms": host_ms(lambda: [np.load(q) for q in paths]),
              "get_many_ms": host_ms(lambda: ds.get_many(idx)),
              "serial_getitem_ms": host_ms(lambda: [ds._load_one(i)
                                                    for i in idx]),
              "native_loads": native_loader.native_loads}
    out["native_loader"] = loader
    log(f"  native loader: built in {build_s:.2f} s; B=32 batch "
        f"({len(paths)} files) byte-equal to np.load; files "
        f"{loader['native_ms']:.2f} ms native vs {loader['np_load_ms']:.2f} "
        f"ms np.load; samples {loader['get_many_ms']:.2f} ms get_many vs "
        f"{loader['serial_getitem_ms']:.2f} ms serial (host clock, median "
        "of 5)")

    shutil.rmtree(work, ignore_errors=True)
    out["launches"] = {fn.__name__: fn.launches for fn in counters}
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"# phase 11: {out['wall_s']:.1f} s; MRF launches "
        f"{out['launches']} (none on this path)")
    return out


# -- phase 12: the quality loop and the tools ----------------------------

QUALITY_STAGES = ("corpus", "preprocess", "train_ct", "synth_ct",
                  "metrics_ct", "vocoder")
TF32_PROBE = r"""
import json, sys, torch
torch.backends.cudnn.allow_tf32 = True
torch.backends.cuda.matmul.allow_tf32 = True
from cmtts_tpu_torch.cli.synthesize import main
main(sys.argv[1:])
print(json.dumps({"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                  "cuda.matmul.allow_tf32":
                      torch.backends.cuda.matmul.allow_tf32}))
"""


def run_script(script: str, env: dict, log_path: str, timeout: float):
    """Run ``cmtts_tpu_torch/tools/<script>`` with ``env`` added to the
    environment, its output into ``log_path``; -> (stdout, wall s).
    Raises when it fails."""
    path = os.path.join("cmtts_tpu_torch", "tools", script)
    t0 = time.perf_counter()
    res = subprocess.run(["bash", path], env={**os.environ, **env},
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=timeout)
    with open(log_path, "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise AssertionError(f"{script} exited {res.returncode}:\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    return res.stdout, time.perf_counter() - t0


def stage_walls(stdout: str) -> dict:
    """{stage: s} from a pipeline's ``== [name] start/done HH:MM:SS ==``
    markers (whole seconds)."""
    def secs(hms):
        h, m, s = (int(x) for x in hms.split(":"))
        return 3600 * h + 60 * m + s

    marks = {(k, n): secs(t) for n, k, t in re.findall(
        r"== \[(\w+)\] (start|done) +(\d\d:\d\d:\d\d) ==", stdout)}
    return {n: (marks[("done", n)] - marks[("start", n)]) % 86400
            for k, n in marks if k == "start" and ("done", n) in marks}


def metrics_of(path: str) -> dict:
    """{section: {metric: value}} of a quality script's metrics file."""
    out, section = {}, None
    with open(path) as f:
        for line in f:
            m = re.match(r"-- (.*) --$", line.strip())
            if m:
                section = m.group(1)
                out[section] = {}
            elif section and re.match(r"^\w+: \S+$", line.strip()):
                k, v = line.strip().split(": ")
                out[section][k] = float(v)
    return out


def quality_phase(counters, root: str, device: str = "cuda",
                  tiny: bool = False, smi: str = "") -> dict:
    """Phase 12: the quality loop and the quality and bench tools on
    ``device``, under ``build/chip_smoke_quality`` (removed at the end):
    a CLI subprocess reports TF32 off; ``run_quality_pipeline.sh`` at full
    LJSpeech width and a few steps (CT, T=1/2/4 Griffin-Lim synthesis and
    metrics, a HiFi-GAN V1 trained for a few steps and the vocoder
    protocol; no CD leg), run again to start no stage; ``vocode_dir`` on the card
    against the CPU; ``cli.train_ge2e`` and ``run_zeroshot_quality.sh`` on
    a 6-speaker corpus (2 held out); ``extend_holdout`` (with its
    determinism check); ``check_ge2e_holdout``; ``diag_pitch`` on the CT
    checkpoint; ``bench_train``; ``run_serve_bench.sh`` against
    ``cli.serve`` with the trained HiFi-GAN.  The tools run in-process
    (``main(argv)``) and launch no MRF kernel; the scripts' CLIs (the
    server's MRF launches among them) run in subprocesses, which the
    counters do not see.  ``tiny`` (a CPU rehearsal) narrows the models,
    skips the vocoder's training (Griffin-Lim serves instead) and shrinks
    the bench.  Returns the readings; raises on any failure."""
    import glob
    import shutil
    from contextlib import redirect_stdout

    import numpy as np
    import torch

    from cmtts_tpu_torch.audio.wavio import read_wav
    from cmtts_tpu_torch.cli.gen_corpus import main as gen_corpus
    from cmtts_tpu_torch.cli.preprocess import main as preprocess
    from cmtts_tpu_torch.cli.train_ge2e import main as train_ge2e
    from cmtts_tpu_torch.tools.bench_train import main as bench_train
    from cmtts_tpu_torch.tools.check_ge2e_holdout import main as ge2e_gate
    from cmtts_tpu_torch.tools.diag_pitch import main as diag_pitch
    from cmtts_tpu_torch.tools.extend_holdout import main as extend_holdout
    from cmtts_tpu_torch.tools.vocode_dir import main as vocode_dir

    log("# phase 12: the quality loop and the tools (the ported scripts, "
        "full widths, a few steps)")
    t_phase = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    work = os.path.join(root, "build", "chip_smoke_quality")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if cuda:
        torch.cuda.empty_cache()     # the scripts' processes share the card
    # the scripts run `python`: this interpreter, whatever the machine names
    bin_dir = os.path.join(work, "bin")
    os.makedirs(bin_dir)
    with open(os.path.join(bin_dir, "python"), "w") as f:
        f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(bin_dir, "python"), 0o755)
    env = {"PATH": bin_dir + os.pathsep + os.environ["PATH"],
           "DEVICE": device, "TMPDIR": work}
    out, walls = {"card": smi}, {}
    for fn in counters:
        fn.launches = 0

    # 1. the float32 policy, read inside a CLI subprocess
    t0 = time.perf_counter()
    probe = subprocess.run(
        [sys.executable, "-c", TF32_PROBE, "--mode", "single", "--text",
         "Printing, in the only sense.", "--vocoder", "griffinlim",
         "--device", device, "--out_dir", os.path.join(work, "probe")],
        cwd=root, capture_output=True, text=True, timeout=300)
    if probe.returncode != 0:
        raise AssertionError(f"TF32 probe:\n{probe.stderr[-3000:]}")
    flags = json.loads(probe.stdout.strip().splitlines()[-1])
    log(f"  TF32 inside cli.synthesize (a subprocess, flags set True before "
        f"its main): {flags}")
    if any(flags.values()):
        raise AssertionError(f"a CLI left TF32 on: {flags}")
    out["tf32_in_cli"] = flags
    walls["tf32_probe_s"] = time.perf_counter() - t0

    # 2. the quality pipeline, then again: no stage may start
    qc, voc = os.path.join(work, "qcorp"), os.path.join(work, "voc")
    ct_steps = 8
    # N - VAL >= BATCH x group 4: train_cm's megabatch
    qenv = dict(env, CORPUS=qc, N="12" if tiny else "40",
                VAL="2", BATCH="2" if tiny else "8",
                CT_STEPS=str(ct_steps), STEPS="4",
                RUN_VOCODER="0" if tiny else "1", RUN_CD="0",
                VOC_OUT=voc,
                CT_ARGS=f"--log_every {ct_steps}",
                GEN_ARGS="--tiny" if tiny else "")
    stdout, walls["quality_pipeline_s"] = run_script(
        "run_quality_pipeline.sh", qenv, os.path.join(work, "pipeline.log"),
        1200)
    stages = [s for s in QUALITY_STAGES if tiny is False or s != "vocoder"]
    walls["stages_s"] = stage_walls(stdout)
    if sorted(walls["stages_s"]) != sorted(stages):
        raise AssertionError(f"pipeline stages {walls['stages_s']}")
    again, walls["quality_pipeline_again_s"] = run_script(
        "run_quality_pipeline.sh", qenv,
        os.path.join(work, "pipeline_again.log"), 300)
    done = re.findall(r"== \[(\w+)\] already done ==", again)
    if done != stages or " start " in again:
        raise AssertionError(f"the second run started a stage:\n{again}")
    log(f"  run_quality_pipeline.sh: {walls['quality_pipeline_s']:.1f} s, "
        f"stages {walls['stages_s']}; again: {len(done)} stages already "
        f"done in {walls['quality_pipeline_again_s']:.1f} s")
    progress = glob.glob(os.path.join(qc, "output", "log", "LJSpeech_cm",
                                      "train", "progress.csv"))
    rows = open(progress[0]).read().splitlines()
    head = rows[0].split(",")
    last = dict(zip(head, rows[-1].split(",")))
    out["ct_loss_last"] = float(last["loss"])
    out["ct_step_last"] = int(float(last["step"]))
    out["metrics_ct_gl"] = metrics_of(os.path.join(qc, "metrics_ct_gl.txt"))
    if not tiny:
        out["metrics_hifigan"] = metrics_of(os.path.join(voc, "metrics.txt"))
    for name in ("metrics_ct_gl",) + (() if tiny else ("metrics_hifigan",)):
        got = out[name]
        if len(got) != (3 if name != "metrics_hifigan" else 4) or any(
                set(v) != {"mcd", "mcd_dctmel", "ffe", "ssim", "f0_rmse"}
                for v in got.values()):
            raise AssertionError(f"{name}: {got}")
    if not np.isfinite(out["ct_loss_last"]):
        raise AssertionError(f"CT loss {out['ct_loss_last']}")
    log(f"  CT loss at step {out['ct_step_last']}: {out['ct_loss_last']:.4f}; "
        + "; ".join(f"{k} MCD {v['mcd']:.3f} FFE {v['ffe']:.3f}"
                    for k, v in out["metrics_ct_gl"].items()))

    # 3. vocode_dir on the card against the CPU (f32, TF32 off)
    gens = sorted(glob.glob(os.path.join(voc, "hifigan", "hifigan_gen_*.npz")))
    if tiny:       # no vocoder training in a rehearsal: a seeded narrow one
        from cmtts_tpu_torch.convert import state_dict_to_flax
        from cmtts_tpu_torch.models.hifigan import (HiFiGANConfig,
                                                    HiFiGANGenerator,
                                                    init_like_flax)
        sys.path.insert(0, os.path.join(root, "tests"))
        from torch_port_helpers import save_flat_npz  # numpy and torch only

        gen_path = os.path.join(work, "hifigan_gen_00000000.npz")
        tree = state_dict_to_flax(init_like_flax(HiFiGANGenerator(
            HiFiGANConfig(upsample_initial_channel=32)),
            torch.Generator().manual_seed(0)))
        save_flat_npz(gen_path, tree)
    else:
        gen_path = gens[-1]
    mels = os.path.join(work, "mels")
    os.makedirs(mels)
    for name in sorted(os.listdir(os.path.join(qc, "pre", "mel")))[:2]:
        shutil.copy(os.path.join(qc, "pre", "mel", name), mels)
    t0 = time.perf_counter()
    for dev_ in (device, "cpu"):
        vocode_dir(["--mel_dir", mels, "--ckpt", gen_path, "--out",
                    os.path.join(work, f"voc_{dev_}"), "--device", dev_])
    walls["vocode_dir_card_and_cpu_s"] = time.perf_counter() - t0
    errs = []
    for name in sorted(os.listdir(os.path.join(work, f"voc_{device}"))):
        a = read_wav(os.path.join(work, f"voc_{device}", name))[0]
        b = read_wav(os.path.join(work, "voc_cpu", name))[0]
        errs.append(check(f"vocode_dir {name} card vs CPU", torch.from_numpy(a),
                          torch.from_numpy(b), F32_TOL))
    if len(errs) != 2:
        raise AssertionError(f"vocode_dir wrote {len(errs)} wavs")
    out["vocode_dir_card_vs_cpu_max_err"] = max(errs)
    log(f"  vocode_dir ({os.path.basename(gen_path)}) card vs CPU on 2 GT "
        f"mels: max|err| {max(errs):.3e}")

    # 4. GE2E and the zero-shot loop on a 6-speaker corpus, 2 held out
    zs = os.path.join(work, "zscorp")
    t0 = time.perf_counter()
    with redirect_stdout(Tee(sys.stdout)):
        zcfg = gen_corpus(["--out", zs, "--speakers", "6",
                           "--utts_per_speaker", "8", "--holdout", "2",
                           "--val_size", "4", "--batch_size",
                           "2" if tiny else "4", "--seed", "1234"]
                          + (["--tiny"] if tiny else []))
        train_ge2e(["--wav_root", os.path.join(zs, "raw"), "--work_dir",
                    os.path.join(zs, "ge2e"), "--total_steps", "4",
                    "--device", device])
        emb = os.path.join(zs, "ge2e", "ge2e_params.npy")
        preprocess(["--dataset", "VCTK", "--config_root", zcfg,
                    "--embedder_ckpt", emb, "--device", device])
    walls["zs_corpus_ge2e_preprocess_s"] = time.perf_counter() - t0
    zout = os.path.join(work, "zs_run")
    # its two evals run on the host's CPU at once: half its cores each
    threads = str(max(1, (os.cpu_count() or 2) // 2))
    _, walls["zeroshot_quality_s"] = run_script(
        "run_zeroshot_quality.sh", dict(env, CORPUS=zs, STEPS="8", OUT=zout,
                                        OMP_NUM_THREADS=threads),
        os.path.join(work, "zeroshot.log"), 900)
    zs_eval = {}
    for spk in sorted(os.listdir(os.path.join(zs, "raw_holdout"))):
        with open(os.path.join(zout, f"zs_eval_{spk}.json")) as f:
            zs_eval[spk] = json.load(f)
        if zs_eval[spk]["n_synth"] < 1:
            raise AssertionError(f"zero-shot eval {spk}: {zs_eval[spk]}")
    out["zeroshot_eval"] = {s: {k: v[k] for k in (
        "n_synth", "cos_to_target_mean", "cos_to_others_mean",
        "target_top1_accuracy", "mcd_vs_target_gt")}
        for s, v in zs_eval.items()}
    log(f"  run_zeroshot_quality.sh: {walls['zeroshot_quality_s']:.1f} s; "
        f"{out['zeroshot_eval']}")

    # 5. extend_holdout, then the GE2E gate over the extended holdout
    t0 = time.perf_counter()
    with redirect_stdout(Tee(sys.stdout)):
        extend_holdout(["--out", zs, "--speakers", "6", "--holdout", "2",
                        "--utts_per_speaker", "8", "--extend_utts_to", "10",
                        "--extra_speakers", "1", "--seed", "1234"])
        gate = ge2e_gate(["--embedder_ckpt", emb, "--holdout_root",
                          os.path.join(zs, "raw_holdout"), "--train_root",
                          os.path.join(zs, "raw"), "--min_top1", "0",
                          "--min_margin", "-2", "--out",
                          os.path.join(work, "ge2e_gate.json"),
                          "--device", device])
    walls["extend_holdout_and_gate_s"] = time.perf_counter() - t0
    with open(os.path.join(work, "ge2e_gate.json")) as f:
        if json.load(f) != gate or len(gate["speakers"]) != 3:
            raise AssertionError(f"GE2E gate report {gate}")
    out["ge2e_gate"] = gate

    # 6. diag_pitch on the CT checkpoint
    t0 = time.perf_counter()
    with redirect_stdout(Tee(sys.stdout)):
        diag = diag_pitch(["--dataset", "LJSpeech", "--config_root",
                           os.path.join(qc, "config"), "--restore_step",
                           str(ct_steps), "--out",
                           os.path.join(work, "diag.json"),
                           "--device", device])
    walls["diag_pitch_s"] = time.perf_counter() - t0
    with open(os.path.join(work, "diag.json")) as f:
        if json.load(f) != diag:
            raise AssertionError("diag_pitch's JSON differs from its report")
    out["diag_pitch"] = diag["variants"]

    # 7. bench_train: one step a call against K = 8 a call, B=32 x 768,
    # over its default 32 steps (32 calls at K=1, 4 at K=8)
    t0 = time.perf_counter()
    bench = bench_train(["--device", device]
                        + (["--batch", "2", "--t_mel", "32", "--t_txt", "8",
                            "--K", "2", "--iters", "2"] if tiny else []))
    walls["bench_train_s"] = time.perf_counter() - t0
    out["bench_train"] = bench
    log(f"  bench_train: {bench}")

    # 8. the serving bench against cli.serve
    serve_json = os.path.join(work, "serve.json")
    senv = dict(env, CORPUS=qc, STEP=str(ct_steps), PORT=str(free_port()),
                OUT=serve_json, CONCURRENCY="1 8", REQUESTS="8",
                PRIME_REQUESTS="8")
    if tiny:
        senv["VOC"] = "griffinlim"
    else:
        senv.update(VOC="hifigan", VOC_CKPT=gen_path)
    _, walls["serve_bench_s"] = run_script(
        "run_serve_bench.sh", senv, os.path.join(work, "serve.log"), 600)
    with open(serve_json) as f:
        served = json.load(f)
    sweep = {r["concurrency"]: r for r in served["sweep"]}
    if sorted(sweep) != [1, 8] or any(r["errors"] for r in sweep.values()):
        raise AssertionError(f"serve bench sweep {served['sweep']}")
    out["serve"] = {"device": served["device"], "vocoder": senv["VOC"],
                    "sweep": served["sweep"]}
    log(f"  run_serve_bench.sh ({senv['VOC']}): "
        + "; ".join(f"c={c} p50 {r['p50']} ms p99 {r['p99']} ms "
                    f"{r['req_per_s']} req/s {r['batch_hist']}"
                    for c, r in sweep.items()))

    out["launches"] = {fn.__name__: fn.launches for fn in counters}
    walls["phase_s"] = time.perf_counter() - t_phase
    out["walls_s"] = walls
    log(f"  phase 12: {walls['phase_s']:.1f} s; in-process MRF launches "
        f"{out['launches']} (the scripts' CLIs, cli.serve among them, "
        "launch theirs in subprocesses)")
    shutil.rmtree(work, ignore_errors=True)
    return out


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "one CUDA card (see the module docstring)")
    ap.add_argument("--kernels", action="store_true",
                    help="phases 1 and 2 only: build, check and time the "
                    "MRF kernels, then stop")
    kernels_only = ap.parse_args(argv).kernels

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cmtts_tpu_torch.cli.synthesize import preprocess_english, random_cmtts
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.masks import DEFAULT_MEL_BUCKETS, pick_bucket
    from cmtts_tpu_torch.models.hifigan import (
        HiFiGANConfig,
        HiFiGANGenerator,
        hifigan_apply_fused,
    )
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.ops import mrf
    from cmtts_tpu_torch.pipeline import Synthesizer

    dev = cli_device("cuda")    # float32 as the CLIs compute it: TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    # -- phase 1 -----------------------------------------------------------
    log(f"# device: {torch.cuda.get_device_name(0)} | {smi}")
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    build_s = mrf.build_kernels(force=True)
    log(f"# kernel build: {build_s:.1f} s (nvcc, sm_90a) -> "
        f"{os.path.relpath(mrf.library_path())}")
    hgmma = inspect_library(mrf.library_path())

    # -- phase 2: kernel vs plain ------------------------------------------
    torch.manual_seed(0)
    gen = HiFiGANGenerator().to(dev).eval()
    # a narrow generator's first stage: C = 16, the bf16 route's narrowest
    # block; V2's last stage: C = 8, which the bf16 route pads to 16
    narrow = HiFiGANGenerator(HiFiGANConfig(
        upsample_initial_channel=32)).to(dev).eval()
    v2 = HiFiGANGenerator(HiFiGANConfig(
        upsample_initial_channel=128)).to(dev).eval()
    chans = {gen.stage_channels(i): (gen, i) for i in range(4)}
    chans[narrow.stage_channels(0)] = (narrow, 0)
    chans[v2.stage_channels(3)] = (v2, 3)
    dtypes = (torch.float32, torch.bfloat16)
    packs = {C: {dt: mrf.pack_mrf_params(g_, i, dt) for dt in dtypes}
             for C, (g_, i) in chans.items()}
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
        f32 = dtype == torch.float32
        tol = F32_TOL if f32 else BF16_STAGE_TOL
        err = check(f"{label} B={B} C={C} L={L} head={head} {dtype}",
                    out, ref, tol)
        bound_ms, bound_by = stage_bound(B, C, L, head, dtype)
        res = {"err": err, "bound_ms": bound_ms, "bound_by": bound_by}
        note = ""
        if timed:
            res["ms"] = cuda_ms(kern)
            res["plain_ms"] = cuda_ms(plain)
            if not f32 and B == 8:   # the cuDNN yardstick, timed only
                res["library_ms"] = cuda_ms(
                    cudnn_stage(x, packs[C][dtype], dtype, post))
            res["flop"] = stage_flop(B, C, L, head)
            res["tflops"] = res["flop"] / res["ms"] / 1e9
            res["of_bound"] = bound_ms / res["ms"]
            note = (f"kernel {res['ms']:.3f} ms plain {res['plain_ms']:.3f} "
                    f"ms ({res['tflops']:.2f} TFLOP/s useful, "
                    f"{res['of_bound']:.1%} of the bound")
            if f32:
                note += ") "
            else:   # the MMA work the bf16 route's tiling issues
                issued = issued_flop(mrf, B, C, L, head)
                res["issued_over_useful"] = issued / res["flop"]
                res["issued_tflops"] = issued / res["ms"] / 1e9
                note += (f"; {res['issued_tflops']:.2f} issued = "
                         f"{res['issued_over_useful']:.3f}x) ")
                if "library_ms" in res:
                    note += f"cuDNN bf16 {res['library_ms']:.3f} ms "
        log(f"  {label:9s} {'streamed' if streamed else 'fused':8s} B={B} "
            f"C={C:3d} L={L:6d} head={int(head)} "
            f"{str(dtype).split('.')[-1]:8s} max|err|={err:.3e} {note}"
            f"bound {res['bound_ms']:.4f} ms ({bound_by})")
        return res

    log("# phase 2: kernel vs plain version (f32 tol "
        f"{F32_TOL}, bf16 tol {BF16_STAGE_TOL})")
    for dtype in dtypes:
        for C in (8, 16, 32, 64, 128, 256):
            for L in (40, 50, 300, 1237):
                for head in ((False,) if C > 128 else (False, True)):
                    case("edge", 2, C, L, head, dtype)
    stages = ((256, 8), (128, 64), (64, 128), (32, 256))
    # the stages of a 768-frame mel, B=1, timed (the latency view)
    timing_b1 = {dt: [] for dt in dtypes}
    for dtype in dtypes:
        for i, (C, up) in enumerate(stages):
            timing_b1[dtype].append(case("mel768", 1, C, 768 * up, i == 3,
                                         dtype, timed=True))
    # the main path's B=8, mel-1024 stages, timed in both types
    timing = {dt: {"fused": [], "streamed": []} for dt in dtypes}
    for dtype in dtypes:
        for i, (C, up) in enumerate(stages):
            res = case("main", 8, C, 1024 * up, i == 3, dtype, timed=True,
                       seed=i)
            timing[dtype]["streamed" if C > 128 else "fused"].append(res)
    for dtype in dtypes:
        for label, rows in (
                ("main B=8 mel 1024",
                 timing[dtype]["streamed"] + timing[dtype]["fused"]),
                ("B=1 mel 768", timing_b1[dtype])):
            ms = sum(r_["ms"] for r_ in rows)
            bound = sum(r_["bound_ms"] for r_ in rows)
            lib = ("" if "library_ms" not in rows[0] else
                   f", cuDNN bf16 {sum(r_['library_ms'] for r_ in rows):.3f}"
                   " ms")
            log(f"  {label}, four stages, {str(dtype).split('.')[-1]}: "
                f"{ms:.3f} ms, {sum(r_['flop'] for r_ in rows) / ms / 1e9:.2f}"
                f" TFLOP/s useful, bound {bound:.3f} ms ({bound / ms:.1%}), "
                f"plain {sum(r_['plain_ms'] for r_ in rows):.3f} ms{lib}")
    stage_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "tflops",
                  "of_bound", "err", "issued_tflops", "issued_over_useful")

    def stage_rows(rows):
        return [{k_: r_[k_] for k_ in stage_keys if k_ in r_} for r_ in rows]

    stages_b8 = {str(dt).split(".")[-1]: stage_rows(
        timing[dt]["streamed"] + timing[dt]["fused"]) for dt in dtypes}
    stages_b1 = {str(dt).split(".")[-1]: stage_rows(timing_b1[dt])
                 for dt in dtypes}
    if kernels_only:
        print(json.dumps({"build_s": build_s, "stages_B8": stages_b8,
                          "stages_B1_mel768": stages_b1}))
        print(smi)
        return 0

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
        return counted_synthesis(synth, seqs, counters, hop, **kw)

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
        return timed_rtf(synth, seqs, counters, hop, sr, reps, **kw)

    results, walls = {}, {}
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
        walls[f"B8_T{T}"] = wall * 1e3
        log(f"  RTF B=8 T={T} (mel bucket 1024): {r:.6f} (median wall "
            f"{wall * 1e3:.2f} ms for {audio:.3f} s of audio)")
    # B=1 in float32 (denoiser and vocoder stages): the float32 kernels'
    # users, against the plain float32 vocoder on the same mel
    synth32 = Synthesizer(cfg, model, vocoder, T=1,
                          compute_dtype=torch.float32)
    before = [fn.launches for fn in counters]
    mel32, _, wav32 = counted_call(synth32, [tokens], x_T=x_T)
    launches_f32 = {fn.__name__: fn.launches - b
                    for fn, b in zip(counters, before)}
    with torch.no_grad():
        wav32_plain = vocoder(torch.from_numpy(mel32).to(dev)).cpu()
    err_voc32 = check("B=1 f32 vocoder kernels vs plain f32 vocoder",
                      torch.from_numpy(wav32), wav32_plain, F32_TOL)
    log(f"  B=1 T=1 float32: max|err| wav vs plain vocoder {err_voc32:.3e}")
    launches = {fn.__name__: fn.launches for fn in counters}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    log(f"# main-path launches: {launches}, of which float32 "
        f"{launches_f32}")

    # the vocoder's share of the B=8 wall: hifigan_apply_fused alone on a
    # mel of the same bucket, timed like the synthesis calls (after the
    # launch counts were read, so they hold the main path's run only)
    mel8 = torch.randn(8, 1024, cfg.stft.n_mel_channels, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(4))
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hifigan_apply_fused(synth1.vocoder, mel8, synth1.vocoder_packed)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    voc_ms = statistics.median(times[1:]) * 1e3
    results["B8_vocoder_ms"] = voc_ms
    log(f"  vocoder alone, B=8 mel 1024: median {voc_ms:.2f} ms "
        f"({voc_ms / walls['B8_T1']:.1%} of the B=8 T=1 wall)")

    # -- phase 5: zero-shot and samplers at full VCTK width ----------------
    zero_shot = zero_shot_phase(counters, vocoder,
                                os.path.dirname(os.path.abspath(__file__)))
    results["zero_shot"] = zero_shot

    # -- phase 6: consistency training at full LJSpeech width --------------
    train = training_phase(counters,
                           os.path.dirname(os.path.abspath(__file__)))

    # -- phase 7: wav -> features -> train -> synthesize -> score ---------
    data = data_phase(counters, os.path.dirname(os.path.abspath(__file__)))

    # -- phase 8: serving and reference checkpoints -------------------------
    served = serve_phase(counters, os.path.dirname(os.path.abspath(__file__)),
                         results["B8_T1"])

    # -- phase 9: the vocoder and speaker-encoder trainers -----------------
    trainers = trainers_phase(counters,
                              os.path.dirname(os.path.abspath(__file__)))

    # -- phase 10: ranks and the MOS metric nets ---------------------------
    parallel = parallel_phase(counters,
                              os.path.dirname(os.path.abspath(__file__)))

    # -- phase 11: the image-domain CM, GAN objectives, native loader ------
    image = image_phase(counters, os.path.dirname(os.path.abspath(__file__)))
    image["card"] = smi

    # -- phase 12: the quality loop and the tools --------------------------
    quality = quality_phase(counters,
                            os.path.dirname(os.path.abspath(__file__)),
                            smi=smi)

    # -- phase 4: summary lines --------------------------------------------
    kernels = []
    phases = {"3": launches, "5": zero_shot["launches"],
              "6": train["launches"], "7": data["launches"],
              "8": served["launches"], "9": trainers["launches"],
              "10": parallel["launches"], "11": image["launches"],
              "12": quality["launches"]}
    for dtype, src, design, note in (
            (torch.bfloat16, "cmtts_tpu_torch/csrc/mrf_wg.cu",
             "wgmma bf16 implicit GEMM, one launch a conv (+ cast, head); "
             "weight tiles by bulk async copies through an mbarrier ring",
             "phase 12 counts its in-process launches; the scripts' CLIs "
             "(cli.serve with HiFi-GAN among them) launch theirs in "
             "subprocesses, not counted; phase 3 less its float32 call"),
            (torch.float32, "cmtts_tpu_torch/csrc/mrf.cu",
             "SIMT f32 implicit GEMM, one launch a conv (+ head)",
             "the float32 route runs on the main path in phase 3's B=1 "
             "float32 synthesis call only")):
        f32 = dtype == torch.float32
        for name, key, replaces in (
                ("fused_mrf_stage", "fused",
                 "cmtts_tpu/ops/mrf_pallas.py:234"),
                ("fused_mrf_stage_streamed", "streamed",
                 "cmtts_tpu/ops/mrf_pallas.py:374")):
            rows = timing[dtype][key]
            ms = sum(r_["ms"] for r_ in rows)
            by_phase = ({"3": launches_f32[name]} if f32 else
                        {ph: n[name] - (launches_f32[name] if ph == "3"
                                        else 0)
                         for ph, n in phases.items()})
            kernels.append({
                "name": name + ("[float32]" if f32 else ""),
                "route": "cuda", "source": src, "replaces": replaces,
                "dtype": str(dtype).split(".")[-1], "design": design,
                "launches": sum(by_phase.values()),
                "launches_by_phase": by_phase, "launches_note": note,
                **({} if f32 else {"hgmma_in_sass": hgmma}),
                "max_abs_err": max(r_["err"] for r_ in rows),
                "ms": ms,
                "tflops": sum(r_["flop"] for r_ in rows) / ms / 1e9,
                "plain_ms": sum(r_["plain_ms"] for r_ in rows),
                "bound_ms": sum(r_["bound_ms"] for r_ in rows),
                "bound_by": ("operations" if all(
                    r_["bound_by"] == "operations" for r_ in rows)
                    else "bytes"),
                # bf16: the cuDNN yardstick (18 F.conv1d in bf16 a stage,
                # timed only); float32: no single PyTorch call
                "library_ms": (None if f32 else
                               sum(r_["library_ms"] for r_ in rows))})
    print(json.dumps({"rtf": results, "build_s": build_s,
                      "stages_B8": stages_b8, "stages_B1_mel768": stages_b1}))
    print(json.dumps({"train": train}))
    print(json.dumps({"data": data}))
    print(json.dumps({"serve": served}))
    print(json.dumps({"trainers": trainers}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"image": image}))
    print(json.dumps({"quality": quality}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
