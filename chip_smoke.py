#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build the MRF kernels,
hold each against its plain PyTorch version on the card, then synthesise
at full LJSpeech width through the port's ``Synthesizer``, and zero-shot
at full VCTK width with both speaker embedders and every sampler.

    python3 chip_smoke.py

Phases (none catches its own failure; any mismatch raises and the script
exits non-zero):
  1. device, power limit, torch/CUDA versions, kernel build time, each
     kernel's registers and stack (``cuobjdump -res-usage``) and the count
     of tensor-core (HMMA) instructions in the bf16 kernel's SASS, which
     must not be 0;
  2. kernel vs plain version on the card: edge shapes at every width of
     the kernels (C = 16, whose bf16 passes are 16 channels wide, to 256)
     in float32 (the SIMT kernel) and bfloat16 (the tensor-core kernel),
     each held to its plain version within about a rounding of its type,
     the shapes of a 768-frame mel, and the shapes of the batch-8,
     1024-frame main path
     (timed: kernel, plain, bound, achieved TFLOP/s of useful work and of
     the MMA work the kernel issues);
  3. synthesis (random weights from a seed): B=1 from text at T=1, checked
     against the float32 acoustic model on the CPU and the plain vocoder on
     the card; B=8 at 96 tokens (mel bucket 1024) at T=1 and T=2, with the
     real-time factor.  Launch counters are zeroed before this phase.
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
     utterances at batch 8; ``cli.synthesize`` with the V2 file (3 fused
     launches and a plain last stage, against the plain V2 generator),
     with MelGAN (card vs CPU) and with ``--lang zh``.  Its numbers go on
     a ``{"serve": {...}}`` line.
  4. a ``{"kernels": [...]}`` line (launches of phases 3, 5, 6, 7 and 8),
     the card's name and power limit, and a last line
     ``{"ok": true, "device": {...}}``.

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


def issued_flop(mrf, B, C, L, head: bool, pass_tiles: int = 0) -> int:
    """FLOP of the MMAs the bf16 kernel issues for one stage: per length
    tile, each conv over its region (the halo recomputed) rounded up to 16
    positions, in warp passes of ``pass_tiles`` m16 tiles that always run
    whole (csrc/mrf_tc.cu's work split).  Over stage_flop, it is the work
    the tiling adds; with ``pass_tiles`` = 1, the part of it that the halo
    and the rounding to 16 positions add.  0 means the kernel's own."""
    pass_tiles = pass_tiles or mrf.PASS_TILES
    pad = 3 if head else 0
    tile, _ = mrf.plan_tile(C, L, 2, mrf.receptive_radius(KS, DS) + pad, pad)
    n_cog = C // 32 if C % 32 == 0 else C // 16   # c_out groups
    flop = 0
    for k in KS:
        half = (k - 1) // 2
        rem = pad + sum(half * d + half for d in DS)
        for d in DS:
            for shrink in (half * d, half):   # conv1, then conv2
                rem -= shrink
                tiles_m = -(-(tile + 2 * rem) // 16)
                units = n_cog * tiles_m
                for w in range(mrf.WARPS):
                    u, u_end = (w * units // mrf.WARPS,
                                (w + 1) * units // mrf.WARPS)
                    while u < u_end:
                        u += min(pass_tiles, tiles_m - u % tiles_m, u_end - u)
                        flop += pass_tiles * 16 * (C // n_cog) * 2 * k * C
    return flop * -(-L // tile) * B


def stage_bound(B, C, L, head: bool):
    """(ms, "operations" | "bytes"): the least time for one stage, the
    larger of its bf16 FLOP at the tensor-core peak and its bytes (x read
    once, output written once, bf16 weights and f32 biases read once) at
    the memory rate."""
    flop = stage_flop(B, C, L, head)
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
    if streamed:
        return lambda: mrf.fused_mrf_stage_streamed(x, packs[dtype], KS, DS,
                                                    dtype)
    p = None if post is None else post[dtype]
    return lambda: mrf.fused_mrf_stage(x, packs[dtype], KS, DS, dtype, post=p)


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


def inspect_library(path: str) -> int:
    """Log each kernel's registers, stack and spills and return the count
    of HMMA instructions in the SASS of the tensor-core kernel; raise if it
    has none, or if the float32 kernel has any."""
    with open(path + ".log") as f:   # nvcc -Xptxas -v, kept by the build
        for line in f:
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                log(f"  ptxas: {line.strip()}")
    usage = subprocess.run([cuda_tool("cuobjdump"), "-res-usage", path],
                           capture_output=True, text=True, check=True).stdout
    for name, lines in kernel_sections(usage).items():
        log(f"  {name}: "
            + " ".join(ln.strip() for ln in lines if "REG" in ln))
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", path],
                          capture_output=True, text=True, check=True).stdout
    hmma = {name: sum("HMMA" in ln for ln in lines)
            for name, lines in kernel_sections(sass).items()}
    log(f"  HMMA instructions per kernel: {hmma}")
    tc = sum(n for name, n in hmma.items() if "mrf_stage_tc_kernel" in name)
    simt = sum(n for name, n in hmma.items() if "mrf_stage_kernel" in name)
    if tc == 0 or simt != 0:
        raise AssertionError(f"HMMA count: tensor-core kernel {tc}, "
                             f"float32 kernel {simt}")
    return tc


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


def denoiser_flop(cfg, B: int, L: int) -> int:
    """FLOP of one denoiser forward at B x L frames, from the module's
    layers: per frame in_proj, per block cond_proj, the k3 gate and filter
    convs and out_proj, then skip_proj and out_proj; per row the step MLP
    and each block's t_proj."""
    C = cfg.model.denoiser.residual_channels
    N = cfg.model.denoiser.residual_layers
    H = cfg.model.transformer.encoder_hidden
    M = cfg.stft.n_mel_channels
    frame = 2 * M * C + N * (2 * H * C + 2 * 2 * 3 * C * C + 2 * C * 2 * C) \
        + 2 * C * C + 2 * C * M
    row = 2 * C * 4 * C * 2 + N * 2 * C * C
    return B * L * frame + B * row


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


def device_busy(fn, reps: int = 3) -> dict:
    """Run ``fn`` ``reps`` times under ``torch.profiler``: the window's
    CUDA-event ms, the summed duration of the device kernels in it, their
    share of the window and kernels per call.  ``busy_share`` is None when
    the profiler records no device activity."""
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
    return {"window_ms_per_call": window / reps,
            "kernel_ms_per_call": busy / reps,
            "busy_share": busy / window if kernels else None,
            "kernels_per_call": len(kernels) / reps}


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
    out["v2_cli_launches"] = expect_launches("V2 CLI", before, [3, 0])
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
    expect_launches("V2 synthesis", before, [3, 0])
    with torch.no_grad():
        plain = gens["v2"][0](torch.from_numpy(mel2).to(dev)).cpu()
    out["err_v2_vs_plain"] = check(
        "V2 (bf16 kernels + plain last stage) vs the plain V2 generator",
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
    from cmtts_tpu_torch.models.hifigan import (
        HiFiGANConfig,
        HiFiGANGenerator,
        hifigan_apply_fused,
    )
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
    log(f"# kernel build: {build_s:.1f} s (nvcc, sm_90a) -> "
        f"{os.path.relpath(mrf.library_path())}")
    hmma = inspect_library(mrf.library_path())

    # -- phase 2: kernel vs plain ------------------------------------------
    torch.manual_seed(0)
    gen = HiFiGANGenerator().to(dev).eval()
    # a narrow generator's first stage: C = 16, the bf16 kernel's passes of
    # one pair of n8 tiles
    narrow = HiFiGANGenerator(HiFiGANConfig(
        upsample_initial_channel=32)).to(dev).eval()
    chans = {gen.stage_channels(i): (gen, i) for i in range(4)}
    chans[narrow.stage_channels(0)] = (narrow, 0)
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
        tol = F32_TOL if dtype == torch.float32 else BF16_STAGE_TOL
        err = check(f"{label} B={B} C={C} L={L} head={head} {dtype}",
                    out, ref, tol)
        bound_ms, bound_by = stage_bound(B, C, L, head)
        res = {"err": err, "bound_ms": bound_ms, "bound_by": bound_by}
        if timed:
            res["ms"] = cuda_ms(kern)
            res["plain_ms"] = cuda_ms(plain)
            res["flop"] = stage_flop(B, C, L, head)
            res["tflops"] = res["flop"] / res["ms"] / 1e9
            issued = issued_flop(mrf, B, C, L, head)
            res["issued_over_useful"] = issued / res["flop"]
            res["issued_tflops"] = issued / res["ms"] / 1e9
            res["halo_over_useful"] = (issued_flop(mrf, B, C, L, head, 1)
                                       / res["flop"])
        log(f"  {label:9s} {'streamed' if streamed else 'fused':8s} B={B} "
            f"C={C:3d} L={L:6d} head={int(head)} "
            f"{str(dtype).split('.')[-1]:8s} max|err|={err:.3e} "
            + (f"kernel {res['ms']:.3f} ms plain {res['plain_ms']:.3f} ms "
               f"({res['tflops']:.2f} TFLOP/s useful, "
               f"{res['issued_tflops']:.2f} issued = "
               f"{res['issued_over_useful']:.3f}x, of which halo and "
               f"rounding {res['halo_over_useful']:.3f}x) " if timed else "")
            + f"bound {res['bound_ms']:.4f} ms")
        return res

    log("# phase 2: kernel vs plain version (f32 tol "
        f"{F32_TOL}, bf16 tol {BF16_STAGE_TOL})")
    for dtype in dtypes:
        for C in (16, 32, 64, 128, 256):
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
    launches = {fn.__name__: fn.launches for fn in counters}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never ran on the main path: "
                             f"{launches}")
    log(f"# main-path launches: {launches}")

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

    # -- phase 4: summary lines --------------------------------------------
    src = "cmtts_tpu_torch/csrc/mrf_tc.cu"
    kernels = []
    for name, key, replaces in (
            ("fused_mrf_stage", "fused", "cmtts_tpu/ops/mrf_pallas.py:234"),
            ("fused_mrf_stage_streamed", "streamed",
             "cmtts_tpu/ops/mrf_pallas.py:374")):
        rows = timing[key]
        ms = sum(r_["ms"] for r_ in rows)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": (launches[name] + zero_shot["launches"][name]
                         + train["launches"][name]
                         + data["launches"][name]
                         + served["launches"][name]),
            "launches_by_phase": {"3": launches[name],
                                  "5": zero_shot["launches"][name],
                                  "6": train["launches"][name],
                                  "7": data["launches"][name],
                                  "8": served["launches"][name]},
            "design": "mma.sync bf16", "float32_design": "simt f32",
            "float32_source": "cmtts_tpu_torch/csrc/mrf.cu",
            "hmma_in_sass": hmma,
            "max_abs_err": max(r_["err"] for r_ in rows),
            "ms": ms,
            "tflops": sum(r_["flop"] for r_ in rows) / ms / 1e9,
            "plain_ms": sum(r_["plain_ms"] for r_ in rows),
            "bound_ms": sum(r_["bound_ms"] for r_ in rows),
            "bound_by": ("operations" if all(
                r_["bound_by"] == "operations" for r_ in rows) else "bytes"),
            "library_ms": None})
    stages = [{k_: r_[k_] for k_ in ("ms", "plain_ms", "bound_ms", "tflops",
                                     "issued_tflops", "issued_over_useful",
                                     "halo_over_useful", "err")}
              for r_ in timing["streamed"] + timing["fused"]]
    print(json.dumps({"rtf": results, "build_s": build_s,
                      "stages_B8": stages}))
    print(json.dumps({"train": train}))
    print(json.dumps({"data": data}))
    print(json.dumps({"serve": served}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
