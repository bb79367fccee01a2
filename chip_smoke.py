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
  4. a ``{"kernels": [...]}`` line (launches of phases 3, 5 and 6), the
     card's name and power limit, and a last line
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
                         + train["launches"][name]),
            "launches_by_phase": {"3": launches[name],
                                  "5": zero_shot["launches"][name],
                                  "6": train["launches"][name]},
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
