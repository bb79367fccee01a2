"""Synthesis in a closed loop: one caller sends ``Synthesizer.__call__``
calls back to back (batch synthesis, as ``cli.synthesize --mode batch``
and ``cli.p_rtf_cm`` run it), or, for a configuration with an external
speaker embedder, embeds each row's reference clip with
``PreDefinedEmbedder.__call__`` and then synthesizes (zero-shot voice
cloning, as the reference's zero-shot scripts run it).

Set-up builds the program from the seed's weights, makes the traffic, and
warms up each (text bucket, mel bucket) shape that the run's calls reach.
The window times each call on the host clock from its start to the wav on the
host.  The check, once the window has closed and the program is freed,
runs the plain reference over a sample of the window's calls, drawn from
the seed, with the longest call in it.
"""

from __future__ import annotations

import gc
import time
import warnings

import numpy as np

from perfbench import compare, flops
from perfbench.harness import Run
from perfbench.reference.config import read_config
from perfbench.reference.synth import pick_bucket
from perfbench.trace import Tracer
from perfbench.traffic import make_calls, make_voices, run_rng
from perfbench.weights import seeded_state_dict

SALT_ACOUSTIC, SALT_VOCODER, SALT_EMBEDDER = 11, 12, 13


def vocoder_cfg(config: dict) -> dict:
    return config["vocoder"]


def weight_overrides(config: dict) -> dict:
    return {k: tuple(v) for k, v in config.get("weight_overrides",
                                               {}).items()}


def seeded_weights(config: dict, seed: int, device: str):
    """(acoustic, vocoder, embedder or None) state dicts from the seed."""
    from perfbench.reference.synth import modules

    c = read_config(config)
    model, voc, emb = modules(c, vocoder_cfg(config), "meta")
    ov = weight_overrides(config)
    return (seeded_state_dict(model, seed, SALT_ACOUSTIC, device, ov),
            seeded_state_dict(voc, seed, SALT_VOCODER, device, ov),
            None if emb is None else
            seeded_state_dict(emb, seed, SALT_EMBEDDER, device, ov))


def shape_of(call, c, buckets) -> tuple:
    m = max(len(t) for t in call.tokens)
    return (pick_bucket(m, buckets["text"]),
            pick_bucket(min(m * 10, c.max_seq_len), buckets["mel"]))


# -- the program ------------------------------------------------------------

def build_program(config: dict, seed: int, device: str, setup: dict):
    """The program's objects, from the seed's weights.  Fills the set-up
    split's ``imports``, ``kernels`` and ``weights``."""
    t = time.perf_counter()
    import torch

    from cmtts_tpu_torch.core.config import config_from_dicts
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.models.cmtts import CMTTS
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
    from cmtts_tpu_torch.models.speaker import PreDefinedEmbedder
    from cmtts_tpu_torch.ops import mrf
    from cmtts_tpu_torch.pipeline import Synthesizer

    setup["imports"] = setup.get("imports", 0.0) + time.perf_counter() - t
    t = time.perf_counter()
    dev = cli_device(device)          # float32 stays float32 (no TF32)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize()
    setup["cuda_init"] = setup.get("cuda_init", 0.0) + time.perf_counter() - t
    t = time.perf_counter()
    if dev.type == "cuda":
        mrf.build_kernels()
    setup["kernels"] = setup.get("kernels", 0.0) + time.perf_counter() - t
    t = time.perf_counter()
    cfg = config_from_dicts(config["preprocess"], config["model"],
                            config["train"], config.get("stats", {}))
    sd_model, sd_voc, sd_emb = seeded_weights(config, seed, dev.type)
    v = vocoder_cfg(config)
    with torch.device(dev):
        model = CMTTS(cfg)
        voc = HiFiGANGenerator(HiFiGANConfig(
            upsample_rates=tuple(v["upsample_rates"]),
            upsample_kernel_sizes=tuple(v["upsample_kernel_sizes"]),
            upsample_initial_channel=v["upsample_initial_channel"],
            resblock_kernel_sizes=tuple(v["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) for d in v["resblock_dilation_sizes"]),
            num_mels=v["num_mels"], sampling_rate=v["sampling_rate"]))
    model.load_state_dict(sd_model, strict=True)
    voc.load_state_dict(sd_voc, strict=True)
    embedder = None
    if sd_emb is not None:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            embedder = PreDefinedEmbedder(cfg, None, dev)
        embedder._impl.model.load_state_dict(sd_emb, strict=True)
    del sd_model, sd_voc, sd_emb
    b = config["buckets"]
    synth = Synthesizer(cfg, model, voc, T=1, text_buckets=b["text"],
                        mel_buckets=b["mel"], compute_dtype=torch.bfloat16,
                        device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup["weights"] = setup.get("weights", 0.0) + time.perf_counter() - t
    return {"synth": synth, "embedder": embedder, "device": dev}


def program_call(prog, call, voices, tracer=None):
    """One request through the program: (outputs dict, embed seconds).
    ``tracer`` marks the embedding and the synthesis as spans."""
    span = tracer.span if tracer is not None else Tracer(False).span
    t = time.perf_counter()
    embeds = None
    if prog["embedder"] is not None:
        with span("embed"):
            embeds = np.stack([prog["embedder"](voices[v])
                               for v in call.voices])
    te = time.perf_counter() - t
    with span("synthesize"):
        mel, mel_lens, wav = prog["synth"](call.tokens, spker_embeds=embeds,
                                           seed=call.noise_seed)
    return {"mel": mel, "mel_lens": mel_lens, "wav": wav,
            "embeds": embeds}, te


# -- the reference ----------------------------------------------------------

def build_reference(config: dict, seed: int, device: str, fmt: str = "f32"):
    """The plain reference from the seed's weights in float32 (TF32 off),
    and beside it the vocoder with its MRF stages' and head's operands
    rounded to bf16 (the witness ``voc_ratio`` divides by).
    ``fmt="control"``: each part one precision below the configuration's,
    the bfloat16 parts (denoiser, MRF stages and head) in float8 e4m3 and
    the float32 parts (conditioning, embedder, the vocoder's other convs)
    in TF32.  ``fmt="bf16"``: the bfloat16 parts' operands rounded to
    bfloat16, a witness of what that precision alone does."""
    from perfbench.reference.quant import lower_precision
    from perfbench.reference.synth import modules

    c = read_config(config)
    sds = seeded_weights(config, seed, device)
    mods = modules(c, vocoder_cfg(config), device)
    for m, sd in zip(mods, sds):
        if m is not None:
            m.to(device).eval().load_state_dict(sd, strict=True)
    model, voc, emb = mods
    voc16 = modules(c, vocoder_cfg(config), device)[1]
    voc16.to(device).eval().load_state_dict(sds[1], strict=True)
    lower_precision(mrf_parts(voc16), "bf16")
    if fmt in ("control", "bf16"):
        lower_precision([model.denoiser] + mrf_parts(voc),
                        "fp8" if fmt == "control" else "bf16")
    return {"model": model, "vocoder": voc, "vocoder_bf16": voc16,
            "embedder": emb, "c": c, "device": device,
            "buckets": config["buckets"], "tf32": fmt == "control"}


def mrf_parts(voc) -> list:
    """The vocoder's modules that the program computes in bf16: the MRF
    stages' ResBlocks and the fused head's conv_post."""
    return [m for n, m in voc.named_children() if n.startswith("res_")] + [
        voc.conv_post]


def _tf32(on: bool) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def reference_call(ref, call, voices, sr: int):
    import torch

    from perfbench.reference.synth import embed, synthesize

    _tf32(ref["tf32"])
    embeds = None
    if ref["embedder"] is not None:
        embeds = torch.stack([embed(ref["embedder"], voices[v], sr,
                                    ref["device"]) for v in call.voices])
    mel, mel_lens, wav = synthesize(ref["model"], ref["vocoder"], ref["c"],
                                    call.tokens, embeds, call.noise_seed,
                                    ref["buckets"], ref["device"])
    return {"mel": mel.cpu().numpy(), "mel_lens": mel_lens.cpu().numpy(),
            "wav": wav.cpu().numpy(),
            "embeds": None if embeds is None else embeds.cpu().numpy()}


def reference_vocode(ref, mel: np.ndarray, which: str = "vocoder"
                     ) -> np.ndarray:
    import torch

    _tf32(False)
    with torch.no_grad():
        x = torch.as_tensor(mel, device=ref["device"])
        return ref[which](x).cpu().numpy()


def gaps(ref, cand: dict, call, voices, sr: int, hop: int) -> dict:
    """The compared numbers of one call: ``cand`` (the program's outputs,
    or the control's) against the reference."""
    want = reference_call(ref, call, voices, sr)
    return compare.synthesis_gaps(
        cand, want, reference_vocode(ref, cand["mel"]),
        reference_vocode(ref, cand["mel"], "vocoder_bf16"), hop)


# -- the run ----------------------------------------------------------------

def run(ctx) -> Run:
    import torch

    c = read_config(ctx.config)
    sr, hop = c.sampling_rate, c.hop
    prog = build_program(ctx.config, ctx.seed, ctx.device, ctx.setup)
    t = time.perf_counter()
    calls = make_calls(ctx.traffic, ctx.seed)
    voices = (make_voices(ctx.traffic, ctx.seed, sr)
              if ctx.traffic.get("voices") else None)
    ctx.setup["traffic"] = time.perf_counter() - t
    sync = torch.cuda.synchronize if prog["device"].type == "cuda" else (
        lambda: None)
    shapes = [shape_of(call, c, ctx.config["buckets"]) for call in calls]
    seen = {}
    for call, shape in zip(calls, shapes):
        seen.setdefault(shape, call)
    for shape, call in sorted(seen.items()):
        t = time.perf_counter()
        program_call(prog, call, voices)
        sync()
        ctx.setup[f"warmup {shape[0]}x{shape[1]}"] = time.perf_counter() - t
    if prog["device"].type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rng = run_rng(ctx.seed, 3)
    k = ctx.cell["check_calls"]
    kept, longest, records = [], None, []
    tracer = Tracer(ctx.trace)
    gc.collect()
    gc.freeze()             # set-up's objects out of the collector's scans
    with tracer:
        sync()
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        i = 0
        while True:
            call = calls[i % len(calls)]
            ts = time.perf_counter()
            out, te = program_call(prog, call, voices, tracer)
            t1 = time.perf_counter()
            audio = float(out["mel_lens"].sum()) * hop / sr
            records.append({"t0": ts, "t1": t1, "embed_s": te,
                            "audio_s": audio, "B": len(call.tokens),
                            "t_txt": shapes[i % len(calls)][0],
                            "t_mel": out["mel"].shape[1]})
            item = (i, call, out)
            if len(kept) < k:
                kept.append(item)
            else:
                j = int(rng.integers(0, i + 1))
                if j < k:
                    kept[j] = item
            if longest is None or audio > longest[2]:
                longest = (i, call, audio, out)
            i += 1
            if t1 - t0 >= ctx.seconds:
                break
        sync()
    gc.unfreeze()
    window = (t0, records[-1]["t1"])
    trace = tracer.result(window[1] - window[0]) if ctx.trace else None
    if trace is not None:
        trace.steps = len(records)
    samples = {i: (call, out) for i, call, out in kept}
    samples[longest[0]] = (longest[1], longest[3])
    flop = flops_of(records, c, ctx.config)
    return Run(records, window, setup_s, ctx.cell["chips"], trace,
               extra={"samples": samples, "voices": voices,
                      "program": prog, "flop": flop,
                      "mrf_bound_s": sum(
                          flops.mrf_bound_s(vocoder_cfg(ctx.config), r["B"],
                                            r["t_mel"]) for r in records),
                      "notes": latency_notes(records)})


def flops_of(records, c, config) -> float:
    v = vocoder_cfg(config)
    total = 0
    for r in records:
        B, L = r["B"], r["t_mel"]
        total += (flops.condition_flop(c, B, r["t_txt"], L)
                  + flops.denoiser_flop(c, B, L) + flops.vocoder_flop(v, B, L))
        if c.speaker_embedder == "DeepSpeaker":
            total += flops.rescnn_flop(B)
    return float(total)


def latency_notes(records) -> list:
    lat = np.array([(r["t1"] - r["t0"]) * 1e3 for r in records])
    return [f"request latency ms: median {np.median(lat):.4f} "
            f"p95 {np.percentile(lat, 95):.4f} max {lat.max():.4f} "
            f"over {len(lat)} requests"]


def check(ctx, run: Run):
    """Free the program, then hold the sampled calls' outputs against the
    reference's: (correct, [(name, value, limit)])."""
    import torch

    run.extra.pop("program", None)
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    c = read_config(ctx.config)
    ref = build_reference(ctx.config, ctx.seed, ctx.device)
    per_call = [gaps(ref, out, call, run.extra["voices"], c.sampling_rate,
                     c.hop)
                for call, out in run.extra["samples"].values()]
    return compare.judge(per_call, ctx.cell["limits"])


# -- calibration (perfbench/calibrate.py) -----------------------------------

def readings(cell, config, traffic, seed: int, device: str, control: bool,
             witness: bool):
    """[(side, numbers)]: the program's compared numbers over as many calls
    as a run compares (``check_calls`` drawn from the seed and the call
    with the most phonemes), the bf16 witness's and the control's."""
    import torch

    c = read_config(config)
    calls = make_calls(traffic, seed)
    rng = run_rng(seed, 4)
    idx = set(rng.choice(len(calls), cell["check_calls"],
                         replace=False).tolist())
    idx.add(max(range(len(calls)),
                key=lambda i: sum(len(t) for t in calls[i].tokens)))
    calls = [calls[i] for i in sorted(idx)]
    voices = (make_voices(traffic, seed, c.sampling_rate)
              if traffic.get("voices") else None)
    prog = build_program(config, seed, device, {})
    outs = [program_call(prog, call, voices)[0] for call in calls]
    del prog
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = build_reference(config, seed, device)

    def numbers(cands):
        return compare.worst([gaps(ref, o, call, voices, c.sampling_rate,
                                   c.hop) for o, call in zip(cands, calls)])

    out = [("program", numbers(outs))]
    sides = (["bf16_reference"] if witness else []) + (
        ["control"] if control else [])
    for side in sides:
        other = build_reference(config, seed, device,
                                "bf16" if side == "bf16_reference"
                                else "control")
        out.append((side, numbers([reference_call(other, call, voices,
                                                  c.sampling_rate)
                                   for call in calls])))
    return out
