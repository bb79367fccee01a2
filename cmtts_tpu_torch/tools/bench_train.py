"""Training-throughput microbench: steps/sec at batch 32x768 (full-size
LJSpeech model, bf16 compute), one step a call vs K steps a call.  Port of
``tools/bench_train.py``.

    python -m cmtts_tpu_torch.tools.bench_train [--K 8] [--iters 32] [--batch 32] [--device cuda]

Prints one JSON line per configuration, with the JAX tool's keys.  A call
of K steps is what ``cli.train_cm --steps_per_call K`` runs: K eager steps
on one set of sampler probabilities (the JAX tool scans them in one
dispatch).  On the card each call is timed with CUDA events and a
synchronize; the rate is from the median call after two warm-up calls.
``flops_per_step`` is the analytic count of the denoiser's work
(``models/denoiser.py::denoiser_flop``, 4x a forward: the student and the
target forward, the backward), not XLA's cost model, so it leaves out the
conditioning net.  XLA's scan unroll (``--unroll``) is not ported; the
``unroll`` key stays 1.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

# dense bf16 peaks by card name (NVIDIA data sheets); unknown cards give
# None, so no MFU is reported rather than a wrong one
PEAK_FLOPS = (("h100", 989e12),)


def device_peak_flops(device) -> float | None:
    """Peak matmul FLOP/s of ``device`` for the MFU denominator
    (``CMTTS_PEAK_FLOPS`` overrides); None when unknown."""
    env = os.environ.get("CMTTS_PEAK_FLOPS")
    if env:
        return float(env)
    import torch

    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for key, peak in PEAK_FLOPS:
        if key in name:
            return peak
    return None


def bench_batch(B: int, T_txt: int, T_mel: int, n_mels: int) -> dict:
    """The JAX tool's synthetic batch (numpy, seed 0)."""
    rng = np.random.RandomState(0)
    d = np.full((B, T_txt), T_mel // T_txt, np.int32)
    d[:, -1] += T_mel - int(d.sum(1)[0])
    mel2ph = np.zeros((B, T_mel), np.int32)
    pos = 0
    for i in range(T_txt):
        mel2ph[:, pos: pos + d[0, i]] = i + 1
        pos += d[0, i]
    return {
        "speakers": np.zeros(B, np.int32),
        "texts": rng.randint(13, 140, (B, T_txt)).astype(np.int32),
        "src_lens": np.full(B, T_txt, np.int32),
        "mels": rng.randn(B, T_mel, n_mels).astype(np.float32) * 0.5,
        "mel_lens": np.full(B, T_mel, np.int32),
        "mel2ph": mel2ph,
        "d_targets": d,
        "e_targets": rng.rand(B, T_txt).astype(np.float32),
        "p_targets": {
            "pitch": rng.randint(1, 255, (B, T_mel)).astype(np.int32),
            "f0": rng.rand(B, T_mel).astype(np.float32) * 2,
            "uv": (rng.rand(B, T_mel) > 0.7).astype(np.float32),
            "cwt_spec": rng.randn(B, T_mel, 10).astype(np.float32),
            "f0_mean": (5 + rng.rand(B)).astype(np.float32),
            "f0_std": (0.5 + rng.rand(B)).astype(np.float32),
        },
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--iters", type=int, default=32,
                    help="total optimizer steps per timed config")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--t_mel", type=int, default=768)
    ap.add_argument("--t_txt", type=int, default=96)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--skip_k1", action="store_true",
                    help="measure only the K-step config")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from cmtts_tpu_torch.models.denoiser import denoiser_flop
    from cmtts_tpu_torch.train.loop import batch_to_device, make_train_step
    from cmtts_tpu_torch.train.state import create_train_state, make_optimizer

    device = cli_device(args.device)
    cfg = load_configs("LJSpeech")
    B, T_txt, T_mel = args.batch, args.t_txt, args.t_mel
    batch = batch_to_device(bench_batch(B, T_txt, T_mel,
                                        cfg.stft.n_mel_channels), device)
    model = init_like_flax(CMTTS(cfg), torch.Generator().manual_seed(0)
                           ).to(device)
    params0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = make_optimizer(1e-4)
    compute_dtype = None if args.f32 else torch.bfloat16
    # CM index grid: indices live in [0, num_scales-1) (reference
    # karras_diffusion.py:213) -- probs has num_scales-1 entries
    probs = np.full((2,), 1 / 2, np.float32)
    step = make_train_step(model, cfg, opt, num_scales=3,
                           compute_dtype=compute_dtype)
    flops_step = 4 * denoiser_flop(cfg, B, T_mel)
    peak = device_peak_flops(device)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}",
          file=sys.stderr, flush=True)

    def timed(fn):
        """(ms, result) of ``fn()``: CUDA events on the card, the host
        clock on the CPU."""
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end), out
        t0 = time.perf_counter()
        out = fn()
        return 1e3 * (time.perf_counter() - t0), out

    results = {}
    for K in ((args.K,) if args.skip_k1 else (1, args.K)):
        state = create_train_state(params0, opt, n_ema=3)
        gen = torch.Generator(device=device).manual_seed(1)

        def call():
            nonlocal state
            for _ in range(K):
                state, m = step(state, batch, probs, 0.95, gen)
            return m

        n_calls = max(args.iters // K, 2)
        for _ in range(2):               # warm-ups
            timed(call)
        ms = []
        for _ in range(n_calls):
            t, m = timed(call)
            ms.append(t)
        loss = float(m["loss"])
        sps = K * 1e3 / statistics.median(ms)
        results[f"K{K}"] = dict(steps_per_sec=round(sps, 2),
                                ms_per_step=round(1000 / sps, 1),
                                loss=round(loss, 3))
        results[f"K{K}"]["flops_per_step"] = flops_step
        if peak:
            results[f"K{K}"]["mfu_pct"] = round(
                100.0 * flops_step * sps / peak, 2)
        print(json.dumps({"config": f"K={K}", "batch": B, "t_mel": T_mel,
                          "dtype": "f32" if args.f32 else "bf16",
                          "unroll": 1, **results[f"K{K}"]}), flush=True)
    if args.K > 1 and not args.skip_k1:
        results["speedup_scan"] = round(
            results[f"K{args.K}"]["steps_per_sec"] /
            results["K1"]["steps_per_sec"], 2)
        print(json.dumps({"speedup_scan": results["speedup_scan"]}))
    return results


if __name__ == "__main__":
    main()
