#!/usr/bin/env python3
"""Time the ImageNet-64 image UNet's B=16 forward on one GPU under four
cuDNN settings, in turns (A B C D D C B A), to see what its float32
convolutions cost and what a setting would change:

  A  float32, TF32 off, ``cudnn.benchmark`` off (what ``chip_smoke.py``
     phase 11 and ``cli.image_sample`` run);
  B  as A with ``cudnn.benchmark`` on (cuDNN times its algorithms once per
     shape and keeps the fastest);
  C  as B with the model and input in ``channels_last`` (NHWC) memory;
  D  as A with TF32 on for convolutions and matmuls (not float32).

    python3 tests/torch_port_unet_conv_ab.py

Each setting's output is held against A's (float32 settings to 1e-3,
TF32 to 5e-2).  Prints one JSON line with the medians (CUDA events,
10 forwards after 2 warm-ups per turn) beside the card's name and power
limit.  Needs CUDA; measures nothing on the CPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_port_unet_conv_ab: CUDA is not available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from cmtts_tpu_torch.models.unet import create_image_unet, init_like_flax
    from torch_port_helpers import redraw_zero_layers

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    # the zero-init layers redrawn, so that the outputs compared are not 0
    unet = redraw_zero_layers(init_like_flax(
        create_image_unet(**chip_smoke.IMAGENET64),
        torch.Generator().manual_seed(0)), 1).to(dev).eval()
    B, S = 16, 64
    g = torch.Generator(dev).manual_seed(1)
    x = torch.randn(B, 3, S, S, device=dev, generator=g)
    t = torch.full((B,), 100.0, device=dev)
    y = torch.arange(B, device=dev) * 61 % 1000
    settings = {"A_f32": dict(), "B_f32_benchmark": dict(benchmark=True),
                "C_f32_benchmark_channels_last": dict(benchmark=True,
                                                      channels_last=True),
                "D_tf32": dict(tf32=True)}

    def run(benchmark=False, channels_last=False, tf32=False):
        torch.backends.cudnn.benchmark = benchmark
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        unet.to(memory_format=fmt)
        xin = x.contiguous(memory_format=fmt)
        ms = []
        with torch.no_grad():
            for i in range(12):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = unet(xin, t, y)
                end.record()
                torch.cuda.synchronize()
                if i >= 2:
                    ms.append(start.elapsed_time(end))
        return ms, out.float().contiguous()

    order = list(settings) + list(settings)[::-1]
    times = {k: [] for k in settings}
    ref = None
    errs = {}
    for name in order:
        ms, out = run(**settings[name])
        times[name] += ms
        if ref is None:
            ref = out
        errs[name] = max(errs.get(name, 0.0), float((out - ref).abs().max()))
    for name, err in errs.items():
        tol = 5e-2 if "tf32" in name else 1e-3
        if err > tol:
            raise AssertionError(f"{name}: max |out - A| {err} > {tol}")
    flop = chip_smoke.unet_flop(unet.cfg, B)
    res = {name: {"median_ms": statistics.median(v),
                  "tflops": flop / statistics.median(v) / 1e9,
                  "max_abs_err_vs_A": errs[name], "forwards": len(v)}
           for name, v in times.items()}
    print(smi)
    print(json.dumps({"unet_forward_B16": res, "flop": flop, "card": smi,
                      "order": order}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
