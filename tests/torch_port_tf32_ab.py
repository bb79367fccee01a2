"""The price of float32 on one CUDA card: the training CLIs' float32 steps
with TF32 on (PyTorch's default for cuDNN convolutions, what the CLIs ran
before ``core/device.py::cli_device`` turned it off) against TF32 off (what
every CLI runs now), timed in one process with CUDA events.

    python3 tests/torch_port_tf32_ab.py [--steps 8] [--work build/tf32_ab]

The steps are the ones ``cli.train_cm`` and ``cli.train_hifigan`` run, at
full width: the f32 CT step (LJSpeech ``train.yaml``, B=32, on a seeded
feature corpus of 128 + 8 utterances; the same bucketed batches in every
block) and the f32 GAN step (HiFi-GAN V1 with the paper's MPD/MSD, B=16 x
8192 crops of a 16-utterance formant corpus).  Each is timed in four
blocks, A B B A (A = TF32 on, B = off), each block two warm-up steps and
``--steps`` timed ones; drift of the card or its host shows up as the two
A blocks (or the two B blocks) differing.  Prints the card's name and
power limit, one JSON line a block, and a table of each block's median,
min and max ms.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def set_tf32(on: bool) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def ct_step_fn(work: str, n: int):
    """-> (fn(batch), batches): one f32 CT step a call, as cli.train_cm."""
    import numpy as np
    import torch

    import chip_smoke
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.data.dataset import FeatureDataset, batch_iterator
    from cmtts_tpu_torch.data.feature_corpus import write_feature_corpus
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from cmtts_tpu_torch.train.loop import batch_to_device, make_train_step
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    dev = torch.device("cuda")
    write_feature_corpus(os.path.join(work, "pre"), 128, 8, seed=0)
    cfg = load_configs("LJSpeech", chip_smoke.write_training_config(work))
    dataset = FeatureDataset("train.txt", cfg)
    model = init_like_flax(CMTTS(cfg), torch.Generator().manual_seed(0)).to(
        dev)
    feed = batch_iterator(dataset, 32, 4, seed=0)
    batches = [batch_to_device(next(feed), dev) for _ in range(n)]
    opt = RAdam(cfg.train.cm.lr)
    hold = {"state": create_train_state(
        {k: v.detach() for k, v in model.named_parameters()}, opt, 3)}
    step = make_train_step(model, cfg, opt, 3)
    probs = np.full(2, 0.5, np.float32)
    gen = torch.Generator(device=dev).manual_seed(0)

    def fn(batch):
        hold["state"], hold["m"] = step(hold["state"], batch, probs, 0.95,
                                        gen)

    return fn, batches, hold


def gan_step_fn(work: str, n: int):
    """-> (fn(wavs), batches): one f32 GAN step a call, as
    cli.train_hifigan."""
    import numpy as np
    import torch

    from cmtts_tpu_torch.audio.stft import MelSpectrogram
    from cmtts_tpu_torch.cli.gen_corpus import main as gen_corpus
    from cmtts_tpu_torch.cli.train_hifigan import disc_config
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig
    from cmtts_tpu_torch.train.hifigan_trainer import (
        HiFiGANTrainConfig,
        WaveSegmentSampler,
        init_hifigan_train,
        make_hifigan_train_step,
    )

    dev = torch.device("cuda")
    with redirect_stdout(sys.stderr):
        gen_corpus(["--out", os.path.join(work, "wavs"), "--n", "16",
                    "--val_size", "2", "--batch_size", "2"])
    cfg = HiFiGANTrainConfig(segment_size=8192, batch_size=16)
    state, gen, disc = init_hifigan_train(cfg, HiFiGANConfig(),
                                          disc_config(1), dev)
    step = make_hifigan_train_step(gen, disc, MelSpectrogram(device=dev), cfg)
    sampler = WaveSegmentSampler(os.path.join(work, "wavs", "raw"), 8192)
    rng = np.random.RandomState(1)
    batches = [torch.from_numpy(sampler.sample(rng, 16)).to(dev)
               for _ in range(n)]
    hold = {"state": state}

    def fn(wavs):
        hold["state"], hold["m"] = step(hold["state"], wavs)

    return fn, batches, hold


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8,
                    help="timed steps a block, after two warm-ups")
    ap.add_argument("--work", default=os.path.join(ROOT, "build", "tf32_ab"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    n = 2 + args.steps
    rows = []
    for name, build in (("ct_f32", ct_step_fn), ("gan_f32", gan_step_fn)):
        fn, batches, hold = build(args.work, n)
        for label in "ABBA":
            set_tf32(label == "A")
            t = chip_smoke.timed_steps(fn, batches, warm=2)
            losses = {k: float(v) for k, v in hold["m"].items()
                      if torch.is_tensor(v) and v.numel() == 1}
            row = {"step": name, "block": label,
                   "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
                   "median_ms": t["median_ms"], "min_ms": min(t["ms"]),
                   "max_ms": max(t["ms"]), "ms": t["ms"],
                   "peak_mem_gib": t["peak_mem_gib"], "losses": losses}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del fn, batches, hold
        torch.cuda.empty_cache()
    set_tf32(False)
    print(f"{'step':8s} {'block':5s} {'TF32':5s} {'median ms':>10s} "
          f"{'min ms':>8s} {'max ms':>8s}")
    for r in rows:
        print(f"{r['step']:8s} {r['block']:5s} {str(r['cudnn.allow_tf32']):5s} "
              f"{r['median_ms']:10.2f} {r['min_ms']:8.2f} {r['max_ms']:8.2f}")
    shutil.rmtree(args.work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
