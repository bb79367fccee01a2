"""Convert reference PyTorch checkpoints into the port's formats, so that a
user of the reference CM-TTS synthesizes, serves and distils from their
trained models (counterpart of ``cli/convert_checkpoint.py``, which writes
Orbax for the JAX package).

    python -m cmtts_tpu_torch.cli.convert_checkpoint --dataset LJSpeech \\
        --model_pt .../model300000.pt \\
        [--target_pt .../target_model300000.pt] \\
        [--ema_pt .../ema_0.9999_300000.pt ...] [--step 300000] [--out DIR]

    # HiFi-GAN vocoder (weight norm folded) -> flat a/b/c npz of flax params
    python -m cmtts_tpu_torch.cli.convert_checkpoint --dataset LJSpeech \\
        --hifigan_pt .../generator_LJSpeech.pth.tar --hifigan_out gen.npz

The CM files become one committed step directory of the port's trainer
(``train/checkpoint.py::save_checkpoint``) under ``--out`` (default the
config's ``ckpt_path``): ``model``, ``target_model`` (the model when no
``--target_pt``), one ``ema_k`` per ``ema_rate`` (the model where no
``--ema_pt`` is given) and a fresh RAdam state, so that
``cli.synthesize --restore_step N`` reads it and ``cli.train_cm
--restore_step N`` resumes from it (with fresh optimizer moments).  The
step is parsed from the file name when ``--step`` is not given.  Host
only: it needs no device.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np


def flat_params(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays as flat ``a/b/c`` keys (the npz layout)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flat_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def step_of(path: str) -> int:
    """The step in a reference file name (``model300000.pt`` -> 300000)."""
    m = re.search(r"(\d+)\.pt$", os.path.basename(path))
    return int(m.group(1)) if m else 0


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--config_root", type=str, default=None)
    parser.add_argument("--model_pt", type=str, default=None)
    parser.add_argument("--target_pt", type=str, default=None)
    parser.add_argument("--ema_pt", type=str, nargs="*", default=[])
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step (parsed from the file name "
                             "when omitted)")
    parser.add_argument("--out", type=str, default=None,
                        help="checkpoint root (default: the config's "
                             "ckpt_path)")
    parser.add_argument("--hifigan_pt", type=str, default=None)
    parser.add_argument("--hifigan_out", type=str, default=None)
    args = parser.parse_args(argv)

    from cmtts_tpu_torch.core.config import load_configs

    cfg = load_configs(args.dataset, args.config_root)
    written = {}
    if args.hifigan_pt:
        from cmtts_tpu_torch.models.hifigan import load_hifigan_params

        out = args.hifigan_out or (args.hifigan_pt + ".npz")
        np.savez(out, **flat_params(load_hifigan_params(args.hifigan_pt)))
        print(f"==> HiFi-GAN params -> {out}")
        written["hifigan"] = out

    if args.model_pt:
        from cmtts_tpu_torch.from_torch import load_torch_cm
        from cmtts_tpu_torch.train.checkpoint import save_checkpoint
        from cmtts_tpu_torch.train.state import (
            CMTrainState,
            clone_params,
            make_optimizer,
        )

        def params_of(path):
            return {k: v.detach()
                    for k, v in load_torch_cm(path, cfg).named_parameters()}

        step = args.step if args.step is not None else step_of(args.model_pt)
        model = params_of(args.model_pt)
        n_ema = len(cfg.train.cm.ema_rate)
        emas = [params_of(p) for p in args.ema_pt]
        emas += [clone_params(model) for _ in range(n_ema - len(emas))]
        cm = cfg.train.cm
        state = CMTrainState(
            step=step, params=model,
            # fresh optimizer moments: the reference's opt.pt is
            # torch-RAdam-specific
            opt_state=make_optimizer(cm.lr, cm.weight_decay).init(model),
            ema_params=tuple(emas),
            target_params=(params_of(args.target_pt) if args.target_pt
                           else clone_params(model)))
        path = save_checkpoint(args.out or cfg.train.ckpt_path, state)
        print(f"==> converted checkpoint -> {path}")
        print(f"    synthesize with: python -m cmtts_tpu_torch.cli.synthesize "
              f"--dataset {args.dataset} --restore_step {step} ...")
        written["model"] = path
    return written


if __name__ == "__main__":
    main()
