"""Export a consistency-model checkpoint of the JAX package to the PyTorch
port.

    python port_tools/export_orbax.py --step_dir <ckpt>/CMDenoiserTTS/step_00020000 \\
        --out <port ckpt base> [--dataset LJSpeech] [--config_root config]

``--step_dir`` is an Orbax step directory written by
``cmtts_tpu/train/checkpoint.py::save_checkpoint`` (roles ``step``,
``model``, ``opt``, ``target_model``, ``ema_<i>`` and, with the
loss-second-moment sampler, ``sampler``).  Every param tree, and the
optimizer's first and second moments, go through the one param bridge
(``cmtts_tpu_torch/convert.py``, loaded with ``strict=True``); optax's
RAdam state, rebuilt with the JAX package's own ``state_from_payload``
against ``make_optimizer`` (``add_decayed_weights`` chained before
``radam`` under weight decay), becomes the port's ``{"count", "mu",
"nu"}``.  The sampler's state and the ``run_config.json`` beside the step
directories are copied.  The result is one committed step directory of the
port (``cmtts_tpu_torch/train/checkpoint.py::save_checkpoint``) under
``<out>/CMDenoiserTTS/``, which ``cli.train_cm --restore_step N`` and
``cli.synthesize --restore_step N`` read with ``--config_root`` pointing
at the same config.

The dataset defaults to the one ``run_config.json`` records.  This file
imports jax, orbax and ``cmtts_tpu``, so it runs where JAX is installed.
The JAX HiFi-GAN trainer's ``hifigan_train_state.npy`` (pickled optax
classes) is refused: its generator reaches the port through
``cli.train_hifigan --init_gen_npz hifigan_gen_<step>.npz``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

HIFIGAN_STATE = "hifigan_train_state.npy"


def _refuse_hifigan_state(path: str) -> None:
    if os.path.basename(path) == HIFIGAN_STATE or os.path.exists(
            os.path.join(path, HIFIGAN_STATE)):
        raise SystemExit(
            f"{path}: the JAX HiFi-GAN trainer's {HIFIGAN_STATE} holds "
            "pickled optax classes and is not exported; warm-start the "
            "port's trainer from its generator with `python -m "
            "cmtts_tpu_torch.cli.train_hifigan --init_gen_npz "
            "hifigan_gen_<step>.npz`")


def read_jax_run_config(step_dir: str) -> dict:
    """The ``run_config.json`` the JAX trainer wrote beside the step
    directories ({} when there is none)."""
    path = os.path.join(os.path.dirname(os.path.abspath(step_dir)),
                        "run_config.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def export_step_dir(step_dir: str, out: str, cfg) -> str:
    """Export the JAX step directory ``step_dir`` as a port step directory
    under ``out`` for the port config ``cfg``; returns its path."""
    import jax
    import torch

    from cmtts_tpu.train.checkpoint import (
        restore_payload_from_dir,
        state_from_payload,
    )
    from cmtts_tpu.train.state import make_optimizer
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.cmtts import CMTTS
    from cmtts_tpu_torch.train.checkpoint import (
        check_run_config,
        save_checkpoint,
        write_run_config,
    )
    from cmtts_tpu_torch.train.state import CMTrainState

    cm = cfg.train.cm
    payload = restore_payload_from_dir(step_dir)
    n_ema = len(cm.ema_rate)
    missing = [f"ema_{i}" for i in range(n_ema) if f"ema_{i}" not in payload]
    if missing:
        raise SystemExit(f"{step_dir} lacks {missing}: the config has "
                         f"{n_ema} EMA rates")
    jstate = state_from_payload(payload, make_optimizer(cm.lr,
                                                        cm.weight_decay),
                                n_ema)
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")]
    if len(adam) != 1:
        raise SystemExit(f"{step_dir}: expected one RAdam state in the "
                         f"optimizer state, found {len(adam)}")
    adam = adam[0]
    model = CMTTS(cfg)

    def to_port(tree) -> dict:
        tree = jax.tree_util.tree_map(np.asarray, tree)
        load_flax_params(model, tree)          # strict=True
        return {k: v.detach().clone() for k, v in model.named_parameters()}

    state = CMTrainState(
        step=int(jstate.step), params=to_port(jstate.params),
        opt_state={"count": int(adam.count), "mu": to_port(adam.mu),
                   "nu": to_port(adam.nu)},
        ema_params=tuple(to_port(e) for e in jstate.ema_params),
        target_params=to_port(jstate.target_params))
    sampler = payload.get("sampler")
    if sampler is not None:
        sampler = {k: np.asarray(v) for k, v in sampler.items()}
    run_config = read_jax_run_config(step_dir)
    if run_config:
        check_run_config(out, run_config)
        write_run_config(out, run_config)
    with torch.no_grad():
        return save_checkpoint(out, state, sampler)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step_dir", required=True,
                    help="a JAX (Orbax) step directory step_XXXXXXXX")
    ap.add_argument("--out", required=True,
                    help="the port's checkpoint base (its ckpt_path)")
    ap.add_argument("--dataset", default=None,
                    help="config name (default: run_config.json's)")
    ap.add_argument("--config_root", default=None)
    args = ap.parse_args(argv)
    _refuse_hifigan_state(args.step_dir)
    if not os.path.isdir(args.step_dir):
        raise SystemExit(f"{args.step_dir} is not a step directory")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    from cmtts_tpu_torch.core.config import load_configs

    dataset = args.dataset or read_jax_run_config(args.step_dir).get(
        "dataset", "LJSpeech")
    path = export_step_dir(args.step_dir, args.out,
                           load_configs(dataset, args.config_root))
    print(f"==> exported {args.step_dir} -> {path}")
    return path


if __name__ == "__main__":
    main()
