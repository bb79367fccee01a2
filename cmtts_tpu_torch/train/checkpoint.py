"""Checkpoints of the train state (port of ``cmtts_tpu/train/checkpoint.py``,
with ``torch.save`` in place of Orbax).

One directory ``<ckpt_path>/CMDenoiserTTS/step_{step:08d}/`` holds one file
a role: ``model``, ``target_model``, ``ema_0`` .. ``ema_{n-1}``, ``opt``,
``sampler`` (the LSM history, when the sampler has one) and ``step``.  Each
file is written under a temporary name and moved into place with
``os.replace``; the marker file ``COMMITTED``, written last, makes the step
complete.  ``run_config.json`` beside the step directories records the
flags that change the graph.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from cmtts_tpu_torch.train.state import CMTrainState

MARKER = "COMMITTED"
# flags whose change between a run and its resume would change the graph
# or the meaning of the saved state
GRAPH_KEYS = ("training_mode", "cwt_masked_std", "schedule_sampler")


def ckpt_dir(base: str) -> str:
    return os.path.join(os.path.abspath(base), "CMDenoiserTTS")


def step_dir(base: str, step: int) -> str:
    return os.path.join(ckpt_dir(base), f"step_{step:08d}")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    return tree


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(base_path: str, state: CMTrainState,
                    sampler_state: dict | None = None) -> str:
    """Write ``state`` (and the sampler's state) as one complete step
    directory; an existing directory of the same step is replaced."""
    path = step_dir(base_path, state.step)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    roles = {"model": state.params, "target_model": state.target_params,
             "opt": state.opt_state, "step": state.step}
    for i, ema in enumerate(state.ema_params):
        roles[f"ema_{i}"] = ema
    if sampler_state:
        roles["sampler"] = sampler_state
    for role, tree in roles.items():
        _save(_to_cpu(tree), os.path.join(path, f"{role}.pt"))
    _save(state.step, os.path.join(path, MARKER))
    return path


def list_checkpoint_steps(base_path: str) -> list[int]:
    d = ckpt_dir(base_path)
    if not os.path.isdir(d):
        return []
    return sorted(int(m.group(1)) for m in (re.fullmatch(r"step_(\d+)", n)
                                            for n in os.listdir(d)) if m)


def is_complete(base_path: str, step: int) -> bool:
    return os.path.exists(os.path.join(step_dir(base_path, step), MARKER))


def latest_complete_step(base_path: str) -> int:
    """The highest step whose directory carries the commit marker; 0 when
    there is no step directory at all.  Raises when step directories exist
    but none is complete: a fresh start would then overwrite a run whose
    saves were all cut short."""
    steps = list_checkpoint_steps(base_path)
    done = [s for s in steps if is_complete(base_path, s)]
    if steps and not done:
        raise RuntimeError(
            f"{ckpt_dir(base_path)} holds step directories {steps} but none "
            f"carries the {MARKER} marker; not starting afresh over them")
    return max(done, default=0)


def restore_checkpoint(base_path: str, step: int | None = None,
                       map_location="cpu") -> dict:
    """{role: saved tree} of a complete step directory (the latest complete
    one if ``step`` is None)."""
    steps = list_checkpoint_steps(base_path)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir(base_path)}")
    if step is None:
        step = latest_complete_step(base_path)
    elif step not in steps:
        raise FileNotFoundError(f"step {step} not in {steps}")
    return load_step_dir(step_dir(base_path, step), map_location)


def load_step_dir(path: str, map_location="cpu") -> dict:
    """{role: saved tree} of one explicit, complete step directory (a
    teacher's, for instance)."""
    if not os.path.exists(os.path.join(path, MARKER)):
        raise FileNotFoundError(f"{path} is not a complete checkpoint (no "
                                f"{MARKER} marker)")
    return {name[:-3]: torch.load(os.path.join(path, name),
                                  map_location=map_location,
                                  weights_only=True)
            for name in sorted(os.listdir(path)) if name.endswith(".pt")}


def state_from_payload(payload: dict, n_ema: int,
                       device="cpu") -> CMTrainState:
    def dev(tree):
        return {k: v.to(device) for k, v in tree.items()}

    opt = payload["opt"]
    return CMTrainState(
        step=int(payload["step"]), params=dev(payload["model"]),
        opt_state={"count": int(opt["count"]), "mu": dev(opt["mu"]),
                   "nu": dev(opt["nu"])},
        ema_params=tuple(dev(payload[f"ema_{i}"]) for i in range(n_ema)),
        target_params=dev(payload["target_model"]))


def sampler_state_from_payload(payload: dict) -> dict | None:
    if "sampler" not in payload:
        return None
    return {k: v.numpy() for k, v in payload["sampler"].items()}


def write_run_config(base_path: str, run_config: dict) -> str:
    """Record the run's graph-affecting flags next to the step directories
    (synthesis adopts them).  Call :func:`check_run_config` first."""
    d = ckpt_dir(base_path)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "run_config.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(run_config, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def read_run_config(base_path: str) -> dict:
    """The recorded run flags ({} when there is no sidecar)."""
    path = os.path.join(ckpt_dir(base_path), "run_config.json")
    if os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    return {}


def check_run_config(base_path: str, run_config: dict) -> None:
    """Raise when the recorded run differs from ``run_config`` in a
    graph-affecting flag: resuming it would mix two graphs in one run."""
    old = read_run_config(base_path)
    diff = {k: (old[k], run_config.get(k)) for k in GRAPH_KEYS
            if k in old and old[k] != run_config.get(k)}
    if diff:
        raise ValueError(
            f"{ckpt_dir(base_path)} was trained with other flags "
            f"(recorded, now): {diff}; use another --path_tag or the same "
            "flags")
