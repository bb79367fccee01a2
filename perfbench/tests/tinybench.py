"""A copy of ``perfbench/`` with each cell's configuration and traffic cut
to a size the CPU runs in seconds (``tiny_<cell>``), for the tests."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELLS = ("lj_synth_b8", "vctk_zs_b1", "lj_ct_b32")


def tiny_config(config: dict) -> dict:
    c = json.loads(json.dumps(config))
    c["model"]["transformer"].update(encoder_hidden=32, encoder_layer=2)
    c["model"]["denoiser"].update(residual_channels=16, residual_layers=2)
    c["model"]["variance_predictor"].update(filter_size=32,
                                            cwt_hidden_size=16)
    c["vocoder"]["upsample_initial_channel"] = 64
    return c


def make(tmp: str) -> str:
    """Copy ``perfbench/`` under ``tmp`` and add ``tiny_<cell>`` for each
    cell; returns the copy's directory."""
    dst = os.path.join(tmp, "perfbench")
    shutil.copytree(BENCH, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for cell in CELLS:
        with open(os.path.join(dst, "workloads", f"{cell}.json")) as f:
            w = json.load(f)
        with open(os.path.join(dst, "configs", f"{w['config']}.json")) as f:
            c = tiny_config(json.load(f))
        with open(os.path.join(dst, "traffic", f"{w['traffic']}.json")) as f:
            t = json.load(f)
        t["phonemes"] = {"mean": 12, "sd": 4, "min": 5, "max": 20}
        if "batch" in t:
            t.update(batch=min(t["batch"], 2), block=2, pool=4)
        if "voices" in t:
            t.update(voices=4, reference_seconds=1.0)
        if "utterances" in t:
            t.update(utterances=64, steps_per_call=2, warm_batches=16)
            c["train"]["optimizer"]["batch_size"] = 4
        w.update(config=f"tiny_{w['config']}_{cell}",
                 traffic=f"tiny_{w['traffic']}")
        if "check_calls" in w:
            w["check_calls"] = 2
        for sub, name, obj in (("configs", w["config"], c),
                               ("traffic", w["traffic"], t),
                               ("workloads", f"tiny_{cell}", w)):
            with open(os.path.join(dst, sub, f"{name}.json"), "w") as f:
                json.dump(obj, f)
    return dst


def run(bench_dir: str, cell: str, seed: int = 2 ** 31 + 77,
        trace: int = 0, seconds: float = 1.0, prelude: str = ""):
    """Run ``cell`` of the copy on the CPU in a process of its own, with
    the harness's look for a card skipped, after ``prelude`` (code that
    may plant a fault in the program): (exit code, last stdout line
    parsed or None, stderr)."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    code = (f"import sys, time\nsys.path.insert(0, {ROOT!r})\n{prelude}\n"
            "from perfbench.harness import main\n"
            f"sys.exit(main({argv!r}, time.perf_counter(), "
            f"bench_dir={bench_dir!r}, device='cpu'))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT, env=env)
    lines = res.stdout.strip().splitlines()
    return res.returncode, (json.loads(lines[-1]) if lines else None), \
        res.stderr
