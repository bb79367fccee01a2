"""The benchmark's general part: it finds a cell, its configuration, its
traffic mix, its runner and the metric readers by name under
``perfbench/``, checks for the cards, runs the runner, reduces what it
recorded to metrics, runs the comparison that decides ``correct``, and
prints the result line.

Layout (each piece found by the name ``BENCHMARK.json`` gives it):

- ``workloads/<cell>.json``: ``config``, ``traffic``, ``chips``, ``runner``,
  ``why``, the end-to-end and per-layer metrics the cell reports, and the
  limits of its comparison;
- ``configs/<config>.json``: the model as it is run, its source, what was
  reduced and assumed, its precision;
- ``traffic/<mix>.json``: the parameters that :mod:`perfbench.traffic`
  reads;
- ``runners/<runner>.py``: ``run(ctx)`` drives the program through set-up
  and the window, ``check(ctx, run)`` compares with the plain reference;
- ``metrics/<metric>.py``: ``UNIT``, ``BETTER``, ``SOURCE``, ``LAYER``,
  ``MOVES`` and ``read(run)``, which returns a number or None.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "cmtts_tpu")


@dataclass
class Context:
    """What a runner gets: the parsed arguments, the cell, its
    configuration and traffic (as read from their files), the device and
    the checkout root (where the program lives and builds)."""

    name: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    traffic: dict
    device: str
    root: str
    t_start: float
    setup: dict = field(default_factory=dict)
    bench_dir: str = BENCH_DIR


@dataclass
class Run:
    """What a runner recorded.  ``calls``: one dict a timed call (host
    clock ``t0``/``t1`` in seconds, and the runner's own fields);
    ``window``: (start, end) on the same clock; ``trace``: a
    :class:`perfbench.trace.Trace` in a traced run; ``extra``: what the
    readers and the check use (``flop`` and ``mrf_bound_s`` of the
    window's work from shapes, the samples kept, the program, notes)."""

    calls: list
    window: tuple
    setup_s: float
    chips: int = 1
    trace: object = None
    failed: int = 0
    extra: dict = field(default_factory=dict)
    cell: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file under ``perfbench/`` (metric files carry dots
    in their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(name: str, bench_dir: str = BENCH_DIR):
    """(cell, config, traffic) dicts of the cell ``name``."""
    cell = read_json(os.path.join(bench_dir, "workloads", f"{name}.json"))
    config = read_json(os.path.join(bench_dir, "configs",
                                    f"{cell['config']}.json"))
    traffic = read_json(os.path.join(bench_dir, "traffic",
                                     f"{cell['traffic']}.json"))
    return cell, config, traffic


def metric_readers(bench_dir: str = BENCH_DIR) -> dict:
    """Every reader of ``metrics/``, by metric name."""
    out = {}
    mdir = os.path.join(bench_dir, "metrics")
    for fn in sorted(os.listdir(mdir)):
        if fn.endswith(".py") and not fn.startswith("_"):
            name = fn[:-3]
            out[name] = load_module(os.path.join(mdir, fn),
                                    "perfbench_metric_" + name.replace(".", "_"))
    return out


def load_runner(cell: dict, bench_dir: str = BENCH_DIR):
    return load_module(os.path.join(bench_dir, "runners",
                                    f"{cell['runner']}.py"),
                       "perfbench_runner_" + cell["runner"])


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's or the
    JAX package's, compared as whole names."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def metrics_of(run: Run, cell: dict, readers: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` off; each must read) or
    every per-layer metric whose ``MOVES`` the cell reports and whose
    reader finds something (``trace`` on)."""
    out = {}
    e2e = cell["end_to_end"]
    names = (e2e if not trace else
             [n for n, r in readers.items() if r.MOVES in e2e])
    for n in names:
        value = readers[n].read(run)
        if value is None:
            if not trace:
                raise RuntimeError(f"metric {n} found nothing to read")
            continue            # a per-layer reader with nothing to read
        out[n] = {"value": float(value), "unit": readers[n].UNIT}
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths;
    the host's thread pools (OpenMP, BLAS, torch's intra-op pool) one
    thread each, so that the process is one steady load of few threads
    (the embedder's numpy fbank spun a pool on every core)."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def device_info(torch, run: "Run", device: str) -> dict:
    """The device block, its peak read before the check runs."""
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": run.chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def main(argv, t_start: float, bench_dir: str = BENCH_DIR,
         device: str | None = None) -> int:
    """Run one cell once; returns the exit code.  ``device`` None looks for
    the cell's cards and fails without them; tests pass ``"cpu"``."""
    args = parse_args(argv)
    root = os.path.dirname(bench_dir)
    cache_dirs(root)
    cell, config, traffic = find_cell(args.workload, bench_dir)
    import torch

    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"perfbench: {cell['chips']} CUDA device(s) needed, "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                  " found", file=sys.stderr)
            return 3
        device = "cuda"
    if root not in sys.path:
        sys.path.insert(0, root)
    ctx = Context(args.workload, args.seed, args.seconds, bool(args.trace),
                  cell, config, traffic, device, root, t_start,
                  bench_dir=bench_dir)
    runner = load_runner(cell, bench_dir)
    readers = metric_readers(bench_dir)
    run = runner.run(ctx)
    return _finish(ctx, run, runner, readers, torch)


def _finish(ctx, run, runner, readers, torch) -> int:
    cell, device = ctx.cell, ctx.device
    run.cell = cell
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    metrics = metrics_of(run, cell, readers, ctx.trace)
    dev = device_info(torch, run, device)
    if ctx.trace:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    print("perfbench: setup split (s): " + json.dumps(
        {k: round(v, 4) for k, v in ctx.setup.items()}), file=sys.stderr)
    for line in run.extra.get("notes", []):
        print("perfbench: " + line, file=sys.stderr)
    correct, numbers = runner.check(ctx, run)
    correct = correct and run.failed == 0
    result = {"correct": bool(correct), "attempted": len(run.calls) + run.failed,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if ctx.trace:
        result["breakdown"] = run.trace.breakdown()
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in numbers}
    for n, v, lim in numbers:
        print(f"perfbench: compared {n} = {v!r} limit {lim!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
