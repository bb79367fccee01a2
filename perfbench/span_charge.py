"""Device time by the program's own spans, for the cells of this benchmark.

    python3 perfbench/span_charge.py [--cells lj_synth_b8,vctk_zs_b1,lj_ct_b32]
        [--calls 40] [--seed N] [--device cuda] [--out PATH]

Each cell is built and warmed as its runner does, then ``--calls`` calls
(a training cell: ``--calls`` steps, whole calls of K) run under one
``torch.profiler`` that records every thread.  The profile is reduced by
these rules, which a reader of the traced window would share:

- **Charge.** A device op is linked to the runtime call that launched it
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) by its own CUPTI
  ``correlation_id``.  It is charged to the path of spans (``bench.*`` and
  ``cmtts.*``, outermost first, prefixes dropped) that contain the launch's
  start on the launching thread.  Where that thread has no span there
  (autograd's device thread runs the backward), it is charged to the main
  thread's path at that instant and counted under ``via_main_thread`` too.
  The main thread is the one with the most ``bench.*`` spans.  Ops with no
  launch record are charged to ``unlinked``; the spans' own device-side
  annotations are no ops.  What no path covers is ``outside spans``.
- **Gaps.** An idle gap of the device (between the union of its ops) is
  labelled with the main thread's path at the gap's midpoint, else
  ``after <the main thread's span that ended last>``.  Other threads' spans
  (the data feed's ``feed.collate``) never label a gap.
- **Host.** Host ms by path over every thread's spans.

Prints one JSON document (also written to ``--out``): per call or step,
device ms and kernels by path, gap ms and count by label, host ms by path,
and the spans' cost off and under a profiler.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PREFIXES = ("bench.", "cmtts.")
OUTSIDE = "outside spans"
UNLINKED = "unlinked"


def events(prof):
    """(spans, launches, ops) of a finished ``torch.profiler.profile``:
    spans ``(name, tid, start_ns, end_ns)``, launches ``{correlation id:
    (tid, start_ns)}`` of the runtime's CPU calls, device ops ``(name,
    start_ns, dur_ns, correlation id)``."""
    spans, launches, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CPU"):
            if name.startswith(PREFIXES):
                spans.append((name, e.start_thread_id(), e.start_ns(),
                              e.start_ns() + e.duration_ns()))
            elif e.correlation_id() and name.startswith("cu"):
                launches[e.correlation_id()] = (e.start_thread_id(),
                                                e.start_ns())
        elif not e.is_user_annotation():
            ops.append((name, e.start_ns(), e.duration_ns(),
                        e.correlation_id()))
    return spans, launches, ops


def main_thread(spans):
    """The thread with the most ``bench.*`` spans, or None."""
    n = {}
    for name, tid, _, _ in spans:
        if name.startswith("bench."):
            n[tid] = n.get(tid, 0) + 1
    return max(n, key=n.get) if n else None


def short(name: str) -> str:
    return name.split(".", 1)[1]


def path_at(spans, tid, t) -> str:
    """The spans of ``tid`` that contain ``t``, outermost first, as
    ``a/b/c``; ``""`` where none does."""
    inside = sorted((s for s in spans if s[1] == tid and s[2] <= t <= s[3]),
                    key=lambda s: (s[2], -s[3]))
    return "/".join(short(s[0]) for s in inside)


class Paths:
    """``path_at`` for many instants: each thread's span boundaries cut
    its time into pieces of one path each, looked up by bisection."""

    def __init__(self, spans):
        self.spans, self.cuts, self.paths = spans, {}, {}
        for tid in {s[1] for s in spans}:
            mine = [s for s in spans if s[1] == tid]
            cuts = sorted({x for s in mine for x in s[2:]})
            self.cuts[tid] = cuts
            self.paths[tid] = [path_at(mine, tid, (a + b) / 2)
                               for a, b in zip(cuts, cuts[1:])]

    def __call__(self, tid, t) -> str:
        cuts = self.cuts.get(tid)
        if not cuts or not cuts[0] < t < cuts[-1]:
            return path_at(self.spans, tid, t) if cuts else ""
        i = bisect.bisect_left(cuts, t)
        if cuts[i] == t:
            return path_at(self.spans, tid, t)
        return self.paths[tid][i - 1]


def charge(spans, launches, ops):
    """Device ns and op counts by span path, and the ns of those charged
    through the main thread (see the module's rules)."""
    main, at = main_thread(spans), Paths(spans)
    ns, kernels, via = {}, {}, {}
    for _, _, dur, link in ops:
        launch = launches.get(link)
        if launch is None:
            key = UNLINKED
        else:
            tid, t = launch
            key = at(tid, t)
            if not key and tid != main and main is not None:
                key = at(main, t)
                if key:
                    via[key] = via.get(key, 0) + dur
            key = key or OUTSIDE
        ns[key] = ns.get(key, 0) + dur
        kernels[key] = kernels.get(key, 0) + 1
    return ns, kernels, via


def idle_gaps(spans, ops):
    """{label: [ns, count]} of the device's idle gaps (see the rules)."""
    main, at = main_thread(spans), Paths(spans)
    ended = sorted((s[3], short(s[0])) for s in spans if s[1] == main)
    iv = sorted((s, s + d) for _, s, d, _ in ops)
    out = {}
    if not iv:
        return out
    end = iv[0][1]
    for s, e in iv[1:]:
        if s > end:
            mid = (end + s) / 2
            label = at(main, mid)
            if not label:
                i = bisect.bisect_left(ended, (mid,))
                label = "after " + ended[i - 1][1] if i else OUTSIDE
            g = out.setdefault(label, [0, 0])
            g[0] += s - end
            g[1] += 1
        end = max(end, e)
    return out


def host_ns(spans):
    """Host ns by span path (the span's own, its ancestors first), every
    thread."""
    out = {}
    for name, tid, a, b in spans:
        key = "/".join(short(s[0]) for s in sorted(
            (s for s in spans if s[1] == tid and s[2] <= a and b <= s[3]),
            key=lambda s: (s[2], -s[3])))
        out[key] = out.get(key, 0) + b - a
    return out


def in_program(path: str) -> bool:
    """Whether a path holds one of the program's spans: theirs are named
    ``<layer>.<part>``, the benchmark's are one word."""
    return any("." in p for p in path.split("/"))


def reduce(spans, launches, ops, n: int) -> dict:
    """Everything above, per call or step (``n`` of them)."""
    def per(d):
        return {k: v / n for k, v in sorted(d.items(), key=lambda kv: -kv[1])}

    def ms(d):
        return {k: v / 1e6 for k, v in per(d).items()}

    ns, kernels, via = charge(spans, launches, ops)
    gaps = idle_gaps(spans, ops)
    total = sum(ns.values())
    return {
        "n": n,
        "device_ms": total / 1e6 / n,
        "under_program_spans_pct": (
            100.0 * sum(v for k, v in ns.items() if in_program(k)) / total
            if total else None),
        "device_ms_by_span": ms(ns),
        "kernels_by_span": per(kernels),
        "via_main_thread_ms": ms(via),
        "gap_ms_by_span": ms({k: v[0] for k, v in gaps.items()}),
        "gaps_by_span": per({k: v[1] for k, v in gaps.items()}),
        "host_ms_by_span": ms(host_ns(spans)),
    }


def profiler():
    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, experimental_config=_ExperimentalConfig(
        profile_all_threads=True))


def synth_cell(name, seed, device, n, bench_dir):
    import torch
    from torch.profiler import record_function

    from perfbench.harness import find_cell
    from perfbench.reference.config import read_config
    from perfbench.runners import synth as S
    from perfbench.traffic import make_calls, make_voices

    _, config, traffic = find_cell(name, bench_dir)
    c = read_config(config)
    prog = S.build_program(config, seed, device, {})
    calls = make_calls(traffic, seed)
    voices = (make_voices(traffic, seed, c.sampling_rate)
              if traffic.get("voices") else None)
    seen = {}
    for call in calls:
        seen.setdefault(S.shape_of(call, c, config["buckets"]), call)
    for call in seen.values():
        S.program_call(prog, call, voices)

    bench = types.SimpleNamespace(
        span=lambda s: record_function("bench." + s))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    with profiler() as prof:
        for i in range(n):
            S.program_call(prog, calls[i % len(calls)], voices, bench)
        sync()
    return reduce(*events(prof), n)


def train_cell(name, seed, device, n, bench_dir):
    import shutil

    import torch
    from torch.profiler import record_function

    from perfbench import corpus
    from perfbench.harness import find_cell
    from perfbench.runners import train as T

    _, config, traffic = find_cell(name, bench_dir)
    prog, kept = T.start("span_charge", config, traffic, seed, device, {})
    seen = set()
    for rows in corpus.batch_order(kept["meta"], prog.cfg.train.batch_size,
                                   prog.cfg.train.group_size,
                                   T.run_seeds(seed)["feed"],
                                   traffic["warm_batches"]):
        shape = T.shape_of(kept["meta"], rows, config)
        if shape not in seen:
            seen.add(shape)
            prog.throwaway_step(rows)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    K = traffic["steps_per_call"]
    calls = max(1, n // K)
    with profiler() as prof:
        for _ in range(calls):
            prog.call(K, lambda s: record_function("bench." + s))
        sync()
    out = reduce(*events(prof), calls * K)
    prog.free()
    shutil.rmtree(kept["corpus"], ignore_errors=True)
    return out


def overhead(device: str) -> dict:
    """ns a span and a count cost, off and under a profiler, and a span
    around a launch on the card."""
    import torch

    from cmtts_tpu_torch.core.trace import count, span

    def per(fn, n):
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter_ns()
            fn(n)
            best = min(best, (time.perf_counter_ns() - t) / n)
        return best

    def empty(n):
        for _ in range(n):
            pass

    def spans(n):
        for _ in range(n):
            with span("probe"):
                pass

    def counts(n):
        for _ in range(n):
            count("probe")

    out = {"off_span_ns": per(spans, 200_000) - per(empty, 200_000),
           "off_count_ns": per(counts, 200_000) - per(empty, 200_000)}
    with profiler():
        out["on_span_ns"] = per(spans, 20_000) - per(empty, 20_000)
        out["on_count_ns"] = per(counts, 20_000) - per(empty, 20_000)
        if device == "cuda":
            x = torch.ones(8, device="cuda")

            def launch(n):
                for _ in range(n):
                    x.add_(1)

            def span_launch(n):
                for _ in range(n):
                    with span("probe"):
                        x.add_(1)

            out["on_span_around_launch_ns"] = (per(span_launch, 5000)
                                               - per(launch, 5000))
            torch.cuda.synchronize()
    return out


def main(argv=None) -> dict:
    from perfbench.harness import BENCH_DIR, cache_dirs, find_cell

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cells", default="lj_synth_b8,vctk_zs_b1,lj_ct_b32")
    p.add_argument("--calls", type=int, default=40)
    p.add_argument("--seed", type=int, default=3141592653)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bench", default=BENCH_DIR)
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "span_charge.json"))
    a = p.parse_args(argv)
    cache_dirs(ROOT)
    res = {"overhead": overhead(a.device)}
    for cell in a.cells.split(","):
        t = time.perf_counter()
        run = (train_cell if find_cell(cell, a.bench)[0]["runner"] == "train"
               else synth_cell)
        res[cell] = run(cell, a.seed, a.device, a.calls, a.bench)
        res[cell]["wall_s"] = time.perf_counter() - t
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
