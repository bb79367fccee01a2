"""The readers of the program's own spans and counters
(:mod:`perfbench.program_spans`): their numbers from a hand-made registry,
nothing from a program without one or from an untraced run, the
program's spans kept out of the benchmark's trace, and every one read in
a traced run of the tiny cells on the CPU.  The charge of device time to
spans (:mod:`perfbench.span_charge`): on hand-made spans of two threads
with linked launches, on a CPU profile, and run on the tiny cells."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from perfbench import program_spans, span_charge
from perfbench.harness import Run, metric_readers
from perfbench.tests import tinybench
from perfbench.trace import Trace, Tracer

NEW = {"fetch_ms.batch", "ct_forward_ms.train", "ct_backward_ms.train",
       "ct_update_ms.train", "feed_collate_ms.train", "feed_empty_pct.train"}

# a window's registry: 4 calls of 2 steps (8 pulls), 10 collates
REGISTRY = {"synth.fetch": 4, "synth.fetch.ns": 6_000_000,
            "ct.forward": 8, "ct.forward.ns": 40_000_000,
            "ct.backward": 8, "ct.backward.ns": 64_000_000,
            "ct.update": 8, "ct.update.ns": 16_000_000,
            "feed.collate": 10, "feed.collate.ns": 90_000_000,
            "feed.pulls": 8, "feed.empty_pulls": 6}
WANT = {"fetch_ms.batch": 1.5, "ct_forward_ms.train": 5.0,
        "ct_backward_ms.train": 8.0, "ct_update_ms.train": 2.0,
        "feed_collate_ms.train": 9.0, "feed_empty_pct.train": 75.0}


def hand_run(traced: bool = True) -> Run:
    calls = [{"t0": i, "t1": i + 0.5, "steps": 2} for i in range(4)]
    trace = Trace(["k"], np.array([0]), np.array([10]), [], 2.0) \
        if traced else None
    return Run(calls, (0.0, 3.5), 1.0, trace=trace)


@pytest.fixture(scope="module")
def readers():
    return {n: r for n, r in metric_readers().items() if n in NEW}


def test_every_new_reader_is_found(readers):
    assert set(readers) == NEW


def test_readers_from_a_hand_made_registry(readers, monkeypatch):
    monkeypatch.setattr(program_spans, "traced", lambda: dict(REGISTRY))
    for name, reader in readers.items():
        assert reader.read(hand_run()) == pytest.approx(WANT[name]), name
        assert reader.read(hand_run(traced=False)) is None, name


def test_nothing_from_a_program_without_the_registry(readers, monkeypatch):
    """The parent's program has no ``cmtts_tpu_torch.core.trace``."""
    import cmtts_tpu_torch.core

    monkeypatch.setitem(sys.modules, "cmtts_tpu_torch.core.trace", None)
    monkeypatch.delattr(cmtts_tpu_torch.core, "trace", raising=False)
    assert program_spans.traced() is None
    for name, reader in readers.items():
        assert reader.read(hand_run()) is None, name


def test_nothing_where_the_window_had_no_such_span(readers, monkeypatch):
    monkeypatch.setattr(program_spans, "traced",
                        lambda: {"synth.fetch": 4, "synth.fetch.ns": 1})
    for name, reader in readers.items():
        got = reader.read(hand_run())
        assert (got is None) == (name != "fetch_ms.batch"), name


def test_program_spans_stay_out_of_the_benchmark_trace():
    """The benchmark's trace keeps its own spans only, so its idle-gap
    labels and device readers are what they were before the program had
    spans."""
    from cmtts_tpu_torch.core.trace import span

    with Tracer(True) as tr:
        with tr.span("synthesize"):
            with span("synth.fetch"):
                sum(range(1000))
    res = tr.result(1.0)
    assert [s[0] for s in res.spans] == ["synthesize"]
    assert not any(n.startswith("cmtts.") for n in res.names)


def test_traced_tiny_cells_read_the_new_metrics(tmp_path):
    d = tinybench.make(str(tmp_path))
    rc, res, err = tinybench.run(d, "tiny_lj_synth_b8", trace=1)
    assert rc == 0, err
    assert res["metrics"]["fetch_ms.batch"]["value"] > 0
    rc, res, err = tinybench.run(d, "tiny_lj_ct_b32", trace=1)
    assert rc == 0, err
    got = {n: m["value"] for n, m in res["metrics"].items()}
    assert NEW - {"fetch_ms.batch"} <= set(got)
    assert "feed_wait_ms.train" in got
    assert 0 <= got["feed_empty_pct.train"] <= 100
    assert all(got[n] > 0 for n in ("ct_forward_ms.train",
                                    "ct_backward_ms.train",
                                    "ct_update_ms.train",
                                    "feed_collate_ms.train"))


# main thread 1: bench.synthesize [0, 100] holding synth.condition [10, 30]
# and synth.vocode [40, 60]; thread 2 (a producer): feed.collate [0, 100];
# thread 3 (autograd's): no span
SPANS = [("bench.synthesize", 1, 0, 100), ("cmtts.synth.condition", 1, 10, 30),
         ("cmtts.synth.vocode", 1, 40, 60), ("cmtts.feed.collate", 2, 0, 100)]
LAUNCHES = {1: (1, 15), 2: (1, 45), 3: (1, 70), 4: (3, 50), 5: (2, 20),
            6: (3, 150)}
OPS = [("cond", 16, 10, 1), ("voc", 46, 12, 2), ("tail", 72, 6, 3),
       ("bwd", 58, 4, 4), ("copy", 80, 2, 5), ("late", 150, 5, 6),
       ("lost", 160, 3, 99)]


def test_each_op_is_charged_to_the_innermost_span_of_its_launcher():
    ns, kernels, via = span_charge.charge(SPANS, LAUNCHES, OPS)
    assert ns == {"synthesize/synth.condition": 10,
                  "synthesize/synth.vocode": 12 + 4, "synthesize": 6,
                  "feed.collate": 2, span_charge.OUTSIDE: 5,
                  span_charge.UNLINKED: 3}
    assert kernels["synthesize/synth.vocode"] == 2
    # the spanless thread's op takes the main thread's path at its launch
    assert via == {"synthesize/synth.vocode": 4}


def test_gap_labels_follow_the_main_thread_only():
    """Device busy 16-26, 46-62, 72-78, 80-82, 150-155, 160-163: gaps
    between the two children (mid 36), in the parent after the child
    ``synth.vocode`` ended (62-72, 78-80), and after every span ended; the
    producer's ``feed.collate``, which covers 0-100, labels none."""
    gaps = span_charge.idle_gaps(SPANS, OPS)
    assert gaps == {"synthesize": [20 + 10 + 2, 3],
                    "after synthesize": [68 + 5, 2]}
    lone = [s for s in SPANS if s[1] == 2]
    assert span_charge.idle_gaps(lone, OPS) == {span_charge.OUTSIDE: [105, 5]}


def test_reduce_per_call():
    r = span_charge.reduce(SPANS, LAUNCHES, OPS, 2)
    assert r["device_ms"] == pytest.approx(42 / 1e6 / 2)
    assert r["under_program_spans_pct"] == pytest.approx(100 * 28 / 42)
    assert r["kernels_by_span"]["synthesize/synth.vocode"] == 1
    assert r["host_ms_by_span"] == pytest.approx({
        "synthesize": 50 / 1e6, "synthesize/synth.condition": 10 / 1e6,
        "synthesize/synth.vocode": 10 / 1e6, "feed.collate": 50 / 1e6})


def test_events_of_a_cpu_profile_keep_each_spans_thread():
    from torch.profiler import record_function

    from cmtts_tpu_torch.core.trace import span

    def producer():
        with span("feed.collate"):
            sum(range(1000))

    with span_charge.profiler() as prof:
        with record_function("bench.synthesize"):
            with span("synth.fetch"):
                t = threading.Thread(target=producer)
                t.start()
                t.join()
    spans, launches, ops = span_charge.events(prof)
    tids = {n: tid for n, tid, _, _ in spans}
    assert set(tids) == {"bench.synthesize", "cmtts.synth.fetch",
                         "cmtts.feed.collate"}
    assert tids["bench.synthesize"] == tids["cmtts.synth.fetch"] \
        != tids["cmtts.feed.collate"]
    assert span_charge.main_thread(spans) == tids["bench.synthesize"]
    assert ops == [] and launches == {}


def test_span_charge_runs_the_tiny_cells(tmp_path):
    d = tinybench.make(str(tmp_path))
    out = tmp_path / "charge.json"
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    res = subprocess.run(
        [sys.executable, os.path.join(tinybench.BENCH, "span_charge.py"),
         "--cells", "tiny_vctk_zs_b1,tiny_lj_ct_b32", "--calls", "4",
         "--device", "cpu", "--bench", d, "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=tinybench.ROOT,
        env=env)
    assert res.returncode == 0, res.stderr
    got = json.loads(out.read_text())
    assert got["overhead"]["off_span_ns"] < got["overhead"]["on_span_ns"]
    host = got["tiny_vctk_zs_b1"]["host_ms_by_span"]
    assert {"embed/embed.fbank", "embed/embed.rescnn", "synthesize",
            "synthesize/synth.vocode", "synthesize/synth.fetch"} <= set(host)
    ct = got["tiny_lj_ct_b32"]
    assert ct["n"] == 4 and "feed.collate" in ct["host_ms_by_span"]
    assert "step/ct.forward/ct.cast" in ct["host_ms_by_span"]
