"""BENCHMARK.json against the files the harness finds by name, and the
shape of a run's last line."""

from __future__ import annotations

import json
import os
import re

import pytest

from perfbench.harness import BENCH_DIR, find_cell, metric_readers
from perfbench.tests import tinybench

ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_name_has_its_files(bench):
    readers = metric_readers()
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        cell, config, traffic = find_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        assert os.path.exists(os.path.join(BENCH_DIR, "runners",
                                           cell["runner"] + ".py"))
        assert configs[w["config"]]["file"] == \
            f"perfbench/configs/{w['config']}.json"
        assert config["reduced"] == configs[w["config"]]["reduced"]
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert m in readers
        for m in cell["per_layer"]:
            assert readers[m].MOVES in cell["end_to_end"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        r = readers[m["name"]]
        assert (r.UNIT, r.BETTER, r.SOURCE) == (m["unit"], m["better"],
                                                m["source"])
        if "layer" in m:
            assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"])
        for w in m.get("workloads", []):
            cell = find_cell(w)[0]
            assert m["name"] in cell["end_to_end"] + cell["per_layer"]


def test_last_line_keys(tmp_path):
    d = tinybench.make(str(tmp_path))
    rc, res, err = tinybench.run(d, "tiny_lj_synth_b8")
    assert rc == 0, err
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert set(res["metrics"]) == {"synth_audio_s_per_s", "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["attempted"] > 0 and res["failed"] == 0
    # the compared numbers close standard error, each beside its limit
    tail = err.strip().splitlines()[-len(res["compared"]):]
    assert all(" limit " in line for line in tail)


def test_traced_line_has_breakdown(tmp_path):
    """On the CPU the device readers find nothing and are left out."""
    d = tinybench.make(str(tmp_path))
    rc, res, err = tinybench.run(d, "tiny_vctk_zs_b1", trace=1)
    assert rc == 0, err
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "compared"]
    assert set(res["metrics"]) == {"embed_ms.latency"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
