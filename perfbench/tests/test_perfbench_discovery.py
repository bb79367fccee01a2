"""A cell, a configuration, a mix or a metric is added by adding files:
a throwaway one in a copy of ``perfbench/`` runs with no code edited."""

from __future__ import annotations

import json
import os

from perfbench.tests import tinybench


def test_new_cell_config_mix_and_metric_by_files(tmp_path):
    d = tinybench.make(str(tmp_path))
    with open(os.path.join(d, "configs", "tiny_ljspeech_lj_synth_b8.json")) as f:
        cfg = json.load(f)
    cfg["model"]["denoiser"]["residual_layers"] = 3
    with open(os.path.join(d, "configs", "throwaway_cfg.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(d, "traffic", "tiny_lj_batch8.json")) as f:
        mix = json.load(f)
    mix.update(batch=3, block=2, pool=4)
    with open(os.path.join(d, "traffic", "throwaway_mix.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(d, "workloads", "tiny_lj_synth_b8.json")) as f:
        cell = json.load(f)
    cell.update(config="throwaway_cfg", traffic="throwaway_mix",
                per_layer=["calls_per_s.batch"])
    with open(os.path.join(d, "workloads", "throwaway_cell.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(d, "metrics", "calls_per_s.batch.py"), "w") as f:
        f.write('UNIT, BETTER, SOURCE, LAYER, MOVES = "1/s", "higher", '
                '"host_clock", "end to end", "synth_audio_s_per_s"\n\n\n'
                "def read(run):\n    return len(run.calls) / run.window_s\n")
    rc, res, err = tinybench.run(d, "throwaway_cell")
    assert rc == 0, err
    assert res["correct"] is True
    rc, res, err = tinybench.run(d, "throwaway_cell", trace=1)
    assert rc == 0, err
    assert "calls_per_s.batch" in res["metrics"]
    assert "device_idle_pct.batch" not in res["metrics"]   # nothing to read


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/, a run
    fails and prints no result."""
    import shutil
    import subprocess
    import sys

    shutil.copytree(tinybench.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tinybench.ROOT, "BENCHMARK.json"), tmp_path)
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "lj_synth_b8",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert not res.stdout.strip()
