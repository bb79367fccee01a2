"""Nothing a run loads has the top-level name ``jax``, ``jaxlib``, ``flax``
or ``cmtts_tpu`` (whole names: ``cmtts_tpu_torch`` is the program), and
the plain reference loads nothing of the program either."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from perfbench.harness import forbidden_modules
from perfbench.tests import tinybench

BLOCKER = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
"""


def test_whole_names():
    assert forbidden_modules(["cmtts_tpu_torch", "cmtts_tpu_torch.ops.mrf",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["cmtts_tpu.models", "jax.numpy", "flax",
                              "jaxlib.xla_client"]) == ["cmtts_tpu", "flax",
                                                        "jax", "jaxlib"]


def test_run_loads_no_jax(tmp_path):
    d = tinybench.make(str(tmp_path))
    rc, res, err = tinybench.run(
        d, "tiny_vctk_zs_b1",
        prelude=BLOCKER.format(blocked={"jax", "jaxlib", "flax",
                                        "cmtts_tpu"}))
    assert rc == 0, err
    assert res["correct"] is True


def test_reference_loads_nothing_of_the_program():
    code = BLOCKER.format(blocked={"jax", "jaxlib", "flax", "cmtts_tpu",
                                   "cmtts_tpu_torch"}) + f"""
sys.path.insert(0, {tinybench.ROOT!r})
import json, torch
from perfbench.tests.tinybench import tiny_config
from perfbench.reference.config import read_config
from perfbench.reference.synth import modules, synthesize, embed
from perfbench.reference import quant, acoustic, vocoder, speaker, train
cfg = tiny_config(json.load(open({os.path.join(tinybench.BENCH, 'configs',
                                               'vctk_zeroshot.json')!r})))
c = read_config(cfg)
model, voc, emb = modules(c, cfg["vocoder"], "cpu")
import numpy as np
e = embed(emb.eval(), np.random.default_rng(0).standard_normal(22050)
          .astype(np.float32), 22050, "cpu")
mel, lens, wav = synthesize(model.eval(), voc, c, [np.arange(64, 80)],
                            e[None], 1, cfg["buckets"], "cpu")
assert wav.shape == (1, mel.shape[1] * 256)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "cmtts_tpu", "cmtts_tpu_torch"))
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(tinybench.BENCH, sub)):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def test_sources_import_no_jax():
    """Whole top-level names: what the benchmark runs may import the
    program (``cmtts_tpu_torch``), never JAX or the JAX package (the
    tests, which the benchmark does not run, hold the reference to the
    JAX package)."""
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in {"jax", "jaxlib", "flax",
                                              "cmtts_tpu"}, (path, name)


def test_reference_sources_import_no_program():
    for path in _sources("reference"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in {"jax", "jaxlib", "flax", "cmtts_tpu",
                               "cmtts_tpu_torch"}, (path, name)
            if top == "perfbench":
                # the reference reads the corpus the benchmark writes
                assert name.startswith(("perfbench.reference",
                                        "perfbench.corpus",
                                        "perfbench.traffic")), (path, name)
