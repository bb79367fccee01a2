"""The ported quality scripts (``cmtts_tpu_torch/tools/*.sh``): the quality
pipeline rehearsed on the CPU at the ``--tiny`` widths (``DEVICE=cpu``),
resumed by a second run that starts no stage; every script parses and
every module it runs imports."""

import importlib
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "cmtts_tpu_torch", "tools")
SCRIPTS = sorted(f for f in os.listdir(TOOLS) if f.endswith(".sh"))
STAGES = ["corpus", "preprocess", "train_ct", "synth_ct", "metrics_ct"]


def _env(**kw):
    env = dict(os.environ)
    # the scripts run `python`: this interpreter's
    env["PATH"] = os.path.dirname(sys.executable) + os.pathsep + env["PATH"]
    # one thread a process: the tiny models gain nothing from more, and
    # beside other test workers a full thread pool per CLI crawled
    env["OMP_NUM_THREADS"] = "1"
    env.update({k: str(v) for k, v in kw.items()})
    return env


def test_the_six_scripts_are_ported():
    assert SCRIPTS == ["run_maskstd_ab.sh", "run_quality_pipeline.sh",
                       "run_serve_bench.sh", "run_vocoder_quality.sh",
                       "run_zeroshot_quality.sh", "run_zeroshot_redo.sh"]


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_parses_and_its_modules_import(script):
    path = os.path.join(TOOLS, script)
    subprocess.run(["bash", "-n", path], check=True)
    with open(path) as f:
        text = f.read()
    modules = set(re.findall(r"python -m ([\w.]+)", text))
    assert modules, script
    assert not re.search(r"(python|bash) (cli|tools)/", text), \
        f"{script} runs a JAX entry point"
    for name in modules:
        assert name.startswith("cmtts_tpu_torch."), name
        importlib.import_module(name)
    # every CLI and tool but the host-only corpus writer takes the device
    code = re.sub(r"\\\n", " ", "\n".join(
        line for line in text.splitlines() if not line.lstrip().startswith("#")))
    for cmd in re.findall(r"python -m (.*)", code):
        if cmd.startswith("cmtts_tpu_torch.cli.gen_corpus"):
            continue
        if '"${args[@]}"' in cmd:
            cmd = re.search(r"args=\((.*?)\)", code, re.S).group(1)
        assert '--device "$DEVICE"' in cmd or "--device cpu" in cmd, \
            (script, cmd)


def test_quality_pipeline_on_the_cpu_resumes_without_a_stage(tmp_path):
    corpus = tmp_path / "qcorp"
    env = _env(CORPUS=corpus, N=12, VAL=2, BATCH=2, CT_STEPS=8, RUN_CD=0,
               RUN_VOCODER=0, GEN_ARGS="--tiny", DEVICE="cpu")
    script = os.path.join(TOOLS, "run_quality_pipeline.sh")
    first = subprocess.run(["bash", script], env=env, capture_output=True,
                           text=True, timeout=600)
    assert first.returncode == 0, first.stdout[-3000:] + first.stderr[-3000:]
    for stage in STAGES:
        assert f"== [{stage}] done" in first.stdout, stage
        assert (corpus / f".stage_{stage}.done").exists(), stage
    assert "== pipeline complete ==" in first.stdout
    assert (corpus / "output" / "ckpt" / "LJSpeech" / "CMDenoiserTTS"
            / "step_00000008" / "COMMITTED").exists()
    for T in (1, 2, 4):
        syn = corpus / "output" / "result" / "LJSpeech_cm" / f"step_8_T{T}"
        assert len([f for f in os.listdir(syn) if f.endswith(".wav")]) == 2
    metrics = (corpus / "metrics_ct_gl.txt").read_text()
    assert metrics.count("(griffinlim) --") == 3
    for name in ("mcd", "mcd_dctmel", "ffe", "ssim", "f0_rmse"):
        # f0_rmse is nan where the tiny model voices no frame the raw does
        assert len(re.findall(rf"^{name}: ([-\d.]+|nan)$", metrics,
                              re.M)) == 3, name

    again = subprocess.run(["bash", script], env=env, capture_output=True,
                           text=True, timeout=120)
    assert again.returncode == 0, again.stderr[-3000:]
    assert " start " not in again.stdout
    assert [f"== [{s}] already done ==" for s in STAGES] == [
        line for line in again.stdout.splitlines() if "already done" in line]
