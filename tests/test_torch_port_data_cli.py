"""The port's data and evaluation CLIs on the CPU: the journey gen_corpus
--tiny -> preprocess -> train_cm -> synthesize --mode batch --restore_step
0 -> all_metrics -> evaluate -> get_mel_cache; ``evaluate_cm`` against the
JAX CLI's on the same flax weights with JAX's x_T injected; ``--workers 2``
equal to serial bit for bit, with jax and cmtts_tpu blocked in the parent
and in the spawned workers; and every device-bound CLI refusing to run
without CUDA unless given ``--device cpu``."""

import importlib.util
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import assert_mel_close, flax_cm_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# evaluate_cm's losses and one-step mel L1, float32 on both sides (the JAX
# suite's f32 tolerance, as the train-step parity tests use)
EVAL_TOL = dict(rtol=2e-4, atol=2e-4)
GEN = ["--n", "12", "--val_size", "2", "--batch_size", "2", "--tiny",
       "--words_min", "2", "--words_max", "4"]


def _cfg_root(root):
    return str(root / "config")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A tiny generated corpus preprocessed serially on the CPU after
    random.seed(0)."""
    from cmtts_tpu_torch.cli.gen_corpus import main as gen_corpus
    from cmtts_tpu_torch.cli.preprocess import main as preprocess

    root = tmp_path_factory.mktemp("journey")
    assert gen_corpus(["--out", str(root), *GEN]) == _cfg_root(root)
    random.seed(0)
    train, val = preprocess(["--dataset", "LJSpeech", "--config_root",
                             _cfg_root(root), "--device", "cpu"])
    assert len(train) == 10 and len(val) == 2
    return root


def test_cpu_journey(corpus, capsys):
    from cmtts_tpu_torch.audio.stft import MelSpectrogram
    from cmtts_tpu_torch.audio.wavio import read_wav
    from cmtts_tpu_torch.cli.all_metrics import main as all_metrics
    from cmtts_tpu_torch.cli.evaluate import main as evaluate
    from cmtts_tpu_torch.cli.get_mel_cache import main as get_mel_cache
    from cmtts_tpu_torch.cli.synthesize import main as synthesize
    from cmtts_tpu_torch.cli.train_cm import main as train_cm

    cfg_root = _cfg_root(corpus)
    common = ["--dataset", "LJSpeech", "--config_root", cfg_root,
              "--device", "cpu"]
    r = train_cm(["--model", "consistency_training", "--total_step", "2",
                  *common])
    assert r["state"].step == 2 and np.isfinite(r["losses"]).all()

    out = synthesize(["--mode", "batch", "--source",
                      str(corpus / "pre" / "val.txt"), "--restore_step", "0",
                      "--vocoder", "griffinlim", "--batch_size", "2",
                      *common])
    assert "restored model of step 2" in capsys.readouterr().out
    assert out == str(corpus / "output" / "result" / "LJSpeech_cm"
                      / "step_0_T1")
    val = [line.split("|")[0] for line in
           (corpus / "pre" / "val.txt").read_text().splitlines()]
    assert sorted(os.listdir(out)) == sorted(
        [f"{b}.wav" for b in val] + [f"{b}-mel.npy" for b in val])
    for b in val:
        mel = np.load(os.path.join(out, f"{b}-mel.npy"))
        wav, _ = read_wav(os.path.join(out, f"{b}.wav"))
        assert mel.shape[1] == 80 and len(wav) == len(mel) * 256 > 0
        assert np.isfinite(mel).all()

    raw = str(corpus / "raw" / "SYN")
    metrics = ["mcd", "ffe", "mfcc_cos"]
    vals = all_metrics(["--single", "--syn_root", out, "--raw_folder", raw,
                        "--metrics", *metrics, "--device", "cpu"])
    assert list(vals) == metrics and np.isfinite(list(vals.values())).all()
    same = all_metrics(["--single", "--syn_root", raw, "--raw_folder", raw,
                        "--metrics", "mcd", "--device", "cpu"])
    assert same["mcd"] == 0.0

    summary = evaluate(common)
    assert {"total", "pdur", "energy", "mel_onestep_l1"} <= set(summary)
    assert np.isfinite(list(summary.values())).all()

    cache = corpus / "mel_cache"
    assert get_mel_cache(["--wav_dir", raw, "--out_dir", str(cache),
                          "--device", "cpu"]) == 12
    from cmtts_tpu.audio.stft import MelSpectrogram as JMel
    from cmtts_tpu_torch.metrics.features import load_wav

    wav = load_wav(os.path.join(raw, "syn0003.wav"))
    cached = np.load(cache / "syn0003-mel.npy")
    assert cached.shape[1] == 80 and cached.dtype == np.float32
    np.testing.assert_array_equal(
        cached, MelSpectrogram(device="cpu")(wav)[0].T)
    assert_mel_close(cached, JMel()(wav)[0].T)


def _jax_evaluate_module():
    spec = importlib.util.spec_from_file_location(
        "jax_cli_evaluate", os.path.join(ROOT, "cli", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluate_cm_matches_jax(corpus):
    """The port's evaluate_cm and cli/evaluate.py's on one val batch of the
    corpus, the same flax-initialised params (through the bridge) and the
    x_T that JAX draws from fold_in(PRNGKey(42), batch)."""
    import jax
    import jax.numpy as jnp

    from cmtts_tpu.core.config import load_configs as jload
    from cmtts_tpu_torch.cli.evaluate import evaluate_cm
    from cmtts_tpu_torch.cm.karras import schedule_from_config
    from cmtts_tpu_torch.convert import flax_to_state_dict
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.models.cmtts import CMTTS

    jcfg = jload("LJSpeech", _cfg_root(corpus))
    tcfg = load_configs("LJSpeech", _cfg_root(corpus))
    params = flax_cm_params(jcfg)
    ref = _jax_evaluate_module().evaluate_cm(
        jcfg, jax.tree_util.tree_map(jnp.asarray, params))

    from cmtts_tpu_torch.data.dataset import FeatureDataset, batch_iterator

    batch = next(batch_iterator(FeatureDataset("val.txt", tcfg, sort=False),
                                2, group_size=1, shuffle=False, epochs=1))
    _, sub = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(42), 0))
    x_T = torch.from_numpy(np.array(
        jax.random.normal(sub, batch["mels"].shape, jnp.float32)
        * schedule_from_config(tcfg).sigma_max))
    out = evaluate_cm(tcfg, flax_to_state_dict(params, CMTTS(tcfg)),
                      device="cpu", x_T=[x_T])
    assert set(out) == set(ref) and "mel_onestep_l1" in out
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], **EVAL_TOL, err_msg=k)


_BLOCK = "raise ImportError('blocked: the port must not import this')\n"


def test_workers_bit_identical_and_jax_free(corpus, tmp_path):
    """preprocess --workers 2 in a subprocess whose PYTHONPATH puts shadow
    jax and cmtts_tpu packages that raise on import in front (spawned
    workers inherit it) equals the serial run file for file, bit for bit."""
    from cmtts_tpu_torch.cli.gen_corpus import main as gen_corpus

    shadow = tmp_path / "shadow"
    for pkg in ("jax", "cmtts_tpu"):
        (shadow / pkg).mkdir(parents=True)
        (shadow / pkg / "__init__.py").write_text(_BLOCK)
    root = tmp_path / "par"
    gen_corpus(["--out", str(root), *GEN])
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = os.pathsep.join([str(shadow), ROOT])
    check = subprocess.run([sys.executable, "-c", "import jax"], env=env,
                           capture_output=True, text=True, timeout=60)
    assert "blocked" in check.stderr
    code = ("import random, sys; random.seed(0); "
            "from cmtts_tpu_torch.cli.preprocess import main; "
            "main(sys.argv[1:]); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'cmtts_tpu')]; assert not bad, bad")
    res = subprocess.run(
        [sys.executable, "-c", code, "--dataset", "LJSpeech",
         "--config_root", _cfg_root(root), "--device", "cpu", "--workers",
         "2"], env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "10 train / 2 val" in res.stdout
    serial, par = corpus / "pre", root / "pre"
    names = sorted(os.path.relpath(os.path.join(d, f), serial)
                   for d, _, fs in os.walk(serial) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), par)
                           for d, _, fs in os.walk(par) for f in fs)
    assert len(names) > 9 * 12
    for rel in names:
        assert (serial / rel).read_bytes() == (par / rel).read_bytes(), rel


@pytest.mark.parametrize("cli", ["preprocess", "get_mel_cache", "synthesize",
                                 "all_metrics", "evaluate"])
def test_device_clis_need_cuda_by_default(cli, corpus, monkeypatch,
                                          tmp_path):
    import importlib

    argv = {
        "preprocess": ["--dataset", "LJSpeech", "--config_root",
                       _cfg_root(corpus)],
        "get_mel_cache": ["--wav_dir", str(corpus / "raw" / "SYN"),
                          "--out_dir", str(tmp_path / "cache")],
        "synthesize": ["--mode", "batch", "--source",
                       str(corpus / "pre" / "val.txt"), "--config_root",
                       _cfg_root(corpus), "--vocoder", "none"],
        "all_metrics": ["--single", "--syn_root", str(corpus / "raw" / "SYN"),
                        "--raw_folder", str(corpus / "raw" / "SYN"),
                        "--metrics", "mcd"],
        "evaluate": ["--dataset", "LJSpeech", "--config_root",
                     _cfg_root(corpus)],
    }[cli]
    main = importlib.import_module(f"cmtts_tpu_torch.cli.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    assert not os.path.exists(tmp_path / "cache")
