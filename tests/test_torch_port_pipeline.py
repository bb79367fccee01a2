"""The port's whole slice against the JAX package: ``Synthesizer`` text ->
mel -> waveform on the same weights, with JAX's x_T and per-step noise
recomputed here by the calls ``cmtts_tpu.cm.sampling`` makes and injected
into the port; plus the port's import isolation and its CLI."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_port_helpers import both_configs, config_dicts, flax_cm_params, tokens, torch_cm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on both sides; the mel passes the cond net and the denoiser, the
# wav also the vocoder: summation order only
MEL_TOL = dict(rtol=2e-4, atol=2e-4)
WAV_TOL = dict(rtol=2e-4, atol=2e-4)


def jax_noise(seed, shape, sigma_max, n_steps):
    """x_T and the multistep noise exactly as sample_mel and
    stochastic_iterative draw them from PRNGKey(seed)."""
    rng, sub = jax.random.split(jax.random.PRNGKey(seed))
    x_T = jax.random.normal(sub, shape, jnp.float32) * sigma_max
    noise = []
    for _ in range(n_steps):
        rng, sub = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))))
    return torch.from_numpy(np.array(x_T)), noise


def tiny_vocoder(n_mels, width=64, seed=0):
    from cmtts_tpu.models.hifigan import HiFiGANConfig, HiFiGANGenerator

    gen = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=width,
                                         num_mels=n_mels))
    init = jax.jit(gen.init)
    return jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, n_mels)))["params"])


def port_vocoder(params, n_mels):
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator

    width = int(params["conv_pre"]["kernel"].shape[-1])
    return load_flax_params(HiFiGANGenerator(HiFiGANConfig(
        upsample_initial_channel=width, num_mels=n_mels)), params).eval()


def run_both(tiny, T, vocode, buckets, mel_bucket=None, seed=7, lengths=(14, 9)):
    from cmtts_tpu.pipeline import Synthesizer as JSynth
    from cmtts_tpu_torch.pipeline import Synthesizer as TSynth

    jcfg, tcfg = both_configs(tiny=tiny)
    params = flax_cm_params(jcfg)
    n_mels = jcfg.stft.n_mel_channels
    voc = tiny_vocoder(n_mels) if vocode else None
    text_b, mel_b = buckets
    seqs = tokens(np.random.RandomState(seed), lengths)
    jsynth = JSynth(jcfg, params, voc, T=T, text_buckets=text_b,
                    mel_buckets=mel_b, compute_dtype=jnp.float32)
    ref = jsynth(seqs, seed=seed, mel_bucket=mel_bucket)
    t_mel = ref[0].shape[1]
    x_T, noise = jax_noise(seed, (len(seqs), t_mel, n_mels),
                           jsynth.sched.sigma_max, T)
    tsynth = TSynth(tcfg, torch_cm(tcfg, params),
                    port_vocoder(voc, n_mels) if vocode else None, T=T,
                    text_buckets=text_b, mel_buckets=mel_b,
                    compute_dtype=torch.float32, device="cpu")
    out = tsynth(seqs, mel_bucket=mel_bucket, x_T=x_T, noise=noise)
    return ref, out, tsynth


@pytest.mark.parametrize("T", [1, 2])
def test_synthesizer_matches_jax(T):
    ref, out, synth = run_both(True, T, True, ((8, 16), (32, 64, 128)),
                               lengths=(8, 5))
    (mel_r, lens_r, wav_r), (mel, lens, wav) = ref, out
    np.testing.assert_array_equal(lens, lens_r)
    assert 0 < lens.min() and lens.max() < mel.shape[1] == mel_r.shape[1]
    np.testing.assert_allclose(mel, mel_r, **MEL_TOL)
    assert wav.shape == wav_r.shape == (2, mel.shape[1] * 256)
    np.testing.assert_allclose(wav, wav_r, **WAV_TOL)
    trimmed = synth.trim_wavs(wav, lens)
    assert [len(w) for w in trimmed] == [int(n) * 256 for n in lens]


def test_synthesizer_full_width_acoustic_model():
    """LJSpeech widths (4x256 encoder, 20x256 denoiser, 80 mels) at text
    bucket 32 / mel bucket 128, mel only."""
    ref, out, _ = run_both(False, 1, False, ((32,), (128,)), mel_bucket=128,
                           lengths=(18, 11))
    (mel_r, lens_r, _), (mel, lens, wav) = ref, out
    assert wav is None
    np.testing.assert_array_equal(lens, lens_r)
    assert 0 < lens.min() and lens.max() < 128 and mel.shape == (2, 128, 80)
    np.testing.assert_allclose(mel, mel_r, rtol=1e-3, atol=1e-3)


_ISOLATION = r"""
import pkgutil, sys, importlib
sys.modules["jax"] = None         # any "import jax" now fails
sys.modules["cmtts_tpu"] = None
import cmtts_tpu_torch
for m in pkgutil.walk_packages(cmtts_tpu_torch.__path__, "cmtts_tpu_torch."):
    importlib.import_module(m.name)
import numpy as np, torch
from cmtts_tpu_torch.core.config import config_from_dicts
from cmtts_tpu_torch.models.cmtts import CMTTS
from cmtts_tpu_torch.models.hifigan import HiFiGANConfig, HiFiGANGenerator
from cmtts_tpu_torch.pipeline import Synthesizer
sys.path.insert(0, "tests")
from torch_port_helpers import config_dicts
cfg = config_from_dicts(*config_dicts())
model = CMTTS(cfg)
voc = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=32, num_mels=16))
mel, lens, wav = Synthesizer(cfg, model, voc, T=2, text_buckets=(8,),
                             mel_buckets=(32,), device="cpu")(
    [np.arange(13, 19)])
assert mel.shape == (1, 32, 16) and wav.shape == (1, 32 * 256)
assert np.isfinite(wav).all()
assert not torch.cuda.is_available()
try:
    Synthesizer(cfg, model)
except RuntimeError as e:
    assert "CUDA is not available" in str(e)
else:
    raise AssertionError("Synthesizer() ran without CUDA")
loaded = [m for m, v in sys.modules.items() if v is not None
          and m.split(".")[0] in ("jax", "jaxlib", "flax", "cmtts_tpu")]
assert not loaded, loaded
print("ISOLATED")
"""


def test_port_imports_no_jax_and_needs_cuda_by_default():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "PYTHONPATH")}
    res = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED" in res.stdout


def test_cli_single_mode(tmp_path):
    """The port's CLI on the CPU with flat npz checkpoints (a tiny config
    written as YAML, a flax-initialised CM and a width-32 HiFi-GAN)."""
    pre, model, train, stats = config_dicts()
    cfg_dir = tmp_path / "config" / "Tiny"
    cfg_dir.mkdir(parents=True)
    pre["path"] = {"preprocessed_path": str(tmp_path / "pre"),
                   "lexicon_path": str(tmp_path / "none.txt")}
    os.makedirs(tmp_path / "pre")
    with open(tmp_path / "pre" / "stats.json", "w") as f:
        json.dump(stats, f)
    for name, d in (("preprocess", pre), ("model", model), ("train", train)):
        with open(cfg_dir / f"{name}.yaml", "w") as f:
            yaml.safe_dump(d, f)
    jcfg, _ = both_configs()

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    np.savez(tmp_path / "cm.npz", **dict(flat(flax_cm_params(jcfg))))
    np.savez(tmp_path / "voc.npz", **dict(flat(tiny_vocoder(16, width=32))))
    from cmtts_tpu_torch.cli.synthesize import main

    out_dir = tmp_path / "out"
    main(["--mode", "single", "--text", "Hello world.", "--dataset", "Tiny",
          "--config_root", str(tmp_path / "config"), "--params",
          str(tmp_path / "cm.npz"), "--vocoder_ckpt", str(tmp_path / "voc.npz"),
          "--device", "cpu", "--out_dir", str(out_dir)])
    mel = np.load(out_dir / "single-mel.npy")
    assert mel.ndim == 2 and mel.shape[1] == 16 and mel.shape[0] > 0
    from cmtts_tpu_torch.audio.wavio import read_wav

    wav, sr = read_wav(str(out_dir / "single.wav"))
    assert sr == 22050 and len(wav) == mel.shape[0] * 256
