"""The port's whole slice against the JAX package: ``Synthesizer`` text ->
mel -> waveform on the same weights, with JAX's x_T and per-step noise
recomputed here by the calls ``cmtts_tpu.cm.sampling`` makes and injected
into the port; plus the port's import isolation and its CLI."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    both_configs,
    config_dicts,
    flax_cm_params,
    jax_draws,
    save_flat_npz,
    tokens,
    write_config,
    torch_cm,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on both sides; the mel passes the cond net and the denoiser, the
# wav also the vocoder: summation order only
MEL_TOL = dict(rtol=2e-4, atol=2e-4)
WAV_TOL = dict(rtol=2e-4, atol=2e-4)


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
    x_T, noise = jax_draws(seed, (len(seqs), t_mel, n_mels),
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
names = [m.name for m in pkgutil.walk_packages(cmtts_tpu_torch.__path__,
                                               "cmtts_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("audio.stft", "models.speaker", "text.segment",
             "cli.synthesize_zeroshot", "cm.losses", "train.loop",
             "train.state", "train.checkpoint", "train.resample", "train.ema",
             "train.kvlogger", "data.dataset", "data.feature_corpus",
             "cli.train_cm", "data.textgrid", "data.prepare",
             "data.synthcorpus", "data.preprocessor", "metrics.yin",
             "metrics.dtw", "metrics.features", "metrics.core",
             "metrics.harness", "utils_plot", "cli.gen_corpus",
             "cli.prepare_align", "cli.preprocess", "cli.get_mel_cache",
             "cli.all_metrics", "cli.evaluate", "from_torch",
             "models.melgan", "text.pinyin", "cli.convert_checkpoint",
             "cli.serve", "cli.p_rtf_cm", "models.hifigan_disc",
             "models.init", "train.hifigan_trainer", "train.ge2e_trainer",
             "cli.train_hifigan", "cli.train_ge2e", "parallel.distributed",
             "metrics.mos", "metrics.ldnet", "core.rng", "models.unet",
             "cm.image", "cm.image_train", "cli.image_sample",
             "models.discriminator", "cm.gan_losses", "data.native_loader",
             "tools.vocode_dir", "tools.extend_holdout",
             "tools.check_ge2e_holdout", "tools.zeroshot_eval",
             "tools.diag_pitch", "tools.bench_train", "tools.bench_serve"):
    assert "cmtts_tpu_torch." + name in names, name
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
pre, mdl, train, stats = config_dicts(speaker_embedder="DeepSpeaker")
ms_cfg = config_from_dicts(pre, dict(mdl, external_speaker_dim=512), train,
                           stats)
from cmtts_tpu_torch.models.speaker import DeepSpeakerInference, DeepSpeakerResCNN
from cmtts_tpu_torch.pipeline import synthesize_long
wav_ref = np.sin(np.arange(22050) * 0.05).astype(np.float32)
emb = DeepSpeakerInference(DeepSpeakerResCNN(), "cpu").predict_embedding(wav_ref)
ms = Synthesizer(ms_cfg, CMTTS(ms_cfg), voc, sampler="heun", sample_steps=3,
                 text_buckets=(8,), mel_buckets=(32,), device="cpu")
wav, mels, lens = synthesize_long(ms, [np.arange(13, 19), np.arange(20, 24)],
                                  spker_embed=emb)
assert len(mels) == 2 and np.isfinite(wav).all()
from cmtts_tpu_torch.audio.stft import GriffinLim, MelSpectrogram
assert GriffinLim(MelSpectrogram(n_mel_channels=16, device="cpu"),
                  n_iters=2)(mel[0]).shape == (32 * 256,)
import os, tempfile
from torch_port_helpers import train_batch
from cmtts_tpu_torch.models.cmtts import init_like_flax
from cmtts_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from cmtts_tpu_torch.train.loop import batch_to_device, make_train_step
from cmtts_tpu_torch.train.state import RAdam, create_train_state
tm = init_like_flax(CMTTS(cfg), torch.Generator().manual_seed(0))
state = create_train_state(dict(tm.named_parameters()), RAdam(1e-4), 3)
state, metrics = make_train_step(tm, cfg, RAdam(1e-4), 3)(
    state, batch_to_device(train_batch(0, (8, 5), 8, 32), "cpu"),
    np.asarray([0.5, 0.5], np.float32), 0.95, torch.Generator().manual_seed(0))
assert np.isfinite(float(metrics["loss"]))
with tempfile.TemporaryDirectory() as d:
    save_checkpoint(d, state)
    assert int(restore_checkpoint(d)["step"]) == 1
from cmtts_tpu_torch.cli.train_hifigan import disc_config
from cmtts_tpu_torch.train.hifigan_trainer import (HiFiGANTrainConfig,
    init_hifigan_train, make_hifigan_train_step)
hcfg = HiFiGANTrainConfig(segment_size=1024, batch_size=1)
hstate, hgen, hdisc = init_hifigan_train(
    hcfg, HiFiGANConfig(upsample_initial_channel=16), disc_config(64), "cpu")
hstate, hm = make_hifigan_train_step(
    hgen, hdisc, MelSpectrogram(device="cpu"), hcfg)(hstate, torch.rand(1, 1024))
assert hstate["step"] == 1 and np.isfinite(float(hm["g_loss"]))
from cmtts_tpu_torch.train.ge2e_trainer import (GE2ETrainConfig,
    init_ge2e_train, make_ge2e_train_step)
genc, gp, gtx, gopt = init_ge2e_train(0, 1e-4, "cpu")
gp, gopt, gloss, _ = make_ge2e_train_step(genc, gtx, 2, 2, GE2ETrainConfig())(
    gp, gopt, torch.rand(4, 20, 40))
assert np.isfinite(float(gloss))
from cmtts_tpu_torch.metrics.mos import MBNetMeanNet, MOSCal
from cmtts_tpu_torch.parallel.distributed import pad_batch_to_multiple
assert MBNetMeanNet().eval()(torch.rand(1, 5, 257)).shape == (1, 5)
assert pad_batch_to_multiple({"a": np.zeros((3, 2))}, 2)[1] == 3
assert not torch.cuda.is_available()
try:
    MOSCal()
except RuntimeError as e:
    assert "CUDA is not available" in str(e)
else:
    raise AssertionError("MOSCal() ran without CUDA")
try:
    Synthesizer(cfg, model)
except RuntimeError as e:
    assert "CUDA is not available" in str(e)
else:
    raise AssertionError("Synthesizer() ran without CUDA")
from cmtts_tpu_torch.cli.image_sample import main as image_main
with tempfile.TemporaryDirectory() as d:
    out = image_main(["--image_size", "16", "--num_channels", "32",
                      "--num_res_blocks", "1", "--channel_mult", "1,2",
                      "--attention_resolutions", "8", "--num_samples", "1",
                      "--batch_size", "1", "--sampler", "onestep",
                      "--class_cond", "True", "--device", "cpu",
                      "--out_dir", d])
    assert np.load(out)["arr_0"].shape == (1, 16, 16, 3)
    np.save(os.path.join(d, "a.npy"), np.arange(3))
    from cmtts_tpu_torch.data.native_loader import NativeNpyLoader
    assert (NativeNpyLoader(1).load([os.path.join(d, "a.npy")])[0]
            == np.arange(3)).all()
try:
    image_main(["--num_samples", "1"])
except RuntimeError as e:
    assert "CUDA is not available" in str(e)
else:
    raise AssertionError("cli.image_sample ran without CUDA")
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
    root = write_config(tmp_path, "Tiny", config_dicts())
    jcfg, _ = both_configs()
    save_flat_npz(tmp_path / "cm.npz", flax_cm_params(jcfg))
    save_flat_npz(tmp_path / "voc.npz", tiny_vocoder(16, width=32))
    from cmtts_tpu_torch.cli.synthesize import main

    out_dir = tmp_path / "out"
    main(["--mode", "single", "--text", "Hello world.", "--dataset", "Tiny",
          "--config_root", root, "--params", str(tmp_path / "cm.npz"),
          "--vocoder_ckpt", str(tmp_path / "voc.npz"),
          "--device", "cpu", "--out_dir", str(out_dir)])
    mel = np.load(out_dir / "single-mel.npy")
    assert mel.ndim == 2 and mel.shape[1] == 16 and mel.shape[0] > 0
    from cmtts_tpu_torch.audio.wavio import read_wav

    wav, sr = read_wav(str(out_dir / "single.wav"))
    assert sr == 22050 and len(wav) == mel.shape[0] * 256


def test_cli_long_mode(tmp_path, capsys):
    """Long mode on the CPU: three sentences over a 12-token chunk budget
    (max_seq_len 128), random weights, heun with 3 levels, Griffin-Lim."""
    root = write_config(tmp_path, "Tiny", config_dicts())
    from cmtts_tpu_torch.audio.wavio import read_wav
    from cmtts_tpu_torch.cli.synthesize import main

    out_dir = tmp_path / "out"
    main(["--mode", "long", "--text", "Hello world. How are you today? "
          "The quick brown fox jumps over the lazy dog.", "--dataset", "Tiny",
          "--config_root", root, "--sampler", "heun", "--sample_steps", "3",
          "--vocoder", "griffinlim", "--gap_ms", "100", "--device", "cpu",
          "--out_dir", str(out_dir)])
    n = int(capsys.readouterr().out.split("long mode: ")[1].split()[0])
    mels = [np.load(out_dir / f"long-chunk{i:02d}-mel.npy") for i in range(n)]
    assert n >= 3 and not (out_dir / f"long-chunk{n:02d}-mel.npy").exists()
    assert all(m.shape[1] == 16 and m.shape[0] > 0 for m in mels)
    wav, sr = read_wav(str(out_dir / "long.wav"))
    assert len(wav) == sum(len(m) for m in mels) * 256 + (n - 1) * 2205
    with pytest.raises(SystemExit, match="requires --vocoder_ckpt"):
        main(["--mode", "long", "--text", "Hi.", "--dataset", "Tiny",
              "--config_root", root, "--vocoder", "hifigan",
              "--device", "cpu"])


@pytest.fixture
def zeroshot_config(tmp_path):
    """A tiny GE2E-conditioned config (256-wide external embeddings)."""
    dicts = config_dicts(speaker_embedder="GE2E")
    dicts[1]["external_speaker_dim"] = 256
    return write_config(tmp_path, "TinyZS", dicts)


@pytest.mark.parametrize("source", ["spker_embed", "ref_wav"])
def test_cli_zeroshot(tmp_path, zeroshot_config, source):
    """Zero-shot CLI on the CPU from a precomputed embedding or from a 2 s
    reference wav (random GE2E weights); Griffin-Lim without a vocoder
    checkpoint."""
    from cmtts_tpu_torch.audio.wavio import read_wav, write_wav
    from cmtts_tpu_torch.cli.synthesize_zeroshot import main

    rs = np.random.RandomState(0)
    if source == "spker_embed":
        np.save(tmp_path / "emb.npy", rs.randn(256).astype(np.float32))
        src = ["--spker_embed", str(tmp_path / "emb.npy")]
    else:
        tt = np.arange(44100) / 22050
        write_wav(str(tmp_path / "ref.wav"),
                  0.3 * np.sin(2 * np.pi * 150 * tt) + 0.01 * rs.randn(44100),
                  22050)
        src = ["--ref_wav", str(tmp_path / "ref.wav")]
    out_dir = tmp_path / "out"
    base = ["--text", "Hello world.", "--dataset", "TinyZS", "--config_root",
            zeroshot_config, "--device", "cpu", "--out_dir", str(out_dir)]
    main(base + src)
    mel = np.load(out_dir / "zeroshot_single-mel.npy")
    assert mel.ndim == 2 and mel.shape[1] == 16 and mel.shape[0] > 0
    wav, sr = read_wav(str(out_dir / "zeroshot_single.wav"))
    assert sr == 22050 and len(wav) == mel.shape[0] * 256
    if source == "spker_embed":
        np.save(tmp_path / "bad.npy", np.zeros(8, np.float32))
        with pytest.raises(SystemExit, match="external_speaker_dim 256"):
            main(base + ["--spker_embed", str(tmp_path / "bad.npy")])
        with pytest.raises(SystemExit, match="requires --vocoder_ckpt"):
            main(base + src + ["--vocoder", "hifigan"])
        with pytest.raises(SystemExit):   # both sources at once
            main(base + src + ["--ref_wav", "x.wav"])
