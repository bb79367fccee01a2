"""Reference-format checkpoints in the port against the JAX package: the CM
``CMTotalTTS`` state dict (through the copied ``from_torch`` and the
bridge), HiFi-GAN ``.pth.tar`` with weight norm, melgan-neurips
``best_netG.pt``, GE2E ``.pt`` / trainer ``.npy``, DeepSpeaker Keras
``.h5``; ``cli.convert_checkpoint`` into the port trainer's step format,
synthesis and distillation from it; and the vocoder's per-stage route,
decided from the shapes when the weights are packed."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    both_configs,
    config_dicts,
    flax_cm_params,
    hifigan_reference_state_dict,
    jax_draws,
    melgan_reference_module,
    reference_state_dict,
    tokens,
    write_config,
)

# float32 on both sides, summation order only (tests/test_torch_port_
# pipeline.py's MEL_TOL / WAV_TOL and the JAX suite's f32 vocoder 2e-4)
F32_TOL = dict(rtol=2e-4, atol=2e-4)
MELGAN_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_melgan.py's
GE2E_ATOL = 1e-5                          # tests/test_torch_port_speaker.py's
CONFIGS = {"single": {}, "external": {"speaker_embedder": "GE2E"}}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert set(fa) == set(fb), set(fa) ^ set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def save_torch(path, sd):
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
               path)


@pytest.fixture(scope="module")
def cm_trees():
    """{config: (jax cfg, port cfg, flax params, reference state dict)}."""
    out = {}
    for name, kw in CONFIGS.items():
        jcfg, tcfg = both_configs(**kw)
        params = flax_cm_params(jcfg)
        out[name] = (jcfg, tcfg, params, reference_state_dict(params, jcfg))
    return out


# -- CM -----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_state_dict_inverts_the_converters(cm_trees, name):
    """The helper's state dict goes back to the flax tree exactly through
    JAX's ``convert_cm_state_dict`` and the port's copy; a leftover key
    raises in both (``strict``)."""
    from cmtts_tpu.convert.from_torch import convert_cm_state_dict as jconv

    from cmtts_tpu_torch.from_torch import convert_cm_state_dict as tconv

    jcfg, tcfg, params, sd = cm_trees[name]
    assert_trees_equal(jconv(sd, jcfg), params)
    assert_trees_equal(tconv(sd, tcfg), params)
    extra = dict(sd, **{"net.stray.weight": np.zeros(3, np.float32)})
    for conv, cfg in ((jconv, jcfg), (tconv, tcfg)):
        with pytest.raises(ValueError, match="net.stray.weight"):
            conv(extra, cfg)
        assert_trees_equal(conv(extra, cfg, strict=False), params)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cm_from_reference_pt_matches_jax(cm_trees, name, tmp_path):
    """The port's CMTTS loaded from a reference ``.pt`` synthesises the mel
    of JAX's Synthesizer on the flax tree, with JAX's draws injected."""
    from cmtts_tpu.pipeline import Synthesizer as JSynth

    from cmtts_tpu_torch.from_torch import load_torch_cm
    from cmtts_tpu_torch.pipeline import Synthesizer as TSynth

    jcfg, tcfg, params, sd = cm_trees[name]
    path = str(tmp_path / "model000100.pt")
    save_torch(path, sd)
    seqs = tokens(np.random.RandomState(3), (9, 6))
    embeds = None
    if name == "external":
        embeds = np.random.RandomState(4).randn(
            2, jcfg.model.external_speaker_dim).astype(np.float32)
    buckets = dict(text_buckets=(8, 16), mel_buckets=(32, 64, 128))
    jsynth = JSynth(jcfg, params, None, T=1, compute_dtype=jnp.float32,
                    **buckets)
    mel_r, lens_r, _ = jsynth(seqs, spker_embeds=embeds, seed=5)
    x_T, noise = jax_draws(5, mel_r.shape, jsynth.sched.sigma_max, 0)
    tsynth = TSynth(tcfg, load_torch_cm(path, tcfg), None, T=1,
                    compute_dtype=torch.float32, device="cpu", **buckets)
    mel, lens, _ = tsynth(seqs, spker_embeds=embeds, x_T=x_T, noise=noise)
    np.testing.assert_array_equal(lens, lens_r)
    np.testing.assert_allclose(mel, mel_r, **F32_TOL)


# -- HiFi-GAN -------------------------------------------------------------------

@pytest.mark.parametrize("width", [32, 128])
def test_hifigan_pth_tar_matches_jax(width, tmp_path):
    """A weight-normed reference ``generator_*.pth.tar`` of width 32 and of
    the V2 width (128): the port's arrays equal JAX's converter's; the
    loaded generator's plain forward matches JAX's generator and the
    generator the file was written from (its ConvTranspose1d carrying the
    reference's own weights: the taps flipped by the converter come back
    flipped by the bridge)."""
    from cmtts_tpu.models.hifigan import HiFiGANConfig as JConfig
    from cmtts_tpu.models.hifigan import HiFiGANGenerator as JGen
    from cmtts_tpu.models.hifigan import load_hifigan_params as jload

    from cmtts_tpu_torch.models.hifigan import (
        HiFiGANConfig,
        HiFiGANGenerator,
        load_hifigan,
        load_hifigan_params,
    )

    torch.manual_seed(width)
    src = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=width,
                                         num_mels=16)).eval()
    path = str(tmp_path / "generator_LJSpeech.pth.tar")
    torch.save({"generator": hifigan_reference_state_dict(src)}, path)
    tree = load_hifigan_params(path)
    assert_trees_equal(tree, jload(path))
    gen = load_hifigan(path)
    assert gen.cfg.upsample_initial_channel == width
    torch.testing.assert_close(gen.up_0.weight, src.up_0.weight,
                               rtol=1e-6, atol=1e-7)
    mel = np.random.RandomState(1).randn(2, 6, 16).astype(np.float32)
    with torch.no_grad():
        out = gen(torch.from_numpy(mel)).numpy()
        ref_torch = src(torch.from_numpy(mel)).numpy()
    ref_jax = np.asarray(jax.jit(JGen(JConfig(
        upsample_initial_channel=width)).apply)({"params": tree},
                                                jnp.asarray(mel)))
    assert out.shape == ref_jax.shape == (2, 6 * 256)
    np.testing.assert_allclose(out, ref_jax, **F32_TOL)
    np.testing.assert_allclose(out, ref_torch, **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [512, 256, 128, 64])
def test_vocoder_stage_routes(width, dtype):
    """Each MRF stage goes to a kernel whose shape predicate holds or to
    the plain stage, decided at pack time: width 512 as before, the V2
    width (128) four fused stages in both types (in bf16 its C = 8 last
    stage is padded to 16 channels), width 64 a plain last stage with its
    head (C = 4)."""
    from cmtts_tpu_torch.models.hifigan import (
        FUSED_MAX_C,
        HiFiGANConfig,
        HiFiGANGenerator,
        stage_routes,
    )
    from cmtts_tpu_torch.ops.mrf import kernel_takes

    gen = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=width))
    routes = stage_routes(gen, dtype)
    assert len(routes) == 4 and routes[-1].endswith("+head")
    assert not any(r.endswith("+head") for r in routes[:-1])
    for i, route in enumerate(routes):
        C = gen.stage_channels(i)
        takes = kernel_takes(C, dtype, (3, 7, 11), (1, 3, 5),
                             7 if i == 3 else 0)
        assert route.startswith("plain") != takes, (i, C, route)
        if route.startswith("streamed"):
            assert C > FUSED_MAX_C
    expected = {
        (512, torch.bfloat16): ["streamed", "fused", "fused", "fused+head"],
        (128, torch.bfloat16): ["fused", "fused", "fused", "fused+head"],
        (128, torch.float32): ["fused", "fused", "fused", "fused+head"],
        (64, torch.bfloat16): ["fused", "fused", "fused", "plain+head"]}
    if (width, dtype) in expected:
        assert routes == expected[(width, dtype)]


def test_hifigan_apply_fused_follows_the_route(monkeypatch):
    """``hifigan_apply_fused`` calls, stage by stage, what the pack's routes
    say (a width-64 generator in bf16: three fused, then plain with the
    head), and its output is the one without the recording."""
    from cmtts_tpu_torch.models import hifigan
    from cmtts_tpu_torch.ops import mrf

    torch.manual_seed(0)
    gen = hifigan.HiFiGANGenerator(hifigan.HiFiGANConfig(
        upsample_initial_channel=64, num_mels=16)).eval()
    packed = hifigan.pack_generator(gen, torch.bfloat16)
    mel = torch.randn(1, 5, 16)
    ref = hifigan.hifigan_apply_fused(gen, mel, packed)
    calls = []

    def recording(name, fn):
        def wrapped(x, *a, **k):
            head = k.get("post") is not None or (
                name == "plain" and a[-1] is not None)
            calls.append(name + ("+head" if head else ""))
            if name != "plain":
                assert mrf.kernel_takes(x.shape[1], torch.bfloat16)
            return fn(x, *a, **k)
        return wrapped

    for attr, name in (("fused_mrf_stage", "fused"),
                       ("fused_mrf_stage_streamed", "streamed"),
                       ("mrf_stage_plain", "plain")):
        monkeypatch.setattr(hifigan, attr,
                            recording(name, getattr(hifigan, attr)))
    out = hifigan.hifigan_apply_fused(gen, mel, packed)
    assert calls == packed.routes == ["fused", "fused", "fused",
                                      "plain+head"]
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# -- MelGAN ---------------------------------------------------------------------

def test_melgan_matches_reference_and_jax(tmp_path):
    """A melgan-neurips ``best_netG.pt`` (tests/test_melgan.py's tiny
    architecture): the port's tree equals JAX's converter's, and the port's
    generator matches the reference torch module and JAX's MelGANGenerator;
    a nested state dict converts the same, and the loader wants a path."""
    from cmtts_tpu.models.melgan import MelGANConfig as JConfig
    from cmtts_tpu.models.melgan import MelGANGenerator as JGen
    from cmtts_tpu.models.melgan import load_melgan_params as jload

    from cmtts_tpu_torch.models.melgan import (
        MelGANConfig,
        convert_torch_melgan,
        load_melgan,
        load_melgan_params,
    )

    kw = dict(ratios=(4, 4), ngf=4, n_residual_layers=2, num_mels=8)
    ref = melgan_reference_module(MelGANConfig(**kw), seed=7)
    path = str(tmp_path / "best_netG.pt")
    torch.save(ref.state_dict(), path)
    tree = load_melgan_params(path, MelGANConfig(**kw))
    assert_trees_equal(tree, jload(path, JConfig(**kw)))
    nested = {"mel2wav." + k: v.numpy() for k, v in ref.state_dict().items()}
    assert_trees_equal(convert_torch_melgan(nested, MelGANConfig(**kw)), tree)
    gen = load_melgan(path, MelGANConfig(**kw))
    mel = np.random.default_rng(3).normal(size=(2, 17, 8)).astype(np.float32)
    with torch.no_grad():
        out = gen(torch.from_numpy(mel)).numpy()
        want = ref(torch.from_numpy(mel).transpose(1, 2))[:, 0].numpy()
    ref_jax = np.asarray(JGen(JConfig(**kw)).apply({"params": tree},
                                                   jnp.asarray(mel)))
    assert out.shape == (2, 17 * 16)
    np.testing.assert_allclose(out, want, **MELGAN_TOL)
    np.testing.assert_allclose(out, ref_jax, **MELGAN_TOL)
    with pytest.raises(FileNotFoundError, match="--vocoder_ckpt"):
        load_melgan(None)


def test_synthesizer_with_melgan_matches_jax(cm_trees, tmp_path):
    """The ``Synthesizer`` with a MelGAN (the published ratios and ngf, 16
    mels) feeds it mel / ln 10 as JAX's does: wavs on injected x_T."""
    from cmtts_tpu.pipeline import Synthesizer as JSynth

    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.cmtts import CMTTS
    from cmtts_tpu_torch.models.melgan import (
        MelGANConfig,
        load_melgan,
        load_melgan_params,
    )
    from cmtts_tpu_torch.pipeline import Synthesizer as TSynth

    jcfg, tcfg, params, _ = cm_trees["single"]
    mcfg = MelGANConfig(num_mels=16)
    path = str(tmp_path / "best_netG.pt")
    torch.save(melgan_reference_module(mcfg, seed=2).state_dict(), path)
    voc = load_melgan(path, mcfg)
    seqs = tokens(np.random.RandomState(8), (7,))
    buckets = dict(text_buckets=(8,), mel_buckets=(32, 64, 128))
    jsynth = JSynth(jcfg, params, load_melgan_params(path, mcfg), T=1,
                    compute_dtype=jnp.float32, vocoder_name="MelGAN",
                    **buckets)
    mel_r, lens_r, wav_r = jsynth(seqs, seed=9)
    x_T, _ = jax_draws(9, mel_r.shape, jsynth.sched.sigma_max, 0)
    tsynth = TSynth(tcfg, load_flax_params(CMTTS(tcfg), params), voc, T=1,
                    compute_dtype=torch.float32, device="cpu", **buckets)
    mel, lens, wav = tsynth(seqs, x_T=x_T)
    np.testing.assert_array_equal(lens, lens_r)
    assert wav.shape == wav_r.shape == (1, mel.shape[1] * 256)
    np.testing.assert_allclose(wav, wav_r, **F32_TOL)


# -- speaker embedders ----------------------------------------------------------

@pytest.fixture(scope="module")
def ge2e_flax():
    """A GE2E flax tree of the encoder's shapes (3 layers of 256, 40 mel
    channels in), random from a seed, gate biases included."""
    rs = np.random.RandomState(3)

    def w(*shape):
        return (rs.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)

    params = {}
    for k, n_in in enumerate((40, 256, 256)):
        params[f"lstm_{k}"] = {}
        for g in "ifgo":
            params[f"lstm_{k}"][f"i{g}"] = {"kernel": w(n_in, 256)}
            params[f"lstm_{k}"][f"h{g}"] = {"kernel": w(256, 256),
                                            "bias": 0.1 * w(256)}
    params["proj"] = {"kernel": w(256, 256), "bias": 0.1 * w(256)}
    return params


def ge2e_reference_state_dict(params, rs):
    """torch ``SpeakerEncoder.state_dict()`` holding the flax tree, the
    gate biases split at random between ``bias_ih`` and ``bias_hh``."""
    sd = {}
    for k in range(3):
        cell = params[f"lstm_{k}"]
        sd[f"lstm.weight_ih_l{k}"] = np.concatenate(
            [cell[f"i{g}"]["kernel"].T for g in "ifgo"])
        sd[f"lstm.weight_hh_l{k}"] = np.concatenate(
            [cell[f"h{g}"]["kernel"].T for g in "ifgo"])
        b = np.concatenate([cell[f"h{g}"]["bias"] for g in "ifgo"])
        part = (0.05 * rs.randn(*b.shape)).astype(np.float32)
        sd[f"lstm.bias_ih_l{k}"], sd[f"lstm.bias_hh_l{k}"] = b - part, part
    sd["linear.weight"] = params["proj"]["kernel"].T
    sd["linear.bias"] = params["proj"]["bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


@pytest.mark.parametrize("fmt", ["pt", "npy"])
def test_ge2e_reference_formats(ge2e_flax, fmt, tmp_path):
    """GE2E's torch ``encoder.pt`` (``model_state``) and the in-repo
    trainer's ``.npy``: the port's tree equals JAX's loader's, and the
    embeddings match JAX's encoder."""
    from cmtts_tpu.models.speaker import GE2EEncoder as JEnc
    from cmtts_tpu.models.speaker import load_ge2e_params as jload

    from cmtts_tpu_torch.models.speaker import (
        ge2e_from_checkpoint,
        load_ge2e_params,
    )

    if fmt == "pt":
        path = str(tmp_path / "encoder.pt")
        torch.save({"model_state": ge2e_reference_state_dict(
            ge2e_flax, np.random.RandomState(5)), "step": 10}, path)
    else:
        path = str(tmp_path / "ge2e_params.npy")
        np.save(path, np.asarray([{"encoder": ge2e_flax, "sim_weight": 10.0,
                                   "sim_bias": -5.0}], dtype=object),
                allow_pickle=True)
    tree = load_ge2e_params(path)
    assert_trees_equal(tree, jload(path))
    frames = np.random.RandomState(6).rand(2, 50, 40).astype(np.float32)
    ref = np.asarray(JEnc().apply({"params": tree}, jnp.asarray(frames)))
    with torch.no_grad():
        out = ge2e_from_checkpoint(path)(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=GE2E_ATOL)


def test_deepspeaker_keras_h5(tmp_path):
    """A Keras ResCNN ``.h5`` laid out as ``convert_keras_deepspeaker_h5``
    reads it (``model_weights/<layer>/<layer>/kernel:0``): the port's copy
    and JAX's give the same trees, which load strictly into the port."""
    h5py = pytest.importorskip("h5py")
    from cmtts_tpu.models.speaker import convert_keras_deepspeaker_h5 as jconv

    from cmtts_tpu_torch.models.speaker import (
        DeepSpeakerResCNN,
        convert_keras_deepspeaker_h5,
        deepspeaker_from_checkpoint,
    )

    rs = np.random.RandomState(0)
    path = str(tmp_path / "ResCNN.h5")
    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")

        def layer(name, **arrays):
            g = root.create_group(name).create_group(name)
            for k, shape in arrays.items():
                g[f"{k}:0"] = (0.05 * rs.randn(*shape)).astype(np.float32)

        def bn(name, c):
            layer(name, gamma=(c,), beta=(c,), moving_mean=(c,),
                  moving_variance=(c,))
            v = root[name][name]["moving_variance:0"]
            v[...] = np.abs(v[...]) + 0.5

        cin = 1
        for i, c in enumerate((64, 128, 256, 512)):
            layer(f"conv{c}-s", kernel=(5, 5, cin, c), bias=(c,))
            bn(f"conv{c}-s_bn", c)
            for b in range(3):
                base = f"res{i + 1}_{b}_branch"
                for s in ("_2a", "_2b"):
                    layer(base + s, kernel=(3, 3, c, c), bias=(c,))
                    bn(base + s + "_bn", c)
            cin = c
        layer("affine", kernel=(512 * 4, 512), bias=(512,))
    params, stats = convert_keras_deepspeaker_h5(path)
    jparams, jstats = jconv(path)
    assert_trees_equal(params, jparams)
    assert_trees_equal(stats, jstats)
    model = deepspeaker_from_checkpoint(path).eval()
    assert isinstance(model, DeepSpeakerResCNN)
    torch.testing.assert_close(
        model.stage_3.res_2.bn_b.running_var,
        torch.from_numpy(stats["stage_3"]["res_2"]["bn_b"]["var"]))


# -- CLIs -----------------------------------------------------------------------

@pytest.fixture
def tiny_run(tmp_path, cm_trees):
    """(config root, tmp dir, reference .pt paths): a tiny config whose
    corpus (10 train, 2 val), checkpoints and results live under tmp, and
    reference model / target / ema files of the flax-initialised CM."""
    from cmtts_tpu_torch.data.feature_corpus import write_feature_corpus

    pre, model, _, stats = config_dicts()
    train = {"path": {k: str(tmp_path / k) for k in
                      ("ckpt_path", "log_path", "result_path")},
             "optimizer": {"batch_size": 2},
             "step": {"save_step": 1, "log_step": 1}}
    root = write_config(tmp_path, "Tiny", (pre, model, train, stats))
    write_feature_corpus(str(tmp_path / "pre"), 10, 2, seed=0, n_mels=16,
                         phonemes=(5, 12), frames=(1, 4))
    _, _, params, sd = cm_trees["single"]
    paths = {}
    for i, role in enumerate(("model", "target_model", "ema_0.9999_")):
        paths[role] = str(tmp_path / f"{role}000100.pt")
        save_torch(paths[role], {k: v * (1 + 0.01 * i)
                                 for k, v in sd.items()})
    return root, tmp_path, paths


def test_convert_checkpoint_synthesize_and_distil(tiny_run, capsys):
    """``cli.convert_checkpoint`` writes a committed step directory (model,
    target, the given EMA and the model in the missing ones, a fresh RAdam
    state) and a HiFi-GAN npz; ``cli.synthesize --restore_step`` reads it
    and gives the mel of the ``.pt`` loaded directly; ``cli.train_cm``
    resumes from it and distils from the ``.pt``, one step each."""
    from cmtts_tpu.models.hifigan import load_hifigan_params as jload

    from cmtts_tpu_torch.cli.convert_checkpoint import main as convert
    from cmtts_tpu_torch.cli.synthesize import main as synthesize
    from cmtts_tpu_torch.cli.train_cm import main as train
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.from_torch import load_torch_cm
    from cmtts_tpu_torch.models.hifigan import (
        HiFiGANConfig,
        HiFiGANGenerator,
        unflatten_npz,
    )
    from cmtts_tpu_torch.train.checkpoint import restore_checkpoint

    root, tmp, paths = tiny_run
    torch.manual_seed(0)
    voc_pt = str(tmp / "generator_LJSpeech.pth.tar")
    torch.save({"generator": hifigan_reference_state_dict(HiFiGANGenerator(
        HiFiGANConfig(upsample_initial_channel=32, num_mels=16)))}, voc_pt)
    written = convert(["--dataset", "Tiny", "--config_root", root,
                       "--model_pt", paths["model"],
                       "--target_pt", paths["target_model"],
                       "--ema_pt", paths["ema_0.9999_"],
                       "--hifigan_pt", voc_pt,
                       "--hifigan_out", str(tmp / "gen.npz")])
    assert written["model"].endswith("step_00000100")
    assert_trees_equal(unflatten_npz(str(tmp / "gen.npz")), jload(voc_pt))
    cfg = load_configs("Tiny", root)
    payload = restore_checkpoint(str(tmp / "ckpt_path"), 100)
    assert int(payload["step"]) == 100 and payload["opt"]["count"] == 0
    for role, src in (("model", "model"), ("target_model", "target_model"),
                      ("ema_0", "ema_0.9999_"), ("ema_1", "model"),
                      ("ema_2", "model")):
        want = dict(load_torch_cm(paths[src], cfg).named_parameters())
        assert set(payload[role]) == set(want)
        for k, v in want.items():
            torch.testing.assert_close(payload[role][k], v.detach(),
                                       rtol=0, atol=0)
    assert all(torch.count_nonzero(v) == 0
               for v in payload["opt"]["mu"].values())

    common = ["--mode", "single", "--text", "Hello world.", "--dataset",
              "Tiny", "--config_root", root, "--vocoder_ckpt",
              str(tmp / "gen.npz"), "--device", "cpu"]
    out_dir = synthesize(common + ["--restore_step", "100"])
    assert out_dir == os.path.join(str(tmp / "result_path") + "_cm",
                                   "step_100_T1")
    direct = synthesize(common + ["--params", paths["model"], "--out_dir",
                                  str(tmp / "direct")])
    mel = np.load(os.path.join(out_dir, "single-mel.npy"))
    np.testing.assert_array_equal(
        mel, np.load(os.path.join(direct, "single-mel.npy")))
    assert os.path.exists(os.path.join(out_dir, "single.wav"))

    r = train(["--model", "consistency_training", "--dataset", "Tiny",
               "--config_root", root, "--device", "cpu", "--restore_step",
               "100", "--total_step", "101"])
    assert r["start_step"] == 100 and r["state"].step == 101
    assert np.isfinite(r["losses"]).all()
    r = train(["--model", "consistency_distillation", "--teacher_path",
               paths["model"], "--dataset", "Tiny", "--config_root", root,
               "--device", "cpu", "--total_step", "1", "--path_tag", "cd"])
    assert "loaded teacher from" in capsys.readouterr().out
    assert r["state"].step == 1 and np.isfinite(r["losses"]).all()
