"""The port's speaker embedders against ``cmtts_tpu.models.speaker``: the
DeepSpeaker ResCNN and the GE2E LSTM at full width on flax-initialised
weights carried across by the bridge (BatchNorm statistics included),
the host front-ends exactly, and the config-selected embedder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import both_configs, save_flat_npz

# float32; the unit vectors pass 16 conv layers (DeepSpeaker) or three
# 160-step LSTM layers (GE2E) summed in other orders by XLA and ATen
DS_ATOL = 1e-4
GE2E_ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.asarray(a))


def perturb_bn(params, stats, rs):
    """Give every BatchNorm a non-trivial affine map and running moments
    (flax init leaves scale 1, bias 0, mean 0, var 1)."""
    for k, v in params.items():
        if isinstance(v, dict) and "scale" in v:
            v["scale"] = (1 + 0.1 * rs.randn(*v["scale"].shape)).astype(
                np.float32)
            v["bias"] = (0.1 * rs.randn(*v["bias"].shape)).astype(np.float32)
            s = stats[k]
            s["mean"] = (0.1 * rs.randn(*s["mean"].shape)).astype(np.float32)
            s["var"] = rs.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)
        elif isinstance(v, dict) and k in stats:
            perturb_bn(v, stats[k], rs)


def speech_like(seconds=1.5, sr=22050, seed=0):
    """A voiced-looking test signal: a harmonic tone gated on and off, with
    noise, and silence at both ends."""
    rs = np.random.RandomState(seed)
    n = int(seconds * sr)
    tt = np.arange(n) / sr
    tone = sum(np.sin(2 * np.pi * 140 * h * tt) / h for h in (1, 2, 3))
    gate = (np.sin(2 * np.pi * 3 * tt) > -0.3).astype(np.float32)
    wav = 0.3 * tone * gate + 0.01 * rs.randn(n)
    wav[: sr // 10] = 0.0
    wav[-sr // 10:] = 0.0
    return wav.astype(np.float32)


@pytest.fixture(scope="module")
def deepspeaker_vars():
    """flax-initialised DeepSpeaker variables with perturbed BatchNorms."""
    from cmtts_tpu.models.speaker import DeepSpeakerResCNN

    v = jax.jit(DeepSpeakerResCNN().init)(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 160, 64, 1)))
    v = jax.tree_util.tree_map(np.array, dict(v))
    perturb_bn(v["params"], v["batch_stats"], np.random.RandomState(1))
    return v


@pytest.fixture(scope="module")
def ge2e_params():
    """flax-initialised GE2E params with non-zero gate biases."""
    from cmtts_tpu.models.speaker import GE2EEncoder

    params = jax.tree_util.tree_map(np.array, jax.jit(GE2EEncoder().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 160, 40)))["params"])
    rs = np.random.RandomState(3)
    for cell in ("lstm_0", "lstm_1", "lstm_2"):   # init leaves them at 0
        for g in "ifgo":
            b = params[cell][f"h{g}"]
            b["bias"] = (0.1 * rs.randn(*b["bias"].shape)).astype(np.float32)
    return params


def test_deepspeaker_full_width(deepspeaker_vars):
    from cmtts_tpu.models.speaker import DeepSpeakerResCNN as J
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.speaker import DeepSpeakerResCNN as T

    params, stats = deepspeaker_vars["params"], deepspeaker_vars["batch_stats"]
    x = np.random.RandomState(2).randn(2, 160, 64, 1).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, x: J().apply(v, x, train=False))(
        deepspeaker_vars, jnp.asarray(x)))
    model = load_flax_params(T(), params, stats).eval()
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves((params, stats)))
    n_torch = sum(v.numel() for k, v in model.state_dict().items()
                  if not k.endswith("num_batches_tracked"))
    assert n_flax == n_torch
    with torch.no_grad():
        out = model(t(x)).numpy()
    assert out.shape == (2, 512)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=0, atol=DS_ATOL)


def test_ge2e_full_width(ge2e_params):
    from cmtts_tpu.models.speaker import GE2EEncoder as J
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.speaker import GE2EEncoder as T

    params = ge2e_params
    assert sorted(params) == ["lstm_0", "lstm_1", "lstm_2", "proj"]
    mels = np.random.RandomState(4).rand(3, 160, 40).astype(np.float32)
    ref = np.asarray(jax.jit(J().apply)({"params": params}, jnp.asarray(mels)))
    model = load_flax_params(T(), params).eval()
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["lstm.bias_hh_l1"].numpy(), 0.0)
    np.testing.assert_array_equal(
        sd["lstm.weight_ih_l2"][512:768].numpy(),
        params["lstm_2"]["ig"]["kernel"].T)
    with torch.no_grad():
        out = model(t(mels)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=GE2E_ATOL)


def test_host_front_ends_exact():
    from cmtts_tpu.models import speaker as js
    from cmtts_tpu_torch.models import speaker as ts

    wav = speech_like(2.0)
    for name in ("ds_fbank_frames", "ge2e_mel_frames"):
        np.testing.assert_array_equal(getattr(ts, name)(wav),
                                      getattr(js, name)(wav))
    frames = js.ds_fbank_frames(wav)
    for f in (frames, frames[:70]):   # crop, and tile a short utterance
        np.testing.assert_array_equal(ts.ds_sample_frames(f),
                                      js.ds_sample_frames(f))
        np.testing.assert_array_equal(
            ts.ds_sample_frames(f, rng=np.random.RandomState(4)),
            js.ds_sample_frames(f, rng=np.random.RandomState(4)))
    for n in (100, 5000, 22050, 35280, 66150, 100000):
        assert ts.compute_partial_slices(n) == js.compute_partial_slices(n)
    for kw in ({}, {"increase_only": True}, {"decrease_only": True}):
        for w in (wav, wav * 20):
            np.testing.assert_array_equal(ts.normalize_volume(w, -30.0, **kw),
                                          js.normalize_volume(w, -30.0, **kw))
    for w in (wav, wav[:3000], wav[:500], np.zeros(100, np.float32)):
        np.testing.assert_array_equal(ts.trim_silences_energy(w),
                                      js.trim_silences_energy(w))


@pytest.mark.parametrize("kind", ["DeepSpeaker", "GE2E"])
def test_predefined_embedder(kind, tmp_path, deepspeaker_vars, ge2e_params):
    """The config-selected embedder on a wav, loaded from a flat npz of the
    flax variables, against the JAX inference class that JAX's
    ``PreDefinedEmbedder`` wraps (GE2E through ``embed_utterance``'s
    partials)."""
    from cmtts_tpu.models.speaker import DeepSpeakerInference, GE2EInference
    from cmtts_tpu_torch.models.speaker import (
        PreDefinedEmbedder,
        get_deep_speaker_emb,
    )

    _, tcfg = both_configs(speaker_embedder=kind)
    wav = speech_like(3.0, seed=5)
    if kind == "DeepSpeaker":
        tree, dim, atol = deepspeaker_vars, 512, DS_ATOL
        ref = DeepSpeakerInference(deepspeaker_vars["params"],
                                   deepspeaker_vars["batch_stats"]
                                   ).predict_embedding(wav)
    else:
        tree, dim, atol = ge2e_params, 256, GE2E_ATOL
        ref = GE2EInference(ge2e_params).embed_utterance(wav)
    ckpt = str(tmp_path / "emb.npz")
    save_flat_npz(ckpt, tree)
    out = PreDefinedEmbedder(tcfg, ckpt, device="cpu")(wav)
    assert out.shape == (dim,)
    np.testing.assert_allclose(np.linalg.norm(out), 1.0, rtol=1e-5)
    np.testing.assert_allclose(out, ref, rtol=0, atol=atol)
    np.testing.assert_array_equal(get_deep_speaker_emb(wav, tcfg, ckpt, "cpu"),
                                  out)


def test_embedder_without_checkpoint_and_device():
    from cmtts_tpu_torch.models.speaker import (
        GE2EEncoder,
        GE2EInference,
        PreDefinedEmbedder,
    )

    _, tcfg = both_configs(speaker_embedder="GE2E")
    with pytest.warns(UserWarning, match="random weights"):
        emb = PreDefinedEmbedder(tcfg, device="cpu")
    a = emb(speech_like(1.0))
    with pytest.warns(UserWarning, match="random weights"):
        b = PreDefinedEmbedder(tcfg, device="cpu")(speech_like(1.0))
    np.testing.assert_array_equal(a, b)   # the seed fixes the weights
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GE2EInference(GE2EEncoder())
    _, none_cfg = both_configs(speaker_embedder="none")
    with pytest.raises(ValueError, match="unknown speaker embedder"):
        PreDefinedEmbedder(none_cfg, device="cpu")


# The DeepSpeaker front end in torch (``DeepSpeakerFrontEnd``, what
# ``DeepSpeakerInference`` embeds through) against the numpy copy in the
# JAX package, float32 on both sides.  Largest deviation of the
# standardised features measured on the CPU: 2.9e-6 (3 s), 2.6e-6 (2 s),
# 1.5e-6 (0.5 s), 1.2e-5 over 500-sample clips of six seeds, 0 for one
# frame: the FFT, the fbank product and the reductions round in other
# orders than numpy's.
FRONT_END_ATOL = 1e-4
FRONT_END_CLIPS = {
    "3s": lambda: speech_like(3.0, seed=5),
    "2s": lambda: speech_like(2.0),
    "0.5s_tiled": lambda: speech_like(0.5),
    # shorter than the 512-sample reflect pad: numpy reflects again
    "500_samples": lambda: speech_like(1.0)[5000:5500],
    "100_samples_one_frame": lambda: speech_like(1.0)[5000:5100],
    "1_sample": lambda: np.array([0.3], np.float32),
}


@pytest.mark.parametrize("clip", list(FRONT_END_CLIPS))
def test_deepspeaker_front_end_matches_numpy(clip):
    from cmtts_tpu.models import speaker as js
    from cmtts_tpu_torch.models.speaker import DeepSpeakerFrontEnd

    wav = FRONT_END_CLIPS[clip]()
    got = DeepSpeakerFrontEnd(22050, torch.device("cpu"))(wav)
    assert got.shape == (1, 160, 64, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got[0, :, :, 0].numpy(),
                               js.ds_sample_frames(js.ds_fbank_frames(wav)),
                               rtol=0, atol=FRONT_END_ATOL)


def test_deepspeaker_front_end_two_frames_and_empty():
    """A clip of 221-439 samples has two frames, so each feature is +-1
    from a bin's two values and their spread.  The log fbank agrees to an
    ulp (9.5e-7 measured, at -5.6 to -10.6); a bin whose two values differ
    by 1.3e-3 turns numpy's float32 mean, rounded by half an ulp, into
    1.00037 / -0.99963 where torch gives +-0.99999845 (3.7e-4).  An empty
    clip fails as numpy's reflect pad fails."""
    from cmtts_tpu.audio.stft import mel_filterbank, stft_magnitudes
    from cmtts_tpu.models import speaker as js
    from cmtts_tpu_torch.models.speaker import DeepSpeakerFrontEnd

    fe = DeepSpeakerFrontEnd(22050, torch.device("cpu"))
    wav = speech_like(1.0, seed=2)[5000:5300]
    mag = stft_magnitudes(wav, n_fft=1024, win_length=551, hop_length=220)
    want = np.log(np.maximum((mag ** 2) @ mel_filterbank(
        22050, 1024, 64, fmin=0.0, fmax=11025.0).T, 1e-10))
    got = fe.log_fbank(wav).numpy()
    assert got.shape == want.shape == (2, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(fe(wav)[0, :, :, 0].numpy(),
                               js.ds_sample_frames(js.ds_fbank_frames(wav)),
                               rtol=0, atol=1e-3)
    empty = np.zeros(0, np.float32)
    with pytest.raises(ValueError, match="can't extend empty axis") as e:
        js.ds_fbank_frames(empty)
    with pytest.raises(ValueError, match=str(e.value)):
        fe(empty)


def test_deepspeaker_embedding_counts_and_front_end_on_torch(
        deepspeaker_vars):
    """``embed.calls`` counts each embedding, ``embed.fbank_device`` none
    on the CPU; the embedding is the ResCNN's on the numpy features
    within the benchmark's ``embed_err`` limit (5e-5; 6e-7 measured on
    the cell's voices)."""
    from cmtts_tpu.models import speaker as js
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.core import trace
    from cmtts_tpu_torch.models.speaker import (
        DeepSpeakerInference,
        DeepSpeakerResCNN,
    )

    model = load_flax_params(DeepSpeakerResCNN(), deepspeaker_vars["params"],
                             deepspeaker_vars["batch_stats"])
    ds = DeepSpeakerInference(model, "cpu")
    before = trace.counters()
    for seed in (5, 6):
        wav = speech_like(3.0, seed=seed)
        emb = ds.predict_embedding(wav)
        with torch.no_grad():
            want = ds.model(t(js.ds_sample_frames(js.ds_fbank_frames(wav))
                              [None, :, :, None]))[0].numpy()
        assert np.linalg.norm(emb - want) / np.linalg.norm(want) < 5e-5
    after = trace.counters()
    assert after["embed.calls"] - before.get("embed.calls", 0) == 2
    assert after.get("embed.fbank_device", 0) == before.get(
        "embed.fbank_device", 0)


def test_deepspeaker_front_end_feeds_the_rescnn_nchw():
    """The ResCNN's convs run in NCHW on the front end's tensor, as on a
    copied numpy array: a contiguous (1, 160, 64, 1) permutes to strides
    that read as channels_last, which the convs would carry through."""
    from cmtts_tpu_torch.models.speaker import (
        DeepSpeakerFrontEnd,
        DeepSpeakerResCNN,
        _same_pad,
    )

    x = DeepSpeakerFrontEnd(22050, torch.device("cpu"))(speech_like(3.0))
    conv = DeepSpeakerResCNN().stage_0.conv
    with torch.no_grad():
        y = conv(_same_pad(x.permute(0, 3, 1, 2), 5, 2))
    assert y.is_contiguous()
    assert not y.is_contiguous(memory_format=torch.channels_last)
