"""Per-module parity of the PyTorch port against the JAX package on the
same inputs (made with numpy from a seed) and the same weights (a flax
init converted by the bridge), in float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import both_configs, flax_cm_params, padded, tokens, torch_cm

# float32 end to end; the tolerances absorb summation order (matmuls,
# convs and LayerNorm reductions run in other orders in XLA and ATen)
RTOL, ATOL = 1e-4, 1e-4


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = both_configs()
    params = flax_cm_params(jcfg)
    return jcfg, tcfg, params, torch_cm(tcfg, params)


def test_karras_scalings_and_rescale_t():
    from cmtts_tpu.cm.karras import KarrasSchedule as JS
    from cmtts_tpu_torch.cm.karras import KarrasSchedule as TS

    sigma = np.array([0.002, 0.01, 0.5, 3.0, 80.0], np.float32)
    js, ts = JS(), TS()
    for jf, tf in ((js.scalings, ts.scalings),
                   (js.boundary_scalings, ts.boundary_scalings)):
        for a, b in zip(jf(jnp.asarray(sigma)), tf(t(sigma))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    np.testing.assert_allclose(ts.rescale_t(t(sigma)).numpy(),
                               np.asarray(js.rescale_t(jnp.asarray(sigma))),
                               rtol=1e-6)
    for ts_ in ((0, 0, 1), (0, 0, 0, 0, 1)):
        np.testing.assert_allclose(ts.ts_grid(ts_, 2).numpy(),
                                   np.asarray(js.ts_grid(ts_, 2)), rtol=1e-6)


def test_schedule_from_config():
    from cmtts_tpu.train.loop import schedule_from_config as jsfc
    from cmtts_tpu_torch.cm.karras import schedule_from_config as tsfc

    jcfg, tcfg = both_configs()
    assert vars(jsfc(jcfg)) == vars(tsfc(tcfg))


def test_pitch_functions():
    from cmtts_tpu.audio import pitch as jp
    from cmtts_tpu_torch.audio import pitch as tp

    rs = np.random.RandomState(0)
    f0 = np.concatenate([[0.0, 50.0, 1100.0, 2000.0],
                         rs.uniform(40, 600, 60)]).astype(np.float32)
    np.testing.assert_array_equal(
        tp.f0_to_coarse(t(f0)).numpy(), np.asarray(jp.f0_to_coarse_jnp(f0)))

    cwt = rs.randn(2, 40, 10).astype(np.float32)
    mask = np.arange(40)[None, :] < np.array([[40], [23]])
    np.testing.assert_allclose(
        tp.inverse_cwt(t(cwt)).numpy(),
        np.asarray(jp.inverse_cwt_jnp(jnp.asarray(cwt))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tp.inverse_cwt(t(cwt), t(mask)).numpy(),
        np.asarray(jp.inverse_cwt_jnp(jnp.asarray(cwt), jnp.asarray(mask))),
        rtol=1e-5, atol=1e-5)
    mean = np.array([5.3, 5.6], np.float32)
    std = np.array([0.2, 0.3], np.float32)
    for t_mel in (30, 40, 55):
        np.testing.assert_allclose(
            tp.cwt2f0_norm(t(cwt), t(mean), t(std), t_mel, "log", 0.0, 1.0,
                           1e-9).numpy(),
            np.asarray(jp.cwt2f0_norm_jnp(jnp.asarray(cwt), mean, std, t_mel,
                                          "log", 0.0, 1.0, 1e-9)),
            rtol=1e-5, atol=1e-5)
    uv = (rs.rand(2, 40) > 0.6).astype(np.float32)
    f0n = rs.randn(2, 40).astype(np.float32)
    np.testing.assert_allclose(
        tp.denorm_f0(t(f0n), t(uv), "log", 0.0, 1.0, True).numpy(),
        np.asarray(jp.denorm_f0_jnp(f0n, uv, "log", 0.0, 1.0, True)),
        rtol=1e-6)


def test_masks():
    from cmtts_tpu.core import masks as jm
    from cmtts_tpu_torch.core import masks as tm

    lens = np.array([0, 3, 7, 9], np.int32)
    np.testing.assert_array_equal(tm.length_mask(t(lens), 7).numpy(),
                                  np.asarray(jm.length_mask(lens, 7)))
    assert tm.DEFAULT_TEXT_BUCKETS == jm.DEFAULT_TEXT_BUCKETS
    assert tm.DEFAULT_MEL_BUCKETS == jm.DEFAULT_MEL_BUCKETS
    for n in (1, 32, 33, 5000):
        assert (tm.pick_bucket(n, tm.DEFAULT_MEL_BUCKETS)
                == jm.pick_bucket(n, jm.DEFAULT_MEL_BUCKETS))
    x = np.arange(12).reshape(3, 4)
    for target in (2, 4, 6):
        np.testing.assert_array_equal(tm.pad_to(x, target, axis=1),
                                      jm.pad_to(x, target, axis=1))


def test_encoder(tiny):
    from cmtts_tpu.models.encoder import FFTEncoder
    from cmtts_tpu.text.symbols import VOCAB_SIZE

    jcfg, tcfg, params, model = tiny
    texts, lens = padded(tokens(np.random.RandomState(1), [12, 7]), 16)
    pad = np.arange(16)[None, :] >= lens[:, None]
    ref = FFTEncoder(jcfg.model.transformer, VOCAB_SIZE,
                     jcfg.model.max_seq_len).apply(
        {"params": params["encoder"]}, jnp.asarray(texts), jnp.asarray(pad))
    with torch.no_grad():
        out = model.encoder(t(texts).long(), t(pad))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("masked_std", [False, True])
def test_variance_adaptor(tiny, masked_std):
    from cmtts_tpu.models.variance import VarianceAdaptor

    params = tiny[2]
    jcfg, tcfg = both_configs(cwt_masked_std=masked_std)
    model = torch_cm(tcfg, params)
    rs = np.random.RandomState(2)
    lens = np.array([16, 9], np.int32)
    pad = np.arange(16)[None, :] >= lens[:, None]
    x = (rs.randn(2, 16, 32) * (~pad)[..., None]).astype(np.float32)
    mc = jcfg.model
    ref = VarianceAdaptor(mc.transformer, mc.variance_predictor,
                          mc.variance_embedding, jcfg.pitch,
                          jcfg.energy).apply(
        {"params": params["variance_adaptor"]}, jnp.asarray(x),
        jnp.asarray(pad), 128)
    with torch.no_grad():
        out = model.variance_adaptor(t(x), t(pad), 128)
    np.testing.assert_array_equal(out["mel2ph"].numpy(),
                                  np.asarray(ref["mel2ph"]))
    np.testing.assert_array_equal(out["mel_lens"].numpy(),
                                  np.asarray(ref["mel_lens"]))
    assert 0 < out["mel_lens"].min() < 128
    np.testing.assert_allclose(out["log_d_pred"].numpy(),
                               np.asarray(ref["log_d_pred"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(out["e_pred"].numpy(),
                               np.asarray(ref["e_pred"]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["cond"].numpy(), np.asarray(ref["cond"]),
                               rtol=RTOL, atol=ATOL)


def test_dur_to_mel2ph_and_gather():
    from cmtts_tpu.models import variance as jv
    from cmtts_tpu_torch.models import variance as tv

    rs = np.random.RandomState(3)
    dur = rs.uniform(0, 6, (3, 9)).astype(np.float32)
    dur[0, 0] = 2.5  # half to even in both
    pad = np.arange(9)[None, :] >= np.array([[9], [5], [1]])
    m_ref = np.asarray(jv.dur_to_mel2ph(jnp.asarray(dur), jnp.asarray(pad), 30))
    m = tv.dur_to_mel2ph(t(dur), t(pad), 30)
    np.testing.assert_array_equal(m.numpy(), m_ref)
    x = rs.randn(3, 9, 4).astype(np.float32)
    m_bad = m_ref.copy()
    m_bad[0, -1] = 40  # out of range: clipped to the last phone
    np.testing.assert_array_equal(
        tv.gather_by_mel2ph(t(x), t(m_bad)).numpy(),
        np.asarray(jv.gather_by_mel2ph(jnp.asarray(x), jnp.asarray(m_bad))))


def test_denoiser(tiny):
    from cmtts_tpu.models.denoiser import Denoiser

    jcfg, tcfg, params, model = tiny
    rs = np.random.RandomState(4)
    x = rs.randn(2, 24, 16).astype(np.float32)
    steps = np.array([1095.5, -310.2], np.float32)
    cond = rs.randn(2, 24, 32).astype(np.float32)
    ref = Denoiser(jcfg.model.denoiser, 16, False).apply(
        {"params": params["denoiser"]}, jnp.asarray(x), jnp.asarray(steps),
        jnp.asarray(cond))
    with torch.no_grad():
        out = model.denoiser(t(x), t(steps), t(cond))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_cmtts_condition_and_denoise(tiny):
    from cmtts_tpu.models.cmtts import CMTTS

    jcfg, tcfg, params, model = tiny
    texts, lens = padded(tokens(np.random.RandomState(5), [14, 9]), 16)
    ref = CMTTS(jcfg).apply(
        {"params": params}, speakers=jnp.zeros(2, jnp.int32),
        texts=jnp.asarray(texts), src_lens=jnp.asarray(lens), t_mel=128,
        method=CMTTS.condition)
    with torch.no_grad():
        out = model.condition(t(texts).long(), t(lens).long(), 128)
    np.testing.assert_array_equal(out["mel_lens"].numpy(),
                                  np.asarray(ref["mel_lens"]))
    np.testing.assert_allclose(out["cond"].numpy(), np.asarray(ref["cond"]),
                               rtol=RTOL, atol=ATOL)
    rs = np.random.RandomState(6)
    x = rs.randn(2, 128, 16).astype(np.float32)
    steps = np.array([1095.5, 1095.5], np.float32)
    ref_d = CMTTS(jcfg).apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(steps), ref["cond"], None,
                              method=CMTTS.denoise)
    with torch.no_grad():
        out_d = model.denoise(t(x), t(steps), out["cond"])
    np.testing.assert_allclose(out_d.numpy(), np.asarray(ref_d), rtol=RTOL,
                               atol=ATOL)
    with torch.no_grad():  # forward = condition + denoise
        out_f, cond_f = model(t(x), t(steps), t(texts).long(), t(lens).long())
    np.testing.assert_array_equal(out_f.numpy(), out_d.numpy())
    np.testing.assert_array_equal(cond_f["mel2ph"].numpy(),
                                  np.asarray(ref["mel2ph"]))


def test_bridge_cmtts_strict_roundtrip(tiny):
    """Every flax leaf lands in exactly one torch tensor (strict load), and
    the element counts agree."""
    jcfg, tcfg, params, model = tiny
    n_flax = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(params))
    n_torch = sum(v.numel() for v in model.state_dict().values())
    assert n_flax == n_torch
    sd = model.state_dict()
    np.testing.assert_array_equal(
        sd["encoder.block_0.attn.k.weight"].numpy(),
        params["encoder"]["block_0"]["attn"]["qkv"]["kernel"][:, 32:64].T)
    np.testing.assert_array_equal(
        sd["denoiser.blocks.2.conv_gate.weight"].numpy(),
        np.transpose(params["denoiser"]["blocks"]["conv_gate"]["kernel"][2],
                     (2, 1, 0)))
    np.testing.assert_array_equal(
        sd["variance_adaptor.cwt_stats.layers_2.weight"].numpy(),
        params["variance_adaptor"]["cwt_stats"]["layers_2"]["kernel"].T)
