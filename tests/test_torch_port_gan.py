"""The port's legacy GAN objectives against the JAX package's: the JCU
discriminator (the JAX suite's tiny plan, the same plan multi-speaker,
and the LJSpeech widths at an odd frame count, where XLA's "SAME" pads a
stride-2 conv asymmetrically) on the same weights through the bridge,
the bridge's round trip, every LSGAN / feature-matching / mel-L1 / SSIM
loss, and each reconstruction routing of ``diffsinger_loss`` and
``diffgan_recon_loss``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmtts_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax

F32_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dicts(plan: str):
    from cmtts_tpu_torch.core.config import load_yaml_configs

    p, m, t = load_yaml_configs("LJSpeech")
    if plan != "ljspeech":
        m["transformer"]["encoder_layer"] = 1
        m["denoiser"]["residual_channels"] = 32
        m["discriminator"]["n_channels"] = [8, 16, 32, 16, 1]
    if plan == "tiny_multispeaker":
        m["multi_speaker"] = True
    return p, m, t


@functools.lru_cache(maxsize=None)
def configs(plan: str):
    """(JAX config, port config) of a discriminator plan."""
    from cmtts_tpu.core.config import config_from_dicts as jcfg
    from cmtts_tpu_torch.core.config import config_from_dicts

    return jcfg(*_dicts(plan)), config_from_dicts(*_dicts(plan))


PLANS = {"tiny": 40, "tiny_multispeaker": 37, "ljspeech": 101}


@pytest.mark.parametrize("plan", list(PLANS))
def test_jcu_discriminator_matches_jax(plan):
    """Every feature of both branches (logits last) on the same weights,
    (B, T', C) in both packages, and the bridge's round trip bit-exact."""
    from cmtts_tpu.models.discriminator import JCUDiscriminator as JD
    from cmtts_tpu_torch.models.discriminator import (
        JCUDiscriminator,
        init_like_flax,
    )

    jcfg, cfg = configs(plan)
    B, T, M = 2, PLANS[plan], cfg.stft.n_mel_channels
    H = cfg.model.transformer.encoder_hidden
    disc = init_like_flax(JCUDiscriminator(cfg),
                          torch.Generator().manual_seed(0)).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in disc.parameters():
            if not p.any():           # biases: nonzero, so a wrong map shows
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    tree = state_dict_to_flax(disc)
    back = state_dict_to_flax(disc, dict(flax_to_state_dict(tree, disc)))
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    for k, v in jax.tree_util.tree_flatten_with_path(back)[0]:
        np.testing.assert_array_equal(v, flat[k])

    rs = np.random.RandomState(2)
    x_ts = rs.randn(B, T, M).astype(np.float32)
    x_prev = rs.randn(B, T, M).astype(np.float32)
    t = np.asarray([3, 1])
    spk = (rs.randn(B, H).astype(np.float32)
           if cfg.model.multi_speaker else None)
    jd = JD(jcfg)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0),
                            jnp.asarray(x_ts), jnp.asarray(x_prev),
                            None if spk is None else jnp.asarray(spk),
                            jnp.asarray(t))["params"]
    assert jax.tree_util.tree_structure(shapes) == \
        jax.tree_util.tree_structure(tree)
    want = jax.jit(lambda p, a, b, s, tt: jd.apply({"params": p}, a, b, s,
                                                   tt))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x_ts),
        jnp.asarray(x_prev), None if spk is None else jnp.asarray(spk),
        jnp.asarray(t))
    with torch.no_grad():
        got = disc(torch.from_numpy(x_ts), torch.from_numpy(x_prev),
                   None if spk is None else torch.from_numpy(spk),
                   torch.from_numpy(t))
    d = cfg.model.discriminator
    assert len(got[0]) == d.n_layer + d.n_cond_layer
    assert len(got[1]) == d.n_layer + d.n_uncond_layer
    assert got[0][-1].shape == (B, -(-T // 4), 1)
    for g_list, w_list in zip(got, want):
        for a, b in zip(g_list, w_list):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)


def test_jcu_conditioning_changes_cond_branch_only():
    from cmtts_tpu_torch.models.discriminator import (
        JCUDiscriminator,
        init_like_flax,
    )

    _, cfg = configs("tiny")
    disc = init_like_flax(JCUDiscriminator(cfg),
                          torch.Generator().manual_seed(0))
    x = torch.randn(2, 40, cfg.stft.n_mel_channels)
    with torch.no_grad():
        c0, u0 = disc(x, x * 0.5, None, torch.zeros(2, dtype=torch.long))
        c1, u1 = disc(x, x * 0.5, None, torch.full((2,), 3))
    torch.testing.assert_close(u0[-1], u1[-1], rtol=0, atol=0)
    assert float((c0[-1] - c1[-1]).abs().max()) > 1e-6


def _logits(seed, shape=(2, 25, 1)):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)], (
        rs.rand(*shape) > 0.3).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_lsgan_losses_match_jax(masked):
    from cmtts_tpu.cm.gan_losses import get_adversarial_losses_fn as jget
    from cmtts_tpu_torch.cm.gan_losses import get_adversarial_losses_fn

    logits, mask = _logits(0)
    jd, jg = jget("lsgan")
    d, g = get_adversarial_losses_fn("lsgan")
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    want = jd(*map(jnp.asarray, logits), mask=jm)
    got = d(*map(torch.from_numpy, logits), mask=tm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), **LOSS_TOL)
    np.testing.assert_allclose(
        float(g(*map(torch.from_numpy, logits[2:]), mask=tm)),
        float(jg(*map(jnp.asarray, logits[2:]), mask=jm)), **LOSS_TOL)


def test_unknown_adv_mode_raises():
    from cmtts_tpu_torch.cm.gan_losses import get_adversarial_losses_fn

    with pytest.raises(NotImplementedError):
        get_adversarial_losses_fn("hinge")


def test_feature_matching_loss_matches_jax():
    from cmtts_tpu.cm.gan_losses import feature_matching_loss as jfm
    from cmtts_tpu_torch.cm.gan_losses import feature_matching_loss

    rs = np.random.RandomState(1)
    shapes = [(2, 40, 8), (2, 20, 16), (2, 10, 32), (2, 10, 1)]
    feats = [[rs.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(4)]
    want = jfm(*[[jnp.asarray(f) for f in fs] for fs in feats], n_layers=5)
    got = feature_matching_loss(
        *[[torch.from_numpy(f) for f in fs] for fs in feats], n_layers=5)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def _mels(seed, B=2, T=48, M=20):
    rs = np.random.RandomState(seed)
    pred = rs.randn(B, T, M).astype(np.float32)
    target = rs.randn(B, T, M).astype(np.float32)
    target[0, 40:] = 0.0                      # padding rows
    valid = np.ones((B, T), np.float32)
    valid[1, 30:] = 0.0
    return pred, target, valid


@pytest.mark.parametrize("with_valid", [False, True])
def test_weighted_mel_l1_matches_jax(with_valid):
    from cmtts_tpu.cm.gan_losses import weighted_mel_l1 as jl1
    from cmtts_tpu.cm.gan_losses import weights_nonzero_speech as jw
    from cmtts_tpu_torch.cm.gan_losses import (
        weighted_mel_l1,
        weights_nonzero_speech,
    )

    pred, target, valid = _mels(2)
    np.testing.assert_array_equal(
        weights_nonzero_speech(torch.from_numpy(target)).numpy(),
        np.asarray(jw(jnp.asarray(target))))
    want = jl1(jnp.asarray(pred), jnp.asarray(target),
               jnp.asarray(valid) if with_valid else None)
    got = weighted_mel_l1(torch.from_numpy(pred), torch.from_numpy(target),
                          torch.from_numpy(valid) if with_valid else None)
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)


def test_ssim_matches_jax():
    """The separable 11-tap gaussian with zero padding: the SSIM map at
    every position and the nonzero-weighted loss."""
    from cmtts_tpu.cm.gan_losses import ssim_loss as jloss
    from cmtts_tpu.cm.gan_losses import ssim_map as jmap
    from cmtts_tpu_torch.cm.gan_losses import ssim_loss, ssim_map

    pred, target, _ = _mels(3, T=37, M=80)
    np.testing.assert_allclose(
        ssim_map(torch.from_numpy(pred) + 6, torch.from_numpy(target) + 6)
        .numpy(), np.asarray(jmap(jnp.asarray(pred) + 6,
                                  jnp.asarray(target) + 6)), **F32_TOL)
    np.testing.assert_allclose(
        float(ssim_loss(torch.from_numpy(pred), torch.from_numpy(target))),
        float(jloss(jnp.asarray(pred), jnp.asarray(target))), **LOSS_TOL)


def _routing_inputs(cfg_pair):
    jcfg, cfg = cfg_pair
    B, T_TXT, T_MEL, M = 2, 6, 20, cfg.stft.n_mel_channels
    rs = np.random.RandomState(4)

    def f(*shape):
        return rs.randn(*shape).astype(np.float32)

    src_pad = np.zeros((B, T_TXT), bool)
    src_pad[1, 4:] = True
    mel_pad = np.zeros((B, T_MEL), bool)
    mel_pad[1, 15:] = True
    cond_out = {
        "src_pad_mask": src_pad, "mel_pad_mask": mel_pad,
        "log_d_pred": f(B, T_TXT),
        "p_pred": {"cwt": f(B, T_MEL, 11), "f0_mean": f(B), "f0_std": f(B)},
        "e_pred": f(B, T_TXT),
    }
    batch = {
        "texts": rs.randint(1, 60, (B, T_TXT)).astype(np.int64),
        "d_targets": rs.randint(1, 5, (B, T_TXT)).astype(np.int64),
        "mels": f(B, T_MEL, M),
        "p_targets": {"cwt_spec": f(B, T_MEL, 10),
                      "uv": (rs.rand(B, T_MEL) > 0.5).astype(np.float32),
                      "f0": f(B, T_MEL), "f0_mean": f(B), "f0_std": f(B)},
        "e_targets": f(B, T_TXT),
    }
    preds = {"mel": f(B, T_MEL, M), "mel2": f(B, T_MEL, M),
             "coarse": f(B, T_MEL, M)}
    return cond_out, batch, preds


def _to(tree, conv):
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    return conv(tree)


ROUTES = [("diffsinger", "diff_aux"), ("diffsinger", "diff_naive"),
          ("diffsinger", "diff_shallow"), ("diffgan", "aux"),
          ("diffgan", "shallow"), ("diffgan", "naive")]


@pytest.mark.parametrize("loss,mode", ROUTES)
def test_legacy_loss_routing_matches_jax(loss, mode):
    """Each routing of the DiffSinger total and the DiffGAN-TTS
    reconstruction loss: the total and every part against JAX on the
    same variance outputs (CWT pitch with uv, phoneme-level energy, a
    padded second row); shallow DiffGAN keeps the mel term only."""
    import cmtts_tpu.cm.gan_losses as jgl
    import cmtts_tpu_torch.cm.gan_losses as gl
    from cmtts_tpu.text import sil_phonemes_ids as jsil
    from cmtts_tpu_torch.text import sil_phonemes_ids

    jcfg, cfg = configs("tiny")
    cond_out, batch, preds = _routing_inputs((jcfg, cfg))
    jc, jb, jp = (_to(x, jnp.asarray) for x in (cond_out, batch, preds))
    tc, tb, tp = (_to(x, torch.from_numpy) for x in (cond_out, batch, preds))
    assert tuple(jsil()) == tuple(sil_phonemes_ids())
    sil = tuple(sil_phonemes_ids())
    if loss == "diffsinger":
        kw = (dict(mel_pred="mel") if mode == "diff_aux"
              else dict(noise_loss=0.7))
        want = jgl.diffsinger_loss(mode, jc, jb, jcfg, sil, **{
            k: (jp[v] if k == "mel_pred" else jnp.asarray(v))
            for k, v in kw.items()})
        got = gl.diffsinger_loss(mode, tc, tb, cfg, sil, **{
            k: (tp[v] if k == "mel_pred" else torch.tensor(v))
            for k, v in kw.items()})
    else:
        def args(p):
            if mode == "aux":
                return ([p["mel"], p["mel2"]],), {}
            if mode == "shallow":
                return (p["mel"],), {"coarse_mels": p["coarse"]}
            return (p["mel"],), {}
        a, k = args(jp)
        want = jgl.diffgan_recon_loss(mode, jc, jb, jcfg, sil, *a, **k)
        a, k = args(tp)
        got = gl.diffgan_recon_loss(mode, tc, tb, cfg, sil, *a, **k)
    assert set(got[1]) == set(want[1])
    if (loss, mode) == ("diffgan", "shallow"):
        assert set(got[1]) == {"mel"}
    np.testing.assert_allclose(float(got[0]), float(want[0]), **LOSS_TOL)
    for key in want[1]:
        np.testing.assert_allclose(float(got[1][key]), float(want[1][key]),
                                   err_msg=key, **LOSS_TOL)
    with pytest.raises(NotImplementedError):
        (gl.diffsinger_loss if loss == "diffsinger"
         else gl.diffgan_recon_loss)("bogus", tc, tb, cfg, sil, None)


def test_fm_lambda_matches_jax():
    from cmtts_tpu.cm.gan_losses import fm_lambda as jfm
    from cmtts_tpu_torch.cm.gan_losses import fm_lambda

    jcfg, cfg = configs("ljspeech")
    for mode in ("aux", "naive", "shallow"):
        assert fm_lambda(cfg, mode) == jfm(jcfg, mode)
    assert fm_lambda(cfg, "shallow") == 0.001 and fm_lambda(cfg, "aux") == 10


def test_adversarial_training_signal():
    """One LSGAN D step (Adam, as optax computes it) on random real and
    fake mels lowers the D loss: the losses, the discriminator and the
    gradients wire together."""
    from cmtts_tpu_torch.cm.gan_losses import lsgan_d_loss
    from cmtts_tpu_torch.models.discriminator import (
        JCUDiscriminator,
        init_like_flax,
    )
    from cmtts_tpu_torch.train.state import Adam

    _, cfg = configs("tiny")
    disc = init_like_flax(JCUDiscriminator(cfg),
                          torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    M = cfg.stft.n_mel_channels
    real, prev = torch.randn(4, 32, M, generator=g), \
        torch.randn(4, 32, M, generator=g)
    fake = torch.randn(4, 32, M, generator=g) * 0.3
    t = torch.zeros(4, dtype=torch.long)

    def d_loss(params):
        rc, ru = torch.func.functional_call(disc, params, (real, prev, None,
                                                           t))
        fc, fu = torch.func.functional_call(disc, params, (fake, prev, None,
                                                           t))
        r, f = lsgan_d_loss(rc[-1], ru[-1], fc[-1], fu[-1])
        return r + f

    params = {k: v.detach().requires_grad_(True)
              for k, v in disc.named_parameters()}
    l0 = d_loss(params)
    grads = dict(zip(params, torch.autograd.grad(l0, list(params.values()))))
    opt = Adam(2e-4)
    new, _ = opt.update(grads, opt.init(params), params)
    l0, l1 = float(l0.detach()), float(d_loss(new).detach())
    assert np.isfinite(l0) and l1 < l0
