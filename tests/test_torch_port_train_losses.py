"""The port's training losses, Karras training grid and teacher-forced
conditioning against the JAX package's, float32 on the CPU.

The loss functions are held to JAX's on identical inputs: the conditioning
outputs of the port's teacher-forced ``condition`` (converted to jnp), and
a closed-form stand-in for the model's apply written once per package, so
that every loss norm, weighting and mode is checked without a model
compile.  The conditioning itself is held to the flax module's on the same
flax-init params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    config_dicts,
    configs_from,
    flax_cm_params,
    jax_tree,
    torch_cm,
    train_batch,
)

TOL = dict(rtol=2e-4, atol=2e-4)     # the JAX suite's float32 tolerance
SCHEDULES = ["snr", "snr+1", "karras", "truncated-snr", "uniform"]


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items() if v is not None}
    return tree.detach().numpy() if torch.is_tensor(tree) else tree


def to_jnp(tree):
    if isinstance(tree, dict):
        return {k: to_jnp(v) for k, v in tree.items() if v is not None}
    return jnp.asarray(to_np(tree))


def assert_tree_close(actual, desired, tol=TOL, prefix=""):
    actual, desired = to_np(actual), to_np(desired)
    if isinstance(desired, dict):
        assert set(actual) == set(desired), (prefix, sorted(actual),
                                             sorted(desired))
        for k in desired:
            assert_tree_close(actual[k], desired[k], tol, f"{prefix}/{k}")
        return
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(desired, np.float64),
                               err_msg=prefix, **tol)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_weightings_match_jax(schedule):
    from cmtts_tpu.cm.karras import KarrasSchedule as JK
    from cmtts_tpu.cm.karras import get_weightings as jw
    from cmtts_tpu_torch.cm.karras import KarrasSchedule, get_weightings

    sig = np.asarray([0.002, 0.05, 0.4, 1.0, 7.5, 80.0], np.float32)
    ref = jw(schedule, JK().snr(jnp.asarray(sig)), 0.5)
    out = get_weightings(schedule, KarrasSchedule().snr(torch.from_numpy(sig)),
                         0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_training_grid_matches_jax():
    """t_of_index over the grid (and past it, as t2 = t(i + 1) reads),
    get_sigmas_karras, append_dims and mean_flat."""
    from cmtts_tpu.cm import karras as jk
    from cmtts_tpu_torch.cm import karras as tk

    for n in (3, 11, 200):
        idx = np.arange(n, dtype=np.int32)
        ref = jk.KarrasSchedule().t_of_index(jnp.asarray(idx), n)
        out = tk.KarrasSchedule().t_of_index(torch.from_numpy(idx), n)
        # float32 powers (x ** 7) differ in the last bits between libraries
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5)
        np.testing.assert_allclose(
            tk.get_sigmas_karras(n, 0.002, 80.0).numpy(),
            np.asarray(jk.get_sigmas_karras(n, 0.002, 80.0)), rtol=1e-5)
    x = np.random.RandomState(0).randn(3, 4, 5).astype(np.float32)
    np.testing.assert_allclose(tk.mean_flat(torch.from_numpy(x)).numpy(),
                               np.asarray(jk.mean_flat(jnp.asarray(x))),
                               rtol=1e-6)
    assert tk.append_dims(torch.ones(3), 3).shape == (3, 1, 1)


# (pitch_type, cwt_masked_std, energy feature)
CONDITIONS = [("cwt", False, "phoneme_level"), ("cwt", True, "phoneme_level"),
              ("cwt", False, "frame_level"), ("frame", False, "frame_level"),
              ("ph", False, "phoneme_level")]


def cond_setup(pitch_type, masked, energy, seed=0, loss=None, cm=None,
               flax_init=False):
    """(JAX config, port config, flax-init params or None, batch)."""
    dicts = config_dicts(pitch_type=pitch_type, cwt_masked_std=masked,
                         energy_feature=energy)
    dicts[2].update(loss=loss or {}, cm=cm or {})
    jcfg, tcfg = configs_from(dicts)
    params = flax_cm_params(jcfg) if flax_init else None
    batch = train_batch(seed, (8, 5), 8, 32, pitch_type=pitch_type,
                        energy_feature=energy)
    return jcfg, tcfg, params, batch


def torch_condition(tcfg, params, batch):
    """The port's teacher-forced conditioning outputs on ``batch``, from
    the flax params or (None) the port's own flax-like init."""
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from cmtts_tpu_torch.train.loop import batch_to_device

    model = (init_like_flax(CMTTS(tcfg), torch.Generator().manual_seed(0))
             if params is None else torch_cm(tcfg, params))
    tb = batch_to_device(batch, "cpu")
    with torch.no_grad():
        return model.condition(
            tb["texts"], tb["src_lens"], tb["mels"].shape[1],
            speakers=tb["speakers"], mel2ph=tb["mel2ph"],
            d_targets=tb["d_targets"], p_targets=tb["p_targets"],
            e_targets=tb["e_targets"]), tb


@pytest.mark.parametrize("pitch_type,masked,energy", CONDITIONS)
def test_condition_teacher_forced_matches_jax(pitch_type, masked, energy):
    """Teacher-forced conditioning: durations, mel2ph and mel_lens from
    the targets, f0 from the target CWT (with and without the masked
    standardisation) or the target f0 track, energy embedding of the
    target; the predictions beside them."""
    from cmtts_tpu.models.cmtts import CMTTS as JCMTTS

    jcfg, tcfg, params, batch = cond_setup(pitch_type, masked, energy,
                                           flax_init=True)
    jb = jax_tree(batch)
    ref = jax.jit(lambda p: JCMTTS(jcfg).apply(
        {"params": p}, jb["speakers"], jb["texts"], jb["src_lens"],
        jb["mels"].shape[1], mel2ph=jb["mel2ph"], d_targets=jb["d_targets"],
        p_targets=jb["p_targets"], e_targets=jb["e_targets"],
        deterministic=True, method=JCMTTS.condition))(params)
    out, _ = torch_condition(tcfg, params, batch)
    ref = {k: v for k, v in ref.items() if v is not None}
    out = {k: v for k, v in out.items() if v is not None}
    assert_tree_close(out, ref, dict(rtol=1e-4, atol=1e-4))
    np.testing.assert_array_equal(out["mel_lens"].numpy(),
                                  np.minimum(batch["d_targets"].sum(1), 32))


# variance-loss settings: (condition, loss dict, sample_valid)
VARIANCE_CASES = [
    (CONDITIONS[0], None, False),
    (CONDITIONS[0], {"cwt_loss": "l2", "lambda_word_dur": 0.5}, True),
    (CONDITIONS[2], {"lambda_sent_dur": 0.0}, False),
    (CONDITIONS[3], {"pitch_loss": "l2", "lambda_uv": 0.3}, True),
    (CONDITIONS[4], {"lambda_word_dur": 1.0, "lambda_f0": 0.5}, False),
]


@pytest.mark.parametrize("case", range(len(VARIANCE_CASES)))
def test_variance_losses_match_jax(case):
    """Duration (phone, word over silence-separated runs, sentence), pitch
    (cwt spectrogram l1/l2 with uv BCE and f0 statistics, frame f0 with uv,
    ph f0), energy at either level, with and without sample_valid zeroing
    a padded duplicate row: each term on the same conditioning outputs."""
    from cmtts_tpu.cm.losses import variance_loss as jloss
    from cmtts_tpu.text import sil_phonemes_ids as jsil
    from cmtts_tpu_torch.cm.losses import variance_loss
    from cmtts_tpu_torch.text import sil_phonemes_ids

    (pitch_type, masked, energy), loss, sv = VARIANCE_CASES[case]
    jcfg, tcfg, params, batch = cond_setup(pitch_type, masked, energy,
                                           loss=loss)
    cond, tb = torch_condition(tcfg, params, batch)
    if sv:
        batch["sample_valid"] = np.asarray([1.0, 0.0], np.float32)
        tb["sample_valid"] = torch.tensor([1.0, 0.0])
    total_r, terms_r = jloss(to_jnp(cond), jax_tree(batch), jcfg,
                             tuple(jsil()))
    total, terms = variance_loss(cond, tb, tcfg, tuple(sil_phonemes_ids()))
    assert set(terms) == set(terms_r)
    assert_tree_close(terms, dict(terms_r), dict(rtol=1e-5, atol=1e-6))
    np.testing.assert_allclose(float(total), float(total_r), rtol=1e-5)


class ToyApply:
    """A closed-form stand-in for the model's apply, one per package: the
    output is tanh(w * x_scaled + 1e-3 * t) with a scalar param w, and the
    conditioning outputs are fixed (the port's teacher-forced ones)."""

    def __init__(self, cond):
        self.cond_t = cond
        self.cond_j = to_jnp(cond)

    def torch(self, params, x_scaled, rescaled_t, batch, gen, det):
        return (torch.tanh(params["w"] * x_scaled
                           + 1e-3 * rescaled_t[:, None, None]), self.cond_t)

    def jax(self, params, x_scaled, rescaled_t, batch, rng, det):
        return (jnp.tanh(params["w"] * x_scaled
                         + 1e-3 * rescaled_t[:, None, None]), self.cond_j)


def loss_setup(**cm):
    jcfg, tcfg, _, batch = cond_setup("cwt", False, "phoneme_level", seed=3,
                                      cm=cm)
    cond, tb = torch_condition(tcfg, None, batch)
    rs = np.random.RandomState(4)
    draws = {"x_start": batch["mels"],
             "noise": rs.randn(*batch["mels"].shape).astype(np.float32)}
    return jcfg, tcfg, batch, tb, ToyApply(cond), draws


def both_sched(jcfg, tcfg, distillation=None):
    import dataclasses

    from cmtts_tpu.train.loop import schedule_from_config as jsched
    from cmtts_tpu_torch.cm.karras import schedule_from_config

    js, ts = jsched(jcfg), schedule_from_config(tcfg)
    if distillation is not None:
        js = dataclasses.replace(js, distillation=distillation)
        ts = dataclasses.replace(ts, distillation=distillation)
    return js, ts


@pytest.mark.parametrize("loss_norm,schedule,teacher", [
    ("l1", "uniform", False), ("l2", "snr+1", False),
    ("mel_loss", "karras", False), ("l1+mel_loss", "truncated-snr", False),
    ("l2", "snr", True)])
def test_consistency_loss_matches_jax(loss_norm, schedule, teacher):
    """CT (Euler against x0) and CD (Heun with a teacher) under every loss
    norm and weighting: per-sample total and aux."""
    from cmtts_tpu.cm.losses import consistency_loss as jloss
    from cmtts_tpu.text import sil_phonemes_ids as jsil
    from cmtts_tpu_torch.cm.losses import consistency_loss
    from cmtts_tpu_torch.text import sil_phonemes_ids

    jcfg, tcfg, batch, tb, toy, d = loss_setup(
        loss_norm=loss_norm, weight_schedule=schedule)
    js, ts = both_sched(jcfg, tcfg)
    idx = np.asarray([0, 1], np.int32)
    jteach = tteach = None
    if teacher:
        def jteach(x, s):
            return 0.9 * jnp.tanh(x / (1.0 + s[:, None, None]))

        def tteach(x, s):
            return 0.9 * torch.tanh(x / (1.0 + s[:, None, None]))
    total_r, aux_r = jloss(
        toy.jax, {"w": jnp.asarray(0.7)}, {"w": jnp.asarray(0.6)},
        jnp.asarray(d["x_start"]), jnp.asarray(d["noise"]), jnp.asarray(idx),
        3, jax_tree(batch), jcfg, js, tuple(jsil()), None,
        teacher_denoise=jteach)
    total, aux = consistency_loss(
        toy.torch, {"w": torch.tensor(0.7)}, {"w": torch.tensor(0.6)},
        torch.from_numpy(d["x_start"]), torch.from_numpy(d["noise"]),
        torch.from_numpy(idx), 3, tb, tcfg, ts, tuple(sil_phonemes_ids()),
        None, teacher_denoise=tteach)
    np.testing.assert_allclose(total.numpy(), np.asarray(total_r), **TOL)
    assert_tree_close(aux, dict(aux_r))


@pytest.mark.parametrize("mode", ["edm", "progdist"])
def test_edm_and_progdist_losses_match_jax(mode):
    """EDM score matching at continuous sigmas with plain scalings, and
    progressive distillation's two teacher half-steps."""
    from cmtts_tpu.cm.losses import edm_loss as jedm
    from cmtts_tpu.cm.losses import progdist_loss as jprog
    from cmtts_tpu.text import sil_phonemes_ids as jsil
    from cmtts_tpu_torch.cm.losses import edm_loss, progdist_loss
    from cmtts_tpu_torch.text import sil_phonemes_ids

    jcfg, tcfg, batch, tb, toy, d = loss_setup(
        training_mode=mode, weight_schedule="karras" if mode == "edm"
        else "snr")
    js, ts = both_sched(jcfg, tcfg)
    x, n = d["x_start"], d["noise"]
    jargs = (jnp.asarray(x), jnp.asarray(n))
    targs = (torch.from_numpy(x), torch.from_numpy(n))
    jp, tp = {"w": jnp.asarray(0.7)}, {"w": torch.tensor(0.7)}
    if mode == "edm":
        sig = np.asarray([0.03, 3.5], np.float32)
        total_r, aux_r = jedm(toy.jax, jp, *jargs, jnp.asarray(sig),
                              jax_tree(batch), jcfg, js, tuple(jsil()), None)
        total, aux = edm_loss(toy.torch, tp, *targs, torch.from_numpy(sig),
                              tb, tcfg, ts, tuple(sil_phonemes_ids()), None)
    else:
        idx = np.asarray([0, 3], np.int32)
        total_r, aux_r = jprog(
            toy.jax, jp, lambda x_, s: 0.9 * jnp.tanh(x_ / (1 + s[:, None,
                                                                   None])),
            *jargs, jnp.asarray(idx), 4, jax_tree(batch), jcfg, js,
            tuple(jsil()), None)
        total, aux = progdist_loss(
            toy.torch, tp, lambda x_, s: 0.9 * torch.tanh(
                x_ / (1 + s[:, None, None])), *targs, torch.from_numpy(idx),
            4, tb, tcfg, ts, tuple(sil_phonemes_ids()), None)
    np.testing.assert_allclose(total.numpy(), np.asarray(total_r), **TOL)
    assert_tree_close(aux, dict(aux_r))


def test_masked_mel_losses_match_jax():
    from cmtts_tpu.cm.losses import masked_mel_l1 as jl1
    from cmtts_tpu.cm.losses import masked_mel_l2 as jl2
    from cmtts_tpu_torch.cm.losses import masked_mel_l1, masked_mel_l2

    rs = np.random.RandomState(5)
    pred, tgt = rs.randn(2, 2, 20, 6).astype(np.float32)
    tgt[0, 17:] = 0.0
    tgt[1, 3] = 0.0                  # an all-zero row inside the length
    lens = np.asarray([17, 12], np.int32)
    for jf, tf in ((jl1, masked_mel_l1), (jl2, masked_mel_l2)):
        ref = jf(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(lens), 20)
        out = tf(torch.from_numpy(pred), torch.from_numpy(tgt),
                 torch.from_numpy(lens), 20)
        np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_dropout_is_flax_dropout():
    """Kept with probability 1 - rate and scaled by 1 / (1 - rate), masks
    from the generator (the same seed draws the same mask); the identity
    without a generator; and a model with dropout refuses to drop out
    without one."""
    from cmtts_tpu_torch.core.config import config_from_dicts
    from cmtts_tpu_torch.models.cmtts import CMTTS
    from cmtts_tpu_torch.models.encoder import dropout

    x = torch.ones(200, 500)
    y = dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(y, dropout(x, 0.3, torch.Generator().manual_seed(0)))
    assert dropout(x, 0.3, None) is x and dropout(x, 0.0, None) is x
    model = CMTTS(config_from_dicts(*config_dicts()))
    with pytest.raises(ValueError, match="generator"):
        model.condition(torch.ones(1, 8, dtype=torch.long),
                        torch.tensor([8]), 32, deterministic=False)
