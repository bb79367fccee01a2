"""The port's train step against the JAX package's: the same flax-init
params, batch and JAX's index and noise draws go through
``cmtts_tpu.train.loop.make_train_step`` and
``cmtts_tpu_torch.train.loop.make_train_step`` (dropout zeroed, float32 on
the CPU), and the loss, the metrics and every updated param, target, EMA
and optimizer moment are compared through the param bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    config_dicts,
    configs_from,
    flax_cm_params,
    jax_draws,
    jax_tree,
    torch_cm,
    train_batch,
    zero_dropout,
)

# float32 on both sides: the loss and the metrics to the JAX suite's f32
# tolerance; params, targets and EMAs after RAdam steps of lr 1e-3 to a
# rounding of their values; the optimizer moments (gradient-sized) a little
# wider
METRIC_TOL = dict(rtol=2e-4, atol=2e-4)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-3, atol=1e-5)
PROBS = np.asarray([1 / 3, 2 / 3], np.float32)


def jax_step_draws(seed, probs, shape, edm=None):
    """(indices or EDM sigmas, noise) exactly as the JAX step draws them
    from PRNGKey(seed)."""
    ri, rn, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    if edm is None:
        idx = jax.random.categorical(ri, jnp.log(jnp.asarray(probs))[None, :],
                                     shape=(shape[0],))
    else:
        p_mean, p_std, lo, hi = edm
        idx = jnp.clip(jnp.exp(p_mean + p_std * jax.random.normal(
            ri, (shape[0],))), lo, hi)
    noise = jax.random.normal(rn, shape, jnp.float32)
    return torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(noise))


class Pair:
    """Both packages' models, optimizers and states on one configuration,
    and the batch in both layouts."""

    def __init__(self, mode="consistency_training", lengths=(8, 5),
                 seed=0, **cm):
        from cmtts_tpu.models.cmtts import CMTTS as JCMTTS
        from cmtts_tpu.train.state import create_train_state as jcreate
        from cmtts_tpu.train.state import make_optimizer as jopt
        from cmtts_tpu_torch.train.loop import batch_to_device
        from cmtts_tpu_torch.train.state import create_train_state, RAdam

        dicts = zero_dropout(config_dicts())
        dicts[1].update(transformer=dict(dicts[1]["transformer"],
                                         encoder_layer=1),
                        denoiser=dict(residual_channels=32,
                                      residual_layers=2))
        dicts[2]["cm"] = dict(lr=1e-3, training_mode=mode, **cm)
        self.jcfg, self.tcfg = configs_from(dicts)
        self.params = flax_cm_params(self.jcfg)
        self.jmodel = JCMTTS(self.jcfg)
        self.tx = jopt(1e-3, self.jcfg.train.cm.weight_decay)
        self.jstate = jcreate(jax.tree_util.tree_map(jnp.asarray, self.params),
                              self.tx, 3)
        self.model = torch_cm(self.tcfg, self.params)
        self.opt = RAdam(1e-3, weight_decay=self.tcfg.train.cm.weight_decay)
        self.tstate = create_train_state(
            {k: v.detach() for k, v in self.model.named_parameters()},
            self.opt, 3)
        self.batch = train_batch(seed, lengths, 8, 32)
        self.jb = jax_tree(self.batch)
        self.tb = batch_to_device(self.batch, "cpu")

    def teacher(self, shift=0.01):
        """A frozen teacher distinct from the student, in both layouts."""
        jt = jax.tree_util.tree_map(lambda x: jnp.asarray(x) + shift,
                                    self.params)
        tt = {k: v.detach() + shift for k, v in self.model.named_parameters()}
        return jt, tt

    def steps(self, num_scales=3, jkw=None, tkw=None, probs=PROBS):
        from cmtts_tpu.train.loop import make_train_step as jmake
        from cmtts_tpu_torch.train.loop import make_train_step

        return (jmake(self.jmodel, self.jcfg, self.tx, num_scales,
                      donate=False, **(jkw or {})),
                make_train_step(self.model, self.tcfg, self.opt, num_scales,
                                **(tkw or {})))

    def run(self, jf, tf, seed, probs=PROBS, edm=None, ema=0.95):
        idx, noise = jax_step_draws(seed, probs, self.batch["mels"].shape,
                                    edm)
        self.jstate, jm = jf(self.jstate, self.jb, jnp.asarray(probs),
                             jax.random.PRNGKey(seed), jnp.asarray(ema))
        self.tstate, tm = tf(self.tstate, self.tb, torch.from_numpy(probs),
                             ema, indices=idx, noise=noise)
        return jm, tm

    def check_state(self, param_tol=PARAM_TOL):
        from cmtts_tpu_torch.convert import flax_to_state_dict

        def close(jtree, ttree, tol, what):
            ref = flax_to_state_dict(
                jax.tree_util.tree_map(np.asarray, jtree), self.model)
            assert set(ref) == set(ttree), what
            for k in ref:
                np.testing.assert_allclose(ttree[k].numpy(), ref[k].numpy(),
                                           err_msg=f"{what} {k}", **tol)

        js, ts = self.jstate, self.tstate
        assert ts.step == int(js.step)
        close(js.params, ts.params, param_tol, "params")
        close(js.target_params, ts.target_params, param_tol, "target")
        for i, (je, te) in enumerate(zip(js.ema_params, ts.ema_params)):
            close(je, te, param_tol, f"ema_{i}")
        adam = [s for s in jax.tree_util.tree_leaves(
            js.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")][0]
        assert ts.opt_state["count"] == int(adam.count)
        close(adam.mu, ts.opt_state["mu"], MOMENT_TOL, "mu")
        close(adam.nu, ts.opt_state["nu"], MOMENT_TOL, "nu")


def check_metrics(jm, tm, tol=METRIC_TOL):
    assert set(jm) == set(tm), (sorted(jm), sorted(tm))
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("variant", ["plain", "sample_valid", "l2_snr"])
def test_ct_step_matches_jax(variant):
    """One CT step: loss, every metric (the per-noise-level sums and
    counts, the variance terms), and every updated param, target, EMA and
    moment; with padded duplicate rows (sample_valid), and with the l2
    norm under the snr weighting."""
    cm = dict(loss_norm="l2", weight_schedule="snr") \
        if variant == "l2_snr" else {}
    pair = Pair(**cm)
    if variant == "sample_valid":
        pair.batch["sample_valid"] = np.asarray([1.0, 0.0], np.float32)
        pair.jb = jax_tree(pair.batch)
        pair.tb["sample_valid"] = torch.tensor([1.0, 0.0])
    jm, tm = pair.run(*pair.steps(), seed=3)
    assert {"cm_i0_sum", "cm_i1_cnt", "C", "uv", "energy"} <= set(tm)
    check_metrics(jm, tm)
    pair.check_state()


def test_radam_8_steps_across_rectification():
    """Eight CT steps (lr 1e-3): RAdam's un-rectified momentum steps 1-5
    and its rectified steps from 6 on (rho_t >= 5 first at t = 6) match
    optax's, with the target EMA and the three EMAs."""
    pair = Pair()
    assert [pair.opt.scalars(t)[0] for t in range(1, 9)] == \
        [False] * 5 + [True] * 3
    jf, tf = pair.steps()
    for s in range(8):
        jm, tm = pair.run(jf, tf, seed=10 + s)
        check_metrics(jm, tm)
    pair.check_state()


def test_radam_weight_decay_matches_optax():
    """The optimizer alone on random gradients, weight decay chained before
    RAdam as the JAX package's make_optimizer does, over 7 updates."""
    import optax

    from cmtts_tpu.train.state import make_optimizer
    from cmtts_tpu_torch.train.state import RAdam

    rs = np.random.RandomState(0)
    p = {"w": rs.randn(5, 3).astype(np.float32),
         "b": rs.randn(3).astype(np.float32)}
    tx, opt = make_optimizer(3e-2, 1e-2), RAdam(3e-2, weight_decay=1e-2)
    jp, js = jax.tree_util.tree_map(jnp.asarray, p), None
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ts = opt.init(tp)
    for _ in range(7):
        g = {k: rs.randn(*v.shape).astype(np.float32) for k, v in p.items()}
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ts, tp)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


def test_microbatch_2_matches_jax():
    """B = 4 in two interleaved microbatches of 2 (ragged lengths, so the
    variance losses renormalise per microbatch), gradients averaged."""
    pair = Pair(lengths=(8, 5, 7, 6))
    jm, tm = pair.run(*pair.steps(jkw=dict(microbatch=2),
                                  tkw=dict(microbatch=2)), seed=4)
    check_metrics(jm, tm)
    pair.check_state()


@pytest.mark.parametrize("mode", ["consistency_distillation", "progdist",
                                  "edm", "cd_edm_teacher"])
def test_distillation_and_edm_steps_match_jax(mode):
    """CD (Heun steps with a frozen teacher, boundary or plain EDM teacher
    scalings), progressive distillation (indices over [0, N)) and EDM
    teacher training (lognormal sigmas in the index slot, karras
    weighting)."""
    from cmtts_tpu.train.loop import schedule_from_config as jsched
    from cmtts_tpu_torch.cm.karras import schedule_from_config

    cm = dict(weight_schedule="karras") if mode == "edm" else {}
    pair = Pair(mode="consistency_distillation" if mode == "cd_edm_teacher"
                else mode, **cm)
    jkw, tkw, probs, edm, scales = {}, {}, PROBS, None, 3
    if mode == "edm":
        edm = (-1.2, 1.2, pair.tcfg.train.cm.sigma_min,
               pair.tcfg.train.cm.sigma_max)
    else:
        jt, tt = pair.teacher()
        jkw, tkw = dict(teacher_params=jt), dict(teacher_params=tt)
    if mode == "progdist":
        probs, scales = np.full(4, 0.25, np.float32), 4
    if mode == "cd_edm_teacher":
        jkw["teacher_sched"] = dataclasses.replace(jsched(pair.jcfg),
                                                   distillation=False)
        tkw["teacher_sched"] = dataclasses.replace(
            schedule_from_config(pair.tcfg), distillation=False)
    jm, tm = pair.run(*pair.steps(scales, jkw, tkw), seed=5, probs=probs,
                      edm=edm)
    check_metrics(jm, tm)
    pair.check_state()


def test_bf16_compute_near_f32_and_jax_bf16():
    """compute_dtype=bfloat16: the loss lands within 5% of the f32 loss (the
    JAX suite's bound) and near JAX's bf16 loss; master params, EMAs and
    target stay float32 and move."""
    from cmtts_tpu_torch.train.loop import make_train_step

    pair = Pair()
    state0 = pair.tstate
    idx, noise = jax_step_draws(6, PROBS, pair.batch["mels"].shape)
    _, m32 = make_train_step(pair.model, pair.tcfg, pair.opt, 3)(
        state0, pair.tb, torch.from_numpy(PROBS), 0.95, indices=idx,
        noise=noise)
    jm, tm = pair.run(*pair.steps(jkw=dict(compute_dtype=jnp.bfloat16),
                                  tkw=dict(compute_dtype=torch.bfloat16)),
                      seed=6)
    l32, l16, lj = float(m32["loss"]), float(tm["loss"]), float(jm["loss"])
    assert np.isfinite(l16) and abs(l16 - l32) / abs(l32) < 0.05
    assert abs(l16 - lj) / abs(lj) < 0.02, (l16, lj)
    np.testing.assert_allclose(tm["loss_per_sample"].numpy(),
                               np.asarray(jm["loss_per_sample"]), rtol=0.02)
    trees = (pair.tstate.params, pair.tstate.target_params,
             *pair.tstate.ema_params)
    assert all(v.dtype == torch.float32 for t in trees for v in t.values())
    k = "denoiser.out_proj.weight"
    assert (pair.tstate.params[k] != state0.params[k]).any()


@pytest.mark.parametrize("pitch_type", ["cwt", "frame"])
def test_synthesize_step_matches_jax(pitch_type):
    """One-step synthesis from the target params with teacher-forced
    conditioning, its masked mel L1, and the viz payload (f0, cwt and
    energy tracks on mel frames), on JAX's x_T."""
    from cmtts_tpu.models.cmtts import CMTTS as JCMTTS
    from cmtts_tpu.train.loop import make_synthesize_step as jmake
    from cmtts_tpu_torch.train.loop import batch_to_device, make_synthesize_step

    jcfg, tcfg = configs_from(config_dicts(pitch_type=pitch_type))
    params = flax_cm_params(jcfg)
    batch = train_batch(1, (8, 5), 8, 32, pitch_type=pitch_type)
    mel_r, loss_r, viz_r = jax.jit(jmake(JCMTTS(jcfg), jcfg, with_viz=True))(
        params, jax_tree(batch), jax.random.PRNGKey(2))
    x_T, _ = jax_draws(2, batch["mels"].shape, 80.0, 0)
    mel, loss, viz = make_synthesize_step(
        torch_cm(tcfg, params), tcfg, with_viz=True)(
        {k: v.detach() for k, v in torch_cm(tcfg, params).named_parameters()},
        batch_to_device(batch, "cpu"), x_T=x_T)
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_r), **METRIC_TOL)
    np.testing.assert_allclose(float(loss), float(loss_r), **METRIC_TOL)
    assert set(viz) == set(viz_r)
    for k in viz:
        np.testing.assert_allclose(viz[k].numpy(), np.asarray(viz_r[k]),
                                   err_msg=k, rtol=2e-4, atol=1e-3)


def _dropout_pair():
    from cmtts_tpu_torch.core.config import config_from_dicts
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from cmtts_tpu_torch.train.loop import batch_to_device
    from cmtts_tpu_torch.train.state import RAdam, create_train_state

    cfg = config_from_dicts(*config_dicts())      # dropout on
    model = init_like_flax(CMTTS(cfg), torch.Generator().manual_seed(0))
    opt = RAdam(1e-3)
    state = create_train_state(
        {k: v.detach() for k, v in model.named_parameters()}, opt, 3)
    batch = batch_to_device(train_batch(2, (8, 5), 8, 32), "cpu")
    return cfg, model, opt, state, batch


def test_student_and_target_share_dropout_masks(monkeypatch):
    """With dropout on, the target forward draws exactly the student's
    masks (the generator's state is put back in between), as the JAX step
    passes one dropout key to both."""
    from cmtts_tpu_torch.models import encoder, variance
    from cmtts_tpu_torch.train.loop import make_train_step

    cfg, model, opt, state, batch = _dropout_pair()
    masks = []
    orig = encoder.dropout

    def recording(x, rate, generator):
        out = orig(x, rate, generator)
        if generator is not None and rate:
            masks.append((out != 0).clone())
        return out

    monkeypatch.setattr(encoder, "dropout", recording)
    monkeypatch.setattr(variance, "dropout", recording)
    step = make_train_step(model, cfg, opt, 3)
    _, m = step(state, batch, PROBS, 0.95, torch.Generator().manual_seed(1))
    assert np.isfinite(float(m["loss"]))
    half = len(masks) // 2
    assert half > 0 and len(masks) == 2 * half
    for a, b in zip(masks[:half], masks[half:]):
        assert torch.equal(a, b)
    assert any(not a.all() for a in masks)


def test_remat_and_dropout_replay():
    """remat=True recomputes the forward in the backward pass with the same
    dropout masks: loss, grad norm and the updated params equal the plain
    step's on the same generator seed; another seed draws other masks."""
    from cmtts_tpu_torch.train.loop import make_train_step

    cfg, model, opt, state, batch = _dropout_pair()
    out = {}
    for remat, seed in ((False, 1), (True, 1), (False, 2)):
        step = make_train_step(model, cfg, opt, 3, remat=remat)
        out[remat, seed] = step(state, batch, PROBS, 0.95,
                                torch.Generator().manual_seed(seed))
    (s_a, m_a), (s_b, m_b) = out[False, 1], out[True, 1]
    np.testing.assert_allclose(float(m_b["loss"]), float(m_a["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m_b["grad_norm"]),
                               float(m_a["grad_norm"]), rtol=1e-5)
    for k in s_a.params:
        np.testing.assert_allclose(s_b.params[k].numpy(),
                                   s_a.params[k].numpy(), rtol=1e-5,
                                   atol=1e-7)
    assert float(out[False, 2][1]["loss"]) != float(m_a["loss"])
    with pytest.raises(ValueError, match="generator"):
        make_train_step(model, cfg, opt, 3)(state, batch, PROBS, 0.95)
