"""Every sampler of the port against ``cmtts_tpu.cm.sampling`` with JAX's
draws injected (x_T, then the multistep re-noise, the heun/dpm churn or
the ancestral noise, in the order JAX makes them): first on a closed-form
denoiser, then on the tiny multi-speaker CMTTS, conditioned once on each
side as the pipelines do.  float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    both_configs,
    flax_cm_params,
    jax_draws,
    padded,
    tokens,
    torch_cm,
)

TOL = dict(rtol=1e-5, atol=1e-5)
# (sampler, T, steps, s_churn, s_tmin, s_tmax): the churn window of the
# last heun/dpm cases covers some grid levels and not others, so that the
# draw order is checked across steps that draw and steps that do not
CASES = [
    ("onestep", 1, 2, 0.0, 0.0, float("inf")),
    ("multistep", 2, 2, 0.0, 0.0, float("inf")),
    ("multistep", 4, 2, 0.0, 0.0, float("inf")),
    ("our_multistep", 3, 2, 0.0, 0.0, float("inf")),
    ("euler", 1, 5, 0.0, 0.0, float("inf")),
    ("ancestral", 1, 5, 0.0, 0.0, float("inf")),
    ("heun", 1, 5, 0.0, 0.0, float("inf")),
    ("dpm", 1, 5, 0.0, 0.0, float("inf")),
    ("heun", 1, 6, 1.5, 0.0, float("inf")),
    ("dpm", 1, 6, 1.5, 0.0, float("inf")),
    ("heun", 1, 6, 1.5, 0.05, 10.0),
    ("dpm", 1, 6, 1.5, 0.05, 10.0),
]
IDS = [f"{c[0]}-T{c[1]}-steps{c[2]}-churn{c[3]}-tmin{c[4]}" for c in CASES]


def schedules():
    from cmtts_tpu.cm.karras import KarrasSchedule as JS
    from cmtts_tpu_torch.cm.karras import KarrasSchedule as TS

    return JS(), TS()


def run_both(jden, tden, shape, case, seed=3):
    """JAX's sample_mel from PRNGKey(seed) and the port's with the same
    draws; returns (port, jax) as numpy."""
    from cmtts_tpu.cm.sampling import default_ts, sample_mel as jsample
    from cmtts_tpu_torch.cm.sampling import sample_mel as tsample

    sampler, T, steps, churn, tmin, tmax = case
    js, ts = schedules()
    ts_ = default_ts(T) if sampler == "multistep" else None
    ref = jsample(jden, shape, jax.random.PRNGKey(seed), js, sampler, T=T,
                  steps=steps, ts=ts_, s_churn=churn, s_tmin=tmin,
                  s_tmax=tmax)
    x_T, noise = jax_draws(seed, shape, js.sigma_max, 8)
    out = tsample(tden, shape, ts, sampler, T=T, steps=steps, ts=ts_,
                  x_T=x_T, noise=noise, s_churn=churn, s_tmin=tmin,
                  s_tmax=tmax)
    return out.numpy(), np.asarray(ref)


# the Bayes denoiser of data ~ N(MU, S^2): (S^2 x + sigma^2 MU) / (S^2 + sigma^2)
S2 = 0.25
MU = np.linspace(-1.0, 1.0, 2 * 12 * 4, dtype=np.float32).reshape(2, 12, 4)


def jax_closed_form(x, sigma):
    s2 = (sigma ** 2)[:, None, None]
    return (S2 * x + s2 * MU) / (S2 + s2)


def torch_closed_form(x, sigma):
    s2 = (sigma ** 2)[:, None, None]
    return (S2 * x + s2 * torch.from_numpy(MU)) / (S2 + s2)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sampler_closed_form_denoiser(case):
    out, ref = run_both(jax_closed_form, torch_closed_form, MU.shape, case)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)


def test_sampler_rejects_unknown_name_and_short_noise():
    from cmtts_tpu_torch.cm.sampling import sample_mel

    _, ts = schedules()
    with pytest.raises(ValueError, match="unknown sampler"):
        sample_mel(torch_closed_form, MU.shape, ts, "ddim")
    x_T = torch.zeros(MU.shape)
    with pytest.raises(ValueError, match="more noise"):
        sample_mel(torch_closed_form, MU.shape, ts, "ancestral", steps=4,
                   x_T=x_T, noise=[torch.zeros(MU.shape)])


@pytest.fixture(scope="module")
def tiny_cm():
    """The tiny multi-speaker CMTTS (speaker table) conditioned once on
    each side; returns both bare denoise closures and the mel shape."""
    from cmtts_tpu.cm.karras import KarrasSchedule
    from cmtts_tpu.models.cmtts import CMTTS

    jcfg, tcfg = both_configs(speaker_embedder="none")
    params = flax_cm_params(jcfg)
    model = torch_cm(tcfg, params)
    texts, lens = padded(tokens(np.random.RandomState(11), [9, 6]), 16)
    speakers = np.array([1, 3], np.int32)
    t_mel = 64
    jm = CMTTS(jcfg)
    cond = jm.apply({"params": params}, speakers=jnp.asarray(speakers),
                    texts=jnp.asarray(texts), src_lens=jnp.asarray(lens),
                    t_mel=t_mel, method=CMTTS.condition)
    sched = KarrasSchedule()

    @jax.jit
    def jden(x_t, sigma):
        c_skip, c_out, c_in = sched.active_scalings(sigma)
        out = jm.apply({"params": params}, c_in[:, None, None] * x_t,
                       sched.rescale_t(sigma), cond["cond"],
                       cond["speaker_emb"], method=CMTTS.denoise)
        return c_out[:, None, None] * out + c_skip[:, None, None] * x_t

    with torch.no_grad():
        tcond = model.condition(torch.from_numpy(texts).long(),
                                torch.from_numpy(lens).long(), t_mel,
                                speakers=torch.from_numpy(speakers).long())
    np.testing.assert_allclose(tcond["cond"].numpy(),
                               np.asarray(cond["cond"]), **TOL)
    tsched = schedules()[1]

    def tden(x_t, sigma):
        c_skip, c_out, c_in = tsched.active_scalings(sigma)
        with torch.no_grad():
            out = model.denoise(c_in[:, None, None] * x_t,
                                tsched.rescale_t(sigma), tcond["cond"],
                                tcond["speaker_emb"])
        return c_out[:, None, None] * out + c_skip[:, None, None] * x_t

    return jden, tden, (2, t_mel, jcfg.stft.n_mel_channels)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sampler_tiny_cmtts(tiny_cm, case):
    jden, tden, shape = tiny_cm
    out, ref = run_both(jden, tden, shape, case)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
