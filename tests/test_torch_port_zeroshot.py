"""Multi-speaker and zero-shot synthesis of the port against the JAX
package on flax-initialised weights carried across by the bridge: the
variance adaptor's phoneme- and frame-level pitch and frame-level energy
with a speaker add, ``CMTTS`` with a speaker table and with an external
embedding, and the ``Synthesizer`` with external embeddings, tiny and at
the VCTK config's width.  float32 on the CPU."""

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

# float32 end to end, summation order only
TOL = dict(rtol=1e-5, atol=1e-5)
RTOL, ATOL = 1e-4, 1e-4   # the per-module tolerance of the slice before


def t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("pitch_type,energy_feature,with_speaker", [
    ("ph", "phoneme_level", True),
    ("frame", "frame_level", True),
    ("cwt", "frame_level", False),
])
def test_variance_adaptor_pitch_and_energy(pitch_type, energy_feature,
                                           with_speaker):
    from cmtts_tpu.models.variance import VarianceAdaptor as J
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.variance import VarianceAdaptor as T

    jcfg, tcfg = both_configs(pitch_type=pitch_type,
                              energy_feature=energy_feature)
    rs = np.random.RandomState(2)
    lens = np.array([16, 9], np.int32)
    pad = np.arange(16)[None, :] >= lens[:, None]
    x = (rs.randn(2, 16, 32) * (~pad)[..., None]).astype(np.float32)
    spk = (rs.randn(2, 32) * 0.5).astype(np.float32) if with_speaker else None
    mc = jcfg.model
    jva = J(mc.transformer, mc.variance_predictor, mc.variance_embedding,
            jcfg.pitch, jcfg.energy)
    params = jax.tree_util.tree_map(np.array, jax.jit(
        jva.init, static_argnums=3)(jax.random.PRNGKey(0), jnp.asarray(x),
                                    jnp.asarray(pad), 128)["params"])
    # ~3 frames a phoneme (random init predicts ~0)
    params["duration_predictor"]["proj"]["bias"][:] = np.log(4.0)
    ref = jva.apply({"params": params}, jnp.asarray(x), jnp.asarray(pad), 128,
                    speaker_emb=None if spk is None else jnp.asarray(spk))
    mt = tcfg.model
    model = load_flax_params(T(mt.transformer, mt.variance_predictor,
                               mt.variance_embedding, tcfg.pitch,
                               tcfg.energy), params).eval()
    with torch.no_grad():
        out = model(t(x), t(pad), 128,
                    speaker_emb=None if spk is None else t(spk))
    for k in ("mel2ph", "mel_lens"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    assert 0 < out["mel_lens"].min() and out["mel_lens"].max() < 128
    for k in ("log_d_pred", "e_pred", "cond"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=ATOL)
    if pitch_type != "cwt":
        for k in ("pitch_pred", "f0_denorm"):
            np.testing.assert_allclose(out["p_pred"][k].numpy(),
                                       np.asarray(ref["p_pred"][k]),
                                       rtol=RTOL, atol=ATOL)
    if pitch_type == "frame":   # frames past the utterance carry f0 = 0
        f0 = out["p_pred"]["f0_denorm"].numpy()
        assert (f0[out["mel2ph"].numpy() == 0] == 0).all()
    assert out["e_pred"].shape == ((2, 128) if energy_feature == "frame_level"
                                   else (2, 16))


@pytest.mark.parametrize("embedder", ["none", "DeepSpeaker"])
def test_multi_speaker_cmtts(embedder):
    from cmtts_tpu.models.cmtts import CMTTS

    jcfg, tcfg = both_configs(speaker_embedder=embedder)
    params = flax_cm_params(jcfg)
    model = torch_cm(tcfg, params)
    n_flax = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(v.numel() for v in model.state_dict().values())
    rs = np.random.RandomState(5)
    texts, lens = padded(tokens(rs, [14, 9]), 16)
    speakers = np.array([2, 1], np.int32)
    embeds = rs.randn(2, 8).astype(np.float32)
    ref = CMTTS(jcfg).apply(
        {"params": params}, speakers=jnp.asarray(speakers),
        texts=jnp.asarray(texts), src_lens=jnp.asarray(lens), t_mel=128,
        spker_embeds=jnp.asarray(embeds), method=CMTTS.condition)
    with torch.no_grad():
        out = model.condition(t(texts).long(), t(lens).long(), 128,
                              speakers=t(speakers).long(),
                              spker_embeds=t(embeds))
    np.testing.assert_array_equal(out["mel_lens"].numpy(),
                                  np.asarray(ref["mel_lens"]))
    for k in ("speaker_emb", "cond"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=ATOL)
    x = rs.randn(2, 128, 16).astype(np.float32)
    steps = np.array([1095.5, 310.0], np.float32)
    ref_d = CMTTS(jcfg).apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(steps), ref["cond"],
                              ref["speaker_emb"], method=CMTTS.denoise)
    with torch.no_grad():
        out_d = model.denoise(t(x), t(steps), out["cond"], out["speaker_emb"])
        out_f, _ = model(t(x), t(steps), t(texts).long(), t(lens).long(),
                         speakers=t(speakers).long(), spker_embeds=t(embeds))
    np.testing.assert_allclose(out_d.numpy(), np.asarray(ref_d), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(out_f.numpy(), out_d.numpy())


def run_both(jcfg, tcfg, seqs, embeds, T, buckets, mel_bucket=None, seed=7):
    """JAX's Synthesizer from PRNGKey(seed) and the port's with JAX's draws
    injected, mel only: (JAX's (mel, lens), the port's, the port's
    Synthesizer)."""
    from cmtts_tpu.pipeline import Synthesizer as JSynth
    from cmtts_tpu_torch.pipeline import Synthesizer as TSynth

    params = flax_cm_params(jcfg)
    text_b, mel_b = buckets
    jsynth = JSynth(jcfg, params, None, T=T, text_buckets=text_b,
                    mel_buckets=mel_b, compute_dtype=jnp.float32)
    mel_r, lens_r, _ = jsynth(seqs, spker_embeds=embeds, seed=seed,
                              mel_bucket=mel_bucket)
    x_T, noise = jax_draws(seed, mel_r.shape, jsynth.sched.sigma_max, T)
    tsynth = TSynth(tcfg, torch_cm(tcfg, params), None, T=T,
                    text_buckets=text_b, mel_buckets=mel_b,
                    compute_dtype=torch.float32, device="cpu")
    mel, lens, wav = tsynth(seqs, spker_embeds=embeds, mel_bucket=mel_bucket,
                            x_T=x_T, noise=noise)
    assert wav is None
    return (mel_r, lens_r), (mel, lens), tsynth


@pytest.mark.parametrize("T", [1, 2])
def test_synthesizer_zeroshot_matches_jax(T):
    jcfg, tcfg = both_configs(speaker_embedder="GE2E")
    seqs = tokens(np.random.RandomState(3), [8, 5])
    embeds = np.random.RandomState(4).randn(2, 8).astype(np.float32)
    (mel_r, lens_r), (mel, lens), synth = run_both(
        jcfg, tcfg, seqs, embeds, T, ((8, 16), (32, 64, 128)))
    np.testing.assert_array_equal(lens, lens_r)
    assert 0 < lens.min() and lens.max() < mel.shape[1] == mel_r.shape[1]
    np.testing.assert_allclose(mel, mel_r, **TOL)
    # another voice changes the mel
    mel2, _, _ = synth(seqs, spker_embeds=embeds + 1.0, mel_bucket=mel.shape[1])
    mel1, _, _ = synth(seqs, spker_embeds=embeds, mel_bucket=mel.shape[1])
    assert np.abs(mel1 - mel2).max() > 1e-3


def test_synthesizer_requires_embedding():
    from cmtts_tpu_torch.pipeline import Synthesizer

    _, tcfg = both_configs(speaker_embedder="DeepSpeaker")
    from cmtts_tpu_torch.models.cmtts import CMTTS

    synth = Synthesizer(tcfg, CMTTS(tcfg), None, text_buckets=(8,),
                        mel_buckets=(32,), device="cpu")
    with pytest.raises(ValueError, match="spker_embeds required"):
        synth([np.array([15, 16], np.int32)], mel_bucket=32)


def test_vctk_acoustic_model_full_width():
    """The VCTK config as shipped (4x256 encoder, 20x256 denoiser, 80 mels,
    DeepSpeaker embeddings of 512 projected to 256): flax-initialised
    params load strict=True, and B=1 at text bucket 32 / mel bucket 128
    matches JAX, mel only."""
    from cmtts_tpu.core.config import load_configs as jload
    from cmtts_tpu_torch.core.config import load_configs as tload

    jcfg, tcfg = jload("VCTK"), tload("VCTK")
    assert tcfg.model.multi_speaker and tcfg.model.external_speaker_dim == 512
    embed = np.random.RandomState(6).randn(1, 512).astype(np.float32)
    embed /= np.linalg.norm(embed)
    (mel_r, lens_r), (mel, lens), _ = run_both(
        jcfg, tcfg, tokens(np.random.RandomState(7), [18]), embed, 1,
        ((32,), (128,)), mel_bucket=128)
    np.testing.assert_array_equal(lens, lens_r)
    assert 0 < lens[0] < 128 and mel.shape == (1, 128, 80)
    np.testing.assert_allclose(mel, mel_r, rtol=1e-3, atol=1e-3)
