"""Shared setup for the PyTorch port's parity tests: one set of config
dicts parsed by both packages, flax-initialised CM params, and the port's
model loaded from them through the bridge."""

import functools

import numpy as np

E_MIN, E_MAX = -1.0, 2.0


def config_dicts(tiny: bool = True, cwt_masked_std: bool = False,
                 n_mels: int = 16):
    """(preprocess, model, train, stats) dicts in the reference YAML format.
    ``tiny=False`` keeps the LJSpeech widths (config/LJSpeech)."""
    preprocess = {
        "preprocessing": {
            "mel": {"n_mel_channels": n_mels if tiny else 80},
            "pitch": {"pitch_type": "cwt", "use_uv": True,
                      "pitch_norm": "log", "pitch_norm_eps": 1e-9,
                      "cwt_masked_std": cwt_masked_std},
            "energy": {"feature": "phoneme_level"},
        },
    }
    if tiny:
        model = {
            "transformer": {"encoder_layer": 2, "encoder_hidden": 32,
                            "encoder_head": 2, "ffn_kernel_size": 9},
            "max_seq_len": 128,
            "variance_embedding": {"pitch_n_bins": 300, "energy_n_bins": 16},
            "variance_predictor": {"filter_size": 32, "cwt_hidden_size": 8},
            "denoiser": {"residual_channels": 32, "residual_layers": 3},
        }
    else:
        model = {"transformer": {"encoder_layer": 4, "encoder_hidden": 256},
                 "max_seq_len": 1000,
                 "denoiser": {"residual_channels": 256,
                              "residual_layers": 20}}
    stats = {"energy": [E_MIN, E_MAX, 0.0, 1.0]}
    return preprocess, model, {}, stats


def both_configs(**kw):
    """The same configuration parsed by cmtts_tpu and by the port."""
    from cmtts_tpu.core.config import config_from_dicts as jax_cfg
    from cmtts_tpu_torch.core.config import config_from_dicts as torch_cfg

    d = config_dicts(**kw)
    return jax_cfg(*d), torch_cfg(*d)


@functools.lru_cache(maxsize=4)
def _flax_cm_params(jcfg, seed: int, dur_bias: float):
    """flax-initialised CMTTS params (cached: one jitted init per config in
    a test process); callers get a copy."""
    import jax
    import jax.numpy as jnp

    from cmtts_tpu.models.cmtts import CMTTS

    B, t_txt = 1, 8
    rng = jax.random.PRNGKey(seed)
    variables = jax.jit(CMTTS(jcfg).init, static_argnames="deterministic")(
        {"params": rng, "dropout": rng},
        jnp.zeros((B, 32, jcfg.stft.n_mel_channels)), jnp.zeros(B),
        speakers=jnp.zeros(B, jnp.int32), texts=jnp.ones((B, t_txt), jnp.int32),
        src_lens=jnp.full((B,), t_txt, jnp.int32), deterministic=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    # random init leaves out_proj (zero-init head) at 0: give the denoiser
    # output some signal so that the parity of the whole stack is visible
    rs = np.random.RandomState(seed + 1)
    den = params["denoiser"]["out_proj"]
    den["kernel"] = (rs.randn(*den["kernel"].shape) * 0.05).astype(np.float32)
    dp = params["variance_adaptor"]["duration_predictor"]["proj"]
    dp["bias"] = np.full_like(dp["bias"], dur_bias)
    return params


def flax_cm_params(jcfg, seed: int = 0, dur_bias: float = float(np.log(7.0))):
    """flax-initialised CMTTS params as a numpy tree, with the duration
    head biased to ~6 frames per phoneme (random init predicts ~0) and a
    non-zero denoiser output head."""
    import jax

    return jax.tree_util.tree_map(np.copy,
                                  _flax_cm_params(jcfg, seed, dur_bias))


def torch_cm(tcfg, params):
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.cmtts import CMTTS

    return load_flax_params(CMTTS(tcfg), params).eval()


def tokens(rs, lengths, vocab_hi: int = 140):
    """Token id sequences of the given lengths (ids 13..vocab_hi-1)."""
    return [rs.randint(13, vocab_hi, n).astype(np.int32) for n in lengths]


def padded(seqs, t_txt: int):
    texts = np.zeros((len(seqs), t_txt), np.int32)
    for i, s in enumerate(seqs):
        texts[i, : len(s)] = s
    return texts, np.asarray([len(s) for s in seqs], np.int32)
