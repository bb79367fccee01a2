"""Shared setup for the PyTorch port's parity tests: one set of config
dicts parsed by both packages, flax-initialised CM params, and the port's
model loaded from them through the bridge."""

import functools

import numpy as np

E_MIN, E_MAX = -1.0, 2.0


def config_dicts(tiny: bool = True, cwt_masked_std: bool = False,
                 n_mels: int = 16, speaker_embedder: str | None = None,
                 pitch_type: str = "cwt",
                 energy_feature: str = "phoneme_level"):
    """(preprocess, model, train, stats) dicts in the reference YAML format.
    ``tiny=False`` keeps the LJSpeech widths (config/LJSpeech).  A
    ``speaker_embedder`` ("none", "DeepSpeaker" or "GE2E") makes the model
    multi-speaker: 4 speakers in the table, or external embeddings of 8
    (tiny) or 512 features."""
    preprocess = {
        "preprocessing": {
            "mel": {"n_mel_channels": n_mels if tiny else 80},
            "pitch": {"pitch_type": pitch_type, "use_uv": True,
                      "pitch_norm": "log", "pitch_norm_eps": 1e-9,
                      "cwt_masked_std": cwt_masked_std},
            "energy": {"feature": energy_feature},
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
    if speaker_embedder is not None:
        preprocess["preprocessing"]["speaker_embedder"] = speaker_embedder
        model["multi_speaker"] = True
        model["external_speaker_dim"] = 8 if tiny else 512
        stats["n_speakers"] = 4
    return preprocess, model, {}, stats


def both_configs(**kw):
    """The same configuration parsed by cmtts_tpu and by the port."""
    return configs_from(config_dicts(**kw))


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
        src_lens=jnp.full((B,), t_txt, jnp.int32),
        spker_embeds=jnp.zeros((B, jcfg.model.external_speaker_dim)),
        deterministic=True)
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


def jax_draws(seed, shape, sigma_max, n_draws):
    """x_T and the next ``n_draws`` unit normals exactly as
    ``cmtts_tpu.cm.sampling`` draws them from PRNGKey(seed): every draw
    splits the key it was left, whichever sampler makes it."""
    import jax
    import jax.numpy as jnp
    import torch

    rng, sub = jax.random.split(jax.random.PRNGKey(seed))
    x_T = jax.random.normal(sub, shape, jnp.float32) * sigma_max
    noise = []
    for _ in range(n_draws):
        rng, sub = jax.random.split(rng)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))))
    return torch.from_numpy(np.array(x_T)), noise


def flat_tree(tree, prefix=""):
    """(``a/b/c`` key, leaf) pairs of a nested dict: the npz layout the
    port's checkpoint arguments read."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_tree(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def save_flat_npz(path, tree):
    np.savez(path, **dict(flat_tree(tree)))


def write_config(tmp_path, name, dicts):
    """Write (preprocess, model, train, stats) dicts as the reference's
    YAML config ``<tmp_path>/config/<name>`` with its stats.json; returns
    the config root."""
    import json
    import os

    import yaml

    pre, model, train, stats = dicts
    root = tmp_path / "config"
    (root / name).mkdir(parents=True)
    pre = dict(pre, path={"preprocessed_path": str(tmp_path / "pre"),
                          "lexicon_path": str(tmp_path / "none.txt")})
    os.makedirs(tmp_path / "pre", exist_ok=True)
    with open(tmp_path / "pre" / "stats.json", "w") as f:
        json.dump(stats, f)
    for part, d in (("preprocess", pre), ("model", model), ("train", train)):
        with open(root / name / f"{part}.yaml", "w") as f:
            yaml.safe_dump(d, f)
    return str(root)


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


def train_batch(seed, lengths, t_txt, t_mel, n_mels=16, pitch_type="cwt",
                energy_feature="phoneme_level", frames=(1, 4)):
    """A teacher-forcing batch (numpy, the layout ``collate_batch`` makes)
    with texts of the given ``lengths`` padded to ``t_txt``, durations of
    ``frames`` frames a phoneme (cut to ``t_mel``), a few silence phonemes,
    random mels and targets; f0 is phoneme-level for ``pitch_type`` ph."""
    from cmtts_tpu_torch.text import sil_phonemes_ids

    rs = np.random.RandomState(seed)
    B = len(lengths)
    seqs = tokens(rs, lengths)
    sil = sil_phonemes_ids()
    for s in seqs:
        s[rs.rand(len(s)) < 0.15] = sil[0]
    texts, src_lens = padded(seqs, t_txt)
    d = np.zeros((B, t_txt), np.int32)
    mel2ph = np.zeros((B, t_mel), np.int32)
    for b, n in enumerate(lengths):
        d[b, :n] = rs.randint(frames[0], frames[1] + 1, n)
        m = np.repeat(np.arange(1, n + 1), d[b, :n])[:t_mel]
        mel2ph[b, :len(m)] = m
    mel_lens = np.minimum(d.sum(1), t_mel).astype(np.int32)
    mels = rs.randn(B, t_mel, n_mels).astype(np.float32)
    mels[np.arange(t_mel)[None, :] >= mel_lens[:, None]] = 0.0
    f0_len = t_txt if pitch_type == "ph" else t_mel
    p_targets = {
        "pitch": rs.randint(1, 255, (B, t_mel)).astype(np.int32),
        "f0": (rs.rand(B, f0_len) * 2 + 6).astype(np.float32),
        "uv": (rs.rand(B, t_mel) > 0.7).astype(np.float32),
    }
    if pitch_type == "cwt":
        p_targets.update(
            cwt_spec=rs.randn(B, t_mel, 10).astype(np.float32),
            f0_mean=(5 + rs.rand(B)).astype(np.float32),
            f0_std=(0.2 + 0.3 * rs.rand(B)).astype(np.float32))
    e_len = t_txt if energy_feature == "phoneme_level" else t_mel
    return {
        "speakers": np.zeros(B, np.int32), "texts": texts,
        "src_lens": src_lens, "mels": mels, "mel_lens": mel_lens,
        "mel2ph": mel2ph, "d_targets": d,
        "e_targets": rs.uniform(E_MIN, E_MAX, (B, e_len)).astype(np.float32),
        "p_targets": p_targets,
    }


def jax_tree(batch):
    """A numpy batch as jnp arrays (nested dicts kept)."""
    import jax.numpy as jnp

    return {k: (jax_tree(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in batch.items() if v is not None}


def zero_dropout(dicts):
    """(preprocess, model, train, stats) with every dropout rate 0, so
    that the two packages' forwards are deterministic and comparable."""
    pre, model, train, stats = dicts
    model = dict(model)
    model["transformer"] = dict(model.get("transformer", {}),
                                encoder_dropout=0.0)
    model["variance_predictor"] = dict(model.get("variance_predictor", {}),
                                       dropout=0.0)
    return pre, model, train, stats


def configs_from(dicts):
    """(JAX config, port config) parsed from the same dicts."""
    from cmtts_tpu.core.config import config_from_dicts as jax_cfg
    from cmtts_tpu_torch.core.config import config_from_dicts as torch_cfg

    return jax_cfg(*dicts), torch_cfg(*dicts)
