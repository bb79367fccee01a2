"""Shared setup for the PyTorch port's parity tests: one set of config
dicts parsed by both packages, flax-initialised CM params, and the port's
model loaded from them through the bridge."""

import functools

import numpy as np

E_MIN, E_MAX = -1.0, 2.0

# the port's log-mel front-end against the JAX one (or the card's against
# the CPU's): MEL_TOL (tests/test_torch_port_audio.py) where the mel power
# is above e^-4.  Below it two float32 FFTs' rounding, ~1e-7 of the mel
# power whatever the bin's level (3.1e-7 at most measured on a formant
# corpus), is magnified by the log, up to 1.8e-3 at the 1e-5 floor of
# near-silent frames, so all bins are also held in the linear domain:
# exp(mel) within MEL_LIN_TOL.
MEL_TOL = dict(rtol=1e-5, atol=1e-5)
MEL_LIN_TOL = dict(rtol=1e-5, atol=2e-7)


def assert_mel_close(a, b, msg=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    loud = b > -4.0
    np.testing.assert_allclose(a[loud], b[loud], **MEL_TOL, err_msg=msg)
    np.testing.assert_allclose(np.exp(a), np.exp(b), **MEL_LIN_TOL,
                               err_msg=msg)


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


def reference_state_dict(params, cfg):
    """A reference ``CMTotalTTS.state_dict()`` (numpy) holding the flax
    tree ``params``: the inverse of ``cmtts_tpu/convert/from_torch.py``'s
    rules (Dense kernel -> Linear weight (out, in); Conv kernel (k, in, out)
    -> Conv1d (out, in, k); 1x1 convs of Dense kernels; the denoiser's
    scanned blocks unstacked, its gate and filter convs concatenated into
    one 2C-out ``conv_layer``)."""
    sd = {}

    def t(w):
        return np.ascontiguousarray(np.asarray(w).T)

    def conv(w):
        return np.ascontiguousarray(np.asarray(w).transpose(2, 1, 0))

    def dense1x1(w):
        return t(w)[:, :, None]

    def ln(key, p):
        sd[key + ".weight"], sd[key + ".bias"] = p["scale"], p["bias"]

    def stack(prefix, p, n):
        for i in range(n):
            sd[f"{prefix}conv.{i}.1.weight"] = conv(p[f"conv_{i}"]["kernel"])
            sd[f"{prefix}conv.{i}.1.bias"] = p[f"conv_{i}"]["bias"]
            ln(f"{prefix}conv.{i}.3", p[f"ln_{i}"])

    def linear(key, p):
        sd[key + ".weight"] = t(p["kernel"])
        if "bias" in p:
            sd[key + ".bias"] = p["bias"]

    def predictor(prefix, p, n):
        sd[prefix + "pos_embed_alpha"] = p["pos"]["alpha"]
        stack(prefix, p["stack"], n)
        linear(prefix + "linear", p["proj"])

    cond = "duration_pitch_energy_net."
    enc, pre = params["encoder"], cond + "text_encoder."
    sd[pre + "embed_tokens.weight"] = enc["tok_embed"]["embedding"]
    ln(pre + "layer_norm", enc["ln_out"])
    for i in range(cfg.model.transformer.encoder_layer):
        b, p = enc[f"block_{i}"], f"{pre}layers.{i}.op."
        ln(p + "layer_norm1", b["ln_attn"])
        sd[p + "self_attn.in_proj_weight"] = t(b["attn"]["qkv"]["kernel"])
        sd[p + "self_attn.out_proj.weight"] = t(b["attn"]["out"]["kernel"])
        ln(p + "layer_norm2", b["ln_ffn"])
        sd[p + "ffn.ffn_1.weight"] = conv(b["ffn"]["conv"]["kernel"])
        sd[p + "ffn.ffn_1.bias"] = b["ffn"]["conv"]["bias"]
        linear(p + "ffn.ffn_2", b["ffn"]["proj"])

    va, pre = params["variance_adaptor"], cond + "variance_adaptor."
    vp = cfg.model.variance_predictor
    stack(pre + "duration_predictor.", va["duration_predictor"]["stack"],
          vp.dur_predictor_layers)
    linear(pre + "duration_predictor.linear", va["duration_predictor"]["proj"])
    if "pitch_embed" in va:
        sd[pre + "pitch_embed.weight"] = va["pitch_embed"]["embedding"]
    if "cwt_in" in va:
        linear(pre + "cwt_predictor.0", va["cwt_in"])
        predictor(pre + "cwt_predictor.1.", va["cwt_predictor"],
                  vp.predictor_layers)
        for j in (0, 2, 4):
            linear(pre + f"cwt_stats_layers.{j}",
                   va["cwt_stats"][f"layers_{j}"])
    if "pitch_predictor" in va:
        predictor(pre + "pitch_predictor.", va["pitch_predictor"],
                  vp.predictor_layers)
    if "energy_predictor" in va:
        predictor(pre + "energy_predictor.", va["energy_predictor"],
                  vp.predictor_layers)
        sd[pre + "energy_embedding.weight"] = va["energy_embed"]["embedding"]

    den, pre = params["denoiser"], "net."
    blocks = den["blocks"]
    for i in range(cfg.model.denoiser.residual_layers):
        p = f"{pre}residual_layers.{i}."
        sd[p + "diffusion_projection.linear.weight"] = t(
            blocks["t_proj"]["kernel"][i])
        sd[p + "conditioner_projection.conv.weight"] = dense1x1(
            blocks["cond_proj"]["kernel"][i])
        sd[p + "conditioner_projection.conv.bias"] = \
            blocks["cond_proj"]["bias"][i]
        sd[p + "conv_layer.conv.weight"] = conv(np.concatenate(
            [blocks["conv_gate"]["kernel"][i],
             blocks["conv_filt"]["kernel"][i]], axis=-1))
        sd[p + "conv_layer.conv.bias"] = np.concatenate(
            [blocks["conv_gate"]["bias"][i], blocks["conv_filt"]["bias"][i]])
        sd[p + "output_projection.conv.weight"] = dense1x1(
            blocks["out_proj"]["kernel"][i])
        sd[p + "output_projection.conv.bias"] = blocks["out_proj"]["bias"][i]
        if "spk_proj" in blocks:
            sd[p + "speaker_projection.linear.weight"] = t(
                blocks["spk_proj"]["kernel"][i])
    sd[pre + "input_projection.0.conv.weight"] = dense1x1(
        den["in_proj"]["kernel"])
    sd[pre + "input_projection.0.conv.bias"] = den["in_proj"]["bias"]
    sd[pre + "mlp.0.linear.weight"] = t(den["mlp_in"]["kernel"])
    sd[pre + "mlp.2.linear.weight"] = t(den["mlp_out"]["kernel"])
    for name in ("skip_projection", "output_projection"):
        key = "skip_proj" if name == "skip_projection" else "out_proj"
        sd[f"{pre}{name}.conv.weight"] = dense1x1(den[key]["kernel"])
        sd[f"{pre}{name}.conv.bias"] = den[key]["bias"]
    if "speaker_emb" in params:
        sd[cond + "speaker_emb.weight"] = params["speaker_emb"]["embedding"]
    if "speaker_proj" in params:
        linear(cond + "speaker_emb", params["speaker_proj"])
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def weight_norm_split(w, rs):
    """(weight_g, weight_v) with weight_g * v / ||v|| == w over all but the
    first axis (torch's weight norm), v a random rescaling of w per row."""
    w = np.asarray(w, np.float32)
    v = w * rs.uniform(0.5, 2.0, (w.shape[0],) + (1,) * (w.ndim - 1))
    g = np.sqrt((w ** 2).sum(axis=tuple(range(1, w.ndim)), keepdims=True))
    return g.astype(np.float32), v.astype(np.float32)


def hifigan_reference_state_dict(gen, seed: int = 0):
    """The reference ``generator_*.pth.tar`` ``["generator"]`` state dict of
    a port ``HiFiGANGenerator`` (names ``conv_pre``, ``ups.i``,
    ``resblocks.r.convs{1,2}.c``, ``conv_post``), every conv weight-normed
    (``weight_g`` / ``weight_v``)."""
    import torch

    c = gen.cfg
    rs = np.random.RandomState(seed)
    names = {"conv_pre": "conv_pre", "conv_post": "conv_post"}
    n_k = len(c.resblock_kernel_sizes)
    for i in range(len(c.upsample_rates)):
        names[f"up_{i}"] = f"ups.{i}"
        for j in range(n_k):
            for p in range(len(c.resblock_dilation_sizes[j])):
                for a in (1, 2):
                    names[f"res_{i}_{j}.conv{a}_{p}"] = \
                        f"resblocks.{i * n_k + j}.convs{a}.{p}"
    sd = {}
    for mod, ref in names.items():
        conv = gen.get_submodule(mod)
        g, v = weight_norm_split(conv.weight.detach().numpy(), rs)
        sd[ref + ".weight_g"] = torch.from_numpy(g)
        sd[ref + ".weight_v"] = torch.from_numpy(v)
        sd[ref + ".bias"] = conv.bias.detach().clone()
    return sd


def melgan_reference_module(cfg, seed: int = 0):
    """The melgan-neurips Generator (``model`` an ``nn.Sequential``, every
    conv weight-normed) built from its published architecture, random
    weights from ``seed`` (the construction of ``tests/test_melgan.py``)."""
    import torch
    import torch.nn as tnn
    from torch.nn.utils import weight_norm

    def wn_conv(*a, **k):
        return weight_norm(tnn.Conv1d(*a, **k))

    class ResnetBlock(tnn.Module):
        def __init__(self, dim, dilation):
            super().__init__()
            self.block = tnn.Sequential(
                tnn.LeakyReLU(0.2), tnn.ReflectionPad1d(dilation),
                wn_conv(dim, dim, 3, dilation=dilation),
                tnn.LeakyReLU(0.2), wn_conv(dim, dim, 1))
            self.shortcut = wn_conv(dim, dim, 1)

        def forward(self, x):
            return self.shortcut(x) + self.block(x)

    torch.manual_seed(seed)
    mult = 2 ** len(cfg.ratios)
    model = [tnn.ReflectionPad1d(3), wn_conv(cfg.num_mels, mult * cfg.ngf, 7)]
    for r in cfg.ratios:
        model += [tnn.LeakyReLU(0.2),
                  weight_norm(tnn.ConvTranspose1d(
                      mult * cfg.ngf, mult * cfg.ngf // 2, r * 2, stride=r,
                      padding=r // 2 + r % 2, output_padding=r % 2))]
        for j in range(cfg.n_residual_layers):
            model += [ResnetBlock(mult * cfg.ngf // 2, 3 ** j)]
        mult //= 2
    model += [tnn.LeakyReLU(0.2), tnn.ReflectionPad1d(3),
              wn_conv(cfg.ngf, 1, 7), tnn.Tanh()]

    class Generator(tnn.Module):
        def __init__(self):
            super().__init__()
            self.model = tnn.Sequential(*model)

        def forward(self, mel):
            """(B, n_mels, T) log10 mel -> (B, 1, T * hop)."""
            return self.model(mel)

    return Generator().eval()


def assert_adam_params_close(ref, got, lr: float, n_steps: int, what=""):
    """Params after ``n_steps`` Adam steps of rate ``lr``, the port's
    against JAX's.  A step moves each entry by about lr whatever its
    gradient's size, so a near-zero gradient whose sign differs between
    XLA and torch puts the two 2 lr apart: every entry within 2 lr per
    step, and all but one in 1e4 within lr / 100 (gradients rounded in
    another order, which Adam's normalisation scales to the step)."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 * lr * n_steps,
                               err_msg=what)
    far = ~np.isclose(got, ref, rtol=1e-6, atol=lr / 100)
    assert far.sum() <= max(1, far.size // 10_000), (what, far.sum())


def formant_corpus(root, speakers: int = 4, utts: int = 3) -> str:
    """A tiny multi-speaker formant corpus (``cli.gen_corpus --speakers``,
    1.8-4.9 s utterances, none held out): -> its ``raw/`` root of
    ``<speaker>/*.wav``."""
    import os

    from cmtts_tpu_torch.cli.gen_corpus import main

    main(["--out", str(root), "--speakers", str(speakers),
          "--utts_per_speaker", str(utts), "--holdout", "0"])
    return os.path.join(str(root), "raw")


# the two LDNet configurations of tests/test_ldnet.py:23-64 (the published
# Pretrained-LDNet-ML-2337 config.yml is not in the repository)
LDNET_V3_RNN = {
    "combine_mean_score": False, "output_type": "scalar",
    "use_mean_net": True, "mean_net_type": "rnn", "mean_net_rnn_dim": 8,
    "mean_net_dnn_dim": 8, "mean_net_output_type": "scalar",
    "mean_net_range_clipping": True, "num_judges": 6, "judge_emb_dim": 4,
    "activation": "ReLU", "encoder_type": "mobilenetv3",
    "encoder_bneck_configs": [
        [16, 3, 16, 16, True, "RE", 3, 1],
        [16, 3, 72, 24, False, "RE", 3, 1],
        [24, 5, 96, 40, True, "HS", 1, 1],
        [40, 5, 120, 40, True, "HS", 1, 1],
    ],
    "encoder_output_dim": 32, "decoder_type": "rnn", "decoder_rnn_dim": 8,
    "decoder_dnn_dim": 8, "range_clipping": True, "use_mean_listener": True,
}
LDNET_V2_FFN = {
    "combine_mean_score": False, "output_type": "categorical",
    "use_mean_net": False, "num_judges": 5, "judge_emb_dim": 3,
    "activation": "ReLU", "encoder_type": "mobilenetv2",
    "encoder_conv_first_ch": 8, "encoder_conv_t": [1, 2],
    "encoder_conv_c": [8, 16], "encoder_conv_n": [1, 2],
    "encoder_conv_s": [3, 3], "encoder_output_dim": 24,
    "decoder_type": "ffn", "decoder_dnn_dim": 16, "range_clipping": False,
    "use_mean_listener": False,
}


def seeded_module(module, seed: int):
    """``module`` with every parameter and BatchNorm statistic drawn from
    ``seed`` (a fresh module's biases are 0 and its statistics 0 and 1,
    which would hide a wrong mapping), in eval mode."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    * (0.5 / max(1, p[0].numel()) ** 0.5 if p.ndim > 1
                       else 0.1))
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.rand(m.running_mean.shape,
                                                generator=g) * 0.6 - 0.3)
                m.running_var.copy_(torch.rand(m.running_var.shape,
                                               generator=g) * 0.8 + 0.7)
    return module.eval()


def flax_trees(module):
    """(params, batch_stats) of a port module in the flax layout."""
    import torch

    from cmtts_tpu_torch.convert import state_dict_to_flax

    stats = {}
    for name, m in module.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            node = stats
            for part in name.split("."):
                node = node.setdefault(part, {})
            node["mean"] = m.running_mean.detach().cpu().numpy()
            node["var"] = m.running_var.detach().cpu().numpy()
    return state_dict_to_flax(module), stats


def _torch_lstm(sd, prefix, fwd, bwd, rs):
    """Flax cells of the two directions -> a torch bidirectional LSTM's
    weights, the summed bias split at random between its two biases."""
    for suffix, cell in (("", fwd), ("_reverse", bwd)):
        b = np.concatenate([cell[f"h{g}"]["bias"] for g in "ifgo"])
        b_hh = rs.randn(*b.shape).astype(np.float32) * 0.1
        sd[f"{prefix}.weight_ih_l0{suffix}"] = np.concatenate(
            [cell[f"i{g}"]["kernel"].T for g in "ifgo"])
        sd[f"{prefix}.weight_hh_l0{suffix}"] = np.concatenate(
            [cell[f"h{g}"]["kernel"].T for g in "ifgo"])
        sd[f"{prefix}.bias_ih_l0{suffix}"] = b - b_hh
        sd[f"{prefix}.bias_hh_l0{suffix}"] = b_hh


def _torch_convbn(sd, key, p, s, conv_i=0, bn_i=1):
    sd[f"{key}.{conv_i}.weight"] = p["conv"]["kernel"].transpose(3, 2, 0, 1)
    _torch_bn(sd, f"{key}.{bn_i}", p["bn"], s["bn"])


def _torch_bn(sd, key, p, s):
    sd[f"{key}.weight"], sd[f"{key}.bias"] = p["scale"], p["bias"]
    sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = s["mean"], s["var"]


def _torch_state_dict(sd):
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}


def mbnet_reference_state_dict(params, stats, seed: int = 0):
    """The reference MBNet state dict (``mean_net_conv``, ``mean_net_rnn``,
    ``mean_net_dnn``) whose ``convert_torch_mbnet`` is ``(params,
    stats)``: the converter inverted."""
    rs = np.random.RandomState(seed)
    sd = {}
    convs = [(0, 1, 2), (6, 7, 8), (12, 13, 14), (18, 19, 20)]
    for s, idx in enumerate(convs):
        for j, ci in enumerate(idx):
            p = params[f"conv_{s}_{j}"]
            sd[f"mean_net_conv.{ci}.weight"] = p["kernel"].transpose(
                3, 2, 0, 1)
            sd[f"mean_net_conv.{ci}.bias"] = p["bias"]
        _torch_bn(sd, f"mean_net_conv.{4 + 6 * s}", params[f"bn_{s}"],
                  stats[f"bn_{s}"])
    _torch_lstm(sd, "mean_net_rnn", params["lstm_fwd"], params["lstm_bwd"],
                rs)
    for i, name in ((0, "dnn_0"), (3, "dnn_1")):
        sd[f"mean_net_dnn.{i}.weight"] = params[name]["kernel"].T
        sd[f"mean_net_dnn.{i}.bias"] = params[name]["bias"]
    return _torch_state_dict(sd)


def ldnet_reference_state_dict(params, stats, config, seed: int = 0):
    """The reference LDNet state dict (``encoder.features.<i>``,
    ``decoder_rnn``, ``decoder_dnn.net``, ``mean_net_*``) whose
    ``convert_torch_ldnet`` is ``(params, stats)``: the converter
    inverted."""
    from cmtts_tpu_torch.metrics.ldnet import _v3_cnf

    rs = np.random.RandomState(seed)
    sd = {"judge_embedding.weight": params["judge_embedding"]["embedding"]}
    ep, es = params["encoder"], stats["encoder"]
    _torch_convbn(sd, "encoder.features.0", ep["first"], es["first"])
    if config["encoder_type"] == "mobilenetv2":
        idx = 0
        for t, n in zip(config["encoder_conv_t"], config["encoder_conv_n"]):
            for _ in range(n):
                bp, bs = ep[f"block_{idx}"], es[f"block_{idx}"]
                base, j = f"encoder.features.{idx + 1}.conv", 0
                if t != 1:
                    _torch_convbn(sd, f"{base}.{j}", bp["expand"],
                                  bs["expand"])
                    j += 1
                _torch_convbn(sd, f"{base}.{j}", bp["depthwise"],
                              bs["depthwise"])
                sd[f"{base}.{j + 1}.weight"] = \
                    bp["project"]["kernel"].transpose(3, 2, 0, 1)
                _torch_bn(sd, f"{base}.{j + 2}", bp["project_bn"],
                          bs["project_bn"])
                idx += 1
        last = idx + 1
    else:
        confs = [_v3_cnf(r) for r in config["encoder_bneck_configs"]]
        for i, (inp, _, expanded, _, use_se, *_) in enumerate(confs):
            bp, bs = ep[f"block_{i}"], es[f"block_{i}"]
            base, j = f"encoder.features.{i + 1}.block", 0
            if expanded != inp:
                _torch_convbn(sd, f"{base}.{j}", bp["expand"], bs["expand"])
                j += 1
            _torch_convbn(sd, f"{base}.{j}", bp["depthwise"],
                          bs["depthwise"])
            j += 1
            if use_se:
                for fc in ("fc1", "fc2"):
                    sd[f"{base}.{j}.{fc}.weight"] = \
                        bp["se"][fc]["kernel"].transpose(3, 2, 0, 1)
                    sd[f"{base}.{j}.{fc}.bias"] = bp["se"][fc]["bias"]
                j += 1
            _torch_convbn(sd, f"{base}.{j}", bp["project"], bs["project"])
        last = len(confs) + 1
    _torch_convbn(sd, f"encoder.features.{last}", ep["last"], es["last"])
    heads = [("decoder_rnn", "dec_cell", "decoder_dnn", "decoder_dnn",
              config["decoder_type"] == "rnn")]
    if config["use_mean_net"]:
        heads.append(("mean_net_rnn", "mean_cell", "mean_net_dnn",
                      "mean_net_dnn", config["mean_net_type"] == "rnn"))
    for rnn, cell, dnn, proj, has_rnn in heads:
        if has_rnn:
            _torch_lstm(sd, rnn, params[f"{cell}_fwd"], params[f"{cell}_bwd"],
                        rs)
        for i, fc in ((0, "fc1"), (3, "fc2")):
            sd[f"{dnn}.net.{i}.weight"] = params[proj][fc]["kernel"].T
            sd[f"{dnn}.net.{i}.bias"] = params[proj][fc]["bias"]
    return _torch_state_dict(sd)


def redraw_zero_layers(unet, seed: int):
    """``unet`` with every all-zero parameter (the zero-init ``out_conv``,
    ``proj_out`` and ``out_conv_f`` that flax's init leaves at 0, and the
    biases) redrawn nonzero from ``seed``, so that a comparison sees what
    lies behind them (the attention, each ResBlock's second conv)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in unet.parameters():
            if not p.any():
                scale = (0.5 / p[0].numel() ** 0.5 if p.ndim > 1 else 0.05)
                p.copy_(torch.randn(p.shape, generator=g) * scale)
    return unet


_UNET_RES_SUBS = {"in_norm": "in_layers.0", "in_conv": "in_layers.2",
                  "emb_proj": "emb_layers.1", "out_norm": "out_layers.0",
                  "out_conv": "out_layers.3", "skip": "skip_connection",
                  "norm": "norm", "qkv": "qkv", "proj_out": "proj_out"}


def unet_reference_state_dict(tree):
    """A reference ``UNetModel`` state dict (openai/consistency_models key
    names and torch layouts) holding the flax tree ``tree``:
    ``cmtts_tpu.models.unet.convert_torch_unet`` inverted.  Attention's
    qkv and proj_out are conv1d weights (O, I, 1), plain up/down-sample
    convs sit under ``.conv`` / ``.op``."""
    import torch

    sd = {}

    def conv(w):
        w = np.asarray(w)
        if w.ndim == 4:
            return np.transpose(w, (3, 2, 0, 1))
        return np.transpose(w, (2, 1, 0))

    def leaves(prefix, node, kind):
        for leaf, v in node.items():
            if leaf in ("scale", "embedding"):
                sd[f"{prefix}.weight"] = v
            elif leaf == "kernel":
                sd[f"{prefix}.weight"] = v.T if kind == "dense" else conv(v)
            else:
                sd[f"{prefix}.{leaf}"] = v

    for name, node in tree.items():
        if name in ("time_0", "time_2"):
            leaves(f"time_embed.{name[-1]}", node, "dense")
        elif name == "label_emb":
            leaves("label_emb", node, "embed")
        elif name == "out_norm_f":
            leaves("out.0", node, "norm")
        elif name == "out_conv_f":
            leaves("out.2", node, "conv")
        else:
            stem, i, j = name.split("_")
            block = (f"middle_block.{j}" if stem == "middle"
                     else f"{stem}_blocks.{i}.{j}")
            if "kernel" in node:          # a plain conv block
                sub = ("" if (stem, i) == ("input", "0")
                       else ".op" if stem == "input" else ".conv")
                leaves(block + sub, node, "conv")
                continue
            for sub, child in node.items():
                leaves(f"{block}.{_UNET_RES_SUBS[sub]}", child,
                       "dense" if sub == "emb_proj" else "conv")
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            for k, v in sd.items()}
