"""The reference's reading of a configuration file of ``perfbench/configs``:
the fields the plain modules use, with the reference's YAML defaults
(CM-TTS ``config/<dataset>/{preprocess,model,train}.yaml``), as plain
namespaces.  Independent of the program's own config parser."""

from __future__ import annotations

from types import SimpleNamespace as NS


def _get(d: dict, *keys, default=None):
    for k in keys:
        if not isinstance(d, dict) or k not in d:
            return default
        d = d[k]
    return d


def read_config(cfg: dict) -> NS:
    pre, model, train = cfg["preprocess"], cfg["model"], cfg["train"]
    stats = cfg.get("stats", {})
    pp = pre.get("preprocessing", {})
    tr, dn = model.get("transformer", {}), model.get("denoiser", {})
    vp, ve = model.get("variance_predictor", {}), model.get(
        "variance_embedding", {})
    cm = train.get("cm", {})
    f0 = stats.get("f0", [0.0, 1.0])
    energy = stats.get("energy", [0.0, 1.0, 0.0, 1.0])
    return NS(
        vocab_size=int(cfg["vocab_size"]),
        n_mels=int(_get(pp, "mel", "n_mel_channels", default=80)),
        hop=int(_get(pp, "stft", "hop_length", default=256)),
        sampling_rate=int(_get(pp, "audio", "sampling_rate", default=22050)),
        max_seq_len=int(model.get("max_seq_len", 1000)),
        multi_speaker=bool(model.get("multi_speaker", False)),
        speaker_embedder=_get(pp, "speaker_embedder", default="none") or "none",
        external_speaker_dim=int(model.get("external_speaker_dim", 512)),
        hidden=int(tr.get("encoder_hidden", 256)),
        heads=int(tr.get("encoder_head", 2)),
        layers=int(tr.get("encoder_layer", 4)),
        ffn_kernel=int(tr.get("ffn_kernel_size", 9)),
        ffn_act=tr.get("ffn_act", "gelu"),
        den_layers=int(dn.get("residual_layers", 20)),
        den_channels=int(dn.get("residual_channels", 256)),
        filter_size=int(vp.get("filter_size", 256)),
        predictor_layers=int(vp.get("predictor_layers", 2)),
        predictor_kernel=int(vp.get("predictor_kernel", 5)),
        cwt_hidden=int(vp.get("cwt_hidden_size", 128)),
        cwt_std_scale=float(vp.get("cwt_std_scale", 0.8)),
        dur_layers=int(vp.get("dur_predictor_layers", 2)),
        dur_kernel=int(vp.get("dur_predictor_kernel", 3)),
        use_pitch=bool(ve.get("use_pitch_embed", True)),
        pitch_bins=int(ve.get("pitch_n_bins", 300)),
        use_energy=bool(ve.get("use_energy_embed", True)),
        energy_bins=int(ve.get("energy_n_bins", 256)),
        energy_quant=ve.get("energy_quantization", "linear"),
        pitch_type=_get(pp, "pitch", "pitch_type", default="cwt"),
        pitch_norm=_get(pp, "pitch", "pitch_norm", default="log"),
        pitch_eps=float(_get(pp, "pitch", "pitch_norm_eps", default=1e-9)),
        use_uv=bool(_get(pp, "pitch", "use_uv", default=True)),
        cwt_masked_std=bool(_get(pp, "pitch", "cwt_masked_std",
                                 default=False)),
        f0_mean=float(f0[0]), f0_std=float(f0[1]),
        energy_feature=_get(pp, "energy", "feature", default="phoneme_level"),
        energy_min=float(energy[0]), energy_max=float(energy[1]),
        sigma_min=float(cm.get("sigma_min", 0.002)),
        sigma_max=float(cm.get("sigma_max", 80.0)),
        sigma_data=float(cm.get("sigma_data", 0.5)),
        distillation="consistency" in cm.get("training_mode",
                                             "consistency_training"),
        enc_dropout=float(tr.get("encoder_dropout", 0.2)),
        vp_dropout=float(vp.get("dropout", 0.5)),
        predictor_grad=float(vp.get("predictor_grad", 0.1)),
        rho=float(cm.get("rho", 7.0)),
    )
