# Copied from cmtts_tpu/core/config.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Typed configuration for CM-TTS-TPU.

The reference loads three YAML files per dataset into raw nested dicts and
threads them through every constructor (reference ``utils/tools.py:25-33``,
``config/<DATASET>/{preprocess,model,train}.yaml``).  We preserve that
three-file surface on disk (so existing configs keep working) but parse it
into frozen dataclasses once, at startup, with validation — models and the
training engine only ever see typed config objects.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any

import yaml


def _get(d: dict, *keys, default=None):
    cur: Any = d
    for k in keys:
        if not isinstance(cur, dict) or k not in cur:
            return default
        cur = cur[k]
    return cur


@dataclass(frozen=True)
class StftConfig:
    """STFT / mel front-end (reference ``config/*/preprocess.yaml`` stft+mel)."""

    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float | None = 8000.0
    max_wav_value: float = 32768.0


@dataclass(frozen=True)
class PitchConfig:
    """Pitch extraction / normalization (reference ``preprocess.yaml`` pitch).

    ``cwt_n_scales`` is fixed at 10 by the reference CWT setup
    (``utils/pitch_tools.py:179-195``: s0=0.01, dj=1, J=9 -> 10 scales).
    """

    pitch_type: str = "cwt"  # 'frame' | 'ph' | 'cwt'
    pitch_norm: str = "log"  # 'standard' | 'log'
    pitch_norm_eps: float = 1e-9
    pitch_ar: bool = False
    with_f0: bool = True
    with_f0cwt: bool = True
    use_uv: bool = True
    f0_mean: float = 0.0  # corpus stats, filled from stats.json for 'standard'
    f0_std: float = 1.0
    # standardize the inverse-CWT reconstruction over VALID frames only
    # (padding-invariant f0; fix over the reference's padded-std
    # behavior, see audio/pitch.inverse_cwt_jnp). Off = exact reference
    # parity.
    cwt_masked_std: bool = False
    cwt_n_scales: int = 10

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class EnergyConfig:
    feature: str = "phoneme_level"  # 'phoneme_level' | 'frame_level'
    normalization: bool = True
    # corpus stats (stats.json "energy" [min, max, mean, std])
    energy_min: float = 0.0
    energy_max: float = 1.0


@dataclass(frozen=True)
class TransformerConfig:
    """FFT-block encoder hyperparameters (reference ``model.yaml`` transformer)."""

    encoder_layer: int = 4
    encoder_head: int = 2
    encoder_hidden: int = 256
    decoder_layer: int = 4
    decoder_head: int = 2
    decoder_hidden: int = 256
    ffn_kernel_size: int = 9
    encoder_dropout: float = 0.1
    decoder_dropout: float = 0.1
    ffn_padding: str = "SAME"
    ffn_act: str = "gelu"


@dataclass(frozen=True)
class DenoiserConfig:
    """WaveNet denoiser (reference ``model.yaml`` denoiser)."""

    residual_layers: int = 20
    residual_channels: int = 256
    denoiser_dropout: float = 0.2
    # lax.scan unroll factor for the residual-block stack: >1 exposes
    # cross-block fusion/pipelining to XLA at the cost of compile time
    # (v5e, batch 32x768 bf16: full train step 37.5 -> 32.5 ms at full
    # unroll — tools/bench_train.py --unroll 20). Default = full unroll
    # for the reference's 20-layer denoiser; YAML/--scan_unroll override.
    scan_unroll: int = 20


@dataclass(frozen=True)
class VariancePredictorConfig:
    filter_size: int = 256
    predictor_grad: float = 0.1
    predictor_layers: int = 2
    predictor_kernel: int = 5
    cwt_hidden_size: int = 128
    cwt_std_scale: float = 0.8
    dur_predictor_layers: int = 2
    dur_predictor_kernel: int = 3
    dropout: float = 0.5


@dataclass(frozen=True)
class VarianceEmbeddingConfig:
    use_pitch_embed: bool = True
    pitch_n_bins: int = 300
    use_energy_embed: bool = True
    energy_n_bins: int = 256
    energy_quantization: str = "linear"


@dataclass(frozen=True)
class DiscriminatorConfig:
    """JCU discriminator layer plan for the legacy DiffGAN-TTS path
    (reference ``model.yaml`` discriminator block; the module itself is
    supplied by :mod:`cmtts_tpu.models.discriminator` — absent from the
    reference snapshot)."""

    n_layer: int = 3
    n_uncond_layer: int = 2
    n_cond_layer: int = 2
    n_channels: tuple[int, ...] = (64, 128, 512, 128, 1)
    kernel_sizes: tuple[int, ...] = (3, 5, 5, 5, 3)
    strides: tuple[int, ...] = (1, 2, 2, 1, 1)


@dataclass(frozen=True)
class ModelConfig:
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    denoiser: DenoiserConfig = field(default_factory=DenoiserConfig)
    discriminator: DiscriminatorConfig = field(
        default_factory=DiscriminatorConfig)
    variance_predictor: VariancePredictorConfig = field(
        default_factory=VariancePredictorConfig
    )
    variance_embedding: VarianceEmbeddingConfig = field(
        default_factory=VarianceEmbeddingConfig
    )
    multi_speaker: bool = False
    n_speakers: int = 1
    external_speaker_dim: int = 512
    speaker_embedder: str = "none"  # 'none' | 'DeepSpeaker' | 'GE2E'
    max_seq_len: int = 1000
    vocoder_model: str = "HiFi-GAN"
    vocoder_speaker: str = "LJSpeech"


@dataclass(frozen=True)
class LossConfig:
    """Variance-loss lambdas (reference ``train.yaml`` loss) plus the
    legacy DiffGAN-TTS adversarial lambdas (train.yaml:29-44)."""

    dur_loss: str = "mse"
    pitch_loss: str = "l1"
    cwt_loss: str = "l1"
    lambda_f0: float = 1.0
    lambda_uv: float = 1.0
    lambda_ph_dur: float = 1.0
    lambda_word_dur: float = 0.0
    lambda_sent_dur: float = 1.0
    adv_loss_mode: str = "lsgan"
    lambda_d: float = 0.1
    lambda_p: float = 0.1
    lambda_e: float = 0.1
    lambda_fm: float = 10.0
    lambda_fm_shallow: float = 0.001


@dataclass(frozen=True)
class CMConfig:
    """Consistency-model hyperparameters (reference ``train.yaml`` cm block,
    consumed by ``model/cm_tool/script_util.py`` and ``karras_diffusion.py:35-64``)."""

    training_mode: str = "consistency_training"
    target_ema_mode: str = "fixed"
    start_ema: float = 0.95
    scale_mode: str = "fixed"
    start_scales: int = 3
    end_scales: int = 200
    total_training_steps: int = 800000
    distill_steps_per_iter: int = 10
    loss_norm: str = "l1"
    weight_schedule: str = "uniform"
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    rho: float = 7.0
    lr: float = 1e-4
    weight_decay: float = 0.0
    ema_rate: tuple[float, ...] = (0.999, 0.9999, 0.9999432189950708)
    schedule_sampler: str = "linear12"
    microbatch: int = -1
    lr_anneal_steps: int = 0
    # synthesis-time defaults
    sampler: str = "onestep"
    generator: str = "determ"
    seed: int = 42
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_noise: float = 1.0
    teacher_model_path: str = ""


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    group_size: int = 4
    grad_clip_thresh: float = 1.0
    total_step: int = 1200000
    log_step: int = 100
    synth_step: int = 1000
    val_step: int = 1000
    save_step: int = 10000
    ckpt_path: str = "./output/ckpt"
    log_path: str = "./output/log"
    result_path: str = "./output/result"
    loss: LossConfig = field(default_factory=LossConfig)
    cm: CMConfig = field(default_factory=CMConfig)


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "LJSpeech"
    corpus_path: str = ""
    lexicon_path: str = "lexicon/librispeech-lexicon.txt"
    raw_path: str = ""
    preprocessed_path: str = ""
    val_size: int = 512
    text_cleaners: tuple[str, ...] = ("english_cleaners",)
    language: str = "en"


@dataclass(frozen=True)
class Config:
    """Top-level framework configuration (all three reference YAML files)."""

    data: DataConfig = field(default_factory=DataConfig)
    stft: StftConfig = field(default_factory=StftConfig)
    pitch: PitchConfig = field(default_factory=PitchConfig)
    energy: EnergyConfig = field(default_factory=EnergyConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def _parse_ema_rate(v) -> tuple[float, ...]:
    if isinstance(v, str):
        return tuple(float(x) for x in v.split(",") if x)
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def config_from_dicts(
    preprocess: dict, model: dict, train: dict, stats: dict | None = None
) -> Config:
    """Build a typed :class:`Config` from the three reference-format dicts.

    ``stats`` is the parsed ``stats.json`` written by preprocessing
    (reference ``preprocessor/preprocessor.py:196-212``); it supplies the
    energy-bin boundaries and (for pitch_norm='standard') the f0 moments.
    """
    stats = stats or {}
    pp = preprocess.get("preprocessing", {})

    fmax = _get(pp, "mel", "mel_fmax")
    stft = StftConfig(
        sampling_rate=int(_get(pp, "audio", "sampling_rate", default=22050)),
        filter_length=int(_get(pp, "stft", "filter_length", default=1024)),
        hop_length=int(_get(pp, "stft", "hop_length", default=256)),
        win_length=int(_get(pp, "stft", "win_length", default=1024)),
        n_mel_channels=int(_get(pp, "mel", "n_mel_channels", default=80)),
        mel_fmin=float(_get(pp, "mel", "mel_fmin", default=0.0)),
        mel_fmax=None if fmax is None else float(fmax),
        max_wav_value=float(_get(pp, "audio", "max_wav_value", default=32768.0)),
    )

    f0_stats = stats.get("f0", [0.0, 1.0])
    pitch = PitchConfig(
        pitch_type=_get(pp, "pitch", "pitch_type", default="cwt"),
        pitch_norm=_get(pp, "pitch", "pitch_norm", default="log"),
        pitch_norm_eps=float(_get(pp, "pitch", "pitch_norm_eps", default=1e-9)),
        pitch_ar=bool(_get(pp, "pitch", "pitch_ar", default=False)),
        with_f0=bool(_get(pp, "pitch", "with_f0", default=True)),
        with_f0cwt=bool(_get(pp, "pitch", "with_f0cwt", default=True)),
        use_uv=bool(_get(pp, "pitch", "use_uv", default=True)),
        f0_mean=float(f0_stats[0]),
        f0_std=float(f0_stats[1]),
        cwt_masked_std=bool(_get(pp, "pitch", "cwt_masked_std",
                                 default=False)),
    )

    e_stats = stats.get("energy", [0.0, 1.0, 0.0, 1.0])
    energy = EnergyConfig(
        feature=_get(pp, "energy", "feature", default="phoneme_level"),
        normalization=bool(_get(pp, "energy", "normalization", default=True)),
        energy_min=float(e_stats[0]),
        energy_max=float(e_stats[1]),
    )

    tr = model.get("transformer", {})
    transformer = TransformerConfig(
        encoder_layer=int(tr.get("encoder_layer", 4)),
        encoder_head=int(tr.get("encoder_head", 2)),
        encoder_hidden=int(tr.get("encoder_hidden", 256)),
        decoder_layer=int(tr.get("decoder_layer", 4)),
        decoder_head=int(tr.get("decoder_head", 2)),
        decoder_hidden=int(tr.get("decoder_hidden", 256)),
        ffn_kernel_size=int(tr.get("ffn_kernel_size", 9)),
        encoder_dropout=float(tr.get("encoder_dropout", 0.1)),
        decoder_dropout=float(tr.get("decoder_dropout", 0.1)),
        ffn_padding=tr.get("ffn_padding", "SAME"),
        ffn_act=tr.get("ffn_act", "gelu"),
    )

    dn = model.get("denoiser", {})
    denoiser = DenoiserConfig(
        residual_layers=int(dn.get("residual_layers", 20)),
        residual_channels=int(dn.get("residual_channels", 256)),
        denoiser_dropout=float(dn.get("denoiser_dropout", 0.2)),
    )

    vp = model.get("variance_predictor", {})
    variance_predictor = VariancePredictorConfig(
        filter_size=int(vp.get("filter_size", 256)),
        predictor_grad=float(vp.get("predictor_grad", 0.1)),
        predictor_layers=int(vp.get("predictor_layers", 2)),
        predictor_kernel=int(vp.get("predictor_kernel", 5)),
        cwt_hidden_size=int(vp.get("cwt_hidden_size", 128)),
        cwt_std_scale=float(vp.get("cwt_std_scale", 0.8)),
        dur_predictor_layers=int(vp.get("dur_predictor_layers", 2)),
        dur_predictor_kernel=int(vp.get("dur_predictor_kernel", 3)),
        dropout=float(vp.get("dropout", 0.5)),
    )

    ve = model.get("variance_embedding", {})
    variance_embedding = VarianceEmbeddingConfig(
        use_pitch_embed=bool(ve.get("use_pitch_embed", True)),
        pitch_n_bins=int(ve.get("pitch_n_bins", 300)),
        use_energy_embed=bool(ve.get("use_energy_embed", True)),
        energy_n_bins=int(ve.get("energy_n_bins", 256)),
        energy_quantization=ve.get("energy_quantization", "linear"),
    )

    dc = model.get("discriminator", {})
    discriminator = DiscriminatorConfig(
        n_layer=int(dc.get("n_layer", 3)),
        n_uncond_layer=int(dc.get("n_uncond_layer", 2)),
        n_cond_layer=int(dc.get("n_cond_layer", 2)),
        n_channels=tuple(dc.get("n_channels", (64, 128, 512, 128, 1))),
        kernel_sizes=tuple(dc.get("kernel_sizes", (3, 5, 5, 5, 3))),
        strides=tuple(dc.get("strides", (1, 2, 2, 1, 1))),
    )

    model_cfg = ModelConfig(
        transformer=transformer,
        denoiser=denoiser,
        discriminator=discriminator,
        variance_predictor=variance_predictor,
        variance_embedding=variance_embedding,
        multi_speaker=bool(model.get("multi_speaker", False)),
        n_speakers=int(stats.get("n_speakers", model.get("n_speakers", 1))),
        external_speaker_dim=int(model.get("external_speaker_dim", 512)),
        speaker_embedder=_get(pp, "speaker_embedder", default="none") or "none",
        max_seq_len=int(model.get("max_seq_len", 1000)),
        vocoder_model=_get(model, "vocoder", "model", default="HiFi-GAN"),
        vocoder_speaker=_get(model, "vocoder", "speaker", default="LJSpeech"),
    )

    ls = train.get("loss", {})
    loss = LossConfig(
        dur_loss=ls.get("dur_loss", "mse"),
        pitch_loss=ls.get("pitch_loss", "l1"),
        cwt_loss=ls.get("cwt_loss", "l1"),
        lambda_f0=float(ls.get("lambda_f0", 1.0)),
        lambda_uv=float(ls.get("lambda_uv", 1.0)),
        lambda_ph_dur=float(ls.get("lambda_ph_dur", 1.0)),
        lambda_word_dur=float(ls.get("lambda_word_dur", 0.0)),
        lambda_sent_dur=float(ls.get("lambda_sent_dur", 1.0)),
        adv_loss_mode=ls.get("adv_loss_mode", "lsgan"),
        lambda_d=float(ls.get("lambda_d", 0.1)),
        lambda_p=float(ls.get("lambda_p", 0.1)),
        lambda_e=float(ls.get("lambda_e", 0.1)),
        lambda_fm=float(ls.get("lambda_fm", 10.0)),
        lambda_fm_shallow=float(ls.get("lambda_fm_shallow", 0.001)),
    )

    cm = train.get("cm", {})
    cm_cfg = CMConfig(
        training_mode=cm.get("training_mode", "consistency_training"),
        target_ema_mode=cm.get("target_ema_mode", "fixed"),
        start_ema=float(cm.get("start_ema", 0.95)),
        scale_mode=cm.get("scale_mode", "fixed"),
        start_scales=int(cm.get("start_scales", 3)),
        end_scales=int(cm.get("end_scales", 200)),
        total_training_steps=int(cm.get("total_training_steps", 800000)),
        distill_steps_per_iter=int(cm.get("distill_steps_per_iter", 10)),
        loss_norm=cm.get("loss_norm", "l1"),
        weight_schedule=cm.get("weight_schedule", "uniform"),
        sigma_min=float(cm.get("sigma_min", 0.002)),
        sigma_max=float(cm.get("sigma_max", 80.0)),
        lr=float(cm.get("lr", 1e-4)),
        weight_decay=float(cm.get("weight_decay", 0.0)),
        ema_rate=_parse_ema_rate(cm.get("ema_rate", "0.999,0.9999,0.9999432189950708")),
        schedule_sampler=cm.get("schedule_sampler", "linear12"),
        microbatch=int(cm.get("microbatch", -1)),
        lr_anneal_steps=int(cm.get("lr_anneal_steps", 0) or 0),
        sampler=cm.get("sampler", "onestep"),
        generator=cm.get("generator", "determ"),
        seed=int(cm.get("seed", 42)),
        s_churn=float(cm.get("s_churn", 0.0)),
        s_tmin=float(cm.get("s_tmin", 0.0)),
        s_noise=float(cm.get("s_noise", 1.0)),
        teacher_model_path=cm.get("teacher_model_path") or "",
    )

    step = train.get("step", {})
    paths = train.get("path", {})
    train_cfg = TrainConfig(
        batch_size=int(_get(train, "optimizer", "batch_size", default=32)),
        grad_clip_thresh=float(_get(train, "optimizer", "grad_clip_thresh", default=1.0)),
        total_step=int(step.get("total_step_consistency_training", 1200000)),
        log_step=int(step.get("log_step", 100)),
        synth_step=int(step.get("synth_step", 1000)),
        val_step=int(step.get("val_step", 1000)),
        save_step=int(step.get("save_step", 10000)),
        ckpt_path=paths.get("ckpt_path", "./output/ckpt"),
        log_path=paths.get("log_path", "./output/log"),
        result_path=paths.get("result_path", "./output/result"),
        loss=loss,
        cm=cm_cfg,
    )

    data_cfg = DataConfig(
        dataset=preprocess.get("dataset", "LJSpeech"),
        corpus_path=_get(preprocess, "path", "corpus_path", default="") or "",
        lexicon_path=_get(preprocess, "path", "lexicon_path", default="") or "",
        raw_path=_get(preprocess, "path", "raw_path", default="") or "",
        preprocessed_path=_get(preprocess, "path", "preprocessed_path", default="") or "",
        val_size=int(_get(pp, "val_size", default=512)),
        text_cleaners=tuple(_get(pp, "text", "text_cleaners", default=["english_cleaners"])),
        language=_get(pp, "text", "language", default="en"),
    )

    return Config(
        data=data_cfg,
        stft=stft,
        pitch=pitch,
        energy=energy,
        model=model_cfg,
        train=train_cfg,
    )


def default_config_root() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "config")


def load_yaml_configs(dataset: str, config_root: str | None = None) -> tuple[dict, dict, dict]:
    """Load the raw three-YAML surface for a dataset (reference ``utils/tools.py:25-33``)."""
    root = config_root or default_config_root()
    out = []
    for name in ("preprocess", "model", "train"):
        path = os.path.join(root, dataset, f"{name}.yaml")
        with open(path) as f:
            out.append(yaml.safe_load(f))
    return tuple(out)  # type: ignore[return-value]


def load_stats(preprocessed_path: str) -> dict:
    """Load corpus stats.json if present (written by preprocessing)."""
    import json

    path = os.path.join(preprocessed_path, "stats.json")
    if os.path.exists(path):
        with open(path) as f:
            stats = json.load(f)
    else:
        stats = {}
    speakers = os.path.join(preprocessed_path, "speakers.json")
    if os.path.exists(speakers):
        with open(speakers) as f:
            stats["n_speakers"] = len(json.load(f))
    return stats


def load_configs(dataset: str, config_root: str | None = None) -> Config:
    """One-call typed config load: YAMLs + stats.json."""
    preprocess, model, train = load_yaml_configs(dataset, config_root)
    stats = load_stats(_get(preprocess, "path", "preprocessed_path", default="") or "")
    return config_from_dicts(preprocess, model, train, stats)
