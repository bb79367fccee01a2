# Copied from cmtts_tpu/convert/from_torch.py (numpy and Config only);
# load_torch_cm added.
"""Convert reference PyTorch CM-TTS checkpoints to flax param trees, which
the port's one bridge (``cmtts_tpu_torch/convert.py``) loads into ``CMTTS``.

The reference saves plain ``state_dict`` files per step
(``model/cm_tool/train_util.py:881-927``): ``model{step:06d}.pt``,
``ema_{rate}_{step:06d}.pt``, ``target_model{step:06d}.pt``.  The module
tree is ``CMTotalTTS`` (``model/cm_tool/tts_net.py:40-56``):

    duration_pitch_energy_net.text_encoder.*     FastspeechEncoder
    duration_pitch_energy_net.variance_adaptor.* VarianceAdaptor
    duration_pitch_energy_net.speaker_emb.*      Embedding | Linear
    net.*                                        Denoiser
    loss_cal_tool.*                              (no learnable params)

Layout rules (torch -> flax):
    Linear  weight (out, in)      -> Dense kernel (in, out):   W.T
    Conv1d  weight (out, in, k)   -> Conv  kernel (k, in, out): W.transpose(2,1,0)
    Embedding weight (V, H)       -> Embed embedding (V, H):    as-is
    fairseq MHA in_proj_weight (3C, C) -> fused qkv Dense (C, 3C): W.T
    LayerNorm weight/bias         -> scale/bias

The denoiser's 20 residual blocks are independent modules in torch but a
single ``nn.scan`` block with leading-axis-stacked params here — each
leaf is ``np.stack`` of the per-block tensors.
"""

from __future__ import annotations

import re

import numpy as np

from cmtts_tpu_torch.core.config import Config


def _t(w) -> np.ndarray:
    return np.asarray(w).T


def _conv(w) -> np.ndarray:
    """torch Conv1d (out, in, k) -> flax Conv (k, in, out)."""
    return np.asarray(w).transpose(2, 1, 0)


def _conv1x1_as_dense(w) -> np.ndarray:
    """torch Conv1d kernel_size=1 (out, in, 1) -> Dense kernel (in, out)."""
    return np.asarray(w)[:, :, 0].T


class _SD:
    """state_dict accessor tracking which keys were consumed."""

    def __init__(self, sd: dict):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}
        self.used: set[str] = set()

    def __call__(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.sd[key]

    def has(self, key: str) -> bool:
        return key in self.sd

    def unused(self) -> list[str]:
        skip = re.compile(
            r"(_float_tensor|num_batches_tracked|energy_bins|loss_cal_tool\.)")
        return [k for k in self.sd if k not in self.used and not skip.search(k)]


def _convert_encoder(sd: _SD, prefix: str, n_layers: int) -> dict:
    enc = {
        "tok_embed": {"embedding": sd(f"{prefix}embed_tokens.weight")},
        "ln_out": {"scale": sd(f"{prefix}layer_norm.weight"),
                   "bias": sd(f"{prefix}layer_norm.bias")},
    }
    for i in range(n_layers):
        p = f"{prefix}layers.{i}.op."
        enc[f"block_{i}"] = {
            "ln_attn": {"scale": sd(p + "layer_norm1.weight"),
                        "bias": sd(p + "layer_norm1.bias")},
            "attn": {
                "qkv": {"kernel": _t(sd(p + "self_attn.in_proj_weight"))},
                "out": {"kernel": _t(sd(p + "self_attn.out_proj.weight"))},
            },
            "ln_ffn": {"scale": sd(p + "layer_norm2.weight"),
                       "bias": sd(p + "layer_norm2.bias")},
            "ffn": {
                "conv": {"kernel": _conv(sd(p + "ffn.ffn_1.weight")),
                         "bias": sd(p + "ffn.ffn_1.bias")},
                "proj": {"kernel": _t(sd(p + "ffn.ffn_2.weight")),
                         "bias": sd(p + "ffn.ffn_2.bias")},
            },
        }
    return enc


def _convert_predictor_stack(sd: _SD, prefix: str, n_layers: int) -> dict:
    """DurationPredictor/PitchPredictor conv tower: conv.{i} is a Sequential
    (pad, Conv1d, ReLU, LayerNorm, Dropout) -> indices 1 and 3."""
    stack = {}
    for i in range(n_layers):
        stack[f"conv_{i}"] = {"kernel": _conv(sd(f"{prefix}conv.{i}.1.weight")),
                              "bias": sd(f"{prefix}conv.{i}.1.bias")}
        stack[f"ln_{i}"] = {"scale": sd(f"{prefix}conv.{i}.3.weight"),
                            "bias": sd(f"{prefix}conv.{i}.3.bias")}
    return stack


def _convert_variance_predictor(sd: _SD, prefix: str, n_layers: int) -> dict:
    """PitchPredictor-style module with its own positional alpha."""
    return {
        "pos": {"alpha": sd(f"{prefix}pos_embed_alpha")},
        "stack": _convert_predictor_stack(sd, prefix, n_layers),
        "proj": {"kernel": _t(sd(f"{prefix}linear.weight")),
                 "bias": sd(f"{prefix}linear.bias")},
    }


def _convert_variance_adaptor(sd: _SD, prefix: str, cfg: Config) -> dict:
    vp = cfg.model.variance_predictor
    ve = cfg.model.variance_embedding
    va: dict = {
        "duration_predictor": {
            "stack": _convert_predictor_stack(
                sd, prefix + "duration_predictor.", vp.dur_predictor_layers),
            "proj": {"kernel": _t(sd(prefix + "duration_predictor.linear.weight")),
                     "bias": sd(prefix + "duration_predictor.linear.bias")},
        },
    }
    if ve.use_pitch_embed:
        va["pitch_embed"] = {"embedding": sd(prefix + "pitch_embed.weight")}
        if cfg.pitch.pitch_type == "cwt":
            va["cwt_in"] = {"kernel": _t(sd(prefix + "cwt_predictor.0.weight")),
                            "bias": sd(prefix + "cwt_predictor.0.bias")}
            va["cwt_predictor"] = _convert_variance_predictor(
                sd, prefix + "cwt_predictor.1.", vp.predictor_layers)
            va["cwt_stats"] = {
                f"layers_{j}": {
                    "kernel": _t(sd(prefix + f"cwt_stats_layers.{j}.weight")),
                    "bias": sd(prefix + f"cwt_stats_layers.{j}.bias")}
                for j in (0, 2, 4)
            }
        else:
            va["pitch_predictor"] = _convert_variance_predictor(
                sd, prefix + "pitch_predictor.", vp.predictor_layers)
    if ve.use_energy_embed:
        va["energy_predictor"] = _convert_variance_predictor(
            sd, prefix + "energy_predictor.", vp.predictor_layers)
        va["energy_embed"] = {"embedding": sd(prefix + "energy_embedding.weight")}
    return va


def _convert_denoiser(sd: _SD, prefix: str, cfg: Config) -> dict:
    n = cfg.model.denoiser.residual_layers
    multi = cfg.model.multi_speaker

    def stack(fn, name):
        return np.stack([fn(f"{prefix}residual_layers.{i}.{name}") for i in range(n)])

    blocks = {
        "t_proj": {"kernel": stack(
            lambda k: _t(sd(k)), "diffusion_projection.linear.weight")},
        "cond_proj": {
            "kernel": stack(lambda k: _conv1x1_as_dense(sd(k)),
                            "conditioner_projection.conv.weight"),
            "bias": stack(sd, "conditioner_projection.conv.bias"),
        },
        # reference computes one (2C out) conv then torch.chunk's it into
        # gate|filter (blocks.py:664-668); the flax block keeps the two
        # halves as separate TP-shardable convs — split along out channels
        "conv_gate": {
            "kernel": stack(lambda k: _conv(sd(k))[..., : cfg.model.denoiser.residual_channels],
                            "conv_layer.conv.weight"),
            "bias": stack(sd, "conv_layer.conv.bias")[
                :, : cfg.model.denoiser.residual_channels],
        },
        "conv_filt": {
            "kernel": stack(lambda k: _conv(sd(k))[..., cfg.model.denoiser.residual_channels:],
                            "conv_layer.conv.weight"),
            "bias": stack(sd, "conv_layer.conv.bias")[
                :, cfg.model.denoiser.residual_channels:],
        },
        "out_proj": {
            "kernel": stack(lambda k: _conv1x1_as_dense(sd(k)),
                            "output_projection.conv.weight"),
            "bias": stack(sd, "output_projection.conv.bias"),
        },
    }
    if multi:
        blocks["spk_proj"] = {"kernel": stack(
            lambda k: _t(sd(k)), "speaker_projection.linear.weight")}
    return {
        "in_proj": {"kernel": _conv1x1_as_dense(sd(prefix + "input_projection.0.conv.weight")),
                    "bias": sd(prefix + "input_projection.0.conv.bias")},
        "mlp_in": {"kernel": _t(sd(prefix + "mlp.0.linear.weight"))},
        "mlp_out": {"kernel": _t(sd(prefix + "mlp.2.linear.weight"))},
        "blocks": blocks,
        "skip_proj": {"kernel": _conv1x1_as_dense(sd(prefix + "skip_projection.conv.weight")),
                      "bias": sd(prefix + "skip_projection.conv.bias")},
        "out_proj": {"kernel": _conv1x1_as_dense(sd(prefix + "output_projection.conv.weight")),
                     "bias": sd(prefix + "output_projection.conv.bias")},
    }


def convert_cm_state_dict(state_dict: dict, cfg: Config,
                          strict: bool = True) -> dict:
    """Reference ``CMTotalTTS.state_dict()`` -> ``CMTTS`` flax params."""
    sd = _SD(state_dict)
    cond = "duration_pitch_energy_net."
    params = {
        "encoder": _convert_encoder(
            sd, cond + "text_encoder.", cfg.model.transformer.encoder_layer),
        "variance_adaptor": _convert_variance_adaptor(
            sd, cond + "variance_adaptor.", cfg),
        "denoiser": _convert_denoiser(sd, "net.", cfg),
    }
    if cfg.model.multi_speaker:
        if cfg.model.speaker_embedder == "none":
            params["speaker_emb"] = {"embedding": sd(cond + "speaker_emb.weight")}
        else:
            params["speaker_proj"] = {"kernel": _t(sd(cond + "speaker_emb.weight")),
                                      "bias": sd(cond + "speaker_emb.bias")}
    leftovers = sd.unused()
    if strict and leftovers:
        raise ValueError(f"unconverted reference params: {leftovers}")
    return params


def load_torch_cm_checkpoint(path: str, cfg: Config, strict: bool = True) -> dict:
    """Load a reference ``model{step:06d}.pt`` / ``ema_*`` / ``target_model*``
    file and convert it to ``CMTTS`` flax params."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(sd, dict) or "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v.detach().cpu().numpy() for k, v in sd.items()
          if hasattr(v, "detach")}
    return convert_cm_state_dict(sd, cfg, strict=strict)


def load_torch_cm(path: str, cfg: Config, strict: bool = True):
    """A port ``CMTTS`` with the params of a reference checkpoint file,
    through :func:`load_torch_cm_checkpoint` and the bridge (``strict``)."""
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.cmtts import CMTTS

    return load_flax_params(CMTTS(cfg), load_torch_cm_checkpoint(
        path, cfg, strict=strict))
