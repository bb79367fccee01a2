"""CMTTS: conditioning network + denoiser (port of
``cmtts_tpu/models/cmtts.py``).

  - ``condition``: text (+ speaker) -> conditioning dict (one cond-net pass);
  - ``denoise``:   bare denoiser on precomputed conditioning;
  - ``forward``:   both.

A multi-speaker model embeds the speaker with a table of ``n_speakers``
rows (``speaker_embedder == "none"``) or projects an external embedding
(DeepSpeaker, GE2E) of ``external_speaker_dim`` to the encoder width.
"""

from __future__ import annotations

import torch
from torch import nn

from cmtts_tpu_torch.core.config import Config
from cmtts_tpu_torch.core.masks import length_mask
from cmtts_tpu_torch.models.denoiser import Denoiser
from cmtts_tpu_torch.models.encoder import FFTEncoder
from cmtts_tpu_torch.models.variance import VarianceAdaptor
from cmtts_tpu_torch.text.symbols import VOCAB_SIZE


class CMTTS(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        mc = cfg.model
        H = mc.transformer.encoder_hidden
        self.cfg = cfg
        self.encoder = FFTEncoder(mc.transformer, VOCAB_SIZE, mc.max_seq_len)
        self.variance_adaptor = VarianceAdaptor(
            mc.transformer, mc.variance_predictor, mc.variance_embedding,
            cfg.pitch, cfg.energy)
        if mc.multi_speaker:
            if mc.speaker_embedder == "none":
                self.speaker_emb = nn.Embedding(mc.n_speakers, H)
            else:
                self.speaker_proj = nn.Linear(mc.external_speaker_dim, H)
        self.denoiser = Denoiser(mc.denoiser, cfg.stft.n_mel_channels, H,
                                 mc.multi_speaker)

    def _speaker(self, speakers, spker_embeds):
        mc = self.cfg.model
        if not mc.multi_speaker:
            return None
        if mc.speaker_embedder == "none":
            return self.speaker_emb(speakers)
        return self.speaker_proj(spker_embeds)

    def condition(self, texts, src_lens, t_mel: int, speakers=None,
                  spker_embeds=None, p_control: float = 1.0,
                  e_control: float = 1.0, d_control: float = 1.0,
                  mel2ph=None, d_targets=None, p_targets=None,
                  e_targets=None, deterministic: bool = True,
                  generator: torch.Generator | None = None) -> dict:
        """texts (B, T_txt) 0-padded ids, src_lens (B,), static mel bucket
        ``t_mel``, speaker ids (B,) or external embeddings (B, D) -> dict
        with ``cond`` (B, t_mel, H), ``speaker_emb`` (B, H) or None,
        ``mel_lens``, ``mel2ph`` and the variance predictions.

        The targets (``mel2ph``, ``d_targets``, ``p_targets``,
        ``e_targets``) teacher-force the variance adaptor; with
        ``deterministic=False`` the encoder and the predictors drop out,
        their masks drawn from ``generator``."""
        mc = self.cfg.model
        if (not deterministic and generator is None
                and (mc.transformer.encoder_dropout
                     or mc.variance_predictor.dropout)):
            raise ValueError("dropout (deterministic=False) needs a "
                             "generator")
        gen = None if deterministic else generator
        src_pad_mask = length_mask(src_lens, texts.shape[1])
        enc = self.encoder(texts, src_pad_mask, gen)
        spk = self._speaker(speakers, spker_embeds)
        out = self.variance_adaptor(
            enc, src_pad_mask, t_mel, speaker_emb=spk, p_control=p_control,
            e_control=e_control, d_control=d_control, mel2ph=mel2ph,
            d_targets=d_targets, p_targets=p_targets, e_targets=e_targets,
            generator=gen)
        out["speaker_emb"] = spk
        out["src_pad_mask"] = src_pad_mask
        return out

    def denoise(self, x_scaled, rescaled_t, cond, speaker_emb=None):
        """Bare denoiser: (B, L, n_mels) scaled input -> model output."""
        return self.denoiser(x_scaled, rescaled_t, cond, speaker_emb)

    def forward(self, x_scaled, rescaled_t, texts, src_lens, speakers=None,
                spker_embeds=None, mel2ph=None, d_targets=None,
                p_targets=None, e_targets=None, deterministic: bool = True,
                generator: torch.Generator | None = None):
        cond_out = self.condition(
            texts, src_lens, x_scaled.shape[1], speakers=speakers,
            spker_embeds=spker_embeds, mel2ph=mel2ph, d_targets=d_targets,
            p_targets=p_targets, e_targets=e_targets,
            deterministic=deterministic, generator=generator)
        return (self.denoise(x_scaled, rescaled_t, cond_out["cond"],
                             cond_out["speaker_emb"]), cond_out)


# layers the flax modules initialise Glorot-uniform or He-normal; the other
# Dense and Conv kernels are LeCun-normal, and every bias starts at 0
_XAVIER = ("q", "k", "v", "out", "proj", "mlp_in", "mlp_out", "t_proj",
           "spk_proj")


def init_like_flax(model: CMTTS, generator: torch.Generator) -> CMTTS:
    """Re-initialise ``model`` in place with the distributions that
    ``cmtts_tpu.models.cmtts.CMTTS.init`` draws from (the draws themselves
    differ): LeCun- or He-normal kernels truncated at two standard
    deviations, Glorot-uniform ones where the flax module asks for it (the
    encoder's q, k and v with the fans of their fused (C, 3C) kernel),
    zero biases, a zero denoiser output head, and every embedding table
    (the speaker table too) normal(H^-0.5) with row 0 zeroed for pitch and
    energy."""

    def trunc(w, scale, fan_in):
        std = (scale / fan_in) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)

    with torch.no_grad():
        for name, m in model.named_modules():
            parent, _, leaf = name.rpartition(".")
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                w = m.weight
                fan_in = w[0].numel()
                if name == "denoiser.out_proj":
                    nn.init.zeros_(w)
                elif leaf in _XAVIER and (name.startswith("denoiser")
                                          or parent.startswith("encoder")):
                    fans = w.shape[0] + fan_in
                    if leaf in ("q", "k", "v"):
                        fans = 4 * fan_in
                    limit = (6.0 / fans) ** 0.5
                    nn.init.uniform_(w, -limit, limit, generator=generator)
                elif (name.startswith("denoiser")
                      or (leaf.startswith("conv_")
                          and parent.endswith("stack"))):
                    trunc(w, 2.0, fan_in)
                else:
                    trunc(w, 1.0, fan_in)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                w = m.weight
                # flax's default nn.Embed: normal(features^-0.5)
                nn.init.normal_(w, 0.0, w.shape[1] ** -0.5,
                                generator=generator)
                if leaf not in ("tok_embed", "speaker_emb"):
                    w[0] = 0.0
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
    return model
