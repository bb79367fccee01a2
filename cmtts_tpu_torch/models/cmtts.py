"""CMTTS: conditioning network + denoiser (port of
``cmtts_tpu/models/cmtts.py``), inference.

  - ``condition``: text (+ speaker) -> conditioning dict (one cond-net pass);
  - ``denoise``:   bare denoiser on precomputed conditioning;
  - ``forward``:   both.

A multi-speaker model embeds the speaker with a table of ``n_speakers``
rows (``speaker_embedder == "none"``) or projects an external embedding
(DeepSpeaker, GE2E) of ``external_speaker_dim`` to the encoder width.
"""

from __future__ import annotations

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
                  e_control: float = 1.0, d_control: float = 1.0) -> dict:
        """texts (B, T_txt) 0-padded ids, src_lens (B,), static mel bucket
        ``t_mel``, speaker ids (B,) or external embeddings (B, D) -> dict
        with ``cond`` (B, t_mel, H), ``speaker_emb`` (B, H) or None,
        ``mel_lens``, ``mel2ph`` and the variance predictions."""
        src_pad_mask = length_mask(src_lens, texts.shape[1])
        enc = self.encoder(texts, src_pad_mask)
        spk = self._speaker(speakers, spker_embeds)
        out = self.variance_adaptor(enc, src_pad_mask, t_mel,
                                    speaker_emb=spk, p_control=p_control,
                                    e_control=e_control, d_control=d_control)
        out["speaker_emb"] = spk
        out["src_pad_mask"] = src_pad_mask
        return out

    def denoise(self, x_scaled, rescaled_t, cond, speaker_emb=None):
        """Bare denoiser: (B, L, n_mels) scaled input -> model output."""
        return self.denoiser(x_scaled, rescaled_t, cond, speaker_emb)

    def forward(self, x_scaled, rescaled_t, texts, src_lens, speakers=None,
                spker_embeds=None):
        cond_out = self.condition(texts, src_lens, x_scaled.shape[1],
                                  speakers=speakers,
                                  spker_embeds=spker_embeds)
        return (self.denoise(x_scaled, rescaled_t, cond_out["cond"],
                             cond_out["speaker_emb"]), cond_out)
