"""CMTTS: conditioning network + denoiser (port of
``cmtts_tpu/models/cmtts.py``), single-speaker inference.

  - ``condition``: text -> conditioning dict (one cond-net pass);
  - ``denoise``:   bare denoiser on precomputed conditioning;
  - ``forward``:   both.
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
        if mc.multi_speaker:
            raise NotImplementedError("multi-speaker CMTTS is not ported yet")
        self.cfg = cfg
        self.encoder = FFTEncoder(mc.transformer, VOCAB_SIZE, mc.max_seq_len)
        self.variance_adaptor = VarianceAdaptor(
            mc.transformer, mc.variance_predictor, mc.variance_embedding,
            cfg.pitch, cfg.energy)
        self.denoiser = Denoiser(mc.denoiser, cfg.stft.n_mel_channels,
                                 mc.transformer.encoder_hidden)

    def condition(self, texts, src_lens, t_mel: int, p_control: float = 1.0,
                  e_control: float = 1.0, d_control: float = 1.0) -> dict:
        """texts (B, T_txt) 0-padded ids, src_lens (B,), static mel bucket
        ``t_mel`` -> dict with ``cond`` (B, t_mel, H), ``mel_lens``,
        ``mel2ph`` and the variance predictions."""
        src_pad_mask = length_mask(src_lens, texts.shape[1])
        enc = self.encoder(texts, src_pad_mask)
        out = self.variance_adaptor(enc, src_pad_mask, t_mel,
                                    p_control=p_control, e_control=e_control,
                                    d_control=d_control)
        out["src_pad_mask"] = src_pad_mask
        return out

    def denoise(self, x_scaled, rescaled_t, cond):
        """Bare denoiser: (B, L, n_mels) scaled input -> model output."""
        return self.denoiser(x_scaled, rescaled_t, cond)

    def forward(self, x_scaled, rescaled_t, texts, src_lens):
        cond_out = self.condition(texts, src_lens, x_scaled.shape[1])
        return self.denoise(x_scaled, rescaled_t, cond_out["cond"]), cond_out
