"""JCU (Joint Conditional/Unconditional) discriminator for the legacy
DiffGAN-TTS training path (port of ``cmtts_tpu/models/discriminator.py``).

The reference snapshot configures this module (``config/*/model.yaml``
``discriminator:`` block) and drives it from the legacy eval path
(``evaluate.py:79-98``) and ``DiffGANTTSLoss.get_fm_loss``
(``model/loss.py:728-736``); the module source itself comes from the
DiffGAN-TTS upstream.  The architecture, as the JAX package re-creates it
from that contract:

- shared trunk: ``n_layer`` strided 1-D convs over the concatenated
  ``[x_t_prev; x_t]`` mel pair (projected by a linear layer first);
- unconditional branch: ``n_uncond_layer`` further convs on the trunk
  output;
- conditional branch: ``n_cond_layer`` convs on the trunk output plus a
  diffusion-step embedding (and speaker embedding when multi-speaker)
  broadcast over time;
- every activation is leaky_relu(0.2); returned feature lists have the
  logits as their last element.

Convs pad as XLA's "SAME" does (at stride 2 the odd sample after).  The
feature lists are (B, T', C), the JAX package's layout, so that masks and
losses carry over unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cmtts_tpu_torch.core.config import Config
from cmtts_tpu_torch.models.denoiser import diffusion_embedding, mish
from cmtts_tpu_torch.models.hifigan_disc import same_pads
from cmtts_tpu_torch.models.init import lecun_normal_

D_LRELU_SLOPE = 0.2


class JCUDiscriminator(nn.Module):
    """cfg.model.discriminator drives the layer plan; ``forward`` returns
    ``(cond_feats, uncond_feats)`` — lists of (B, T', C) activations, last
    entry = logits.  ``spk_dim`` is the width of the speaker embedding
    (the encoder's hidden width unless given); ``spk_mlp`` exists only
    when ``cfg.model.multi_speaker``."""

    def __init__(self, cfg: Config, spk_dim: int | None = None):
        super().__init__()
        self.cfg = cfg
        d = cfg.model.discriminator
        res_ch = cfg.model.denoiser.residual_channels
        n_mels = cfg.stft.n_mel_channels
        self.res_ch = res_ch
        self.input_projection = nn.Linear(2 * n_mels, 2 * n_mels)
        self.mlp_0 = nn.Linear(res_ch, res_ch * 4)
        self.mlp_1 = nn.Linear(res_ch * 4, d.n_channels[d.n_layer - 1])
        cin = 2 * n_mels
        for i in range(d.n_layer):
            self.add_module(f"conv_{i}", nn.Conv1d(
                cin, d.n_channels[i], d.kernel_sizes[i], d.strides[i]))
            cin = d.n_channels[i]
        if cfg.model.multi_speaker:
            self.spk_mlp = nn.Linear(
                spk_dim or cfg.model.transformer.encoder_hidden,
                d.n_channels[d.n_layer - 1])
        for branch, n in (("uncond", d.n_uncond_layer),
                          ("cond", d.n_cond_layer)):
            cin = d.n_channels[d.n_layer - 1]
            for i in range(d.n_layer, d.n_layer + n):
                self.add_module(f"{branch}_conv_{i}", nn.Conv1d(
                    cin, d.n_channels[i], d.kernel_sizes[i], d.strides[i]))
                cin = d.n_channels[i]

    @staticmethod
    def _conv(conv: nn.Conv1d, x):
        """``conv`` with "SAME" padding, then leaky ReLU: (B, C, T) in and
        out."""
        x = F.pad(x, same_pads(x.shape[-1], conv.kernel_size[0],
                               conv.stride[0]))
        return F.leaky_relu(conv(x), D_LRELU_SLOPE)

    def forward(self, x_ts, x_t_prevs, spk_emb, t):
        """x_ts/x_t_prevs: (B, T, n_mels); spk_emb: (B, H) or None;
        t: (B,) integer diffusion step."""
        d = self.cfg.model.discriminator
        x = self.input_projection(torch.cat([x_t_prevs, x_ts], dim=-1))
        x = x.transpose(1, 2)

        step = diffusion_embedding(t.float(), self.res_ch).to(x.dtype)
        step = self.mlp_1(mish(self.mlp_0(step)))

        cond_feats, uncond_feats = [], []
        for i in range(d.n_layer):
            x = self._conv(getattr(self, f"conv_{i}"), x)
            cond_feats.append(x.transpose(1, 2))
            uncond_feats.append(x.transpose(1, 2))

        x_cond = x + step[:, :, None]
        if self.cfg.model.multi_speaker and spk_emb is not None:
            x_cond = x_cond + self.spk_mlp(spk_emb)[:, :, None]
        x_uncond = x

        for i in range(d.n_layer, d.n_layer + d.n_uncond_layer):
            x_uncond = self._conv(getattr(self, f"uncond_conv_{i}"),
                                  x_uncond)
            uncond_feats.append(x_uncond.transpose(1, 2))
        for i in range(d.n_layer, d.n_layer + d.n_cond_layer):
            x_cond = self._conv(getattr(self, f"cond_conv_{i}"), x_cond)
            cond_feats.append(x_cond.transpose(1, 2))
        return cond_feats, uncond_feats


def init_like_flax(disc: JCUDiscriminator,
                   generator: torch.Generator) -> JCUDiscriminator:
    """Re-initialise ``disc`` in place as the JAX module's ``init`` draws
    it (the distributions, not the draws): every dense and conv kernel
    LeCun-normal truncated at two standard deviations, zero biases."""
    with torch.no_grad():
        for m in disc.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
    return disc
