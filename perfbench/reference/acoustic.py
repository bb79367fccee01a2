"""Plain PyTorch reference of the CM-TTS acoustic model: the FFT encoder,
the variance adaptor (duration, phoneme-level energy, the ``mel2ph``
length regulator, CWT pitch with uv and its inverse CWT) and the 20-block
gated WaveNet denoiser, at inference and, teacher-forced with dropout, in
training (:mod:`perfbench.reference.ct`).

Written from the CM-TTS configuration's architecture (FastSpeech2 with the
DiffSpeech CWT pitch head, the DiffSinger WaveNet), one configuration
only (CWT pitch, phoneme-level energy, external speaker embeddings), with
the parameter names of the program's modules so that one state dict loads
into both.  It imports nothing of the program; the tests hold it to the
JAX package's model.  Dropout is flax's (keep with 1 - rate, scale by
1 / (1 - rate)), its masks drawn from the step's generator in the order
the forward pass meets them, as the program draws them.  Every op
computes in float32; ``quant`` (see :mod:`perfbench.reference.quant`)
rounds the denoiser's matmul and conv operands for the lower-precision
control.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9
F0_BIN, F0_MAX, F0_MIN = 256, 1100.0, 50.0
F0_MEL_MIN = 1127.0 * np.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * np.log(1.0 + F0_MAX / 700.0)


def dropout(x, rate: float, gen):
    """The identity without a generator (inference) or at rate 0."""
    if gen is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def grad_scale(x, scale: float):
    """Forward identity, backward times ``scale`` (FastSpeech2's
    ``predictor_grad``)."""
    if not x.requires_grad:
        return x
    d = x.detach()
    return d + scale * (x - d)


# -- encoder ----------------------------------------------------------------

def sinusoid_table(n_positions: int, dim: int) -> np.ndarray:
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64)
                  * -(math.log(10000.0) / (half - 1)))
    args = np.arange(n_positions, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((n_positions, 1))], axis=1)
    table[0, :] = 0.0
    return table.astype(np.float32)


def positions_from_mask(nonpad: torch.Tensor) -> torch.Tensor:
    nonpad = nonpad.long()
    return torch.cumsum(nonpad, dim=1) * nonpad


class PositionalEmbedding(nn.Module):
    def __init__(self, dim: int, max_positions: int,
                 learned_alpha: bool = False):
        super().__init__()
        self.max_positions = max_positions
        self.register_buffer(
            "table", torch.from_numpy(sinusoid_table(max_positions + 2, dim)),
            persistent=False)
        self.alpha = nn.Parameter(torch.ones(1)) if learned_alpha else None

    def forward(self, positions):
        emb = self.table[torch.clamp(positions, 0, self.max_positions + 1)]
        return emb if self.alpha is None else self.alpha * emb


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim, bias=False)
        self.k = nn.Linear(dim, dim, bias=False)
        self.v = nn.Linear(dim, dim, bias=False)
        self.out = nn.Linear(dim, dim, bias=False)

    def forward(self, x, pad_mask):
        B, T, C = x.shape
        H = self.num_heads
        hd = C // H

        def heads(t):
            return t.reshape(B, T, H, hd).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        logits = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
        bias = pad_mask[:, None, None, :].to(logits.dtype) * NEG_INF
        probs = torch.softmax(logits + bias, dim=-1)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, C)
        return self.out(out)


class ConvFFN(nn.Module):
    def __init__(self, hidden: int, filter_size: int, kernel_size: int,
                 act: str, rate: float = 0.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.act = act
        self.rate = rate
        self.conv = nn.Conv1d(hidden, filter_size, kernel_size,
                              padding=(kernel_size - 1) // 2)
        self.proj = nn.Linear(filter_size, hidden)

    def forward(self, x, gen=None):
        h = self.conv(x.transpose(1, 2)).transpose(1, 2)
        h = h * (self.kernel_size ** -0.5)
        if self.act == "gelu":
            h = F.gelu(h)
        elif self.act == "relu":
            h = F.relu(h)
        elif self.act == "swish":
            h = h * torch.sigmoid(h)
        return self.proj(dropout(h, self.rate, gen))


class FFTBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        H = c.hidden
        self.ln_attn = nn.LayerNorm(H, eps=1e-12)
        self.attn = MultiHeadSelfAttention(H, c.heads)
        self.ln_ffn = nn.LayerNorm(H, eps=1e-12)
        self.ffn = ConvFFN(H, 4 * H, c.ffn_kernel, c.ffn_act, c.enc_dropout)
        self.rate = c.enc_dropout

    def forward(self, x, pad_mask, gen=None):
        nonpad = (~pad_mask).to(x.dtype)[..., None]
        h = dropout(self.attn(self.ln_attn(x), pad_mask), self.rate, gen)
        x = (x + h) * nonpad
        h = dropout(self.ffn(self.ln_ffn(x), gen), self.rate, gen)
        return (x + h) * nonpad


class FFTEncoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.hidden, self.n_layers = c.hidden, c.layers
        self.rate = c.enc_dropout
        self.tok_embed = nn.Embedding(c.vocab_size, c.hidden)
        self.pos = PositionalEmbedding(c.hidden, c.max_seq_len * 2)
        for i in range(c.layers):
            self.add_module(f"block_{i}", FFTBlock(c))
        self.ln_out = nn.LayerNorm(c.hidden, eps=1e-12)

    def forward(self, tokens, pad_mask, gen=None):
        x = math.sqrt(self.hidden) * self.tok_embed(tokens)
        x = x + self.pos(positions_from_mask(~pad_mask))
        x = dropout(x, self.rate, gen)
        nonpad = (~pad_mask).to(x.dtype)[..., None]
        x = x * nonpad
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, pad_mask, gen)
        return self.ln_out(x) * nonpad


# -- pitch math -------------------------------------------------------------

def f0_to_coarse(f0):
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = ((f0_mel - F0_MEL_MIN) * (F0_BIN - 2)
              / (F0_MEL_MAX - F0_MEL_MIN) + 1.0)
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = torch.clamp(f0_mel, 1.0, F0_BIN - 1)
    return torch.floor(f0_mel + 0.5).long()


def norm_f0(f0, c):
    if c.pitch_norm == "standard":
        return (f0 - c.f0_mean) / c.f0_std
    if c.pitch_norm == "log":
        return torch.log2(f0 + c.pitch_eps)
    return f0


def denorm_f0(f0, uv, c):
    if c.pitch_norm == "standard":
        f0 = f0 * c.f0_std + c.f0_mean
    elif c.pitch_norm == "log":
        f0 = 2.0 ** f0
    if uv is not None and c.use_uv:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    return f0


def inverse_cwt(cwt_spec, mask=None):
    n_scales = cwt_spec.shape[-1]
    b = (torch.arange(n_scales, dtype=cwt_spec.dtype, device=cwt_spec.device)
         + 1.0 + 2.5) ** (-2.5)
    rec = (cwt_spec * b[None, None, :]).sum(-1)
    if mask is None:
        mean = rec.mean(-1, keepdim=True)
        n = rec.shape[-1]
        var = ((rec - mean) ** 2).sum(-1, keepdim=True) / max(n - 1, 1)
        return (rec - mean) / torch.sqrt(var)
    m = mask.to(rec.dtype)
    n = torch.clamp(m.sum(-1, keepdim=True), min=2.0)
    mean = (rec * m).sum(-1, keepdim=True) / n
    var = (((rec - mean) ** 2) * m).sum(-1, keepdim=True) / (n - 1.0)
    return (rec - mean) / torch.sqrt(var + 1e-12)


def cwt2f0_norm(cwt_spec, mean, std, t_mel: int, c, mask=None):
    f0 = torch.exp(inverse_cwt(cwt_spec, mask) * std[:, None] + mean[:, None])
    t = f0.shape[1]
    if t < t_mel:
        f0 = torch.cat([f0, f0[:, -1:].expand(-1, t_mel - t)], dim=1)
    elif t > t_mel:
        f0 = f0[:, :t_mel]
    return norm_f0(f0, c)


# -- variance adaptor -------------------------------------------------------

def dur_to_mel2ph(dur, pad_mask, t_mel: int):
    dur = torch.round(dur.float()).long() * (~pad_mask).long()
    cumsum = torch.cumsum(dur, dim=1)
    prev = torch.cat([torch.zeros_like(cumsum[:, :1]), cumsum[:, :-1]], dim=1)
    pos = torch.arange(t_mel, device=dur.device)[None, None, :]
    idx = torch.arange(1, dur.shape[1] + 1, device=dur.device)[None, :, None]
    member = (pos >= prev[:, :, None]) & (pos < cumsum[:, :, None])
    return (idx * member.long()).sum(dim=1)


def gather_by_mel2ph(x_ph, mel2ph):
    B, T, C = x_ph.shape
    padded = torch.cat([x_ph.new_zeros(B, 1, C), x_ph], dim=1)
    idx = torch.clamp(mel2ph, 0, T)[:, :, None].expand(-1, -1, C)
    return torch.gather(padded, 1, idx)


class ConvPredictorStack(nn.Module):
    def __init__(self, n_layers, in_dim, n_chans, kernel_size, rate,
                 mask_between_layers=False):
        super().__init__()
        self.n_layers, self.rate = n_layers, rate
        self.mask_between_layers = mask_between_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", nn.Conv1d(
                in_dim if i == 0 else n_chans, n_chans, kernel_size,
                padding=(kernel_size - 1) // 2))
            self.add_module(f"ln_{i}", nn.LayerNorm(n_chans, eps=1e-12))

    def forward(self, x, pad_mask, gen=None):
        nonpad = (~pad_mask).to(x.dtype)[..., None]
        for i in range(self.n_layers):
            x = getattr(self, f"conv_{i}")(x.transpose(1, 2)).transpose(1, 2)
            x = dropout(getattr(self, f"ln_{i}")(torch.relu(x)), self.rate,
                        gen)
            if self.mask_between_layers:
                x = x * nonpad
        return x


class DurationPredictor(nn.Module):
    def __init__(self, in_dim, c):
        super().__init__()
        self.stack = ConvPredictorStack(c.dur_layers, in_dim, c.filter_size,
                                        c.dur_kernel, c.vp_dropout, True)
        self.proj = nn.Linear(c.filter_size, 1)

    def forward(self, x, pad_mask, gen=None):
        out = self.proj(self.stack(x, pad_mask, gen))
        return (out * (~pad_mask).to(out.dtype)[..., None])[..., 0]


class VariancePredictor(nn.Module):
    def __init__(self, in_dim, c, odim):
        super().__init__()
        self.pos = PositionalEmbedding(in_dim, 4096, learned_alpha=True)
        self.stack = ConvPredictorStack(c.predictor_layers, in_dim,
                                        c.filter_size, c.predictor_kernel,
                                        c.vp_dropout)
        self.proj = nn.Linear(c.filter_size, odim)

    def forward(self, x, pad_mask, gen=None):
        x = x + self.pos(positions_from_mask(x[..., 0] != 0))
        return self.proj(self.stack(x, pad_mask, gen))


class VarianceAdaptor(nn.Module):
    """Speaker add -> duration -> phoneme-level energy -> length
    regulation -> CWT pitch.  Only the configuration the benchmark runs
    (``pitch_type: cwt``, ``energy feature: phoneme_level``)."""

    def __init__(self, c):
        super().__init__()
        if c.pitch_type != "cwt" or c.energy_feature != "phoneme_level":
            raise NotImplementedError("the reference covers CWT pitch and "
                                      "phoneme-level energy")
        H = c.hidden
        self.c = c
        self.duration_predictor = DurationPredictor(H, c)
        cwt_out = 10 + (1 if c.use_uv else 0)
        self.cwt_in = nn.Linear(H, c.cwt_hidden)
        self.cwt_predictor = VariancePredictor(c.cwt_hidden, c, cwt_out)
        self.cwt_stats = nn.Sequential(OrderedDict([
            ("layers_0", nn.Linear(H, c.cwt_hidden)), ("layers_1", nn.ReLU()),
            ("layers_2", nn.Linear(c.cwt_hidden, c.cwt_hidden)),
            ("layers_3", nn.ReLU()), ("layers_4", nn.Linear(c.cwt_hidden, 2)),
        ]))
        self.pitch_embed = nn.Embedding(c.pitch_bins, H)
        self.energy_predictor = VariancePredictor(H, c, 1)
        if c.energy_quant == "log":
            bins = np.exp(np.linspace(np.log(max(c.energy_min, 1e-8)),
                                      np.log(max(c.energy_max, 1e-7)),
                                      c.energy_bins - 1))
        else:
            bins = np.linspace(c.energy_min, c.energy_max, c.energy_bins - 1)
        self.register_buffer("energy_bins",
                             torch.tensor(bins, dtype=torch.float32),
                             persistent=False)
        self.energy_embed = nn.Embedding(c.energy_bins, H)

    def forward(self, x, src_pad_mask, t_mel: int, speaker_emb=None,
                targets=None, gen=None):
        """Inference: (x_mel, mel_lens).  ``targets`` (a training batch:
        ``d_targets``, ``mel2ph``, ``e_targets``, ``p_targets``)
        teacher-force the adaptor: (x_mel, the predictions and
        ``mel_lens``).  The duration and CWT predictors' inputs pass
        ``predictor_grad`` of the gradient back; the energy predictor's
        and the stats head's the whole of it."""
        c = self.c
        if speaker_emb is not None:
            x = x + speaker_emb[:, None, :]
        log_d = self.duration_predictor(grad_scale(x, c.predictor_grad),
                                        src_pad_mask, gen)
        pad = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
        e_pred = self.energy_predictor(x, pad, gen)[..., 0]
        e_src = e_pred if targets is None else targets["e_targets"]
        x = x + self.energy_embed(torch.searchsorted(self.energy_bins,
                                                     e_src.contiguous()))
        encoder_out = x
        if targets is None:
            d = torch.clamp(torch.round(torch.exp(log_d) - 1.0), min=0)
            mel2ph = dur_to_mel2ph(d, src_pad_mask, t_mel)
            mel_lens = torch.clamp(
                torch.round(d * (~src_pad_mask)).sum(-1).long(), max=t_mel)
        else:
            mel2ph = targets["mel2ph"]
            mel_lens = torch.clamp((targets["d_targets"] * (~src_pad_mask))
                                   .sum(-1).long(), max=t_mel)
        x_mel = gather_by_mel2ph(x, mel2ph)
        pad = torch.zeros(x_mel.shape[:2], dtype=torch.bool,
                          device=x_mel.device)
        cwt_out = self.cwt_predictor(
            self.cwt_in(grad_scale(x_mel, c.predictor_grad)), pad, gen)
        stats = self.cwt_stats(encoder_out[:, 0, :])
        mask = (mel2ph > 0) if c.cwt_masked_std else None
        if targets is None:
            f0 = cwt2f0_norm(cwt_out[..., :10], stats[:, 0],
                             stats[:, 1] * c.cwt_std_scale, mel2ph.shape[1],
                             c, mask=mask)
            uv = (cwt_out[..., -1] > 0) if c.use_uv else None
        else:
            p = targets["p_targets"]
            f0 = cwt2f0_norm(p["cwt_spec"], p["f0_mean"], p["f0_std"],
                             mel2ph.shape[1], c, mask=mask)
            uv = p["uv"]
        x_mel = x_mel + self.pitch_embed(f0_to_coarse(denorm_f0(f0, uv, c)))
        if targets is None:
            return x_mel, mel_lens
        return x_mel, {"log_d": log_d, "e_pred": e_pred, "cwt": cwt_out,
                       "f0_mean": stats[:, 0], "f0_std": stats[:, 1],
                       "mel_lens": mel_lens}


# -- denoiser ---------------------------------------------------------------

def mish(x):
    return x * torch.tanh(F.softplus(x))


def diffusion_embedding(t, dim: int):
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * -(math.log(10000.0) / (half - 1)))
    args = t[:, None].float() * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class ResidualBlock(nn.Module):
    def __init__(self, C, cond_dim, multi_speaker):
        super().__init__()
        self.t_proj = nn.Linear(C, C, bias=False)
        self.cond_proj = nn.Linear(cond_dim, C)
        self.spk_proj = (nn.Linear(cond_dim, C, bias=False) if multi_speaker
                         else None)
        self.conv_gate = nn.Conv1d(C, C, 3, padding=1)
        self.conv_filt = nn.Conv1d(C, C, 3, padding=1)
        self.out_proj = nn.Linear(C, 2 * C)

    def forward(self, x, t_emb, cond, spk):
        residual = y = x + self.t_proj(t_emb)[:, None, :]
        y = y + self.cond_proj(cond)
        if self.spk_proj is not None:
            y = y + self.spk_proj(spk)[:, None, :]
        y = y.transpose(1, 2)
        y = (torch.sigmoid(self.conv_gate(y))
             * torch.tanh(self.conv_filt(y))).transpose(1, 2)
        res_out, skip = self.out_proj(y).chunk(2, dim=-1)
        return (res_out + residual) / math.sqrt(2.0), skip


class Denoiser(nn.Module):
    def __init__(self, c):
        super().__init__()
        C = c.den_channels
        self.channels = C
        self.in_proj = nn.Linear(c.n_mels, C)
        self.mlp_in = nn.Linear(C, 4 * C, bias=False)
        self.mlp_out = nn.Linear(4 * C, C, bias=False)
        self.blocks = nn.ModuleList([ResidualBlock(C, c.hidden,
                                                   c.multi_speaker)
                                     for _ in range(c.den_layers)])
        self.skip_proj = nn.Linear(C, C)
        self.out_proj = nn.Linear(C, c.n_mels)

    def forward(self, x, rescaled_t, cond, spk=None):
        h = torch.relu(self.in_proj(x))
        t = self.mlp_out(mish(self.mlp_in(
            diffusion_embedding(rescaled_t, self.channels))))
        skips = []
        for block in self.blocks:
            h, skip = block(h, t, cond, spk)
            skips.append(skip)
        h = torch.stack(skips).sum(0) / math.sqrt(len(self.blocks))
        return self.out_proj(torch.relu(self.skip_proj(h)))


class AcousticModel(nn.Module):
    """Conditioning network and denoiser under the program's names."""

    def __init__(self, c):
        super().__init__()
        self.c = c
        self.encoder = FFTEncoder(c)
        self.variance_adaptor = VarianceAdaptor(c)
        if c.multi_speaker:
            if c.speaker_embedder == "none":
                raise NotImplementedError("the reference covers external "
                                          "speaker embeddings")
            self.speaker_proj = nn.Linear(c.external_speaker_dim, c.hidden)
        self.denoiser = Denoiser(c)

    def condition(self, texts, src_lens, t_mel: int, spker_embeds=None):
        """-> (cond (B, t_mel, H), speaker embedding or None, mel_lens)."""
        ids = torch.arange(texts.shape[1], device=texts.device)[None, :]
        src_pad = ids >= src_lens[:, None]
        enc = self.encoder(texts, src_pad)
        spk = self.speaker_proj(spker_embeds) if self.c.multi_speaker else None
        cond, mel_lens = self.variance_adaptor(enc, src_pad, t_mel, spk)
        return cond, spk, mel_lens

    def forward(self, x_scaled, rescaled_t, batch: dict, gen):
        """The training forward pass: the conditioning teacher-forced by
        ``batch`` with dropout from ``gen``, then the denoiser on
        ``x_scaled``: (denoiser output, the adaptor's predictions with
        ``src_pad``)."""
        texts = batch["texts"]
        ids = torch.arange(texts.shape[1], device=texts.device)[None, :]
        src_pad = ids >= batch["src_lens"][:, None]
        enc = self.encoder(texts, src_pad, gen)
        spk = (self.speaker_proj(batch["spker_embeds"])
               if self.c.multi_speaker else None)
        cond, pred = self.variance_adaptor(enc, src_pad, x_scaled.shape[1],
                                           spk, targets=batch, gen=gen)
        pred["src_pad"] = src_pad
        return self.denoiser(x_scaled, rescaled_t, cond, spk), pred
