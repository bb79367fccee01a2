"""FFT-block phoneme encoder (port of ``cmtts_tpu/models/encoder.py``).

Pre-LN self-attention + conv-FFN blocks in batch-major (B, T, C) layout
with an additive key-padding bias; activations are re-masked after every
sublayer.  Inference only: dropout is the identity.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cmtts_tpu_torch.core.config import TransformerConfig

NEG_INF = -1e9


def sinusoid_table(n_positions: int, dim: int) -> np.ndarray:
    """Fairseq-style sinusoidal table: [sin | cos] concatenated (not
    interleaved), row 0 zeroed for the padding index."""
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
    """Position ids: cumulative count over valid steps, 0 at padding."""
    nonpad = nonpad.long()
    return torch.cumsum(nonpad, dim=1) * nonpad


class PositionalEmbedding(nn.Module):
    """Lookup into a fixed sinusoidal table of ``max_positions + 2`` rows,
    with an optional learned scale ``alpha``."""

    def __init__(self, dim: int, max_positions: int,
                 learned_alpha: bool = False):
        super().__init__()
        self.max_positions = max_positions
        self.register_buffer(
            "table", torch.from_numpy(sinusoid_table(max_positions + 2, dim)),
            persistent=False)
        self.alpha = nn.Parameter(torch.ones(1)) if learned_alpha else None

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        emb = self.table[torch.clamp(positions, 0, self.max_positions + 1)]
        if self.alpha is not None:
            emb = self.alpha * emb
        return emb


class MultiHeadSelfAttention(nn.Module):
    """Bias-free MHSA with an additive -1e9 key-padding bias."""

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
    """Conv-k feed-forward with a 1/sqrt(k) post-scale."""

    def __init__(self, hidden: int, filter_size: int, kernel_size: int,
                 act: str = "gelu"):
        super().__init__()
        self.kernel_size = kernel_size
        self.act = act
        self.conv = nn.Conv1d(hidden, filter_size, kernel_size,
                              padding=(kernel_size - 1) // 2)
        self.proj = nn.Linear(filter_size, hidden)

    def forward(self, x):
        h = self.conv(x.transpose(1, 2)).transpose(1, 2)
        h = h * (self.kernel_size ** -0.5)
        if self.act == "gelu":
            h = F.gelu(h)
        elif self.act == "relu":
            h = F.relu(h)
        elif self.act == "swish":
            h = h * torch.sigmoid(h)
        return self.proj(h)


class FFTBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        H = cfg.encoder_hidden
        self.ln_attn = nn.LayerNorm(H, eps=1e-12)
        self.attn = MultiHeadSelfAttention(H, cfg.encoder_head)
        self.ln_ffn = nn.LayerNorm(H, eps=1e-12)
        self.ffn = ConvFFN(H, 4 * H, cfg.ffn_kernel_size, cfg.ffn_act)

    def forward(self, x, pad_mask):
        nonpad = (~pad_mask).to(x.dtype)[..., None]
        x = (x + self.attn(self.ln_attn(x), pad_mask)) * nonpad
        x = (x + self.ffn(self.ln_ffn(x))) * nonpad
        return x


class FFTEncoder(nn.Module):
    """Token embedding (scaled by sqrt(H)) + sinusoidal positions + N FFT
    blocks + final LayerNorm.  Blocks are named ``block_{i}`` like the flax
    module's."""

    def __init__(self, cfg: TransformerConfig, vocab_size: int,
                 max_seq_len: int):
        super().__init__()
        H = cfg.encoder_hidden
        self.hidden = H
        self.n_layers = cfg.encoder_layer
        self.tok_embed = nn.Embedding(vocab_size, H)
        self.pos = PositionalEmbedding(H, max_seq_len * 2)
        for i in range(cfg.encoder_layer):
            self.add_module(f"block_{i}", FFTBlock(cfg))
        self.ln_out = nn.LayerNorm(H, eps=1e-12)

    def forward(self, tokens, pad_mask):
        x = math.sqrt(self.hidden) * self.tok_embed(tokens)
        x = x + self.pos(positions_from_mask(~pad_mask))
        nonpad = (~pad_mask).to(x.dtype)[..., None]
        x = x * nonpad
        for i in range(self.n_layers):
            x = getattr(self, f"block_{i}")(x, pad_mask)
        return self.ln_out(x) * nonpad
