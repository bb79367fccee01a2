"""Non-causal gated WaveNet mel denoiser (port of
``cmtts_tpu/models/denoiser.py``).

Channels-last (B, L, C) activations; the k3 gate and filter convs run as
``Conv1d`` on a transposed view.  The compute dtype follows the input: the
synthesis pipeline runs a bf16 copy of this module on bf16 inputs, as the
JAX pipeline casts the denoiser's params and activations to bf16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cmtts_tpu_torch.core.config import DenoiserConfig
from cmtts_tpu_torch.parallel.distributed import CopyToGroup, ReduceFromGroup


def mish(x):
    return x * torch.tanh(F.softplus(x))


def diffusion_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of a continuous step value (B,) -> (B, dim),
    computed in float32."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * -(math.log(10000.0) / (half - 1)))
    args = t[:, None].float() * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class ResidualBlock(nn.Module):
    """One gated block.  With ``tp_group`` set (``parallel.distributed.
    set_tp_group``) its params are this rank's Megatron shards: the gate and
    filter convs hold a slice of the output channels, ``out_proj`` the same
    slice of its input features, and the partial outputs are summed over
    the group before ``out_proj``'s bias is added."""

    tp_group = None

    def __init__(self, channels: int, cond_dim: int, multi_speaker: bool):
        super().__init__()
        C = channels
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
        if self.tp_group is not None:
            y = CopyToGroup.apply(y, self.tp_group)
        y = (torch.sigmoid(self.conv_gate(y))
             * torch.tanh(self.conv_filt(y))).transpose(1, 2)
        if self.tp_group is None:
            y = self.out_proj(y)
        else:
            y = ReduceFromGroup.apply(F.linear(y, self.out_proj.weight),
                                      self.tp_group) + self.out_proj.bias
        res_out, skip = y.chunk(2, dim=-1)
        return (res_out + residual) / math.sqrt(2.0), skip


class Denoiser(nn.Module):
    """x_t (B, L, n_mels) + rescaled t (B,) + cond (B, L, H) [+ speaker
    embedding (B, H) for a multi-speaker model] -> output."""

    def __init__(self, cfg: DenoiserConfig, n_mels: int, cond_dim: int,
                 multi_speaker: bool = False):
        super().__init__()
        C = cfg.residual_channels
        self.channels = C
        self.in_proj = nn.Linear(n_mels, C)
        self.mlp_in = nn.Linear(C, 4 * C, bias=False)
        self.mlp_out = nn.Linear(4 * C, C, bias=False)
        self.blocks = nn.ModuleList(
            [ResidualBlock(C, cond_dim, multi_speaker)
             for _ in range(cfg.residual_layers)])
        self.skip_proj = nn.Linear(C, C)
        self.out_proj = nn.Linear(C, n_mels)

    def forward(self, x, rescaled_t, cond, speaker_emb=None):
        dt = x.dtype
        cond = cond.to(dt)
        spk = None if speaker_emb is None else speaker_emb.to(dt)
        h = torch.relu(self.in_proj(x))
        t = diffusion_embedding(rescaled_t, self.channels).to(dt)
        t = self.mlp_out(mish(self.mlp_in(t)))
        skips = []
        for block in self.blocks:
            h, skip = block(h, t, cond, spk)
            skips.append(skip)
        h = torch.stack(skips).sum(0) / math.sqrt(len(self.blocks))
        return self.out_proj(torch.relu(self.skip_proj(h)))


def denoiser_flop(cfg, B: int, L: int) -> int:
    """FLOP (2 per multiply-add) of one denoiser forward at B x L frames,
    from the module's layers: per frame in_proj, per block cond_proj, the
    k3 gate and filter convs and out_proj, then skip_proj and out_proj; per
    row the step MLP and each block's t_proj.  A CT/CD train step runs the
    denoiser forward for the student and the target and backward (two
    forwards' worth) once: 4x this."""
    C = cfg.model.denoiser.residual_channels
    N = cfg.model.denoiser.residual_layers
    H = cfg.model.transformer.encoder_hidden
    M = cfg.stft.n_mel_channels
    frame = 2 * M * C + N * (2 * H * C + 2 * 2 * 3 * C * C + 2 * C * 2 * C) \
        + 2 * C * C + 2 * C * M
    row = 2 * C * 4 * C * 2 + N * 2 * C * C
    return B * L * frame + B * row
