"""MelGAN vocoder, the reference's alternative to HiFi-GAN (port of
``cmtts_tpu/models/melgan.py``).

Architecture (melgan-neurips ``mel2wav/modules.py`` Generator, ngf=32,
n_residual_layers=3, ratios 8/8/2/2): reflection-padded 7-tap conv_pre ->
4 x [LeakyReLU(0.2), ConvTranspose(k=2r, stride=r), 3 ResnetBlocks with
dilations 3^j] -> LeakyReLU -> reflection-padded 7-tap conv_post -> tanh.
Modules carry the flax module's names (``conv_pre``, ``up_i``,
``res_i_j.{conv1,conv2,shortcut}``, ``conv_post``), so the one bridge
(``cmtts_tpu_torch/convert.py``) loads a flax tree into it.  Plain torch
ops: the JAX package leaves MelGAN to XLA, so it has no kernel.

The reference pulls MelGAN from torch.hub at run time; the port reads a
local melgan-neurips ``best_netG.pt`` (weight norm folded by
:func:`convert_torch_melgan`) or a flat npz of flax params, and raises
without one.  Input is ``mel / ln(10)`` (natural-log mels -> log10, as the
reference feeds it); the public layouts are JAX's: mel (B, T, n_mels) in,
wav (B, T * 256) out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cmtts_tpu_torch.convert import load_flax_params
from cmtts_tpu_torch.models.hifigan import torch_conv_getters, unflatten_npz

LRELU_SLOPE = 0.2


@dataclass(frozen=True)
class MelGANConfig:
    ratios: tuple[int, ...] = (8, 8, 2, 2)
    ngf: int = 32
    n_residual_layers: int = 3
    num_mels: int = 80

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.ratios:
            out *= r
        return out


class MelGANResnetBlock(nn.Module):
    """lrelu -> reflection pad -> dilated k3 conv -> lrelu -> k1 conv, plus
    a k1 shortcut conv of the input."""

    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.conv1 = nn.Conv1d(dim, dim, 3, dilation=dilation)
        self.conv2 = nn.Conv1d(dim, dim, 1)
        self.shortcut = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        h = F.pad(F.leaky_relu(x, LRELU_SLOPE), (self.dilation,) * 2,
                  mode="reflect")
        h = self.conv2(F.leaky_relu(self.conv1(h), LRELU_SLOPE))
        return self.shortcut(x) + h


class MelGANGenerator(nn.Module):
    def __init__(self, cfg: MelGANConfig | None = None):
        super().__init__()
        c = cfg or MelGANConfig()
        self.cfg = c
        mult = 2 ** len(c.ratios)
        self.conv_pre = nn.Conv1d(c.num_mels, mult * c.ngf, 7)
        for i, r in enumerate(c.ratios):
            ch = mult * c.ngf // 2
            # the reference's padding; (k - r) // 2 for the even ratios,
            # the relation flax's 'SAME' keeps
            self.add_module(f"up_{i}", nn.ConvTranspose1d(
                mult * c.ngf, ch, 2 * r, stride=r, padding=r // 2 + r % 2,
                output_padding=r % 2))
            for j in range(c.n_residual_layers):
                self.add_module(f"res_{i}_{j}", MelGANResnetBlock(ch, 3 ** j))
            mult //= 2
        self.conv_post = nn.Conv1d(c.ngf, 1, 7)

    def forward(self, mel):
        """mel (B, T, n_mels), log10 domain -> waveform (B, T * hop)."""
        c = self.cfg
        x = self.conv_pre(F.pad(mel.float().transpose(1, 2), (3, 3),
                                mode="reflect"))
        for i in range(len(c.ratios)):
            x = getattr(self, f"up_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            for j in range(c.n_residual_layers):
                x = getattr(self, f"res_{i}_{j}")(x)
        x = F.pad(F.leaky_relu(x, LRELU_SLOPE), (3, 3), mode="reflect")
        return torch.tanh(self.conv_post(x))[:, 0]


# Copied from cmtts_tpu/models/melgan.py::convert_torch_melgan (numpy).
def convert_torch_melgan(state_dict: dict, cfg: MelGANConfig | None = None
                         ) -> dict:
    """Convert a melgan-neurips Generator torch state dict (keys
    ``model.{i}.weight_g/weight_v/bias`` over the nn.Sequential indices)
    into flax params.  Accepts either the bare generator state dict or one
    nested under ``mel2wav``/``model_g``/``generator``/``netG``.
    """
    cfg = cfg or MelGANConfig()
    for nest in ("mel2wav", "model_g", "generator", "netG"):
        if any(k.startswith(nest + ".") for k in state_dict):
            state_dict = {k[len(nest) + 1:]: v for k, v in state_dict.items()
                          if k.startswith(nest + ".")}
            break

    get, conv_w, convT_w = torch_conv_getters(state_dict)

    # walk the torch nn.Sequential indices exactly as the generator
    # builds them: [pad, conv] + per stage [lrelu, convT, res*n] +
    # [lrelu, pad, conv, tanh]
    params: dict = {}
    idx = 1
    params["conv_pre"] = {"kernel": conv_w(f"model.{idx}"),
                          "bias": get(f"model.{idx}.bias")}
    idx += 1
    for i in range(len(cfg.ratios)):
        idx += 1  # lrelu
        params[f"up_{i}"] = {"kernel": convT_w(f"model.{idx}"),
                             "bias": get(f"model.{idx}.bias")}
        idx += 1
        for j in range(cfg.n_residual_layers):
            base = f"model.{idx}"
            params[f"res_{i}_{j}"] = {
                "conv1": {"kernel": conv_w(f"{base}.block.2"),
                          "bias": get(f"{base}.block.2.bias")},
                "conv2": {"kernel": conv_w(f"{base}.block.4"),
                          "bias": get(f"{base}.block.4.bias")},
                "shortcut": {"kernel": conv_w(f"{base}.shortcut"),
                             "bias": get(f"{base}.shortcut.bias")},
            }
            idx += 1
    idx += 2  # lrelu, pad
    params["conv_post"] = {"kernel": conv_w(f"model.{idx}"),
                           "bias": get(f"model.{idx}.bias")}
    return params


def load_melgan_params(path: str, cfg: MelGANConfig | None = None) -> dict:
    """MelGAN flax params from a flat npz, or converted from a local torch
    checkpoint (``best_netG.pt``, or any .pt holding the state dict, bare,
    nested or under ``state_dict``)."""
    if path.endswith(".npz"):
        return unflatten_npz(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not any(torch.is_tensor(v) or isinstance(v, np.ndarray)
               for v in ckpt.values()):
        ckpt = ckpt.get("state_dict", ckpt)
    sd = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
              else np.asarray(v)) for k, v in ckpt.items()
          if torch.is_tensor(v) or isinstance(v, np.ndarray)}
    return convert_torch_melgan(sd, cfg)


def load_melgan(path: str | None, cfg: MelGANConfig | None = None
                ) -> MelGANGenerator:
    """A MelGAN generator from :func:`load_melgan_params`'s formats.  There
    is no bundled checkpoint (the reference downloads one through torch.hub,
    and nothing is downloaded here), so a path is required."""
    if not path:
        raise FileNotFoundError(
            "MelGAN has no bundled checkpoint (the reference downloads it "
            "via torch.hub) — pass a local melgan-neurips generator .pt via "
            "--vocoder_ckpt")
    cfg = cfg or MelGANConfig()
    return load_flax_params(MelGANGenerator(cfg),
                            load_melgan_params(path, cfg)).eval()
