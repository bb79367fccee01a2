"""MOS predictors (port of ``cmtts_tpu/metrics/mos.py``): MBNet's MeanNet,
the hamming |STFT| it scores, and ``MOSCal``, which loads MBNet and LDNet
(:mod:`cmtts_tpu_torch.metrics.ldnet`) from the reference's torch
checkpoints on the caller's device.

A reference state dict goes through the copied numpy converter
(``convert_torch_mbnet``, ``convert_torch_ldnet``) into the flax layout and
then through the one bridge (``convert.load_flax_params``), so that the
modules carry the flax names.  The MBNet weights (``model-50000.pt``) and
the LDNet checkpoint are missing blobs in the reference; without them the
loaders raise the JAX package's messages.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cmtts_tpu_torch.convert import load_flax_params
from cmtts_tpu_torch.core.device import resolve_device
from cmtts_tpu_torch.models.hifigan_disc import same_pads

_MB_CHANNELS = (16, 32, 64, 128)


class MBNetMeanNet(nn.Module):
    """MBNet's mean-score network (the reference's metrics/mb_model.py:6-41,
    69-77): four stages of three 3x3 convs, the third strided 3 along
    frequency, each stage closed by BatchNorm (running statistics) and
    ReLU; a BLSTM of 128 over the frames; a 256 -> 128 -> 1 ReLU MLP.

    NCHW ``(B, C, time, freq)``; the convs pad as XLA's "SAME" does (at the
    strided conv the odd pad sample goes after), as the flax module
    computes."""

    def __init__(self):
        super().__init__()
        c_in = 1
        for s, c in enumerate(_MB_CHANNELS):
            for j in range(3):
                self.add_module(f"conv_{s}_{j}", nn.Conv2d(
                    c_in if j == 0 else c, c, 3,
                    stride=(1, 3) if j == 2 else 1))
            self.add_module(f"bn_{s}", nn.BatchNorm2d(c, eps=1e-5))
            c_in = c
        self.lstm = nn.LSTM(4 * 128, 128, batch_first=True,
                            bidirectional=True)
        self.dnn_0 = nn.Linear(256, 128)
        self.dnn_1 = nn.Linear(128, 1)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        """spec (B, T, 257) |STFT| frames -> per-frame scores (B, T)."""
        x = spec[:, None]
        for s in range(len(_MB_CHANNELS)):
            for j in range(3):
                conv = getattr(self, f"conv_{s}_{j}")
                lo, hi = same_pads(x.shape[-1], 3, conv.stride[1])
                x = conv(F.pad(x, (lo, hi, 1, 1)))
            x = torch.relu(getattr(self, f"bn_{s}")(x))
        B, C, T, W = x.shape
        # the flax layout (B, T, freq, C) flattened per frame
        x = x.permute(0, 2, 3, 1).reshape(B, T, W * C)
        x, _ = self.lstm(x)
        x = torch.relu(self.dnn_0(x))
        return torch.relu(self.dnn_1(x))[..., 0]


# Copied from cmtts_tpu/metrics/mos.py:50-105 (the numpy converter).
def _lstm_cell_params(sd, prefix, hidden):
    w_ih = np.asarray(sd[f"{prefix}.weight_ih_l0"])
    w_hh = np.asarray(sd[f"{prefix}.weight_hh_l0"])
    b = np.asarray(sd[f"{prefix}.bias_ih_l0"]) + np.asarray(
        sd[f"{prefix}.bias_hh_l0"])
    gates = {"i": slice(0, hidden), "f": slice(hidden, 2 * hidden),
             "g": slice(2 * hidden, 3 * hidden),
             "o": slice(3 * hidden, 4 * hidden)}
    cell = {}
    for gname, sl in gates.items():
        cell[f"i{gname}"] = {"kernel": w_ih[sl].T}
        cell[f"h{gname}"] = {"kernel": w_hh[sl].T, "bias": b[sl]}
    return cell


def convert_torch_mbnet(state_dict: dict) -> tuple[dict, dict]:
    """Reference MBNet state_dict -> (params, batch_stats) for the
    flax MeanNet.  Torch Conv2d (out,in,kh,kw) -> flax (kh,kw,in,out);
    the mean_net_conv Sequential indexes convs at 0,1,2 / 6,7,8 /
    12,13,14 / 18,19,20 and BNs at 4,10,16,22."""
    sd = state_dict
    conv_idx = [(0, 1, 2), (6, 7, 8), (12, 13, 14), (18, 19, 20)]
    bn_idx = [4, 10, 16, 22]
    params: dict = {}
    stats: dict = {}
    for s, (c0, c1, c2) in enumerate(conv_idx):
        for j, ci in enumerate((c0, c1, c2)):
            w = np.asarray(sd[f"mean_net_conv.{ci}.weight"])
            params[f"conv_{s}_{j}"] = {
                "kernel": w.transpose(2, 3, 1, 0),
                "bias": np.asarray(sd[f"mean_net_conv.{ci}.bias"])}
        bi = bn_idx[s]
        params[f"bn_{s}"] = {
            "scale": np.asarray(sd[f"mean_net_conv.{bi}.weight"]),
            "bias": np.asarray(sd[f"mean_net_conv.{bi}.bias"])}
        stats[f"bn_{s}"] = {
            "mean": np.asarray(sd[f"mean_net_conv.{bi}.running_mean"]),
            "var": np.asarray(sd[f"mean_net_conv.{bi}.running_var"])}
    params["lstm_fwd"] = _lstm_cell_params(sd, "mean_net_rnn", 128)
    # torch bidirectional LSTM stores reverse weights with _reverse suffix
    bwd = {}
    w_ih_r = np.asarray(sd["mean_net_rnn.weight_ih_l0_reverse"])
    w_hh_r = np.asarray(sd["mean_net_rnn.weight_hh_l0_reverse"])
    b_r = np.asarray(sd["mean_net_rnn.bias_ih_l0_reverse"]) + np.asarray(
        sd["mean_net_rnn.bias_hh_l0_reverse"])
    gates = {"i": slice(0, 128), "f": slice(128, 256),
             "g": slice(256, 384), "o": slice(384, 512)}
    for gname, sl in gates.items():
        bwd[f"i{gname}"] = {"kernel": w_ih_r[sl].T}
        bwd[f"h{gname}"] = {"kernel": w_hh_r[sl].T, "bias": b_r[sl]}
    params["lstm_bwd"] = bwd
    params["dnn_0"] = {"kernel": np.asarray(sd["mean_net_dnn.0.weight"]).T,
                       "bias": np.asarray(sd["mean_net_dnn.0.bias"])}
    params["dnn_1"] = {"kernel": np.asarray(sd["mean_net_dnn.3.weight"]).T,
                       "bias": np.asarray(sd["mean_net_dnn.3.bias"])}
    return params, stats


# Copied from cmtts_tpu/metrics/mos.py:108-118.
def hamming_spectrum(wav: np.ndarray, sr_unused: int = 22500) -> np.ndarray:
    """|STFT| with a hamming window, n_fft=512 hop=256 — the MOSCal input
    (metrics/mos.py:58-60), frames-major (T, 257)."""
    n_fft, hop = 512, 256
    window = np.hamming(n_fft).astype(np.float32)
    pad = n_fft // 2
    x = np.pad(np.asarray(wav, np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[idx] * window[None, :]
    return np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)


def _numpy_state_dict(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}


class MOSCal:
    """MOS predictor harness (the reference's metrics/mos.py:11-67) on
    ``device`` (``cuda`` unless the caller asks for another).  ``mb_ckpt``
    is the torch MBNet checkpoint; ``ld_ckpt`` / ``ld_config`` a local
    LDNet checkpoint and its config.yml."""

    def __init__(self, sample_rate: int = 22500, mb_ckpt: str | None = None,
                 ld_ckpt: str | None = None, ld_config: str | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.mb_ckpt = mb_ckpt
        self.ld_ckpt = ld_ckpt
        self.ld_config = ld_config
        self._mb = None
        self._ld = None

    def _spec(self, wav: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            hamming_spectrum(wav, self.sample_rate)[None]).to(self.device)

    def _load_mb(self):
        if self.mb_ckpt is None:
            raise RuntimeError(
                "MBNet checkpoint unavailable: the reference's "
                "metrics/model-50000.pt is a missing large blob "
                "(.MISSING_LARGE_BLOBS) — pass mb_ckpt= to MOSCal")
        params, stats = convert_torch_mbnet(_numpy_state_dict(self.mb_ckpt))
        self._mb = load_flax_params(MBNetMeanNet(), params, stats).to(
            self.device).eval()

    @torch.no_grad()
    def get_mb_mos(self, wav: np.ndarray) -> float:
        if self._mb is None:
            self._load_mb()
        return float(self._mb(self._spec(wav)).mean())

    def _load_ld(self):
        if self.ld_ckpt is None or self.ld_config is None:
            raise RuntimeError(
                "LDNet checkpoint unavailable: the reference loads the "
                "external Pretrained-LDNet-ML-2337 (model-27000.pt + "
                "config.yml, hardcoded developer paths in "
                "metrics/mos.py:30-31) — pass ld_ckpt=/ld_config= to MOSCal")
        import yaml

        from cmtts_tpu_torch.metrics.ldnet import LDNet, convert_torch_ldnet

        with open(self.ld_config) as f:
            config = yaml.safe_load(f)
        params, stats = convert_torch_ldnet(_numpy_state_dict(self.ld_ckpt),
                                            config)
        self._ld = load_flax_params(LDNet(config), params, stats).to(
            self.device).eval()

    @torch.no_grad()
    def get_ld_mos(self, wav: np.ndarray) -> float:
        """Average-listener LDNet MOS of one waveform (reference
        metrics/mos.py:39-51)."""
        if self._ld is None:
            self._load_ld()
        scores, _posterior = self._ld.average_inference(
            self._spec(wav), include_meanspk=False)
        return float(scores[0])
