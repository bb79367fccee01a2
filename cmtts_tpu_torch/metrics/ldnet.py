"""LDNet MOS predictor, the listener-dependent MOS network (port of
``cmtts_tpu/metrics/ldnet.py``; parity source: the reference's
``metrics/ld_model/{LDNet,modules,mobilenetv2,mobilenetv3}.py``).

NCHW ``(B, C, time, freq)``.  The convs stride the frequency axis only
(the reference's "stride only operates on the last axis",
mobilenetv2.py:49-50), here the last axis, so time is kept end to end and
the final pooling is a mean over frequency.  The modules carry the flax
names, and ``config`` uses the torch LDNet's keys, so that its
``config.yml`` passes through unchanged.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

STRIDE = 3  # modules.py:10


# Copied from cmtts_tpu/metrics/ldnet.py:34-39.
def _make_divisible(v: float, divisor: int = 8) -> int:
    """mobilenetv2.py:15-28 channel rounding."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


_ACTS = {
    "relu": torch.relu,
    "relu6": F.relu6,
    "hardswish": F.hardswish,
    "identity": lambda x: x,
}


class ConvBNAct(nn.Module):
    """ConvBNActivation (mobilenetv2.py:31-55): conv (no bias, stride on
    frequency only, symmetric pad (k - 1) // 2 * dilation) -> BatchNorm
    (running statistics) -> activation."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 act: str = "relu6"):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=(1, stride),
                              padding=(kernel - 1) // 2 * dilation,
                              dilation=dilation, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.act = act

    def forward(self, x):
        return _ACTS[self.act](self.bn(self.conv(x)))


class InvertedResidualV2(nn.Module):
    """mobilenetv2.py:62-100 (expand -> depthwise -> linear project)."""

    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.expand = (ConvBNAct(inp, hidden, kernel=1)
                       if expand_ratio != 1 else None)
        self.depthwise = ConvBNAct(hidden, hidden, kernel=3, stride=stride,
                                   groups=hidden)
        self.project = nn.Conv2d(hidden, oup, 1, bias=False)
        self.project_bn = nn.BatchNorm2d(oup, eps=1e-5)
        self.residual = stride == 1 and inp == oup

    def forward(self, x):
        y = x if self.expand is None else self.expand(x)
        y = self.project_bn(self.project(self.depthwise(y)))
        return y + x if self.residual else y


class SqueezeExcitation(nn.Module):
    """mobilenetv3.py:20-38: mean over time and frequency -> fc1 -> relu
    -> fc2 -> hard-sigmoid gate."""

    def __init__(self, input_channels: int, squeeze_factor: int = 4):
        super().__init__()
        squeeze = _make_divisible(input_channels // squeeze_factor)
        self.fc1 = nn.Conv2d(input_channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, input_channels, 1)

    def forward(self, x):
        scale = torch.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True)))
        return F.hardsigmoid(self.fc2(scale)) * x


class InvertedResidualV3(nn.Module):
    """mobilenetv3.py:59-97.  ``cnf`` = (input_channels, kernel,
    expanded_channels, out_channels, use_se, use_hs, stride, dilation),
    width-adjusted (width_mult=1 in LDNet)."""

    def __init__(self, cnf: tuple):
        super().__init__()
        inp, kernel, expanded, out, use_se, use_hs, stride, dilation = cnf
        act = "hardswish" if use_hs else "relu"
        self.expand = (ConvBNAct(inp, expanded, kernel=1, act=act)
                       if expanded != inp else None)
        self.depthwise = ConvBNAct(expanded, expanded, kernel=kernel,
                                   stride=1 if dilation > 1 else stride,
                                   groups=expanded, dilation=dilation,
                                   act=act)
        self.se = SqueezeExcitation(expanded) if use_se else None
        self.project = ConvBNAct(expanded, out, kernel=1, act="identity")
        self.residual = stride == 1 and inp == out

    def forward(self, x):
        y = x if self.expand is None else self.expand(x)
        y = self.depthwise(y)
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        return y + x if self.residual else y


class _Encoder(nn.Module):
    """first conv (stride 3 on frequency) -> blocks -> 1x1 out conv ->
    mean over frequency -> (B, T, C)."""

    def forward(self, spec):
        x = self.first(spec[:, None])
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
        return self.last(x).mean(dim=3).transpose(1, 2)


class MobileNetV2Encoder(_Encoder):
    """modules.py:68-106."""

    def __init__(self, first_ch: int, t_list: Sequence[int],
                 c_list: Sequence[int], n_list: Sequence[int],
                 s_list: Sequence[int], output_dim: int):
        super().__init__()
        self.first = ConvBNAct(1, first_ch, kernel=3, stride=STRIDE)
        in_ch, idx = first_ch, 0
        for t, c, n, s in zip(t_list, c_list, n_list, s_list):
            for i in range(n):
                self.add_module(f"block_{idx}", InvertedResidualV2(
                    in_ch, c, s if i == 0 else 1, t))
                in_ch = c
                idx += 1
        self.n_blocks = idx
        self.last = ConvBNAct(in_ch, output_dim, kernel=1)


class MobileNetV3Encoder(_Encoder):
    """modules.py:108-156: hard-swish stem -> v3 bottlenecks -> 1x1
    hard-swish out conv."""

    def __init__(self, bneck_confs: Sequence, output_dim: int):
        super().__init__()
        confs = [_v3_cnf(row) for row in bneck_confs]
        self.first = ConvBNAct(1, confs[0][0], kernel=3, stride=STRIDE,
                               act="hardswish")
        for i, cnf in enumerate(confs):
            self.add_module(f"block_{i}", InvertedResidualV3(cnf))
        self.n_blocks = len(confs)
        self.last = ConvBNAct(confs[-1][3], output_dim, kernel=1,
                              act="hardswish")


# Copied from cmtts_tpu/metrics/ldnet.py:192-199.
def _v3_cnf(row) -> tuple:
    """Config row [in, kernel, expanded, out, use_se, act, stride,
    dilation] -> width-adjusted tuple (InvertedResidualConfig with
    width_mult=1, mobilenetv3.py:41-56)."""
    inp, kernel, expanded, out, use_se, act, stride, dilation = row
    return (_make_divisible(inp), int(kernel), _make_divisible(expanded),
            _make_divisible(out), bool(use_se), act == "HS", int(stride),
            int(dilation))


class Projection(nn.Module):
    """modules.py:12-40: Linear -> ReLU -> dropout(0.3) -> Linear; a scalar
    output optionally range-clipped to tanh * 2 + 3.  Inference only, so
    the dropout is the identity."""

    def __init__(self, in_dim: int, hidden_dim: int, output_type: str,
                 range_clipping: bool = False):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, 1 if output_type == "scalar" else 5)
        self.clip = output_type == "scalar" and range_clipping

    def forward(self, x):
        x = self.fc2(torch.relu(self.fc1(x)))
        return torch.tanh(x) * 2.0 + 3.0 if self.clip else x


class LDNet(nn.Module):
    """LDNet (LDNet.py:10-210), the judge-conditioned MOS predictor."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = self.config = config
        self.num_judges = cfg["num_judges"]
        emb = cfg["judge_emb_dim"]
        self.judge_embedding = nn.Embedding(cfg["num_judges"], emb)
        enc = cfg["encoder_type"]
        if enc == "mobilenetv2":
            self.encoder = MobileNetV2Encoder(
                cfg["encoder_conv_first_ch"], cfg["encoder_conv_t"],
                cfg["encoder_conv_c"], cfg["encoder_conv_n"],
                cfg["encoder_conv_s"], cfg["encoder_output_dim"])
        elif enc == "mobilenetv3":
            self.encoder = MobileNetV3Encoder(cfg["encoder_bneck_configs"],
                                              cfg["encoder_output_dim"])
        else:
            raise NotImplementedError(f"encoder_type {enc}")
        C = cfg["encoder_output_dim"]
        dec_in = C + emb
        if cfg["decoder_type"] == "rnn":
            self.dec_cell = nn.LSTM(dec_in, cfg["decoder_rnn_dim"],
                                    batch_first=True, bidirectional=True)
            dec_in = 2 * cfg["decoder_rnn_dim"]
        self.decoder_dnn = Projection(dec_in, cfg["decoder_dnn_dim"],
                                      cfg["output_type"],
                                      cfg["range_clipping"])
        if cfg["use_mean_net"]:
            mean_in = C
            if cfg["mean_net_type"] == "rnn":
                self.mean_cell = nn.LSTM(C, cfg["mean_net_rnn_dim"],
                                         batch_first=True,
                                         bidirectional=True)
                mean_in = 2 * cfg["mean_net_rnn_dim"]
            self.mean_net_dnn = Projection(
                mean_in, cfg["mean_net_dnn_dim"], cfg["output_type"],
                cfg["mean_net_range_clipping"])

    def _decode(self, x):
        if self.config["decoder_type"] == "rnn":
            x = self.dec_cell(x)[0]
        return self.decoder_dnn(x)

    def _mean_net(self, x):
        if self.config["mean_net_type"] == "rnn":
            x = self.mean_cell(x)[0]
        return self.mean_net_dnn(x)

    def forward(self, spectrum, judge_id):
        """(B, T, D) spectrum + (B,) judge ids -> (mean_score, ld_score)
        per frame (LDNet.py:83-124)."""
        B, T, _ = spectrum.shape
        judge_feat = self.judge_embedding(judge_id)[:, None, :].expand(
            B, T, -1)
        encoder_outputs = self.encoder(spectrum)
        decoder_inputs = torch.cat([encoder_outputs, judge_feat], dim=-1)
        mean_score = (self._mean_net(encoder_outputs)
                      if self.config["use_mean_net"] else None)
        return mean_score, self._decode(decoder_inputs)

    def mean_listener_inference(self, spectrum):
        """Mean-listener (last judge id) scores (B,) (LDNet.py:126-155)."""
        if not self.config["use_mean_listener"]:
            raise ValueError("mean_listener_inference needs "
                             "use_mean_listener")
        judge_id = torch.full((spectrum.shape[0],), self.num_judges - 1,
                              dtype=torch.long, device=spectrum.device)
        _, ld_score = self(spectrum, judge_id)
        return ld_score[..., 0].mean(dim=1)

    def average_inference(self, spectrum, include_meanspk: bool = False):
        """Average over all listeners (LDNet.py:157-210): returns (scores
        (B,), posterior_scores (B, nj))."""
        cfg = self.config
        B, T, _ = spectrum.shape
        nj = self.num_judges - (1 if cfg["use_mean_listener"]
                                and not include_meanspk else 0)
        judge_feat = self.judge_embedding(
            torch.arange(nj, device=spectrum.device))          # (nj, E)
        encoder_outputs = self.encoder(spectrum)              # (B, T, C)
        # (B, nj, T, C+E) flattened to (B*nj, T, .) like LDNet.py:191
        enc = encoder_outputs[:, None].expand(B, nj, T, -1)
        jf = judge_feat[None, :, None, :].expand(B, nj, T, -1)
        flat = torch.cat([enc, jf], dim=-1).reshape(B * nj, T, -1)
        out = self._decode(flat).reshape(B, nj, T, -1)
        if cfg["output_type"] == "scalar":
            out = out[..., 0]                                 # (B, nj, T)
        else:  # categorical: the expected score of the softmax
            out = torch.softmax(out, dim=-1) @ torch.arange(
                1.0, 6.0, device=out.device)
        return out.mean(dim=1).mean(dim=1), out.mean(dim=2)


# ---------------------------------------------------------------------------
# Copied from cmtts_tpu/metrics/ldnet.py:354-502 (the numpy torch -> flax
# converter).
# ---------------------------------------------------------------------------

def _conv(sd, key, depthwise=False):
    """Torch Conv2d weight (O, I/g, kh, kw) -> flax (kh, kw, I/g, O)."""
    w = np.asarray(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)
    out = {"kernel": w}
    if f"{key}.bias" in sd:
        out["bias"] = np.asarray(sd[f"{key}.bias"])
    return out


def _bn(sd, key):
    params = {"scale": np.asarray(sd[f"{key}.weight"]),
              "bias": np.asarray(sd[f"{key}.bias"])}
    stats = {"mean": np.asarray(sd[f"{key}.running_mean"]),
             "var": np.asarray(sd[f"{key}.running_var"])}
    return params, stats


def _convbn(sd, key, params, stats, conv_i=0, bn_i=1):
    """Map a torch ConvBNActivation Sequential at ``key`` into a flax
    ConvBNAct subtree."""
    p, s = _bn(sd, f"{key}.{bn_i}")
    params["conv"] = _conv(sd, f"{key}.{conv_i}")
    params["bn"] = p
    stats["bn"] = s


def _lstm_dir(sd, prefix, hidden, suffix=""):
    w_ih = np.asarray(sd[f"{prefix}.weight_ih_l0{suffix}"])
    w_hh = np.asarray(sd[f"{prefix}.weight_hh_l0{suffix}"])
    b = np.asarray(sd[f"{prefix}.bias_ih_l0{suffix}"]) + np.asarray(
        sd[f"{prefix}.bias_hh_l0{suffix}"])
    gates = {"i": slice(0, hidden), "f": slice(hidden, 2 * hidden),
             "g": slice(2 * hidden, 3 * hidden),
             "o": slice(3 * hidden, 4 * hidden)}
    cell = {}
    for gname, sl in gates.items():
        cell[f"i{gname}"] = {"kernel": w_ih[sl].T}
        cell[f"h{gname}"] = {"kernel": w_hh[sl].T, "bias": b[sl]}
    return cell


def _projection(sd, prefix):
    return {
        "fc1": {"kernel": np.asarray(sd[f"{prefix}.net.0.weight"]).T,
                "bias": np.asarray(sd[f"{prefix}.net.0.bias"])},
        "fc2": {"kernel": np.asarray(sd[f"{prefix}.net.3.weight"]).T,
                "bias": np.asarray(sd[f"{prefix}.net.3.bias"])},
    }


def convert_torch_ldnet(state_dict: dict, config: dict) -> tuple[dict, dict]:
    """Reference LDNet ``state_dict`` (numpy values) + its config dict ->
    (params, batch_stats) for the flax :class:`LDNet`."""
    sd = state_dict
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}

    params["judge_embedding"] = {
        "embedding": np.asarray(sd["judge_embedding.weight"])}

    enc_p: dict[str, Any] = {}
    enc_s: dict[str, Any] = {}
    if config["encoder_type"] == "mobilenetv2":
        fi = 0  # torch features index
        p, s = {}, {}
        _convbn(sd, f"encoder.features.{fi}", p, s)
        enc_p["first"], enc_s["first"] = p, s
        fi += 1
        idx = 0
        in_ch = config["encoder_conv_first_ch"]
        for t, c, n, s_ in zip(config["encoder_conv_t"],
                               config["encoder_conv_c"],
                               config["encoder_conv_n"],
                               config["encoder_conv_s"]):
            for i in range(n):
                base = f"encoder.features.{fi}.conv"
                bp: dict[str, Any] = {}
                bs: dict[str, Any] = {}
                j = 0
                if t != 1:
                    ep, es = {}, {}
                    _convbn(sd, f"{base}.{j}", ep, es)
                    bp["expand"], bs["expand"] = ep, es
                    j += 1
                dp, ds = {}, {}
                _convbn(sd, f"{base}.{j}", dp, ds)
                bp["depthwise"], bs["depthwise"] = dp, ds
                j += 1
                bp["project"] = _conv(sd, f"{base}.{j}")
                pbn, sbn = _bn(sd, f"{base}.{j + 1}")
                bp["project_bn"], bs["project_bn"] = pbn, sbn
                enc_p[f"block_{idx}"], enc_s[f"block_{idx}"] = bp, bs
                in_ch = c
                idx += 1
                fi += 1
        p, s = {}, {}
        _convbn(sd, f"encoder.features.{fi}", p, s)
        enc_p["last"], enc_s["last"] = p, s
    elif config["encoder_type"] == "mobilenetv3":
        confs = [_v3_cnf(r) for r in config["encoder_bneck_configs"]]
        p, s = {}, {}
        _convbn(sd, "encoder.features.0", p, s)
        enc_p["first"], enc_s["first"] = p, s
        for i, cnf in enumerate(confs):
            inp, kernel, expanded, out, use_se, use_hs, stride, dil = cnf
            base = f"encoder.features.{i + 1}.block"
            bp, bs = {}, {}
            j = 0
            if expanded != inp:
                ep, es = {}, {}
                _convbn(sd, f"{base}.{j}", ep, es)
                bp["expand"], bs["expand"] = ep, es
                j += 1
            dp, ds = {}, {}
            _convbn(sd, f"{base}.{j}", dp, ds)
            bp["depthwise"], bs["depthwise"] = dp, ds
            j += 1
            if use_se:
                bp["se"] = {"fc1": _conv(sd, f"{base}.{j}.fc1"),
                            "fc2": _conv(sd, f"{base}.{j}.fc2")}
                j += 1
            pp, ps = {}, {}
            _convbn(sd, f"{base}.{j}", pp, ps)
            bp["project"], bs["project"] = pp, ps
            enc_p[f"block_{i}"], enc_s[f"block_{i}"] = bp, bs
        p, s = {}, {}
        _convbn(sd, f"encoder.features.{len(confs) + 1}", p, s)
        enc_p["last"], enc_s["last"] = p, s
    else:
        raise NotImplementedError(config["encoder_type"])
    params["encoder"] = enc_p
    stats["encoder"] = enc_s

    if config["decoder_type"] == "rnn":
        dim = config["decoder_rnn_dim"]
        params["dec_cell_fwd"] = _lstm_dir(sd, "decoder_rnn", dim)
        params["dec_cell_bwd"] = _lstm_dir(sd, "decoder_rnn", dim,
                                           suffix="_reverse")
    params["decoder_dnn"] = _projection(sd, "decoder_dnn")

    if config["use_mean_net"]:
        if config["mean_net_type"] == "rnn":
            dim = config["mean_net_rnn_dim"]
            params["mean_cell_fwd"] = _lstm_dir(sd, "mean_net_rnn", dim)
            params["mean_cell_bwd"] = _lstm_dir(sd, "mean_net_rnn", dim,
                                                suffix="_reverse")
        params["mean_net_dnn"] = _projection(sd, "mean_net_dnn")

    return params, stats
