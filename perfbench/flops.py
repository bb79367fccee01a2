"""The yardstick's arithmetic: peaks of the card and the operations and
bytes of each piece of work, counted from shapes (2 FLOP a multiply-add).

Frozen copies: the MRF stage's FLOP and bytes are ``chip_smoke.py``'s
``stage_flop`` / ``stage_bound`` (252 C^2 L B a stage, 14 C L B for the
fused head; x read once and the output written once, the weights in the
compute type and the float32 biases read once); the denoiser's is
``cmtts_tpu_torch/models/denoiser.py::denoiser_flop``; the vocoder's
transposed convs count as ``chip_smoke.py::hifigan_step_flop`` counts
them (each input sample meets the whole kernel).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12}
PEAK_BYTES_S = 3.35e12
# the MRF stage's kernel sizes and dilations (HiFi-GAN V1)
MRF_KS, MRF_DS = (3, 7, 11), (1, 3, 5)


def mrf_stage_flop(B: int, C: int, L: int, head: bool) -> int:
    """18 convs of 2 k C^2 a position, k in {3, 7, 11}; the head's
    conv_post 2 * 7 * C a position."""
    return 252 * C * C * L * B + (14 * C * L * B if head else 0)


def mrf_stage_bytes(B: int, C: int, L: int, head: bool,
                    weight_bytes: int) -> int:
    return (C * L * B * 4 + (L * B if head else C * L * B) * 4
            + (126 * C * C + (7 * C if head else 0)) * weight_bytes
            + 18 * C * 4)


def mrf_stage_bound_s(B, C, L, head, dtype="bfloat16") -> float:
    """The least time of one stage: the larger of its FLOP at the type's
    peak and its bytes at the memory rate."""
    wb = 4 if dtype == "float32" else 2
    return max(mrf_stage_flop(B, C, L, head) / PEAK_FLOPS[dtype],
               mrf_stage_bytes(B, C, L, head, wb) / PEAK_BYTES_S)


def vocoder_stages(v: dict, T: int):
    """[(C, L, head)] of the MRF stages of a HiFi-GAN of config ``v`` on T
    mel frames."""
    out, L, width = [], T, v["upsample_initial_channel"]
    n = len(v["upsample_rates"])
    for i, r in enumerate(v["upsample_rates"]):
        L *= r
        out.append((width // 2 ** (i + 1), L, i == n - 1))
    return out


def mrf_bound_s(v: dict, B: int, T: int, dtype="bfloat16") -> float:
    return sum(mrf_stage_bound_s(B, C, L, head, dtype)
               for C, L, head in vocoder_stages(v, T))


def vocoder_flop(v: dict, B: int, T: int) -> int:
    """conv_pre, each transposed conv and each MRF stage with the head."""
    width = v["upsample_initial_channel"]
    flop = 2 * v["num_mels"] * width * 7 * T * B
    cin, L = width, T
    for i, (r, k) in enumerate(zip(v["upsample_rates"],
                                   v["upsample_kernel_sizes"])):
        cout = width // 2 ** (i + 1)
        flop += 2 * L * B * cin * cout * k
        cin, L = cout, L * r
    return flop + sum(mrf_stage_flop(B, C, L2, head)
                      for C, L2, head in vocoder_stages(v, T))


def denoiser_flop(c, B: int, L: int) -> int:
    """One denoiser forward at B x L frames: per frame in_proj, per block
    cond_proj (and spk_proj per row), the k3 gate and filter convs and
    out_proj, then skip_proj and out_proj; per row the step MLP and each
    block's t_proj."""
    C, N, H, M = c.den_channels, c.den_layers, c.hidden, c.n_mels
    frame = (2 * M * C + N * (2 * H * C + 2 * 2 * 3 * C * C + 2 * C * 2 * C)
             + 2 * C * C + 2 * C * M)
    row = 2 * C * 4 * C * 2 + N * 2 * C * C
    if c.multi_speaker:
        row += N * 2 * H * C
    return B * L * frame + B * row


def condition_flop(c, B: int, T_txt: int, L: int) -> int:
    """The conditioning network at B rows, T_txt padded phonemes and L mel
    frames: the encoder (q, k, v, out, attention, conv FFN), the duration
    and energy predictors over phonemes, the CWT branch over frames and
    the speaker projection."""
    H, F = c.hidden, c.filter_size
    enc = c.layers * (8 * T_txt * H * H + 4 * T_txt * T_txt * H
                      + 2 * T_txt * H * 4 * H * c.ffn_kernel
                      + 2 * T_txt * 4 * H * H)
    dur = 2 * T_txt * (H * F * c.dur_kernel
                       + (c.dur_layers - 1) * F * F * c.dur_kernel + F)
    energy = 2 * T_txt * (H * F * c.predictor_kernel
                          + (c.predictor_layers - 1) * F * F
                          * c.predictor_kernel + F)
    cwt = 2 * L * (H * c.cwt_hidden + c.cwt_hidden * F * c.predictor_kernel
                   + (c.predictor_layers - 1) * F * F * c.predictor_kernel
                   + F * 11)
    stats = 2 * (H * c.cwt_hidden + c.cwt_hidden * c.cwt_hidden
                 + 2 * c.cwt_hidden)
    spk = 2 * c.external_speaker_dim * H if c.multi_speaker else 0
    return B * (enc + dur + energy + cwt + stats + spk)


def rescnn_flop(B: int, frames: int = 160, fbanks: int = 64,
                filters=(64, 128, 256, 512), embedding: int = 512) -> int:
    """DeepSpeaker ResCNN: per stage a 5x5 stride-2 conv and three
    identity blocks of two 3x3 convs, then the affine layer."""
    flop, h, w, cin = 0, frames, fbanks, 1
    for f in filters:
        h, w = -(-h // 2), -(-w // 2)
        flop += 2 * h * w * f * cin * 25 + 6 * 2 * h * w * f * f * 9
        cin = f
    return B * (flop + 2 * filters[-1] * w * embedding)
