"""Vocode a directory of mel npys with a trained HiFi-GAN (or Griffin-Lim
for A/B): the vocoder-isolation half of the quality loop -- same mels,
different vocoder, so metric deltas are attributable to the vocoder alone.
Port of ``tools/vocode_dir.py``.

    python -m cmtts_tpu_torch.tools.vocode_dir --mel_dir <dir with *-mel.npy / *-mel-*.npy> \\
        --ckpt out/hifigan/hifigan_gen_00010000.npz --out <wav dir> [--device cuda]
    python -m cmtts_tpu_torch.tools.vocode_dir --mel_dir ... --griffinlim --out ...

Mels are ln-compressed (the front-end contract, ``audio/stft.py``); shapes
(frames, 80) or (80, frames) both accepted.  HiFi-GAN runs its plain
float32 forward (``HiFiGANGenerator.forward``, as the JAX tool runs
``gen.apply``), not the MRF kernels' path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def make_vocoder(args, device):
    """mel (T, n_mels) numpy -> wav numpy, on ``device``."""
    import torch

    if args.griffinlim:
        from cmtts_tpu_torch.audio.stft import GriffinLim, MelSpectrogram

        return GriffinLim(MelSpectrogram(sampling_rate=args.sr,
                                         n_mel_channels=args.n_mels,
                                         device=device))

    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.hifigan import (
        HiFiGANConfig,
        HiFiGANGenerator,
        load_hifigan_params,
    )

    params = load_hifigan_params(args.ckpt)
    width = int(np.asarray(params["conv_pre"]["kernel"]).shape[-1])
    gen = load_flax_params(HiFiGANGenerator(HiFiGANConfig(
        num_mels=args.n_mels, sampling_rate=args.sr,
        upsample_initial_channel=width)), params).to(device).eval()
    hop = args.hop  # front-end contract (audio/stft.py)

    @torch.no_grad()
    def vocode(mel):
        # the JAX tool pads frames up to a multiple of 64 with the ln-mel
        # silence floor (to bound its compiled shapes) and trims the output
        # to the true length; the padding changes the wav near its end, so
        # the port pads alike
        t = mel.shape[0]
        t_pad = -(-t // 64) * 64
        if t_pad != t:
            mel = np.pad(mel, ((0, t_pad - t), (0, 0)),
                         constant_values=float(np.log(1e-5)))
        wav = gen(torch.from_numpy(mel)[None].to(device))[0].cpu().numpy()
        return wav[: t * hop]

    return vocode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mel_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", default=None, help="hifigan generator npz/pt")
    ap.add_argument("--griffinlim", action="store_true")
    ap.add_argument("--n_mels", type=int, default=80)
    ap.add_argument("--sr", type=int, default=22050)
    ap.add_argument("--hop", type=int, default=256)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if (args.ckpt is None) == (not args.griffinlim):
        ap.error("exactly one of --ckpt / --griffinlim")

    from cmtts_tpu_torch.audio.wavio import write_wav
    from cmtts_tpu_torch.core.device import cli_device

    vocode = make_vocoder(args, cli_device(args.device))
    os.makedirs(args.out, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(args.mel_dir)):
        if not name.endswith(".npy") or "mel" not in name:
            continue
        mel = np.load(os.path.join(args.mel_dir, name)).astype(np.float32)
        if mel.ndim != 2:
            continue
        if mel.shape[0] == args.n_mels and mel.shape[1] != args.n_mels:
            mel = mel.T
        stem = name[:-4]
        if "-mel-" in stem:
            base = stem.split("-mel-", 1)[1]
        elif stem.endswith("-mel"):
            base = stem[:-4]
        else:
            base = stem
        wav = vocode(mel)
        write_wav(os.path.join(args.out, base + ".wav"), wav, args.sr)
        n += 1
    print(f"vocoded {n} mels -> {args.out}")
    return n


if __name__ == "__main__":
    main()
