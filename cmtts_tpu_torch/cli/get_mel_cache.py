"""Mel npy caches of synthesized wavs for metric runs (counterpart of
``cli/get_mel_cache.py``).

    python -m cmtts_tpu_torch.cli.get_mel_cache --wav_dir DIR --out_dir DIR \\
        [--sampling_rate 22050] [--device cuda]

Each ``<name>.wav`` becomes ``<name>-mel.npy`` (T, 80), from the port's
``MelSpectrogram`` at the LJSpeech STFT settings on ``--device`` (``cuda``
by default; raises without CUDA unless given ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav_dir", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--sampling_rate", type=int, default=22050)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from cmtts_tpu_torch.audio.stft import MelSpectrogram
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.metrics.features import load_wav

    stft = MelSpectrogram(sampling_rate=args.sampling_rate,
                          device=cli_device(args.device))
    os.makedirs(args.out_dir, exist_ok=True)
    n = 0
    for name in sorted(os.listdir(args.wav_dir)):
        if not name.endswith(".wav"):
            continue
        wav = load_wav(os.path.join(args.wav_dir, name), args.sampling_rate)
        mel, _energy = stft(wav)
        np.save(os.path.join(args.out_dir, name.replace(".wav", "-mel.npy")),
                mel.T.astype(np.float32))  # (T, n_mels)
        n += 1
    print(f"cached {n} mels -> {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
