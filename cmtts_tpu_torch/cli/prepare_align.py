"""Corpus normalisation (counterpart of ``cli/prepare_align.py``): a raw
LJSpeech, VCTK or LibriTTS corpus -> ``raw_path/<speaker>/<basename>.{wav,lab}``.

    python -m cmtts_tpu_torch.cli.prepare_align --dataset LJSpeech \\
        [--config_root PATH]

Host numpy only: this CLI touches no device.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--config_root", type=str, default=None)
    args = parser.parse_args(argv)

    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.data.prepare import PREPARERS

    cfg = load_configs(args.dataset, args.config_root)
    PREPARERS[cfg.data.dataset](cfg)


if __name__ == "__main__":
    main()
