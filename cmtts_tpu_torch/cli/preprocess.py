"""Feature extraction (counterpart of ``cli/preprocess.py``): the TextGrids
and wavs of the config's corpus -> per-utterance feature npy files,
``stats.json``, ``speakers.json``, ``train.txt`` and ``val.txt``.

    python -m cmtts_tpu_torch.cli.preprocess --dataset LJSpeech \\
        [--config_root PATH] [--workers N] [--embedder_ckpt e.npz] \\
        [--device cuda]

The mel front-end runs on ``--device`` (``cuda`` by default; raises without
CUDA unless given ``--device cpu``); the f0 tracker, the CWT and the
statistics are host numpy.  ``--workers N`` fans the utterances over N
spawned processes, each with its own front-end on the same device, so N
workers on ``cuda`` open N CUDA contexts.  A multi-speaker config with an
external speaker embedder embeds every utterance (serially) with the
port's DeepSpeaker or GE2E, from a flat npz of flax params or random
weights.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--config_root", type=str, default=None)
    parser.add_argument("--embedder_ckpt", type=str, default=None,
                        help="flat a/b/c npz of the speaker embedder's "
                             "flax params (random weights if omitted)")
    parser.add_argument("--workers", type=int, default=1,
                        help="parallel feature-extraction processes "
                             "(0 = cpu count; ignored with a speaker "
                             "embedder)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.workers == 0:
        args.workers = os.cpu_count() or 1

    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.data.preprocessor import Preprocessor

    device = cli_device(args.device)
    cfg = load_configs(args.dataset, args.config_root)
    embedder = None
    if cfg.model.multi_speaker and cfg.model.speaker_embedder != "none":
        from cmtts_tpu_torch.models.speaker import PreDefinedEmbedder

        embedder = PreDefinedEmbedder(cfg, args.embedder_ckpt, device)
    return Preprocessor(cfg, speaker_embedder=embedder,
                        device=device).build_from_path(workers=args.workers)


if __name__ == "__main__":
    main()
