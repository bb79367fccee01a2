"""GE2E speaker-encoder training with the PyTorch port (counterpart of
``cli/train_ge2e.py``; reference ``ge2e_encoder/train.py`` surface).

    python -m cmtts_tpu_torch.cli.train_ge2e --wav_root raw_data/VCTK \\
        --work_dir out/ge2e --total_steps 10000 [--device cuda]

``--wav_root`` (``<root>/<speaker>/*.wav``) is sliced into 160-frame
partials under ``<work_dir>/partials`` first; ``--partials_root`` takes
pre-sliced ones.  Writes ``<work_dir>/ge2e_params.npy``, which
``--embedder_ckpt`` of this package's preprocessing and zero-shot CLIs
reads.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav_root", type=str, default=None,
                        help="<root>/<speaker>/*.wav — sliced into partials")
    parser.add_argument("--partials_root", type=str, default=None,
                        help="pre-sliced <root>/<speaker>/*.npy partials")
    parser.add_argument("--work_dir", type=str, required=True)
    parser.add_argument("--total_steps", type=int, default=10000)
    parser.add_argument("--speakers_per_batch", type=int, default=64)
    parser.add_argument("--utterances_per_speaker", type=int, default=10)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--log_every", type=int, default=100)
    parser.add_argument("--val_speakers", type=int, default=0,
                        help="reserve the LAST N speakers for unseen-"
                             "speaker EER validation + early stopping")
    parser.add_argument("--eval_every", type=int, default=500)
    parser.add_argument("--patience", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if (args.wav_root is None) == (args.partials_root is None):
        parser.error("exactly one of --wav_root / --partials_root")

    from cmtts_tpu_torch.core.device import resolve_device
    from cmtts_tpu_torch.train.ge2e_trainer import (
        GE2ETrainConfig,
        SpeakerVerificationDataset,
        train_ge2e,
    )

    device = resolve_device(args.device)
    partials = args.partials_root
    if partials is None:
        partials = os.path.join(args.work_dir, "partials")
        n = SpeakerVerificationDataset.prepare_from_wavs(args.wav_root,
                                                         partials)
        print(f"==> sliced {n} partial utterances -> {partials}")

    cfg = GE2ETrainConfig(
        speakers_per_batch=args.speakers_per_batch,
        utterances_per_speaker=args.utterances_per_speaker,
        learning_rate=args.lr)
    params = train_ge2e(partials, args.work_dir, args.total_steps, cfg,
                        log_every=args.log_every,
                        val_speakers=args.val_speakers,
                        eval_every=args.eval_every, patience=args.patience,
                        device=device)
    print(f"==> saved {os.path.join(args.work_dir, 'ge2e_params.npy')}")
    return params


if __name__ == "__main__":
    main()
