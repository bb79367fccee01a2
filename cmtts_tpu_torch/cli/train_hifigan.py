"""HiFi-GAN vocoder training with the PyTorch port (counterpart of
``cli/train_hifigan.py``).

    python -m cmtts_tpu_torch.cli.train_hifigan --wav_root raw_data/LJSpeech \\
        --work_dir output/hifigan --total_steps 100000 [--device cuda]

Trains a vocoder from scratch on any wav corpus (searched recursively), or
fine-tunes one on external mels aligned to the wavs (``--finetune_mel_dir``
with ``--init_gen_npz``).  The generator exports as
``<work_dir>/hifigan_gen_<step>.npz`` in the flax key layout, which
``--vocoder_ckpt`` of this package's synthesis CLIs and of the JAX
package's load; ``--resume`` continues from ``hifigan_train_state.pt``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav_root", type=str, required=True,
                        help="directory tree of training wavs (searched "
                             "recursively)")
    parser.add_argument("--work_dir", type=str, required=True)
    parser.add_argument("--total_steps", type=int, default=100000)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--segment_size", type=int, default=8192)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--lambda_mel", type=float, default=45.0)
    parser.add_argument("--lambda_fm", type=float, default=2.0)
    parser.add_argument("--sampling_rate", type=int, default=22050)
    parser.add_argument("--num_mels", type=int, default=80)
    parser.add_argument("--upsample_initial_channel", type=int, default=512,
                        help="generator width (official v1=512; v2=128 is "
                             "~13x cheaper at reduced fidelity)")
    parser.add_argument("--disc_scale", type=int, default=1,
                        help="divide discriminator channel widths by this "
                             "(smoke runs / small corpora; 1 = paper scale)")
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--save_every", type=int, default=2000)
    parser.add_argument("--max_files", type=int, default=None,
                        help="cap the number of wavs loaded (smoke runs)")
    parser.add_argument("--finetune_mel_dir", type=str, default=None,
                        help="paired fine-tuning: directory of external "
                             "(e.g. teacher-forced TTS-predicted) mel npys "
                             "aligned to --wav_root ground-truth wavs "
                             "(HiFi-GAN paper sec. 4.2)")
    parser.add_argument("--init_gen_npz", type=str, default=None,
                        help="warm-start the generator from an exported "
                             "hifigan_gen_*.npz")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.models.hifigan import HiFiGANConfig
    from cmtts_tpu_torch.train.hifigan_trainer import (
        HiFiGANTrainConfig,
        train_hifigan,
    )

    device = cli_device(args.device)
    cfg = HiFiGANTrainConfig(
        segment_size=args.segment_size, batch_size=args.batch_size,
        learning_rate=args.lr, lambda_mel=args.lambda_mel,
        lambda_fm=args.lambda_fm, seed=args.seed)
    gen_cfg = HiFiGANConfig(
        num_mels=args.num_mels, sampling_rate=args.sampling_rate,
        upsample_initial_channel=args.upsample_initial_channel)
    return train_hifigan(args.wav_root, args.work_dir, args.total_steps, cfg,
                         gen_cfg, disc_config(args.disc_scale),
                         log_every=args.log_every,
                         save_every=args.save_every, resume=args.resume,
                         max_files=args.max_files,
                         finetune_mel_dir=args.finetune_mel_dir,
                         init_gen_npz=args.init_gen_npz, device=device)


def disc_config(scale: int):
    """The paper's discriminators with every width divided by ``scale``,
    floored at 4 (MPD) and 16 (MSD, whose groups must divide its
    widths)."""
    from cmtts_tpu_torch.models.hifigan_disc import HiFiGANDiscConfig

    dd = HiFiGANDiscConfig()
    s = max(scale, 1)
    if s == 1:
        return dd
    return HiFiGANDiscConfig(
        mpd_channels=tuple(max(c // s, 4) for c in dd.mpd_channels),
        msd_channels=tuple(max(c // s, 16) for c in dd.msd_channels))


if __name__ == "__main__":
    main()
