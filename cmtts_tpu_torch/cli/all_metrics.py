"""Offline metric harness (counterpart of ``cli/all_metrics.py``).

    python -m cmtts_tpu_torch.cli.all_metrics --syn_root output/result/LJSpeech_cm \\
        --raw_folder raw_data/LJSpeech --data_type LJSpeech \\
        --metrics mcd ffe ssim [--single] [--device cuda]

With ``--single`` it prints ``<metric>: <value>`` for one results dir;
otherwise it walks the step subdirectories and writes a CSV.  The metrics
are host numpy; ``speaker_cos`` embeds with the port's GE2E and ``mb_mos``
/ ``ld_mos`` score with MBNet (``--mos_ckpt``) and LDNet (``--ld_ckpt``,
``--ld_config``) on ``--device`` (``cuda`` by default; the CLI raises
without CUDA unless given ``--device cpu``).  ``wer`` needs
``--asr_model``, a local directory of whisper weights.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--syn_root", type=str, required=True,
                        help="folder containing per-step result subdirs, or "
                             "a single results dir (with --single)")
    parser.add_argument("--raw_folder", type=str, required=True)
    parser.add_argument("--data_type", type=str, default="LJSpeech",
                        choices=["LJSpeech", "VCTK", "LibriTTS"])
    parser.add_argument("--metrics", nargs="+", required=True,
                        help="e.g. mcd mcd24 mcd_dctmel ffe ssim f0_rmse "
                             "f0_corr mfcc_cos si_sdr fid_mel fid_mfcc "
                             "precision_mel recall_mel speaker_cos "
                             "mfcc_gmm_kl wer mb_mos ld_mos")
    parser.add_argument("--single", action="store_true",
                        help="treat --syn_root as one results dir")
    parser.add_argument("--file_find_type", type=str, default=None,
                        choices=[None, "key_step", "only_end"])
    parser.add_argument("--max_pairs", type=int, default=None)
    parser.add_argument("--mos_ckpt", type=str, default=None,
                        help="local MBNet torch checkpoint for mb_mos")
    parser.add_argument("--ld_ckpt", type=str, default=None,
                        help="local LDNet torch checkpoint for ld_mos")
    parser.add_argument("--ld_config", type=str, default=None,
                        help="LDNet config.yml accompanying --ld_ckpt")
    parser.add_argument("--asr_model", type=str, default=None,
                        help="local whisper-weights dir for wer")
    parser.add_argument("--speaker_embedder_ckpt", type=str, default=None,
                        help="flat a/b/c npz of GE2E flax params for "
                             "speaker_cos; random weights if omitted")
    parser.add_argument("--meta_txt", nargs="*", default=None,
                        help="train/val.txt metadata files supplying "
                             "reference transcripts for wer")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.metrics import Cal, CalOneModel

    device = cli_device(args.device)
    kw = dict(transcriber=args.asr_model, meta_txt=args.meta_txt,
              mos_ckpt=args.mos_ckpt, ld_ckpt=args.ld_ckpt,
              ld_config=args.ld_config, device=device)
    if args.speaker_embedder_ckpt:
        from cmtts_tpu_torch.models.speaker import (
            GE2EInference,
            ge2e_from_checkpoint,
        )

        kw["speaker_embedder"] = GE2EInference(
            ge2e_from_checkpoint(args.speaker_embedder_ckpt),
            device).embed_utterance
    if args.single:
        cal = Cal(args.syn_root, data_type=args.data_type,
                  raw_folder=args.raw_folder, max_pairs=args.max_pairs, **kw)
        vals = cal.get_metrics_by_list(args.metrics)
        for name, val in zip(args.metrics, vals):
            print(f"{name}: {val:.6f}")
        return dict(zip(args.metrics, vals))
    tool = CalOneModel(args.syn_root, raw_folder=args.raw_folder,
                       data_type=args.data_type,
                       file_find_type=args.file_find_type,
                       max_pairs=args.max_pairs, **kw)
    csv_path = tool.get_model_metrics_by_list(args.metrics)
    print(f"wrote {csv_path}")
    return csv_path


if __name__ == "__main__":
    main()
