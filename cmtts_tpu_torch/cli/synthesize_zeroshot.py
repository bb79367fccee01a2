"""Zero-shot synthesis with the PyTorch port: condition a multi-speaker
model that takes external speaker embeddings on an unseen voice
(counterpart of ``cli/synthesize_zeroshot.py``).

    python -m cmtts_tpu_torch.cli.synthesize_zeroshot --dataset VCTK \\
        --text "Hello world" (--ref_wav voice.wav | --spker_embed emb.npy) \\
        [--embedder_ckpt emb.npz|encoder.pt|ge2e_params.npy|ds.h5] \\
        [--params cm.npz|model.pt | --restore_step N] [--T 1] \\
        [--vocoder griffinlim|hifigan|melgan|none] [--vocoder_ckpt ...]
    python -m cmtts_tpu_torch.cli.synthesize_zeroshot --mode batch \\
        --source <preprocessed>/val.txt --ref_wav voice.wav --restore_step 0

``--ref_wav`` is embedded on the fly by the config's embedder (DeepSpeaker
or GE2E; ``--embedder_ckpt`` is a flat npz of its flax variables, GE2E's
torch ``encoder.pt`` or trainer ``.npy``, or DeepSpeaker's Keras ``.h5``;
random weights with a warning otherwise); ``--spker_embed`` is a
precomputed ``.npy``.  Its width must be the model's
``external_speaker_dim``.  ``--restore_step`` reads a checkpoint of the
port's trainer and adopts the masked inverse-CWT standardisation its run
recorded.  Without ``--vocoder`` or ``--vocoder_ckpt`` the mel is inverted
with Griffin-Lim (a random-init neural vocoder would only buzz).  Single
mode writes ``zeroshot_single.wav`` and ``-mel.npy``; batch mode (batch
size 1, as the reference's zero-shot scripts run) ``<basename>.wav`` and
``-mel.npy`` for each metadata line.  Outputs go to ``--out_dir``, else,
from a checkpoint, to ``<result_path>_cm/step_{N}_T{T}_{tag}`` as the JAX
CLI writes them, else to ``output/result_torch_{tag}``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cmtts_tpu_torch.cli.synthesize import (
    add_common_args,
    adopt_run_flags,
    load_cmtts,
    load_vocoder,
    restore_cmtts,
    tokenizer,
    write_outputs,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", type=str, choices=["single", "batch"],
                        default="single")
    parser.add_argument("--dataset", type=str, default="VCTK",
                        help="config of a multi-speaker model trained with "
                             "an external speaker embedder")
    add_common_args(parser, text_required=False)
    parser.add_argument("--source", type=str, default=None,
                        help="batch mode: metadata file to synthesize")
    parser.add_argument("--ref_wav", type=str, default=None,
                        help="reference wav of the target speaker")
    parser.add_argument("--spker_embed", type=str, default=None,
                        help="precomputed speaker-embedding .npy")
    parser.add_argument("--embedder_ckpt", type=str, default=None,
                        help="the embedder's flat npz, torch .pt, GE2E "
                             "trainer .npy or Keras .h5")
    parser.add_argument("--tag", type=str, default="zeroshot")
    parser.add_argument("--out_dir", type=str, default=None)
    args = parser.parse_args(argv)
    if (args.ref_wav is None) == (args.spker_embed is None):
        parser.error("exactly one of --ref_wav / --spker_embed is required")
    if args.mode == "batch" and not args.source:
        parser.error("--mode batch needs --source")
    if args.mode == "single" and args.text is None:
        parser.error("--mode single needs --text")
    if args.restore_step is not None and args.params:
        parser.error("--restore_step and --params exclude each other")

    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.pipeline import Synthesizer

    device = cli_device(args.device)
    cfg = load_configs(args.dataset, args.config_root)
    mc = cfg.model
    if not mc.multi_speaker or mc.speaker_embedder == "none":
        raise SystemExit("zero-shot requires a multi-speaker model trained "
                         "with an external speaker embedder")
    if args.spker_embed:
        embed = np.load(args.spker_embed).astype(np.float32).reshape(-1)
    else:
        from cmtts_tpu_torch.audio.wavio import read_wav
        from cmtts_tpu_torch.models.speaker import get_deep_speaker_emb

        wav, _ = read_wav(args.ref_wav)
        embed = np.asarray(get_deep_speaker_emb(wav, cfg, args.embedder_ckpt,
                                                device), np.float32)
    if embed.shape[0] != mc.external_speaker_dim:
        raise SystemExit(f"embedding dim {embed.shape[0]} != "
                         f"external_speaker_dim {mc.external_speaker_dim}")

    if args.restore_step is not None:
        from cmtts_tpu_torch.train.checkpoint import read_run_config

        # the JAX CLI adopts only the run's masked standardisation
        run_cfg = read_run_config(cfg.train.ckpt_path)
        cfg = adopt_run_flags(
            cfg, {"cwt_masked_std": run_cfg.get("cwt_masked_std", False)})
        model = restore_cmtts(cfg, args.restore_step, "model")
        out_dir = args.out_dir or os.path.join(
            cfg.train.result_path + "_cm",
            f"step_{args.restore_step}_T{args.T}_{args.tag}")
    else:
        model = load_cmtts(cfg, args.params)
        out_dir = args.out_dir or f"output/result_torch_{args.tag}"

    vocoder = args.vocoder
    if vocoder is None and args.vocoder_ckpt is None:
        print("== no --vocoder_ckpt: vocoding with Griffin-Lim "
              "(pass --vocoder hifigan --vocoder_ckpt ... for neural) ==")
        vocoder = "griffinlim"
    neural, griffin = load_vocoder(cfg, vocoder, args.vocoder_ckpt, device)
    synth = Synthesizer(cfg, model, neural, T=args.T, device=device)

    def run(ids, tokens):
        B = len(tokens)
        mel, mel_lens, wav = synth(
            tokens, spker_embeds=np.tile(embed[None], (B, 1)),
            seed=args.seed, d_control=args.duration_control,
            p_control=args.pitch_control, e_control=args.energy_control)
        write_outputs(out_dir, ids, mel, mel_lens, wav, synth, griffin)

    if args.mode == "batch":
        from cmtts_tpu_torch.data.dataset import TextMetaDataset

        # the reference zero-shot scripts run batch_size=1
        for batch in TextMetaDataset(args.source, cfg).batches(1):
            run(batch["ids"], batch["tokens"])
    else:
        run(["zeroshot_single"], [tokenizer(cfg)(args.text)])
    return out_dir


if __name__ == "__main__":
    main()
