"""Zero-shot synthesis with the PyTorch port: condition a multi-speaker
model that takes external speaker embeddings on an unseen voice
(counterpart of ``cli/synthesize_zeroshot.py``, single mode).

    python -m cmtts_tpu_torch.cli.synthesize_zeroshot --dataset VCTK \\
        --text "Hello world" (--ref_wav voice.wav | --spker_embed emb.npy) \\
        [--embedder_ckpt emb.npz] [--params cm.npz] \\
        [--vocoder griffinlim|hifigan|none] [--vocoder_ckpt hifigan.npz]

``--ref_wav`` is embedded on the fly by the config's embedder (DeepSpeaker
or GE2E; ``--embedder_ckpt`` is a flat npz of its flax variables, random
weights with a warning otherwise); ``--spker_embed`` is a precomputed
``.npy``.  Without ``--vocoder_ckpt`` the mel is inverted with Griffin-Lim
(a random-init neural vocoder would only buzz).  Writes
``zeroshot_single.wav`` and ``zeroshot_single-mel.npy`` under ``--out_dir``.
"""

from __future__ import annotations

import argparse

import numpy as np

from cmtts_tpu_torch.cli.synthesize import (
    add_common_args,
    load_cmtts,
    load_vocoder,
    preprocess_english,
    write_outputs,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", type=str, choices=["single"],
                        default="single")
    parser.add_argument("--dataset", type=str, default="VCTK",
                        help="config of a multi-speaker model trained with "
                             "an external speaker embedder")
    add_common_args(parser)
    parser.add_argument("--ref_wav", type=str, default=None,
                        help="reference wav of the target speaker")
    parser.add_argument("--spker_embed", type=str, default=None,
                        help="precomputed speaker-embedding .npy")
    parser.add_argument("--embedder_ckpt", type=str, default=None,
                        help="flat a/b/c npz of the embedder's flax variables")
    parser.add_argument("--out_dir", type=str,
                        default="output/result_torch_zeroshot")
    args = parser.parse_args(argv)
    if (args.ref_wav is None) == (args.spker_embed is None):
        parser.error("exactly one of --ref_wav / --spker_embed is required")

    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import resolve_device
    from cmtts_tpu_torch.pipeline import Synthesizer

    device = resolve_device(args.device)
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

    vocoder = args.vocoder
    if vocoder is None and args.vocoder_ckpt is None:
        print("== no --vocoder_ckpt: vocoding with Griffin-Lim "
              "(pass --vocoder hifigan --vocoder_ckpt ... for neural) ==")
        vocoder = "griffinlim"
    hifigan, griffin = load_vocoder(cfg, vocoder, args.vocoder_ckpt, device)
    synth = Synthesizer(cfg, load_cmtts(cfg, args.params), hifigan, T=args.T,
                        device=device)
    tokens = preprocess_english(args.text, cfg.data.lexicon_path,
                                list(cfg.data.text_cleaners))
    mel, mel_lens, wav = synth(
        [tokens], spker_embeds=embed[None], seed=args.seed,
        d_control=args.duration_control, p_control=args.pitch_control,
        e_control=args.energy_control)
    write_outputs(args.out_dir, ["zeroshot_single"], mel, mel_lens, wav,
                  synth, griffin)


if __name__ == "__main__":
    main()
