"""Generate the deterministic parametric corpus and a patched config root
(counterpart of ``cli/gen_corpus.py``).

Produces everything the port's pipeline needs under one root dir:

    <root>/raw/SYN/*.wav|.lab          (prepare_align output layout)
    <root>/pre/TextGrid/LJSpeech/*.TextGrid
    <root>/config/LJSpeech/*.yaml      (paths pointed into <root>)

    python -m cmtts_tpu_torch.cli.gen_corpus --out /tmp/syncorpus [--n 200] \\
        [--seed 1234] [--val_size 16] [--batch_size 32] [--tiny] \\
        [--speakers N --utts_per_speaker 40 --holdout 1] [--det_prosody]

then ``python -m cmtts_tpu_torch.cli.preprocess --dataset LJSpeech
--config_root <root>/config`` and ``python -m cmtts_tpu_torch.cli.train_cm
... --config_root <root>/config``.  The corpus is host numpy: this CLI
touches no device.  The configs are the repo's ``config/<dataset>/``.
"""

from __future__ import annotations

import argparse
import os


# the --tiny model: small enough to train and serve on the CPU
TINY_WIDTHS = {"transformer": {"encoder_layer": 1, "encoder_hidden": 32,
                               "decoder_hidden": 32},
               "denoiser": {"residual_layers": 2, "residual_channels": 32}}


def apply_tiny_widths(model: dict) -> dict:
    """Patch a ``model.yaml`` dict to :data:`TINY_WIDTHS` in place."""
    for section, widths in TINY_WIDTHS.items():
        model[section].update(widths)
    return model


def write_config_root(root: str, repo_cfg_dir: str, val_size: int,
                      batch_size: int, tiny: bool = False,
                      max_seq_len: int | None = None,
                      save_step: int | None = None,
                      log_step: int | None = None,
                      dataset: str = "LJSpeech",
                      speaker_embedder: str | None = None,
                      external_speaker_dim: int | None = None) -> str:
    """Copy config/<dataset>/*.yaml with paths re-pointed into ``root``."""
    import yaml

    cfg_dir = os.path.join(root, "config", dataset)
    os.makedirs(cfg_dir, exist_ok=True)

    with open(os.path.join(repo_cfg_dir, "preprocess.yaml")) as f:
        pre = yaml.safe_load(f)
    pre["path"]["raw_path"] = os.path.join(root, "raw")
    pre["path"]["preprocessed_path"] = os.path.join(root, "pre")
    pre["preprocessing"]["val_size"] = val_size
    if speaker_embedder is not None:
        pre["preprocessing"]["speaker_embedder"] = speaker_embedder
    with open(os.path.join(repo_cfg_dir, "model.yaml")) as f:
        model = yaml.safe_load(f)
    if max_seq_len:
        model["max_seq_len"] = max_seq_len
    if external_speaker_dim is not None:
        model["external_speaker_dim"] = external_speaker_dim
    if tiny:
        apply_tiny_widths(model)
    with open(os.path.join(repo_cfg_dir, "train.yaml")) as f:
        train = yaml.safe_load(f)
    # keep the ckpt/log/result split (./output/<role>/<dataset>) — a bare
    # basename would collapse all three roles into one directory
    train["path"] = {k: os.path.join(root, "output",
                                     os.path.basename(os.path.dirname(v)),
                                     os.path.basename(v))
                     for k, v in train["path"].items()}
    train["optimizer"]["batch_size"] = batch_size
    if save_step:
        train["step"]["save_step"] = save_step
    if log_step:
        train["step"]["log_step"] = log_step
    for name, blob in (("preprocess.yaml", pre), ("model.yaml", model),
                       ("train.yaml", train)):
        with open(os.path.join(cfg_dir, name), "w") as f:
            yaml.safe_dump(blob, f, sort_keys=False)
    return os.path.join(root, "config")


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--val_size", type=int, default=16)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--words_min", type=int, default=3)
    ap.add_argument("--words_max", type=int, default=7)
    ap.add_argument("--tiny", action="store_true",
                    help="shrink the model config for CPU smoke runs")
    ap.add_argument("--save_step", type=int, default=None)
    ap.add_argument("--log_step", type=int, default=None)
    ap.add_argument("--speakers", type=int, default=0,
                    help=">0: VCTK-layout multi-speaker corpus with "
                         "per-speaker voice profiles (zero-shot protocol)")
    ap.add_argument("--utts_per_speaker", type=int, default=40)
    ap.add_argument("--holdout", type=int, default=1,
                    help="speakers kept out of preprocess/train entirely "
                         "(zero-shot targets), written to raw_holdout/")
    ap.add_argument("--det_prosody", action="store_true",
                    help="text-predictable prosody: fixed per-speaker f0 "
                         "register, per-vowel deterministic accents, no "
                         "jitter")
    args = ap.parse_args(argv)

    from cmtts_tpu_torch.core.config import default_config_root
    from cmtts_tpu_torch.data.synthcorpus import (
        generate_corpus,
        generate_multispeaker_corpus,
    )

    raw = os.path.join(args.out, "raw")
    pre = os.path.join(args.out, "pre")
    repo_cfg = default_config_root()

    if args.speakers > 0:
        train_spk, hold_spk, phones = generate_multispeaker_corpus(
            raw, pre, n_speakers=args.speakers,
            utts_per_speaker=args.utts_per_speaker, seed=args.seed,
            n_words=(args.words_min, args.words_max),
            holdout_speakers=args.holdout,
            deterministic_prosody=args.det_prosody)
        cfg_root = write_config_root(
            args.out, os.path.join(repo_cfg, "VCTK"),
            args.val_size, args.batch_size, tiny=args.tiny,
            save_step=args.save_step, log_step=args.log_step,
            dataset="VCTK", speaker_embedder="GE2E",
            external_speaker_dim=256)
        # zero-shot source meta for the held-out utterances: ground-truth
        # phones as {PH ...} lines (speaker column is a dummy train
        # speaker — zero-shot identity comes from --ref_wav/--spker_embed)
        src = os.path.join(args.out, "zeroshot_source.txt")
        with open(src, "w") as f:
            for (spk, base), ph in sorted(phones.items()):
                if spk in hold_spk:
                    # match get_alignment: trim boundary silences, keep
                    # interior sp (data/preprocessor.py)
                    core = [p for p in ph if p != "sil"]
                    while core and core[0] == "sp":
                        core = core[1:]
                    while core and core[-1] == "sp":
                        core = core[:-1]
                    f.write(f"{base}|{train_spk[0]}|{{{' '.join(core)}}}|syn\n")
        print(f"==> {len(train_spk)} train + {len(hold_spk)} holdout "
              f"speakers x {args.utts_per_speaker} utts under {raw}")
        print(f"==> zero-shot source: {src}")
    else:
        names = generate_corpus(raw, pre, n_utts=args.n, seed=args.seed,
                                n_words=(args.words_min, args.words_max),
                                deterministic_prosody=args.det_prosody)
        cfg_root = write_config_root(
            args.out, os.path.join(repo_cfg, "LJSpeech"),
            args.val_size, args.batch_size, tiny=args.tiny,
            save_step=args.save_step, log_step=args.log_step)
        print(f"==> {len(names)} utterances under {raw}")
    print(f"==> config root: {cfg_root}")
    return cfg_root


if __name__ == "__main__":
    main()
