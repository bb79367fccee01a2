"""Single-utterance synthesis with the PyTorch port (counterpart of
``cli/synthesize.py --mode single``).

    python -m cmtts_tpu_torch.cli.synthesize --mode single \\
        --text "Hello world" --T 1 --dataset LJSpeech \\
        [--params cm.npz] [--vocoder_ckpt hifigan.npz] [--device cuda]

``--params`` takes a flat ``a/b/c`` npz of flax CM params and
``--vocoder_ckpt`` a HiFi-GAN npz; without them the CLI warns and uses
random weights (with the duration head biased to ~6 frames per phoneme so
that the output has a realistic length).  Writes ``single.wav`` and
``single-mel.npy`` under ``--out_dir``.  Batch mode needs the dataset
module, which is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import re
import warnings
from string import punctuation

import numpy as np


def read_lexicon(lex_path: str) -> dict:
    lexicon = {}
    if not os.path.exists(lex_path):
        return lexicon
    with open(lex_path) as f:
        for line in f:
            temp = re.split(r"\s+", line.strip("\n"))
            if not temp or not temp[0]:
                continue
            word, phones = temp[0], temp[1:]
            lexicon.setdefault(word.lower(), phones)
    return lexicon


# Copied from cli/synthesize.py::preprocess_english (jax-free).
def preprocess_english(text: str, lexicon_path: str, cleaners) -> np.ndarray:
    """Word -> phoneme lookup with {ARPAbet} formatting.  Fallback chain for
    OOV words: g2p_en when installed, else the built-in rule G2P."""
    from cmtts_tpu_torch.text import text_to_sequence
    from cmtts_tpu_torch.text.cleaners import expand_numbers
    from cmtts_tpu_torch.text.g2p import g2p as rule_g2p

    text = text.rstrip(punctuation)
    text = expand_numbers(text)
    lexicon = read_lexicon(lexicon_path)
    try:
        from g2p_en import G2p  # optional
        g2p = G2p()
    except Exception:
        g2p = None

    phones = []
    for w in re.split(r"([,;.\-\?\!\s+])", text):
        if w.lower() in lexicon:
            phones += lexicon[w.lower()]
        elif g2p is not None:
            phones += [p for p in g2p(w) if p != " "]
        elif w.strip() and w.strip() not in punctuation:
            ph = rule_g2p(w)
            phones += ph if ph else ["spn"]
    phones = "{" + "}{".join(phones) + "}"
    phones = re.sub(r"\{[^\w\s]?\}", "{sp}", phones)
    phones = phones.replace("}{", " ")
    print(f"Phoneme sequence: {phones}")
    return np.asarray(text_to_sequence(phones, cleaners), dtype=np.int32)


def random_cmtts(cfg, seed: int = 0):
    """A randomly initialised CMTTS with the duration head biased to
    ln(7), i.e. ~6 frames per phoneme (random init predicts ~0 frames)."""
    import torch

    from cmtts_tpu_torch.models.cmtts import CMTTS

    torch.manual_seed(seed)
    model = CMTTS(cfg)
    with torch.no_grad():
        model.variance_adaptor.duration_predictor.proj.bias.fill_(
            float(np.log(7.0)))
    return model


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", type=str, choices=["single"],
                        required=True)
    parser.add_argument("--text", type=str, required=True)
    parser.add_argument("--dataset", type=str, default="LJSpeech")
    parser.add_argument("--config_root", type=str, default=None)
    parser.add_argument("--T", type=int, default=1, choices=[1, 2, 4])
    parser.add_argument("--params", type=str, default=None,
                        help="flat a/b/c npz of flax CM params")
    parser.add_argument("--vocoder_ckpt", type=str, default=None,
                        help="flat a/b/c npz of flax HiFi-GAN params")
    parser.add_argument("--pitch_control", type=float, default=1.0)
    parser.add_argument("--energy_control", type=float, default=1.0)
    parser.add_argument("--duration_control", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--out_dir", type=str, default="output/result_torch")
    args = parser.parse_args(argv)

    from cmtts_tpu_torch.audio.wavio import write_wav
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import resolve_device
    from cmtts_tpu_torch.models.cmtts import CMTTS
    from cmtts_tpu_torch.models.hifigan import (
        HiFiGANConfig,
        HiFiGANGenerator,
        unflatten_npz,
    )
    from cmtts_tpu_torch.pipeline import Synthesizer

    device = resolve_device(args.device)
    cfg = load_configs(args.dataset, args.config_root)
    if args.params:
        model = load_flax_params(CMTTS(cfg), unflatten_npz(args.params))
    else:
        warnings.warn("no --params given; using a random-init CMTTS")
        model = random_cmtts(cfg)
    if args.vocoder_ckpt:
        voc_tree = unflatten_npz(args.vocoder_ckpt)
        width = int(voc_tree["conv_pre"]["kernel"].shape[-1])
    else:
        warnings.warn("no --vocoder_ckpt given; using a random-init HiFi-GAN")
        voc_tree, width = None, 512
    vocoder = HiFiGANGenerator(HiFiGANConfig(
        num_mels=cfg.stft.n_mel_channels,
        sampling_rate=cfg.stft.sampling_rate,
        upsample_initial_channel=width))
    if voc_tree is not None:
        load_flax_params(vocoder, voc_tree)

    synth = Synthesizer(cfg, model, vocoder, T=args.T, device=device)
    tokens = preprocess_english(args.text, cfg.data.lexicon_path,
                                list(cfg.data.text_cleaners))
    mel, mel_lens, wav = synth(
        [tokens], seed=args.seed, d_control=args.duration_control,
        p_control=args.pitch_control, e_control=args.energy_control)
    os.makedirs(args.out_dir, exist_ok=True)
    write_wav(os.path.join(args.out_dir, "single.wav"),
              synth.trim_wavs(wav, mel_lens)[0], cfg.stft.sampling_rate)
    np.save(os.path.join(args.out_dir, "single-mel.npy"),
            mel[0, : int(mel_lens[0])])
    print(f"synthesized 1 -> {args.out_dir}")


if __name__ == "__main__":
    main()
