"""Synthesis with the PyTorch port (counterpart of ``cli/synthesize.py``,
single and long modes).

    python -m cmtts_tpu_torch.cli.synthesize --mode single \\
        --text "Hello world" --T 1 --dataset LJSpeech \\
        [--params cm.npz] [--vocoder_ckpt hifigan.npz] [--device cuda]
    python -m cmtts_tpu_torch.cli.synthesize --mode long --text "..." \\
        [--gap_ms 150] [--speaker_id 0] [--sampler heun --sample_steps 18] \\
        [--vocoder hifigan|griffinlim|none]

``--params`` takes a flat ``a/b/c`` npz of flax CM params, and
``--restore_step N`` a checkpoint of the port's trainer
(``python -m cmtts_tpu_torch.cli.train_cm``) under the config's
``ckpt_path`` (with ``--path_tag`` as in training; ``--params_role`` picks
model, target_model or ema_k), adopting the ``cwt_masked_std`` and
``training_mode`` the run recorded; ``--vocoder_ckpt`` takes a HiFi-GAN
npz.  Without them the CLI warns and uses random weights (with the
duration head biased to ~6 frames per phoneme so that the output has a
realistic length).  Single mode writes
``single.wav`` and ``single-mel.npy`` under ``--out_dir``; long mode splits
the text into sentences, packs them into chunks that fit the model's frame
budget, synthesises all chunks as one batch and writes the spliced
``long.wav`` and one ``long-chunkNN-mel.npy`` a chunk.  ``--vocoder
griffinlim`` inverts the mel without a neural vocoder, ``none`` writes mels
only.  Batch mode needs the dataset module, which is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import re
import warnings
from string import punctuation

import numpy as np

from cmtts_tpu_torch.cm.sampling import SAMPLERS


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


def load_cmtts(cfg, params_path: str | None):
    """CMTTS from a flat npz of flax params, else random (with a warning)."""
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.cmtts import CMTTS
    from cmtts_tpu_torch.models.hifigan import unflatten_npz

    if params_path:
        return load_flax_params(CMTTS(cfg), unflatten_npz(params_path))
    warnings.warn("no --params given; using a random-init CMTTS")
    return random_cmtts(cfg)


def restore_cmtts(cfg, step: int, role: str):
    """(config adopting the run's recorded flags, CMTTS with the ``role``
    params of checkpoint ``step`` under ``cfg.train.ckpt_path``)."""
    import dataclasses

    from cmtts_tpu_torch.models.cmtts import CMTTS
    from cmtts_tpu_torch.train.checkpoint import (
        read_run_config,
        restore_checkpoint,
    )

    run_cfg = read_run_config(cfg.train.ckpt_path)
    if run_cfg.get("cwt_masked_std") and not cfg.pitch.cwt_masked_std:
        print("==> checkpoint was trained with --cwt_masked_std; adopting it")
        cfg = dataclasses.replace(cfg, pitch=dataclasses.replace(
            cfg.pitch, cwt_masked_std=True))
    mode = run_cfg.get("training_mode")
    if mode and mode != cfg.train.cm.training_mode:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, cm=dataclasses.replace(cfg.train.cm,
                                              training_mode=mode)))
    payload = restore_checkpoint(cfg.train.ckpt_path, step)
    if role not in payload:
        raise SystemExit(f"role {role!r} not in checkpoint (roles: "
                         f"{sorted(payload)})")
    model = CMTTS(cfg)
    model.load_state_dict(payload[role], strict=True)
    print(f"==> restored {role} of step {int(payload['step'])} from "
          f"{cfg.train.ckpt_path}")
    return cfg, model


def load_vocoder(cfg, vocoder: str | None, ckpt: str | None, device):
    """(HiFi-GAN generator or None, Griffin-Lim inverter or None) for
    ``--vocoder``: None means HiFi-GAN, random (with a warning) without a
    checkpoint; an explicit ``hifigan`` requires one."""
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.models.hifigan import (
        HiFiGANConfig,
        HiFiGANGenerator,
        unflatten_npz,
    )

    if vocoder == "hifigan" and ckpt is None:
        raise SystemExit("--vocoder hifigan requires --vocoder_ckpt (no "
                         "checkpoint means random-init output); use "
                         "--vocoder griffinlim instead")
    if vocoder == "none":
        return None, None
    if vocoder == "griffinlim":
        from cmtts_tpu_torch.audio.stft import GriffinLim, MelSpectrogram

        st = cfg.stft
        return None, GriffinLim(MelSpectrogram(
            st.sampling_rate, st.filter_length, st.hop_length, st.win_length,
            st.n_mel_channels, st.mel_fmin, st.mel_fmax, device=device))
    if ckpt:
        voc_tree = unflatten_npz(ckpt)
        width = int(voc_tree["conv_pre"]["kernel"].shape[-1])
    else:
        warnings.warn("no --vocoder_ckpt given; using a random-init HiFi-GAN")
        voc_tree, width = None, 512
    gen = HiFiGANGenerator(HiFiGANConfig(
        num_mels=cfg.stft.n_mel_channels,
        sampling_rate=cfg.stft.sampling_rate,
        upsample_initial_channel=width))
    if voc_tree is not None:
        load_flax_params(gen, voc_tree)
    return gen, None


def write_outputs(out_dir: str, names, mel, mel_lens, wav, synth, griffin):
    """``<name>-mel.npy`` for every utterance and ``<name>.wav`` when there
    is a waveform (the vocoder's, or Griffin-Lim's from the trimmed mel)."""
    from cmtts_tpu_torch.audio.wavio import write_wav

    os.makedirs(out_dir, exist_ok=True)
    sr = synth.cfg.stft.sampling_rate
    mels = [mel[i, : int(n)] for i, n in enumerate(mel_lens)]
    wavs = (synth.trim_wavs(wav, mel_lens) if wav is not None
            else [griffin(m) for m in mels] if griffin is not None else None)
    for i, name in enumerate(names):
        np.save(os.path.join(out_dir, f"{name}-mel.npy"), mels[i])
        if wavs is not None:
            write_wav(os.path.join(out_dir, f"{name}.wav"), wavs[i], sr)
    print(f"synthesized {len(names)} -> {out_dir}")


def add_common_args(parser):
    """The flags both synthesis CLIs share."""
    parser.add_argument("--text", type=str, required=True)
    parser.add_argument("--config_root", type=str, default=None)
    parser.add_argument("--T", type=int, default=1, choices=[1, 2, 4])
    parser.add_argument("--params", type=str, default=None,
                        help="flat a/b/c npz of flax CM params")
    parser.add_argument("--vocoder_ckpt", type=str, default=None,
                        help="flat a/b/c npz of flax HiFi-GAN params")
    parser.add_argument("--vocoder", type=str, default=None,
                        choices=["hifigan", "griffinlim", "none"])
    parser.add_argument("--pitch_control", type=float, default=1.0)
    parser.add_argument("--energy_control", type=float, default=1.0)
    parser.add_argument("--duration_control", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", type=str, choices=["single", "long"],
                        required=True)
    parser.add_argument("--dataset", type=str, default="LJSpeech")
    add_common_args(parser)
    parser.add_argument("--gap_ms", type=float, default=150.0,
                        help="long mode: silence between chunks")
    parser.add_argument("--speaker_id", type=int, default=0)
    parser.add_argument("--sampler", type=str, default=None,
                        choices=list(SAMPLERS),
                        help="override the T-derived sampler")
    parser.add_argument("--sample_steps", type=int, default=2,
                        help="sigma-grid size of the ODE samplers "
                             "(euler, heun, dpm, ancestral)")
    parser.add_argument("--restore_step", type=int, default=None,
                        help="synthesize from this checkpoint of the "
                             "port's trainer")
    parser.add_argument("--params_role", type=str, default="model",
                        help="model | target_model | ema_0/1/2")
    parser.add_argument("--path_tag", type=str, default="",
                        help="the trainer's --path_tag")
    parser.add_argument("--out_dir", type=str, default="output/result_torch")
    args = parser.parse_args(argv)
    if args.restore_step is not None and args.params:
        raise SystemExit("--restore_step and --params exclude each other")

    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import resolve_device
    from cmtts_tpu_torch.pipeline import Synthesizer

    device = resolve_device(args.device)
    cfg = load_configs(args.dataset, args.config_root)
    if args.restore_step is not None:
        import dataclasses

        if args.path_tag:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, ckpt_path=f"{cfg.train.ckpt_path}_{args.path_tag}"))
        cfg, model = restore_cmtts(cfg, args.restore_step, args.params_role)
    else:
        model = load_cmtts(cfg, args.params)
    vocoder, griffin = load_vocoder(cfg, args.vocoder, args.vocoder_ckpt,
                                    device)
    synth = Synthesizer(cfg, model, vocoder, T=args.T, sampler=args.sampler,
                        sample_steps=args.sample_steps, device=device)
    controls = dict(d_control=args.duration_control,
                    p_control=args.pitch_control,
                    e_control=args.energy_control)

    def tokenize(text: str) -> np.ndarray:
        return preprocess_english(text, cfg.data.lexicon_path,
                                  list(cfg.data.text_cleaners))

    if args.mode == "single":
        mel, mel_lens, wav = synth(
            [tokenize(args.text)], speakers=np.asarray([args.speaker_id]),
            seed=args.seed, **controls)
        write_outputs(args.out_dir, ["single"], mel, mel_lens, wav, synth,
                      griffin)
        return

    # long: sentences -> chunks that fit the frame budget -> one batched
    # call -> the chunks' waveforms spliced with gap_ms of silence
    from cmtts_tpu_torch.audio.wavio import write_wav
    from cmtts_tpu_torch.pipeline import synthesize_long
    from cmtts_tpu_torch.text import text_to_sequence
    from cmtts_tpu_torch.text.segment import chunk_text

    budget = max(8, int(cfg.model.max_seq_len
                        / (10 * max(args.duration_control, 1e-3))))
    sp_id = text_to_sequence("{sp}", [])[0]
    chunks = chunk_text(args.text, tokenize, budget, sep_token=sp_id)
    if not chunks:
        raise SystemExit("text produced no phonemes")
    print(f"long mode: {len(chunks)} chunk(s), budget {budget} tokens/chunk")
    wav, mels, _ = synthesize_long(synth, chunks, speaker=args.speaker_id,
                                   gap_ms=args.gap_ms, seed=args.seed,
                                   **controls)
    sr = cfg.stft.sampling_rate
    if wav is None and griffin is not None:
        gap = np.zeros(int(sr * args.gap_ms / 1000.0), np.float32)
        pieces = []
        for i, m in enumerate(mels):
            pieces += [griffin(m)] + ([gap] if i < len(mels) - 1 else [])
        wav = np.concatenate(pieces)
    os.makedirs(args.out_dir, exist_ok=True)
    if wav is not None:
        write_wav(os.path.join(args.out_dir, "long.wav"), wav, sr)
        print(f"long.wav: {len(wav) / sr:.1f}s -> {args.out_dir}")
    for i, m in enumerate(mels):
        np.save(os.path.join(args.out_dir, f"long-chunk{i:02d}-mel.npy"), m)


if __name__ == "__main__":
    main()
