"""Synthesis with the PyTorch port (counterpart of ``cli/synthesize.py``,
single, long and batch modes).

    python -m cmtts_tpu_torch.cli.synthesize --mode single \\
        --text "Hello world" --T 1 --dataset LJSpeech \\
        [--params cm.npz|model300000.pt] \\
        [--vocoder_ckpt hifigan.npz|generator_LJSpeech.pth.tar] [--device cuda]
    python -m cmtts_tpu_torch.cli.synthesize --mode long --text "..." \\
        [--gap_ms 150] [--speaker_id 0] [--sampler heun --sample_steps 18] \\
        [--vocoder hifigan|melgan|griffinlim|none]
    python -m cmtts_tpu_torch.cli.synthesize --mode batch \\
        --source <preprocessed>/val.txt [--batch_size 8] --restore_step 0
    python -m cmtts_tpu_torch.cli.synthesize --mode single --lang zh \\
        --text "ni3 hao3 shi4 jie4"

``--params`` takes a flat ``a/b/c`` npz of flax CM params or a reference
``CMTotalTTS`` state dict (``model300000.pt``, converted on load), and
``--restore_step N`` a checkpoint of the port's trainer
(``python -m cmtts_tpu_torch.cli.train_cm``, or a reference checkpoint
converted by ``cli.convert_checkpoint``) under the config's ``ckpt_path``
(``0``: the latest committed one; with ``--path_tag`` as in training;
``--params_role`` picks model, target_model or ema_k).  The graph flags
follow the JAX CLI's precedence: ``--model`` beats the run's recorded
``training_mode``, which beats the config; ``--cwt_masked_std`` or the
run's record turns the masked inverse-CWT standardisation on, and
``--no_cwt_masked_std`` turns it off whatever the rest says.
``--vocoder_ckpt`` takes a HiFi-GAN npz or the reference's ``.pth.tar``
(with ``--vocoder melgan``, a melgan-neurips ``best_netG.pt``).  Without
checkpoints the CLI warns and uses random weights (with the duration head
biased to ~6 frames per phoneme so that the output has a realistic
length).  ``--lang zh`` reads space-separated toned pinyin.  Single mode
writes ``single.wav`` and ``single-mel.npy``; long mode splits the text
into sentences, packs them into chunks that fit the model's frame budget,
synthesises all chunks as one batch and writes the spliced ``long.wav`` and
one ``long-chunkNN-mel.npy`` a chunk.  ``--vocoder griffinlim`` inverts the
mel without a neural vocoder, ``none`` writes mels only.  Batch mode reads
a metadata file (``basename|speaker|{phones}|raw`` lines, as preprocessing
writes ``val.txt``) in batches of ``--batch_size`` and writes
``<basename>.wav`` and ``<basename>-mel.npy`` for each line;
``--save_plots`` adds a ``<basename>.png`` of the mel (matplotlib).
Outputs go to ``--out_dir``; without it, a run from a checkpoint writes to
``<result_path>_cm[_path_tag]/step_{N}_T{T}[_{sampler}{steps}][_{tag}]`` as
the JAX CLI does, any other run to ``output/result_torch[_{tag}]``.
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
    """CMTTS from a flat npz of flax params or a reference torch checkpoint,
    else random (with a warning)."""
    from cmtts_tpu_torch.convert import load_flax_params
    from cmtts_tpu_torch.from_torch import load_torch_cm
    from cmtts_tpu_torch.models.cmtts import CMTTS
    from cmtts_tpu_torch.models.hifigan import unflatten_npz

    if params_path and params_path.endswith(".pt"):
        return load_torch_cm(params_path, cfg)
    if params_path:
        return load_flax_params(CMTTS(cfg), unflatten_npz(params_path))
    warnings.warn("no --params given; using a random-init CMTTS")
    return random_cmtts(cfg)


def adopt_run_flags(cfg, run_cfg: dict, model: str | None = None,
                    cwt_masked_std: bool = False,
                    no_cwt_masked_std: bool = False):
    """The config the checkpoint is synthesized with (the JAX CLI's
    precedence, ``cli/synthesize.py:164-194``): the training mode is
    ``model``, else the run's recorded one, else the config's; the masked
    inverse-CWT standardisation is on with ``cwt_masked_std`` or when the
    run recorded it, and ``no_cwt_masked_std`` turns it off whatever the
    rest says."""
    import dataclasses

    masked = cwt_masked_std
    if not masked and run_cfg.get("cwt_masked_std"):
        print("==> checkpoint was trained with --cwt_masked_std; adopting "
              "it (pass --no_cwt_masked_std to force the padded parity "
              "standardization)")
        masked = True
    if no_cwt_masked_std:
        masked = False
    if masked or no_cwt_masked_std:
        cfg = dataclasses.replace(cfg, pitch=dataclasses.replace(
            cfg.pitch, cwt_masked_std=masked))
    mode = model or run_cfg.get("training_mode") or cfg.train.cm.training_mode
    if mode != cfg.train.cm.training_mode:
        if run_cfg.get("training_mode") not in (None, mode):
            print(f"==> note: checkpoint records training_mode="
                  f"{run_cfg['training_mode']!r}, synthesizing as {mode!r}")
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, cm=dataclasses.replace(cfg.train.cm,
                                              training_mode=mode)))
    return cfg


def restore_cmtts(cfg, step: int, role: str):
    """CMTTS with the ``role`` params of checkpoint ``step`` under
    ``cfg.train.ckpt_path`` (step 0 is the latest committed one)."""
    from cmtts_tpu_torch.models.cmtts import CMTTS
    from cmtts_tpu_torch.train.checkpoint import restore_checkpoint

    payload = restore_checkpoint(cfg.train.ckpt_path, step or None)
    if role not in payload:
        raise SystemExit(f"role {role!r} not in checkpoint (roles: "
                         f"{sorted(payload)})")
    model = CMTTS(cfg)
    model.load_state_dict(payload[role], strict=True)
    print(f"==> restored {role} of step {int(payload['step'])} from "
          f"{cfg.train.ckpt_path}")
    return model


def load_vocoder(cfg, vocoder: str | None, ckpt: str | None, device):
    """(neural vocoder or None, Griffin-Lim inverter or None) for
    ``--vocoder``.  None means the config's vocoder: HiFi-GAN, random (with
    a warning) without a checkpoint, or MelGAN; an explicit ``hifigan`` or
    ``melgan`` requires a checkpoint, in any format its loader reads."""
    from cmtts_tpu_torch.models.hifigan import load_hifigan
    from cmtts_tpu_torch.models.melgan import MelGANConfig, load_melgan

    if vocoder is None and cfg.model.vocoder_model in ("MelGAN", "melgan"):
        vocoder = "melgan"
    if vocoder in ("hifigan", "melgan") and ckpt is None:
        raise SystemExit(f"--vocoder {vocoder} requires --vocoder_ckpt (no "
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
    if vocoder == "melgan":
        return load_melgan(ckpt, MelGANConfig(
            num_mels=cfg.stft.n_mel_channels)), None
    return load_hifigan(ckpt, cfg), None


def write_outputs(out_dir: str, names, mel, mel_lens, wav, synth, griffin,
                  plots: bool = False):
    """``<name>-mel.npy`` for every utterance, ``<name>.wav`` when there is
    a waveform (the vocoder's, or Griffin-Lim's from the trimmed mel) and,
    with ``plots``, ``<name>.png`` of the mel."""
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
        if plots:
            from cmtts_tpu_torch.utils_plot import plot_mel

            plot_mel(mels[i], os.path.join(out_dir, f"{name}.png"),
                     title=name)
    print(f"synthesized {len(names)} -> {out_dir}")


def token_budget(cfg, d_control: float = 1.0) -> int:
    """Phonemes one utterance may hold (the mel bucket's estimate of 10
    frames a phoneme within max_seq_len); longer text is chunked."""
    return max(8, int(cfg.model.max_seq_len / (10 * max(d_control, 1e-3))))


def tokenizer(cfg, lang: str = "en", lexicon_path: str | None = None):
    """text -> token ids: English through the lexicon (``lexicon_path``,
    else the config's) and G2P, Mandarin (``zh``) from space-separated
    toned pinyin."""
    if lang == "zh":
        from cmtts_tpu_torch.text import text_to_sequence
        from cmtts_tpu_torch.text.pinyin import preprocess_mandarin

        def tokenize(text: str) -> np.ndarray:
            phones = preprocess_mandarin(text)
            print(f"Phoneme sequence: {phones}")
            return np.asarray(text_to_sequence(phones, []), dtype=np.int32)
        return tokenize

    def tokenize(text: str) -> np.ndarray:
        return preprocess_english(text, lexicon_path or cfg.data.lexicon_path,
                                  list(cfg.data.text_cleaners))
    return tokenize


def add_common_args(parser, text_required: bool = True):
    """The flags both synthesis CLIs share."""
    parser.add_argument("--text", type=str, required=text_required)
    parser.add_argument("--config_root", type=str, default=None)
    parser.add_argument("--T", type=int, default=1, choices=[1, 2, 4])
    parser.add_argument("--params", type=str, default=None,
                        help="flat a/b/c npz of flax CM params, or a "
                             "reference CMTotalTTS state dict (.pt)")
    parser.add_argument("--restore_step", type=int, default=None,
                        help="synthesize from this checkpoint of the "
                             "port's trainer (0: the latest committed one)")
    parser.add_argument("--vocoder_ckpt", type=str, default=None,
                        help="HiFi-GAN: flat npz of flax params or the "
                             "reference .pth.tar / .pt; MelGAN: a local "
                             "melgan-neurips .pt or npz")
    parser.add_argument("--vocoder", type=str, default=None,
                        choices=["hifigan", "melgan", "griffinlim", "none"])
    parser.add_argument("--pitch_control", type=float, default=1.0)
    parser.add_argument("--energy_control", type=float, default=1.0)
    parser.add_argument("--duration_control", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--mode", type=str,
                        choices=["single", "long", "batch"], required=True)
    parser.add_argument("--dataset", type=str, default="LJSpeech")
    add_common_args(parser, text_required=False)
    parser.add_argument("--lang", type=str, default="en", choices=["en", "zh"],
                        help="text language of single and long mode: zh "
                             "takes space-separated toned pinyin")
    parser.add_argument("--source", type=str, default=None,
                        help="batch mode: metadata file to synthesize")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--gap_ms", type=float, default=150.0,
                        help="long mode: silence between chunks")
    parser.add_argument("--speaker_id", type=int, default=0)
    parser.add_argument("--model", type=str, default=None,
                        choices=["consistency_training",
                                 "consistency_distillation", "progdist",
                                 "edm"],
                        help="training mode of the checkpoint (edm: plain "
                             "EDM scalings); default the run's record, "
                             "else the config")
    parser.add_argument("--sampler", type=str, default=None,
                        choices=list(SAMPLERS),
                        help="override the T-derived sampler")
    parser.add_argument("--sample_steps", type=int, default=2,
                        help="sigma-grid size of the ODE samplers "
                             "(euler, heun, dpm, ancestral)")
    parser.add_argument("--params_role", type=str, default="model",
                        help="model | target_model | ema_0/1/2")
    parser.add_argument("--path_tag", type=str, default="",
                        help="the trainer's --path_tag")
    parser.add_argument("--tag", type=str, default="",
                        help="suffix of the result dir only (..._<tag>), "
                             "for A/B runs of one checkpoint")
    parser.add_argument("--cwt_masked_std", action="store_true",
                        help="padding-invariant inverse-CWT f0 (adopted "
                             "when the checkpoint was trained with it)")
    parser.add_argument("--no_cwt_masked_std", action="store_true",
                        help="force the padded parity standardization")
    parser.add_argument("--save_plots", action="store_true",
                        help="write a mel png per utterance (matplotlib)")
    parser.add_argument("--out_dir", type=str, default=None)
    args = parser.parse_args(argv)
    if args.restore_step is not None and args.params:
        raise SystemExit("--restore_step and --params exclude each other")
    if args.mode == "batch" and not args.source:
        raise SystemExit("--mode batch needs --source")
    if args.mode != "batch" and args.text is None:
        raise SystemExit(f"--mode {args.mode} needs --text")
    if args.save_plots:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit("--save_plots needs matplotlib, which is not "
                             "installed") from None

    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.pipeline import Synthesizer
    from cmtts_tpu_torch.train.checkpoint import read_run_config

    device = cli_device(args.device)
    cfg = load_configs(args.dataset, args.config_root)
    path_tag = f"_{args.path_tag}" if args.path_tag else ""
    if path_tag:
        import dataclasses

        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, ckpt_path=cfg.train.ckpt_path + path_tag))
    from_ckpt = args.restore_step is not None
    cfg = adopt_run_flags(
        cfg, read_run_config(cfg.train.ckpt_path) if from_ckpt else {},
        args.model, args.cwt_masked_std, args.no_cwt_masked_std)
    tag = f"_{args.tag}" if args.tag else ""
    if from_ckpt:
        model = restore_cmtts(cfg, args.restore_step, args.params_role)
        out_dir = args.out_dir or os.path.join(
            cfg.train.result_path + "_cm" + path_tag,
            f"step_{args.restore_step}_T{args.T}"
            + (f"_{args.sampler}{args.sample_steps}" if args.sampler in
               ("heun", "euler", "dpm", "ancestral") else "") + tag)
    else:
        model = load_cmtts(cfg, args.params)
        out_dir = args.out_dir or "output/result_torch" + tag
    vocoder, griffin = load_vocoder(cfg, args.vocoder, args.vocoder_ckpt,
                                    device)
    synth = Synthesizer(cfg, model, vocoder, T=args.T, sampler=args.sampler,
                        sample_steps=args.sample_steps, device=device)
    controls = dict(d_control=args.duration_control,
                    p_control=args.pitch_control,
                    e_control=args.energy_control)
    tokenize = tokenizer(cfg, args.lang)

    if args.mode == "single":
        mel, mel_lens, wav = synth(
            [tokenize(args.text)], speakers=np.asarray([args.speaker_id]),
            seed=args.seed, **controls)
        write_outputs(out_dir, ["single"], mel, mel_lens, wav, synth,
                      griffin, args.save_plots)
        return out_dir
    if args.mode == "batch":
        from cmtts_tpu_torch.data.dataset import TextMetaDataset

        dataset = TextMetaDataset(args.source, cfg)
        for batch in dataset.batches(args.batch_size):
            mel, mel_lens, wav = synth(
                batch["tokens"], speakers=batch["speakers"],
                spker_embeds=batch["spker_embeds"], seed=args.seed,
                **controls)
            write_outputs(out_dir, batch["ids"], mel, mel_lens, wav, synth,
                          griffin, args.save_plots)
        return out_dir

    # long: sentences -> chunks that fit the frame budget -> one batched
    # call -> the chunks' waveforms spliced with gap_ms of silence
    from cmtts_tpu_torch.audio.wavio import write_wav
    from cmtts_tpu_torch.pipeline import synthesize_long
    from cmtts_tpu_torch.text import text_to_sequence
    from cmtts_tpu_torch.text.segment import chunk_text

    budget = token_budget(cfg, args.duration_control)
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
    os.makedirs(out_dir, exist_ok=True)
    if wav is not None:
        write_wav(os.path.join(out_dir, "long.wav"), wav, sr)
        print(f"long.wav: {len(wav) / sr:.1f}s -> {out_dir}")
    for i, m in enumerate(mels):
        np.save(os.path.join(out_dir, f"long-chunk{i:02d}-mel.npy"), m)
    return out_dir


if __name__ == "__main__":
    main()
