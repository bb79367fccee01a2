"""Real-time factor of batch synthesis with the PyTorch port (counterpart
of ``cli/p_rtf_cm.py``).

    python -m cmtts_tpu_torch.cli.p_rtf_cm --dataset LJSpeech \\
        --source <preprocessed>/val.txt [--restore_step 0] [--T 1] \\
        [--batch_size 8] [--vocoder_ckpt gen.npz] [--write_wavs] \\
        [--out rtf_out] [--device cuda]

RTF = synthesis wall time / seconds of audio produced, per batch of the
metadata file after a warm-up call on the first batch: the wall covers the
``Synthesizer`` call, the trim to each utterance's length and, with
``--write_wavs``, the wav writes.  Prints one JSON line (``T``, ``batches``,
``mean_rtf`` = total wall / total audio, ``per_batch_rtf_mean``,
``audio_seconds``) and writes it with the per-batch list to
``<out>/rtf_{mean_rtf:.6f}.json``.  The checkpoint is the port trainer's
``model`` role (``0``: the latest committed step); without
``--vocoder_ckpt`` HiFi-GAN has random weights (with a warning).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--restore_step", type=int, default=0)
    parser.add_argument("--source", type=str, required=True)
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--T", type=int, default=1, choices=[1, 2, 4])
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--config_root", type=str, default=None)
    parser.add_argument("--vocoder_ckpt", type=str, default=None)
    parser.add_argument("--write_wavs", action="store_true")
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from cmtts_tpu_torch.audio.wavio import write_wav
    from cmtts_tpu_torch.cli.synthesize import load_vocoder, restore_cmtts
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.data.dataset import TextMetaDataset
    from cmtts_tpu_torch.pipeline import Synthesizer

    device = cli_device(args.device)
    cfg = load_configs(args.dataset, args.config_root)
    model = restore_cmtts(cfg, args.restore_step, "model")
    vocoder, _ = load_vocoder(cfg, None, args.vocoder_ckpt, device)
    synth = Synthesizer(cfg, model, vocoder, T=args.T, device=device)
    batches = list(TextMetaDataset(args.source, cfg).batches(args.batch_size))

    # warm-up on the first batch.  Synthesizer.__call__ returns numpy
    # arrays: the copy to the host waits for the device, so each timed
    # call below ends when its work on the device has ended
    b0 = batches[0]
    synth(b0["tokens"], speakers=b0["speakers"],
          spker_embeds=b0["spker_embeds"])

    rtf_list = []
    total_audio, total_wall = 0.0, 0.0
    out_dir = args.out or "./rtf_out"
    os.makedirs(out_dir, exist_ok=True)
    sr = cfg.stft.sampling_rate
    for batch in batches:
        t0 = time.perf_counter()
        _, mel_lens, wav = synth(batch["tokens"], speakers=batch["speakers"],
                                 spker_embeds=batch["spker_embeds"])
        wavs = synth.trim_wavs(wav, mel_lens)
        if args.write_wavs:
            for w, basename in zip(wavs, batch["ids"]):
                write_wav(os.path.join(out_dir, f"{basename}.wav"), w, sr)
        elapsed = time.perf_counter() - t0
        audio_sec = sum(len(w) for w in wavs) / sr
        if audio_sec > 0:
            rtf_list.append(elapsed / audio_sec)
            total_audio += audio_sec
            total_wall += elapsed

    mean_rtf = total_wall / max(total_audio, 1e-9)
    result = {
        "T": args.T,
        "batches": len(batches),
        "mean_rtf": mean_rtf,
        "per_batch_rtf_mean": float(np.mean(rtf_list)) if rtf_list else None,
        "audio_seconds": total_audio,
    }
    print(json.dumps(result))
    with open(os.path.join(out_dir, f"rtf_{mean_rtf:.6f}.json"), "w") as f:
        json.dump({"rtf_list": rtf_list, **result}, f)
    return result


if __name__ == "__main__":
    main()
