"""Validation losses of a checkpoint (counterpart of ``cli/evaluate.py``).

    python -m cmtts_tpu_torch.cli.evaluate --dataset LJSpeech \\
        [--config_root PATH] [--restore_step 0] [--params_role target_model] \\
        [--max_batches N] [--no_mel_loss] [--path_tag t] [--device cuda]

``evaluate_cm`` runs the conditioning net with teacher forcing and the
variance losses over ``val.txt`` and, unless ``--no_mel_loss``, the
one-step synthesis mel L1 from the same params.  ``--restore_step 0`` (the
default) evaluates the latest committed checkpoint of the port's trainer.
Runs on ``--device`` (``cuda`` by default; raises without CUDA unless given
``--device cpu``).  A val set smaller than one batch is evaluated as one
batch of all of it, where the JAX CLI raises.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Sequence

import numpy as np
import torch


def evaluate_cm(cfg, params: dict, max_batches: int | None = None,
                with_mel: bool = True, seed: int = 42, device=None,
                x_T: Sequence[torch.Tensor] | None = None) -> dict:
    """{"total": mean variance loss, each term, "mel_onestep_l1"} over the
    val batches (``cfg.train.batch_size``, or the whole val set when it is
    smaller; unshuffled, group 1).

    ``params`` is a CMTTS state dict.  The one-step synthesis of batch n
    starts from ``x_T[n]`` when given (the JAX draws, in a parity test),
    else from a generator seeded with ``seed``."""
    from cmtts_tpu_torch.cm.losses import variance_loss
    from cmtts_tpu_torch.core.device import resolve_device
    from cmtts_tpu_torch.data.dataset import FeatureDataset, batch_iterator
    from cmtts_tpu_torch.models.cmtts import CMTTS
    from cmtts_tpu_torch.text import sil_phonemes_ids
    from cmtts_tpu_torch.train.loop import batch_to_device, make_synthesize_step

    device = resolve_device(device)
    model = CMTTS(cfg)
    model.load_state_dict(params, strict=True)
    model = model.to(device).eval()
    weights = {k: v.detach() for k, v in model.named_parameters()}
    sil_ids = tuple(sil_phonemes_ids())
    synth_step = make_synthesize_step(model, cfg) if with_mel else None
    generator = torch.Generator(device=device).manual_seed(seed)

    dataset = FeatureDataset("val.txt", cfg, sort=False, drop_last=False,
                             cache_in_ram=False)  # single pass
    batch_size = min(cfg.train.batch_size, len(dataset))
    totals, all_losses = [], {}
    n = 0
    for host_batch in batch_iterator(dataset, batch_size, group_size=1,
                                     shuffle=False, epochs=1):
        batch = batch_to_device(host_batch, device)
        with torch.no_grad():
            cond_out = model.condition(
                batch["texts"], batch["src_lens"], batch["mels"].shape[1],
                speakers=batch.get("speakers"),
                spker_embeds=batch.get("spker_embeds"),
                mel2ph=batch["mel2ph"], d_targets=batch["d_targets"],
                p_targets=batch["p_targets"], e_targets=batch["e_targets"],
                deterministic=True)
            total, losses = variance_loss(cond_out, batch, cfg, sil_ids)
        totals.append(float(total))
        for k, v in losses.items():
            all_losses.setdefault(k, []).append(float(v))
        if synth_step is not None:
            _, mel_l1 = synth_step(weights, batch, generator,
                                   x_T=None if x_T is None else x_T[n])
            all_losses.setdefault("mel_onestep_l1", []).append(float(mel_l1))
        n += 1
        if max_batches and n >= max_batches:
            break
    summary = {"total": float(np.mean(totals))}
    summary.update({k: float(np.mean(v)) for k, v in all_losses.items()})
    return summary


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--restore_step", type=int, default=0,
                        help="checkpoint step; 0 = the latest committed one")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--config_root", type=str, default=None)
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--no_mel_loss", action="store_true",
                        help="skip the one-step synthesis mel L1 "
                             "(variance losses only)")
    parser.add_argument("--params_role", type=str, default="target_model",
                        help="checkpoint role to evaluate (the one-step "
                             "sampler uses the target network in training)")
    parser.add_argument("--path_tag", type=str, default="",
                        help="checkpoint-dir suffix (matches train_cm "
                             "--path_tag, e.g. a distillation run)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.train.checkpoint import restore_checkpoint

    device = cli_device(args.device)
    cfg = load_configs(args.dataset, args.config_root)
    if args.path_tag:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, ckpt_path=cfg.train.ckpt_path + f"_{args.path_tag}"))
    payload = restore_checkpoint(cfg.train.ckpt_path, args.restore_step or None)
    if args.params_role not in payload:
        raise SystemExit(f"role {args.params_role!r} not in checkpoint "
                         f"(roles: {sorted(payload)})")
    print(f"==> evaluating {args.params_role} of step "
          f"{int(payload['step'])}")
    summary = evaluate_cm(cfg, payload[args.params_role], args.max_batches,
                          with_mel=not args.no_mel_loss, device=device)
    print("validation losses:")
    for k, v in summary.items():
        print(f"  {k}: {v:.5f}")
    return summary


if __name__ == "__main__":
    main()
