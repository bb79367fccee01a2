"""Consistency-model training with the PyTorch port (counterpart of
``cli/train_cm.py``).

    python -m cmtts_tpu_torch.cli.train_cm --model consistency_training \\
        --dataset LJSpeech [--config_root PATH] [--restore_step -1] \\
        [--total_step N] [--bf16] [--device cuda]
    python -m cmtts_tpu_torch.cli.train_cm --model consistency_distillation \\
        --teacher_path <ckpt>/CMDenoiserTTS/step_00010000 --dataset LJSpeech

It reads the preprocessed feature corpus named by the config, draws
length-sorted bucketed batches, and takes RAdam steps with the configured
timestep sampler (the loss-second-moment sampler learns from each step's
per-sample losses), three EMAs and the target EMA.  Every ``log_step`` it
logs the step's metrics and a one-step synthesis from the target params
(``progress.csv`` under ``<log_path>_cm[_tag]/train``); every ``save_step``
and at the end it saves a checkpoint under ``<ckpt_path>[_tag]``.
``--restore_step -1`` resumes from the latest complete checkpoint (the
data feed and the draws restart from the seed); a resume refuses a run
recorded with other graph-affecting flags.  With ``DIFFUSION_TRAINING_TEST``
set it stops after the first save.

A distillation teacher is a step directory of this port's checkpoints
(``--teacher_role`` picks model, target_model or ema_k) or a flat ``a/b/c``
npz of flax params; the student starts from a copy of it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import torch


def _replace_cm(cfg, **kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, cm=dataclasses.replace(cfg.train.cm, **kw)))


def load_teacher(path: str, role: str, model, device):
    """(teacher params, trained as edm or None) from a step directory of
    this port's checkpoints or a flat npz of flax params."""
    from cmtts_tpu_torch.convert import flax_to_state_dict
    from cmtts_tpu_torch.models.hifigan import unflatten_npz
    from cmtts_tpu_torch.train.checkpoint import load_step_dir

    if path.endswith(".npz"):
        params = flax_to_state_dict(unflatten_npz(path), model)
        return {k: v.to(device) for k, v in params.items()}, None
    payload = load_step_dir(path)
    if role not in payload:
        raise SystemExit(f"role {role!r} not in {path} (roles: "
                         f"{sorted(payload)})")
    is_edm = None
    rc_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                           "run_config.json")
    if os.path.isfile(rc_path):
        with open(rc_path) as f:
            is_edm = json.load(f).get("training_mode") == "edm"
    return {k: v.to(device) for k, v in payload[role].items()}, is_edm


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True,
                        choices=["consistency_training",
                                 "consistency_distillation", "progdist",
                                 "edm"])
    parser.add_argument("--teacher_path", type=str, default=None,
                        help="distillation teacher: a checkpoint step "
                             "directory of this port or a flat npz of flax "
                             "params")
    parser.add_argument("--teacher_role", type=str, default="model",
                        help="model | target_model | ema_0/1/2")
    parser.add_argument("--teacher_edm", action="store_true", default=None,
                        help="drive the teacher with plain EDM scalings "
                             "(an edm-trained teacher; auto-detected from "
                             "its run_config.json)")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--weight_schedule", type=str, default=None,
                        choices=["uniform", "snr", "snr+1", "karras",
                                 "truncated-snr"])
    parser.add_argument("--p_mean", type=float, default=-1.2,
                        help="edm mode: lognormal sigma mean")
    parser.add_argument("--p_std", type=float, default=1.2,
                        help="edm mode: lognormal sigma std")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--restore_step", type=int, default=0,
                        help="checkpoint step to resume from; -1 resumes "
                             "from the latest complete one (fresh start "
                             "if there is none)")
    parser.add_argument("--path_tag", type=str, default="")
    parser.add_argument("--config_root", type=str, default=None)
    parser.add_argument("--total_step", type=int, default=None)
    parser.add_argument("--log_every", type=int, default=None)
    parser.add_argument("--bf16", action="store_true",
                        help="forward in bfloat16 (float32 master params, "
                             "optimizer and EMAs)")
    parser.add_argument("--schedule_sampler", type=str, default=None,
                        choices=["uniform", "linear12", "linear21",
                                 "loss-second-moment"])
    parser.add_argument("--cwt_masked_std", action="store_true",
                        help="padding-invariant inverse-CWT f0; use the "
                             "same flag at synthesis")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from cmtts_tpu_torch.cm.karras import schedule_from_config
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import resolve_device
    from cmtts_tpu_torch.data.dataset import (
        FeatureDataset,
        batch_iterator,
        prefetch_iterator,
    )
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from cmtts_tpu_torch.train import kvlogger
    from cmtts_tpu_torch.train.checkpoint import (
        check_run_config,
        latest_complete_step,
        restore_checkpoint,
        sampler_state_from_payload,
        save_checkpoint,
        state_from_payload,
        write_run_config,
    )
    from cmtts_tpu_torch.train.ema import create_ema_and_scales_fn
    from cmtts_tpu_torch.train.loop import (
        batch_to_device,
        make_synthesize_step,
        make_train_step,
    )
    from cmtts_tpu_torch.train.resample import create_schedule_sampler
    from cmtts_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    device = resolve_device(args.device)
    cfg = load_configs(args.dataset, args.config_root)
    if args.cwt_masked_std:
        cfg = dataclasses.replace(cfg, pitch=dataclasses.replace(
            cfg.pitch, cwt_masked_std=True))
    overrides = {"training_mode": args.model,
                 "schedule_sampler": args.schedule_sampler,
                 "weight_schedule": args.weight_schedule, "seed": args.seed}
    cfg = _replace_cm(cfg, **{k: v for k, v in overrides.items()
                              if v is not None})
    cm = cfg.train.cm
    total_step = args.total_step or cfg.train.total_step
    log_step = args.log_every or cfg.train.log_step
    save_step = cfg.train.save_step
    tag = f"_{args.path_tag}" if args.path_tag else ""
    if tag:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, ckpt_path=cfg.train.ckpt_path + tag))
    ckpt = cfg.train.ckpt_path
    logger = kvlogger.configure(os.path.join(cfg.train.log_path + "_cm" + tag,
                                             "train"))

    step0 = args.restore_step
    if step0 < 0:
        step0 = latest_complete_step(ckpt)
        print(f"==> auto-resume: "
              f"{f'step {step0}' if step0 else 'no checkpoint, fresh start'}")
    run_config = {"training_mode": args.model,
                  "cwt_masked_std": bool(cfg.pitch.cwt_masked_std),
                  "schedule_sampler": cm.schedule_sampler,
                  "weight_schedule": cm.weight_schedule, "seed": cm.seed,
                  "dataset": args.dataset}
    if step0 > 0:
        # the recorded flags are checked before the sidecar is rewritten
        check_run_config(ckpt, run_config)
    write_run_config(ckpt, run_config)

    print(f"==> CM-TTS training (PyTorch port): {args.model} on "
          f"{args.dataset}, device {device}")
    dataset = FeatureDataset("train.txt", cfg, sort=True, drop_last=True)
    print(f"==> dataset: {len(dataset)} utterances")

    model = init_like_flax(CMTTS(cfg),
                           torch.Generator().manual_seed(cm.seed)).to(device)
    ema_scale_fn = create_ema_and_scales_fn(
        cm.target_ema_mode, cm.start_ema, cm.scale_mode, cm.start_scales,
        cm.end_scales, cm.total_training_steps, cm.distill_steps_per_iter)

    def make_sampler(num_scales: int):
        # progdist samples indices in [0, N), the CM grid in [0, N - 1);
        # edm draws continuous sigmas in the step and bypasses the sampler
        n = num_scales + (1 if args.model == "progdist" else 0)
        return create_schedule_sampler(
            "uniform" if args.model == "edm" else cm.schedule_sampler, n)

    sampler = make_sampler(cm.start_scales)
    opt = make_optimizer(cm.lr, cm.weight_decay)
    n_ema = len(cm.ema_rate)
    restored = restored_sampler = None
    if step0 > 0:
        payload = restore_checkpoint(ckpt, step0)
        state = restored = state_from_payload(payload, n_ema, device)
        restored_sampler = sampler_state_from_payload(payload)
        if restored_sampler is not None and hasattr(sampler,
                                                    "load_state_dict"):
            sampler.load_state_dict({k: v.copy()
                                     for k, v in restored_sampler.items()})
        print(f"==> restored step {step0}")
    else:
        state = create_train_state(
            {k: v.detach() for k, v in model.named_parameters()}, opt, n_ema)
        n_params = sum(v.numel() for v in state.params.values())
        print(f"==> params: {n_params / 1e6:.1f}M")

    teacher_params = teacher_sched = None
    if args.model in ("consistency_distillation", "progdist"):
        tp = args.teacher_path or cm.teacher_model_path
        if not tp:
            raise SystemExit(f"{args.model} needs --teacher_path (or "
                             "cm.teacher_model_path in train.yaml)")
        teacher_params, detected = load_teacher(tp, args.teacher_role, model,
                                                device)
        teacher_is_edm = bool(args.teacher_edm if args.teacher_edm
                              is not None else detected)
        print(f"==> loaded teacher from {tp} "
              f"({'edm' if teacher_is_edm else 'boundary'} scalings)")
        if teacher_is_edm:
            teacher_sched = dataclasses.replace(schedule_from_config(cfg),
                                                distillation=False)
        if step0 == 0:
            # the student starts from a copy of the teacher
            state = create_train_state(teacher_params, opt, n_ema)

    compute_dtype = torch.bfloat16 if args.bf16 else None

    def build_step(num_scales: int):
        return make_train_step(model, cfg, opt, num_scales,
                               teacher_params=teacher_params,
                               compute_dtype=compute_dtype,
                               teacher_sched=teacher_sched,
                               edm_p_mean=args.p_mean, edm_p_std=args.p_std)

    _, num_scales = ema_scale_fn(step0)
    train_step = build_step(num_scales)
    synth_step = make_synthesize_step(model, cfg)
    generator = torch.Generator(device=device).manual_seed(cm.seed)
    feed = prefetch_iterator(lambda: batch_iterator(
        dataset, cfg.train.batch_size, cfg.train.group_size, seed=cm.seed))

    result = {"start_step": step0, "restored": restored,
              "restored_sampler": restored_sampler, "losses": []}
    step = step0 + 1
    t_last, steps_since_log = time.perf_counter(), 0
    with contextlib.closing(feed):
        for host_batch in feed:
            target_ema, new_scales = ema_scale_fn(step)
            if new_scales != num_scales:
                num_scales = new_scales
                train_step = build_step(num_scales)
                sampler = make_sampler(num_scales)
            batch = batch_to_device(host_batch, device)
            state, metrics = train_step(state, batch, sampler.probs(),
                                        target_ema, generator)
            if sampler.needs_update:
                sampler.update(metrics["indices"].cpu().numpy(),
                               metrics["loss_per_sample"].cpu().numpy())
            result["losses"].append(float(metrics["loss"]))
            steps_since_log += 1

            if step % log_step == 0:
                _, mel_loss = synth_step(state.target_params, batch,
                                         generator)
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                logger.logkv("step", step)
                logger.logkv("mel_loss_onestep", float(mel_loss))
                logger.logkv("steps_per_sec", steps_since_log / dt)
                steps_since_log = 0
                for k, v in metrics.items():
                    if v.ndim == 0:
                        logger.logkv(k, float(v))
                logger.dumpkvs()

            if step % save_step == 0 or step >= total_step:
                path = save_checkpoint(
                    ckpt, state, sampler.state_dict()
                    if hasattr(sampler, "state_dict") else None)
                print(f"==> saved {path}")
                if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                    print("==> DIFFUSION_TRAINING_TEST set; stopping after "
                          "first save")
                    break
            if step >= total_step:
                print("==> training complete")
                break
            step += 1
    logger.close()
    result.update(state=state, sampler=sampler)
    return result


if __name__ == "__main__":
    main()
