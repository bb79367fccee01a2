"""Consistency-model training with the PyTorch port (counterpart of
``cli/train_cm.py``).

    python -m cmtts_tpu_torch.cli.train_cm --model consistency_training \\
        --dataset LJSpeech [--config_root PATH] [--restore_step -1] \\
        [--total_step N] [--bf16] [--device cuda]
    python -m cmtts_tpu_torch.cli.train_cm --model consistency_distillation \\
        --teacher_path <ckpt>/CMDenoiserTTS/step_00010000 --dataset LJSpeech
    torchrun --nproc_per_node N -m cmtts_tpu_torch.cli.train_cm \\
        --model consistency_training --dataset LJSpeech [--tp T]

It reads the preprocessed feature corpus named by the config, draws
length-sorted bucketed batches, and takes RAdam steps with the configured
timestep sampler (the loss-second-moment sampler learns from each step's
per-sample losses), three EMAs and the target EMA.  Every ``log_step`` it
logs the step's metrics, a one-step synthesis from the target params,
``feed_empty_frac`` and ``feed_full_frac`` (``progress.csv`` under
``<log_path>_cm[_tag]/train``): of the window's batch pulls, the share
that found the prefetch queue empty, and the number of batches whose put
found it full, per pull, from the ``feed.pulls``, ``feed.empty_pulls``
and ``feed.full_puts`` counters of :mod:`cmtts_tpu_torch.core.trace`
(empty near 1: the steps wait on the feed; full near 1: the feed waits on
the steps); every ``save_step`` and at the end it saves a checkpoint
under ``<ckpt_path>[_tag]``.
``--restore_step -1`` resumes from the latest complete checkpoint (the
data feed and the draws restart from the seed); a resume refuses a run
recorded with other graph-affecting flags.  With ``DIFFUSION_TRAINING_TEST``
set it stops after the first save.

A distillation teacher is a step directory of this port's checkpoints
(``--teacher_role`` picks model, target_model or ema_k), a flat ``a/b/c``
npz of flax params or a reference ``CMTotalTTS`` state dict (``.pt``,
converted on load); the student starts from a copy of it.

Under ``torchrun`` every rank runs the same seeded feed, pads each batch
to the data-parallel degree (world / ``--tp``) and takes its own rows; the
step computes the one-device step over the global batch
(:mod:`cmtts_tpu_torch.parallel.distributed`), the LSM sampler learns from
the gathered rows with the padded ones dropped, and ``--tp`` splits the
denoiser's blocks.  Rank 0 logs and saves (the whole state, gathered from
its shards, so that a checkpoint resumes at any tp); the others wait.
``--steps_per_call K`` takes K steps on one set of sampler probabilities
and hands the LSM history the K steps at once (K is 1 under a
progressive ``scale_mode``).  ``--profile_dir`` traces steps 2K+1 .. 7K
with ``torch.profiler`` into ``trace_rank<r>.json``, every thread with the
port's ``cmtts.*`` spans (the step's draw, forward, cast, backward and
update; the feed's ``feed.collate`` on its producer thread).  With
``tensorboard`` in ``CMTTS_LOG_FORMAT`` each ``synth_step`` also logs the
mel, f0, CWT and energy figures and a Griffin-Lim rendering of the
one-step mel.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist


def _replace_cm(cfg, **kw):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, cm=dataclasses.replace(cfg.train.cm, **kw)))


def load_teacher(path: str, role: str, model, device):
    """(teacher params, trained as edm or None) from a step directory of
    this port's checkpoints, a flat npz of flax params or a reference
    torch checkpoint (no edm detection for the last two, as in JAX)."""
    from cmtts_tpu_torch.convert import flax_to_state_dict
    from cmtts_tpu_torch.from_torch import load_torch_cm_checkpoint
    from cmtts_tpu_torch.models.hifigan import unflatten_npz
    from cmtts_tpu_torch.train.checkpoint import load_step_dir

    if path.endswith((".npz", ".pt")):
        tree = (unflatten_npz(path) if path.endswith(".npz")
                else load_torch_cm_checkpoint(path, model.cfg))
        params = flax_to_state_dict(tree, model)
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
                             "directory of this port, a flat npz of flax "
                             "params or a reference .pt")
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
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree: split the denoiser's "
                             "blocks over T ranks; world / T is the "
                             "data-parallel degree")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="K steps on one set of sampler probabilities; "
                             "the LSM history takes the K steps at once")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="trace steps 2K+1 .. 7K with torch.profiler "
                             "into <dir>/trace_rank<r>.json")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from cmtts_tpu_torch.cm.karras import schedule_from_config
    from cmtts_tpu_torch.core.config import load_configs
    from cmtts_tpu_torch.core.device import cli_device
    from cmtts_tpu_torch.core.trace import counters
    from cmtts_tpu_torch.data.dataset import (
        FeatureDataset,
        batch_iterator,
        prefetch_iterator,
    )
    from cmtts_tpu_torch.models.cmtts import CMTTS, init_like_flax
    from cmtts_tpu_torch.parallel.distributed import (
        broadcast_params,
        broadcast_state,
        gather_per_sample,
        init_distributed,
        make_mesh,
        pad_batch_to_multiple,
        rank_rows,
        tp_gather_state,
        tp_shard_params,
        tp_shard_state,
    )
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

    own_group = "RANK" in os.environ and not dist.is_initialized()
    rank, world, device = init_distributed(cli_device(args.device))
    mesh = make_mesh(args.tp)
    lead = rank == 0
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
    logger = (kvlogger.configure(os.path.join(cfg.train.log_path + "_cm" + tag,
                                              "train")) if lead else None)
    if logger is not None and logger.has_tb:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise SystemExit("the TensorBoard figures need matplotlib, which "
                             f"is not importable here ({e}); drop "
                             "tensorboard from CMTTS_LOG_FORMAT") from e

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
    if world > 1:
        dist.barrier()
    if lead:
        write_run_config(ckpt, run_config)

    print(f"==> CM-TTS training (PyTorch port): {args.model} on "
          f"{args.dataset}, device {device}, rank {rank} of {world} "
          f"(dp {mesh.dp} x tp {mesh.tp})")
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

    if world > 1:
        # every rank starts from rank 0's state (and teacher)
        broadcast_state(state)
        if teacher_params is not None:
            broadcast_params(teacher_params)
    if mesh.tp > 1:
        state = tp_shard_state(state, mesh.tp_rank, mesh.tp)
        if teacher_params is not None:
            teacher_params = tp_shard_params(teacher_params, mesh.tp_rank,
                                             mesh.tp)

    compute_dtype = torch.bfloat16 if args.bf16 else None
    K = max(1, args.steps_per_call)
    if K > 1 and cm.scale_mode != "fixed":
        print("==> steps_per_call forced to 1: a progressive scale_mode "
              "changes num_scales within a call")
        K = 1

    def build_step(num_scales: int):
        return make_train_step(model, cfg, opt, num_scales,
                               teacher_params=teacher_params,
                               compute_dtype=compute_dtype,
                               teacher_sched=teacher_sched,
                               edm_p_mean=args.p_mean, edm_p_std=args.p_std,
                               dp_group=mesh.data, tp_group=mesh.model)

    _, num_scales = ema_scale_fn(step0)
    train_step = build_step(num_scales)
    synth_step = make_synthesize_step(model, cfg, with_viz=True,
                                      dp_group=mesh.data)
    generator = torch.Generator(device=device).manual_seed(cm.seed)

    def rank_feed():
        # every rank draws the same global batches and keeps its rows;
        # padded duplicates carry sample_valid 0
        for b in batch_iterator(dataset, cfg.train.batch_size,
                                cfg.train.group_size, seed=cm.seed):
            if mesh.dp > 1:
                b, _ = pad_batch_to_multiple(
                    {k: v for k, v in b.items()
                     if k not in ("ids", "raw_texts")}, mesh.dp)
                b = rank_rows(b, mesh.dp_rank, mesh.dp)
            yield b

    feed = prefetch_iterator(rank_feed)
    result = {"start_step": step0, "restored": restored,
              "restored_sampler": restored_sampler, "losses": []}
    step = step0 + 1      # the first step of the coming call

    def feed_pulls():
        c = counters()
        return tuple(c.get(k, 0) for k in ("feed.pulls", "feed.empty_pulls",
                                           "feed.full_puts"))

    t_last, steps_since_log = time.perf_counter(), 0
    pulls_last = feed_pulls()
    prof, gl = None, None

    def stop_profiler(why: str):
        nonlocal prof
        if prof is not None:
            prof.stop()
            path = os.path.join(args.profile_dir, f"trace_rank{rank}.json")
            prof.export_chrome_trace(path)
            print(f"==> profiler trace written to {path} ({why})")
            prof = None
            args.profile_dir = None

    with contextlib.closing(feed):
        while True:
            window = [next(feed) for _ in range(K)]
            last_step = step + K - 1
            new_scales = ema_scale_fn(step)[1]
            if new_scales != num_scales:      # only reachable at K == 1
                num_scales = new_scales
                train_step = build_step(num_scales)
                sampler = make_sampler(num_scales)
            if args.profile_dir:
                if prof is None and step >= step0 + 1 + 2 * K:
                    from torch.profiler import (
                        ProfilerActivity,
                        _ExperimentalConfig,
                        profile,
                    )

                    os.makedirs(args.profile_dir, exist_ok=True)
                    prof = profile(activities=[ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if device.type == "cuda"
                        else []), experimental_config=_ExperimentalConfig(
                            profile_all_threads=True))
                    prof.start()
                elif prof is not None and step >= step0 + 1 + 7 * K:
                    stop_profiler(f"steps {step0 + 1 + 2 * K}-{step - 1}")

            probs = sampler.probs()
            steps = []
            for i, host_batch in enumerate(window):
                batch = batch_to_device(host_batch, device)
                state, metrics = train_step(state, batch, probs,
                                            ema_scale_fn(step + i)[0],
                                            generator)
                steps.append((batch, metrics))
                result["losses"].append(float(metrics["loss"]))
            if sampler.needs_update:
                # the global batch's rows, padded duplicates dropped; the
                # K steps' at once
                idx, lps = [], []
                for batch, m in steps:
                    i_ = gather_per_sample(m["indices"], mesh.data)
                    l_ = gather_per_sample(m["loss_per_sample"], mesh.data)
                    if "sample_valid" in batch:
                        keep = gather_per_sample(batch["sample_valid"],
                                                 mesh.data) > 0
                        i_, l_ = i_[keep], l_[keep]
                    idx.append(i_)
                    lps.append(l_)
                sampler.update(np.concatenate(idx), np.concatenate(lps))
            steps_since_log += K

            if last_step // log_step > (step - 1) // log_step:
                batch = steps[-1][0]
                mel, mel_loss, viz = synth_step(state.target_params, batch,
                                                generator)
                if logger is not None:
                    if logger.has_tb and last_step // cfg.train.synth_step \
                            > (step - 1) // cfg.train.synth_step:
                        gl = log_figures(logger, cfg, batch, mel, viz,
                                         last_step, gl, device)
                    dt = time.perf_counter() - t_last
                    logger.logkv("step", last_step)
                    logger.logkv("mel_loss_onestep", float(mel_loss))
                    logger.logkv("steps_per_sec", steps_since_log / dt)
                    pulls, empty, full = feed_pulls()
                    n = max(pulls - pulls_last[0], 1)
                    logger.logkv("feed_empty_frac",
                                 (empty - pulls_last[1]) / n)
                    logger.logkv("feed_full_frac", (full - pulls_last[2]) / n)
                    for k, v in steps[-1][1].items():
                        if v.ndim == 0:
                            logger.logkv(k, np.mean([float(m[k])
                                                     for _, m in steps]))
                    logger.dumpkvs()
                t_last, steps_since_log = time.perf_counter(), 0
                pulls_last = feed_pulls()

            done = last_step >= total_step
            if last_step // save_step > (step - 1) // save_step or done:
                whole = tp_gather_state(state, mesh.model)
                if lead:
                    path = save_checkpoint(
                        ckpt, whole, sampler.state_dict()
                        if hasattr(sampler, "state_dict") else None)
                    print(f"==> saved {path}")
                if world > 1:
                    dist.barrier()
                if os.environ.get("DIFFUSION_TRAINING_TEST", ""):
                    print("==> DIFFUSION_TRAINING_TEST set; stopping after "
                          "first save")
                    break
            if done:
                print("==> training complete")
                break
            step = last_step + 1
    stop_profiler("training ended")
    if logger is not None:
        logger.close()
    result.update(state=tp_gather_state(state, mesh.model), sampler=sampler)
    if own_group:
        dist.destroy_process_group()
    return result


def log_figures(logger, cfg, batch, mel, viz, step: int, gl, device):
    """The mel, f0, CWT and energy figures of the batch's first row and a
    Griffin-Lim rendering of its one-step mel (the reference's
    synth_one_sample_diff, utils/tools.py:294-345); -> the Griffin-Lim
    instance, built once."""
    from cmtts_tpu_torch.audio.stft import GriffinLim, MelSpectrogram
    from cmtts_tpu_torch.utils_plot import (
        contour_comparison_figure,
        mel_comparison_figure,
    )

    L = int(batch["mel_lens"][0])
    row = {k: v[0, :L].float().cpu().numpy() for k, v in viz.items()}
    syn = mel[0, :L].float().cpu().numpy()
    logger.log_figure("synth/mel_comparison", mel_comparison_figure(
        batch["mels"][0, :L].cpu().numpy(), syn, f"step {step}"), step)
    if "f0_target" in row:
        logger.log_figure("synth/f0_comparison", contour_comparison_figure(
            row["f0_target"], row["f0_pred"], f"f0 - step {step}",
            "f0 (Hz)"), step)
    if "cwt_target" in row:
        logger.log_figure("synth/cwt_comparison", mel_comparison_figure(
            row["cwt_target"], row["cwt_pred"], f"pitch cwt - step {step}"),
            step)
    if "e_target" in row:
        logger.log_figure("synth/energy_comparison",
                          contour_comparison_figure(
                              row["e_target"], row["e_pred"],
                              f"energy - step {step}", "energy"), step)
    st = cfg.stft
    if gl is None:
        gl = GriffinLim(MelSpectrogram(
            st.sampling_rate, st.filter_length, st.hop_length, st.win_length,
            st.n_mel_channels, st.mel_fmin, st.mel_fmax, device=device),
            n_iters=32)
    logger.log_audio("synth/onestep_audio", gl(syn), st.sampling_rate, step)
    return gl


if __name__ == "__main__":
    main()
