"""The consistency-training step (port of ``cmtts_tpu/train/loop.py``):
draw indices and noise -> perturb -> student denoise -> Euler (CT) or Heun
(CD) step to t2 -> target denoise -> loss -> grad -> RAdam -> EMA x3 ->
target EMA.  Progressive distillation and EDM teacher training run through
the same step.

Params are dicts ``{name: tensor}`` applied with
``torch.func.functional_call``; the step returns a new state and leaves the
one it was given as it was.  Its draws, in JAX's order (indices, noise,
dropout), come from one explicit ``torch.Generator`` unless ``indices`` or
``noise`` are passed in, as the parity tests pass JAX's.

Across ranks (``dp_group``, ``tp_group``; see
:mod:`cmtts_tpu_torch.parallel.distributed`) a step computes the one-device
step over the global batch, as the JAX package's step does on a mesh.
"""

from __future__ import annotations

import zlib
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from cmtts_tpu_torch.cm.karras import KarrasSchedule, schedule_from_config
from cmtts_tpu_torch.cm.losses import (
    consistency_loss,
    edm_loss,
    make_denoise_fn,
    masked_mel_l1,
    progdist_loss,
)
from cmtts_tpu_torch.core.config import Config
from cmtts_tpu_torch.core.trace import span
from cmtts_tpu_torch.models.cmtts import CMTTS
from cmtts_tpu_torch.parallel.distributed import (
    all_reduce_,
    all_reduce_grads,
    global_count,
    group_rank,
    group_size,
    rank_share,
    set_tp_group,
    tp_split_dim,
)
from cmtts_tpu_torch.text import sil_phonemes_ids
from cmtts_tpu_torch.train.state import CMTrainState, RAdam, tree_ema


def batch_to_device(batch: dict, device) -> dict:
    """A collated numpy batch (``data.dataset.collate_batch``) as tensors on
    ``device``: integer arrays as int64, floats as float32; the host-only
    ``ids`` and ``raw_texts`` are dropped."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        a = np.asarray(v)
        a = a.astype(np.int64 if a.dtype.kind in "iu" else np.float32)
        return torch.from_numpy(a).to(device)

    return {k: conv(v) for k, v in batch.items()
            if k not in ("ids", "raw_texts") and v is not None}


def make_apply_fn(model: CMTTS, compute_dtype: torch.dtype | None = None,
                  remat: bool = False) -> Callable:
    """``(params, x_scaled, rescaled_t, batch, generator, deterministic) ->
    (model output, cond_out)`` through ``functional_call``.

    ``compute_dtype`` (bfloat16) casts the params at the apply boundary,
    as the JAX step does, and keeps the batch targets float32: the
    denoiser computes in bf16 on bf16 params and inputs, while the
    conditioning net, whose flax layers promote bf16 params and f32 inputs
    to f32, computes in float32 on bf16-rounded params; its embedding
    tables stay bf16, since flax's ``Embed`` returns its table's dtype.
    Output and conditioning come back float32, and gradients flow to the
    float32 master params through the casts.

    ``remat`` recomputes the forward in the backward pass
    (``torch.utils.checkpoint``), replaying the dropout generator so that
    the recomputation draws the same masks."""
    embeds = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, nn.Embedding)}

    def cast(params):
        if compute_dtype is None:
            return params
        out = {}
        with span("ct.cast"):
            for k, v in params.items():
                low = v.to(compute_dtype)
                out[k] = (low if k.startswith("denoiser.") or k in embeds
                          else low.float())
        return out

    def apply(params, x_scaled, rescaled_t, batch, generator, deterministic):
        if compute_dtype is not None:
            x_scaled = x_scaled.to(compute_dtype)
        out, cond = functional_call(
            model, cast(params), (x_scaled, rescaled_t, batch["texts"],
                                  batch["src_lens"]),
            dict(speakers=batch.get("speakers"),
                 spker_embeds=batch.get("spker_embeds"),
                 mel2ph=batch.get("mel2ph"), d_targets=batch.get("d_targets"),
                 p_targets=batch.get("p_targets"),
                 e_targets=batch.get("e_targets"),
                 deterministic=deterministic, generator=generator))
        if compute_dtype is not None:
            out = out.float()
            cond = {k: (v.float() if torch.is_tensor(v)
                        and v.is_floating_point() else v)
                    for k, v in cond.items()}
        return out, cond

    if not remat:
        return apply

    def apply_remat(params, x_scaled, rescaled_t, batch, generator,
                    deterministic):
        state = None if generator is None else generator.get_state()

        def run(params, x_scaled, rescaled_t):
            if generator is not None:
                generator.set_state(state)
            return apply(params, x_scaled, rescaled_t, batch, generator,
                         deterministic)

        return checkpoint(run, params, x_scaled, rescaled_t,
                          use_reentrant=False)

    return apply_remat


def _slice(tree, i: int, k: int):
    """Microbatch i of k: every leaf's rows i, i + k, ... (the JAX step's
    interleave)."""
    if isinstance(tree, dict):
        return {key: _slice(v, i, k) for key, v in tree.items()}
    return tree[i::k]


def _interleave(parts: list) -> torch.Tensor:
    """Inverse of ``_slice`` over microbatches: (k parts of B/k rows) -> B
    rows in the original order."""
    return torch.stack(parts, 1).reshape((-1,) + parts[0].shape[1:])


def make_train_step(model: CMTTS, cfg: Config, opt: RAdam, num_scales: int,
                    teacher_params: dict | None = None, remat: bool = False,
                    microbatch: int | None = None,
                    compute_dtype: torch.dtype | None = None,
                    teacher_sched: KarrasSchedule | None = None,
                    edm_p_mean: float = -1.2, edm_p_std: float = 1.2,
                    dp_group=None, tp_group=None):
    """Build the train step ``(state, batch, probs, target_ema,
    generator=None, indices=None, noise=None) -> (state, metrics)``.

    ``batch`` holds tensors on the device (``batch_to_device``); ``probs``
    (num_scales - 1,) is the schedule sampler's distribution over grid
    indices, from which the step draws ``indices`` (categorical, importance
    weights 1 / (K p_i)); in ``edm`` mode the same slot carries lognormal
    sigmas clipped to [sigma_min, sigma_max], and ``probs`` is unused.
    ``teacher_params`` switches CT to distillation (``training_mode``
    consistency_distillation) or drives progressive distillation
    (``progdist``); ``teacher_sched`` gives an EDM teacher its plain
    scalings.  ``microbatch`` (default ``cfg.train.cm.microbatch``; <= 0
    off) accumulates gradients over B // microbatch interleaved slices
    ``batch[i::k]``, averaged.  ``compute_dtype`` and ``remat`` as in
    :func:`make_apply_fn`; master params, the optimizer, the EMAs and every
    loss stay float32.

    ``dp_group``: ``batch`` is this rank's contiguous share of a global
    batch of ``dp`` equal shares.  The step draws the global batch's
    indices and noise from ``generator`` (which must be in the same state
    on every rank) and keeps its own rows, leaving the generator as the
    one-device step does; injected ``indices`` and ``noise`` are the
    global batch's.  Every mean over the batch divides
    by the global count (:mod:`cmtts_tpu_torch.cm.losses`), the gradients
    are summed over the group, and the optimizer and EMAs then run alike
    on every rank.  Dropout masks are drawn on each rank from a generator
    seeded by the shared generator's state and the rank, so that they
    differ between ranks; with dropout off the step equals the one-device
    step.  With
    ``microbatch`` each rank's share must hold a whole number of rows of
    every microbatch of JAX's interleave.  ``tp_group`` runs the
    denoiser's blocks split over the group (``model.denoiser`` is set so,
    and the state holds this rank's shards, ``tp_shard_state``).

    Metrics: ``loss``, ``cm_loss``, ``tts_loss``, ``grad_norm``,
    ``indices``, ``loss_per_sample``, ``cm_i{k}_sum`` / ``cm_i{k}_cnt`` when
    num_scales - 1 <= 8 (not in edm mode), and the variance-loss terms;
    the scalars are the global batch's, ``indices`` and ``loss_per_sample``
    this rank's rows."""
    sched = schedule_from_config(cfg)
    teacher_sched = teacher_sched or sched
    sil_ids = tuple(sil_phonemes_ids())
    apply_fn = make_apply_fn(model, compute_dtype, remat)
    ema_rates = cfg.train.cm.ema_rate
    training_mode = cfg.train.cm.training_mode
    if training_mode in ("consistency_distillation", "progdist") and \
            teacher_params is None:
        raise ValueError(f"{training_mode} requires teacher_params")
    if microbatch is None:
        microbatch = cfg.train.cm.microbatch
    if teacher_params is not None:
        t_denoise = make_denoise_fn(make_apply_fn(model, compute_dtype),
                                    teacher_sched)
    set_tp_group(model.denoiser, tp_group)
    dp, dp_rank = group_size(dp_group), group_rank(dp_group)

    def psum(x):
        return x if dp_group is None else all_reduce_(x.clone(), dp_group)

    def micro_loss(params, target_params, mb, generator):
        b = mb["batch"]
        teacher = None
        if teacher_params is not None:
            def teacher(x_t, sigma):
                with torch.no_grad():
                    return t_denoise(teacher_params, x_t, sigma, b, None,
                                     True)[0]
        if training_mode == "edm":
            total, aux = edm_loss(apply_fn, params, mb["x_start"],
                                  mb["noise"], mb["indices"], b, cfg, sched,
                                  sil_ids, generator, dp_group)
        elif training_mode == "progdist":
            total, aux = progdist_loss(apply_fn, params, teacher,
                                       mb["x_start"], mb["noise"],
                                       mb["indices"], num_scales, b, cfg,
                                       sched, sil_ids, generator, dp_group)
        else:
            total, aux = consistency_loss(
                apply_fn, params, target_params, mb["x_start"], mb["noise"],
                mb["indices"], num_scales, b, cfg, sched, sil_ids, generator,
                teacher_denoise=teacher, dp_group=dp_group)
        # the ranks' shares of the global mean: their sum is the global
        # batch's loss, and their gradients sum to its gradient
        return (total * mb["weights"]).mean() / dp, total, aux

    def step_fn(state: CMTrainState, batch: dict, probs: torch.Tensor,
                target_ema: float, generator: torch.Generator | None = None,
                indices: torch.Tensor | None = None,
                noise: torch.Tensor | None = None):
        x_start = batch["mels"]
        dev = x_start.device
        B = x_start.shape[0] * dp           # the global batch
        if generator is None and (indices is None or noise is None):
            raise ValueError("the step draws its indices and noise from "
                             "a generator; pass one, or both draws")
        with span("ct.draw"):
            probs = torch.as_tensor(probs, dtype=torch.float32, device=dev)
            if training_mode == "edm":
                if indices is None:
                    z = torch.randn(B, generator=generator, device=dev)
                    indices = torch.exp(edm_p_mean + edm_p_std * z)
                indices = torch.clamp(
                    rank_share(indices, dp_group).to(dev, torch.float32),
                    sched.sigma_min, sched.sigma_max)
                weights = torch.ones(indices.shape[0], device=dev)
            else:
                if indices is None:
                    indices = torch.multinomial(probs, B, replacement=True,
                                                generator=generator)
                indices = rank_share(indices, dp_group).to(dev, torch.long)
                # unbiased importance weights 1 / (K p_i)
                weights = 1.0 / (probs.shape[0] * probs[indices])
            sv = batch.get("sample_valid")
            if sv is not None:
                # padded duplicate rows: zero their cm contribution and
                # renormalise to the real-sample count over the whole
                # batch, so that the gradient equals the unpadded batch's
                # with or without microbatches
                weights = weights * sv * (B / torch.clamp(
                    global_count(sv.sum(), dp_group), min=1.0))
            if noise is None:
                noise = torch.randn((B,) + tuple(x_start.shape[1:]),
                                    generator=generator, device=dev)
            noise = rank_share(noise, dp_group).to(dev, torch.float32)
            if dp > 1 and generator is not None:
                # each rank's dropout masks from a generator of its own,
                # seeded by the shared generator's state (which is left as
                # the one-device step leaves it) and the rank
                seed = zlib.crc32(generator.get_state().numpy().tobytes())
                generator = torch.Generator(dev).manual_seed(
                    (seed << 16) + dp_rank)
            data = {"x_start": x_start, "noise": noise, "indices": indices,
                    "weights": weights, "batch": batch}

        if 0 < microbatch < B:
            if B % microbatch != 0:
                raise ValueError(f"batch size {B} not divisible by "
                                 f"microbatch {microbatch}")
            k = B // microbatch
            if x_start.shape[0] % k:
                raise ValueError(
                    f"a rank's {x_start.shape[0]} rows do not hold a whole "
                    f"number of rows of each of the {k} interleaved "
                    f"microbatches of {microbatch} (microbatch must divide "
                    f"by the data-parallel degree {dp})")
        else:
            k = 1
        names = list(state.params)
        params = {n: v.detach().requires_grad_(True)
                  for n, v in state.params.items()}
        grads, losses, totals, auxes = None, [], [], []
        for i in range(k):
            mb = data if k == 1 else _slice(data, i, k)
            with span("ct.forward"):
                loss, total, aux = micro_loss(params, state.target_params,
                                              mb, generator)
            with span("ct.backward"):
                g = torch.autograd.grad(loss, [params[n] for n in names],
                                        allow_unused=True)
                g = [torch.zeros_like(params[n]) if gi is None else gi
                     for n, gi in zip(names, g)]
                grads = g if grads is None else torch._foreach_add(grads, g)
            losses.append(loss.detach())
            totals.append(total.detach())
            auxes.append({key: v.detach() for key, v in aux.items()})
        with span("ct.update"):
            if k == 1:
                loss, total, aux = losses[0], totals[0], auxes[0]
            else:
                torch._foreach_div_(grads, float(k))
                loss = torch.stack(losses).mean()
                total = _interleave(totals)
                aux = {key: (_interleave([a[key] for a in auxes])
                             if auxes[0][key].ndim else
                             torch.stack([a[key] for a in auxes]).mean())
                       for key in auxes[0]}
            grads = all_reduce_grads(dict(zip(names, grads)), dp_group)
            norms = torch.stack(torch._foreach_norm(list(grads.values())))
            if tp_group is not None:
                # a split tensor's norm over its shards
                split = torch.tensor([tp_split_dim(n) is not None
                                      for n in grads], device=norms.device)
                norms = torch.cat([norms[~split], all_reduce_(
                    norms[split] ** 2, tp_group).sqrt()])

            new_params, opt_state = opt.update(grads, state.opt_state,
                                               state.params)
            new_state = CMTrainState(
                step=state.step + 1, params=new_params, opt_state=opt_state,
                ema_params=tuple(
                    tree_ema(e, new_params, r)
                    for e, r in zip(state.ema_params, ema_rates)),
                target_params=tree_ema(state.target_params, new_params,
                                       target_ema))
            metrics = {
                "loss": psum(loss),
                "cm_loss": psum((aux["cm_loss"] * weights).sum()) / B,
                "tts_loss": aux["tts_loss"],
                "grad_norm": torch.linalg.vector_norm(norms),
                "indices": indices,
                "loss_per_sample": total,
            }
            if training_mode != "edm" and num_scales - 1 <= 8:
                # per-noise-level cm loss, as sum and count pairs so that
                # the host can form exact means over any logging window
                for ki in range(num_scales - 1):
                    msk = (indices == ki).float()
                    metrics[f"cm_i{ki}_sum"] = psum(
                        (aux["cm_loss"] * msk).sum())
                    metrics[f"cm_i{ki}_cnt"] = psum(msk.sum())
            for key in ("pdur", "sdur", "C", "uv", "f0_mean", "f0_std",
                        "energy", "f0"):
                if key in aux:
                    metrics[key] = aux[key]
        return new_state, metrics

    return step_fn


def _expand_ph(x_ph, mel2ph):
    """Phoneme-level track -> mel frames through mel2ph (0 = padding)."""
    padded = torch.cat([torch.zeros_like(x_ph[:, :1]), x_ph], dim=1)
    return torch.gather(padded, 1, mel2ph)


def make_synthesize_step(model: CMTTS, cfg: Config, with_viz: bool = False,
                         dp_group=None):
    """Eval-time one-step synthesis from the target params with
    teacher-forced conditioning, and its masked mel L1: ``(target_params,
    batch, generator=None, x_T=None) -> (mel, mel_loss[, viz])``.  Under
    ``dp_group`` the batch is this rank's rows, x_T its rows of the global
    batch's draw, and the loss the global batch's.

    ``with_viz`` also returns the variance tracks that the training log
    compares: denormalised target and predicted f0 on mel frames (cwt,
    frame or ph), the target and predicted cwt spectrograms, and the energy
    tracks on mel frames."""
    from cmtts_tpu_torch.audio.pitch import cwt2f0_norm, denorm_f0

    sched = schedule_from_config(cfg)
    pc = cfg.pitch

    def viz_of(cond_out, batch):
        viz = {}
        p_pred, mel2ph = cond_out["p_pred"], cond_out["mel2ph"]
        if p_pred is not None:
            # teacher-forced condition: f0_denorm is the target track
            if pc.pitch_type == "cwt":
                cwt_out = p_pred["cwt"]
                f0n = cwt2f0_norm(
                    cwt_out[..., :10], p_pred["f0_mean"],
                    p_pred["f0_std"]
                    * cfg.model.variance_predictor.cwt_std_scale,
                    mel2ph.shape[1], pc.pitch_norm, pc.f0_mean, pc.f0_std,
                    pc.pitch_norm_eps,
                    mask=(mel2ph > 0) if pc.cwt_masked_std else None)
                uv_pred = (cwt_out[..., -1] > 0) if pc.use_uv else None
                viz["f0_pred"] = denorm_f0(f0n, uv_pred, pc.pitch_norm,
                                           pc.f0_mean, pc.f0_std, pc.use_uv)
                viz["f0_target"] = p_pred["f0_denorm"]
                viz["cwt_pred"] = cwt_out[..., :10]
                viz["cwt_target"] = batch["p_targets"]["cwt_spec"]
            elif pc.pitch_type == "frame":
                pp = p_pred["pitch_pred"]
                uv_pred = (pp[..., 1] > 0) if pc.use_uv else None
                viz["f0_pred"] = denorm_f0(
                    pp[..., 0], uv_pred, pc.pitch_norm, pc.f0_mean,
                    pc.f0_std, pc.use_uv, pitch_padding=mel2ph == 0)
                viz["f0_target"] = p_pred["f0_denorm"]
            else:  # 'ph': predictions and targets live at phoneme rate
                f0p = denorm_f0(p_pred["pitch_pred"][..., 0], None,
                                pc.pitch_norm, pc.f0_mean, pc.f0_std,
                                use_uv=False)
                viz["f0_pred"] = _expand_ph(f0p, mel2ph)
                viz["f0_target"] = _expand_ph(p_pred["f0_denorm"], mel2ph)
        e_pred = cond_out["e_pred"]
        if e_pred is not None:
            e_tgt = batch["e_targets"]
            if cfg.energy.feature == "phoneme_level":
                e_pred, e_tgt = _expand_ph(e_pred, mel2ph), _expand_ph(
                    e_tgt, mel2ph)
            viz["e_pred"], viz["e_target"] = e_pred, e_tgt
        return viz

    denoise = make_denoise_fn(make_apply_fn(model), sched)

    @torch.no_grad()
    def synth_fn(target_params, batch, generator=None, x_T=None):
        mels = batch["mels"]
        if x_T is None:
            if generator is None:
                raise ValueError("pass x_T or a generator to draw it")
            n = mels.shape[0] * group_size(dp_group)
            x_T = rank_share(torch.randn(
                (n,) + tuple(mels.shape[1:]), generator=generator,
                device=mels.device), dp_group) * sched.sigma_max
        # one step at sigma_max: the conditioning and the denoiser in one
        # teacher-forced forward
        sigma = torch.full((mels.shape[0],), sched.sigma_max,
                           device=mels.device)
        mel, cond_out = denoise(target_params, x_T.to(mels.device), sigma,
                                batch, None, True)
        mel_loss = masked_mel_l1(mel, mels, batch["mel_lens"], mels.shape[1],
                                 dp_group)
        if with_viz:
            return mel, mel_loss, viz_of(cond_out, batch)
        return mel, mel_loss

    return synth_fn
