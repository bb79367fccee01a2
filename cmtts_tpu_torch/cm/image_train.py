"""Consistency training/distillation for the image-domain UNet (port of
``cmtts_tpu/cm/image_train.py``).

The reference carries generic image-CM training loops inherited from
openai/consistency_models (``model/cm_tool/train_util.py:31-589``
TrainLoop/CMTrainLoop) whose loss math lives in
``karras_diffusion.py:139-297`` (``consistency_losses``) — the same
Euler/Heun step-to-target objective the TTS path uses, minus the TTS
variance losses.  This module provides that objective over
:class:`cmtts_tpu_torch.models.unet.ImageUNet` and a train step (grad ->
RAdam -> EMA -> target EMA), sharing the schedule, weighting, optimizer
and EMA of the TTS trainer.

Params are dicts ``{name: tensor}`` applied through
``torch.func.functional_call``; the step leaves the state it was given as
it was.  Feed it (B, C, H, W) images in [-1, 1]; the reference ships no
image dataset pipeline or training CLI, and neither does the port.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import functional_call

from cmtts_tpu_torch.cm.karras import (
    KarrasSchedule,
    append_dims,
    get_weightings,
    mean_flat,
)
from cmtts_tpu_torch.train.state import CMTrainState, RAdam, tree_ema


def make_image_denoise(apply_fn: Callable, sched: KarrasSchedule):
    """EDM-parameterized denoiser (karras_diffusion.py:392-407):
    ``(params, x_t, sigma (B,), model_kwargs) -> x0``."""

    def denoise(params, x_t, sigma, model_kwargs):
        c_skip, c_out, c_in = sched.active_scalings(sigma)
        out = apply_fn(params, append_dims(c_in, x_t.ndim) * x_t,
                       sched.rescale_t(sigma), **model_kwargs)
        return append_dims(c_out, x_t.ndim) * out + \
            append_dims(c_skip, x_t.ndim) * x_t

    return denoise


def image_consistency_loss(apply_fn, params, target_params, x_start, noise,
                           indices, num_scales: int, sched: KarrasSchedule,
                           loss_norm: str = "l2",
                           weight_schedule: str = "uniform",
                           model_kwargs=None, teacher_denoise=None):
    """Per-sample CT/CD loss (reference ``consistency_losses``,
    karras_diffusion.py:139-297, image branch with l1/l2 in place of
    LPIPS, whose pretrained VGG weights the repository does not hold).

    ``teacher_denoise(x_t, sigma, model_kwargs)`` is given the labels too
    (the JAX package's teacher is called without them, so its CD step
    fails for a class-conditional model).

    Returns (per-sample loss (B,), aux dict)."""
    model_kwargs = model_kwargs or {}
    denoise = make_image_denoise(apply_fn, sched)
    dims = x_start.ndim

    t = sched.t_of_index(indices, num_scales)
    t2 = sched.t_of_index(indices + 1, num_scales)

    x_t = x_start + noise * append_dims(t, dims)
    distiller = denoise(params, x_t, t, model_kwargs)

    with torch.no_grad():
        if teacher_denoise is None:
            # CT: Euler toward t2 with ground-truth x0 (:194-211)
            d = (x_t - x_start) / append_dims(t, dims)
            x_t2 = x_t + d * append_dims(t2 - t, dims)
        else:
            # CD: Heun with the frozen teacher (:213-227)
            den1 = teacher_denoise(x_t, t, model_kwargs)
            d = (x_t - den1) / append_dims(t, dims)
            x_mid = x_t + d * append_dims(t2 - t, dims)
            den2 = teacher_denoise(x_mid, t2, model_kwargs)
            d2 = (x_mid - den2) / append_dims(t2, dims)
            x_t2 = x_t + (d + d2) * append_dims((t2 - t) / 2.0, dims)
        distiller_target = denoise(target_params, x_t2, t2, model_kwargs)

    snrs = sched.snr(t)
    weights = get_weightings(weight_schedule, snrs, sched.sigma_data)
    diffs = distiller - distiller_target
    if loss_norm == "l1":
        loss = mean_flat(torch.abs(diffs)) * weights
    elif loss_norm == "l2":
        loss = mean_flat(diffs ** 2) * weights
    else:
        raise ValueError(f"unsupported image loss norm '{loss_norm}'")
    return loss, {"cm_loss": loss}


def make_image_train_step(model, sched: KarrasSchedule, num_scales: int,
                          opt: RAdam, ema_rates=(0.999,),
                          loss_norm: str = "l2",
                          weight_schedule: str = "uniform",
                          teacher_params=None, class_cond: bool = False):
    """The image-CM step ``(state, batch, target_ema, generator=None,
    indices=None, noise=None) -> (state, {"loss", "grad_norm"})``: grad ->
    optimizer -> EMA -> target EMA (the CMTrainLoop step semantics,
    train_util.py:700-879, on one device).

    ``batch`` holds ``images`` (B, C, H, W) and, when ``class_cond``,
    ``labels`` (B,).  The step draws ``indices`` (uniform over
    [0, num_scales - 1)) and then ``noise`` from ``generator`` unless they
    are passed in, as the parity tests pass JAX's."""

    def apply_fn(params, x, t, y=None):
        return functional_call(model, params, (x, t, y))

    teacher_denoise = None
    if teacher_params is not None:
        den = make_image_denoise(apply_fn, sched)

        def teacher_denoise(x_t, sigma, kw=None):
            with torch.no_grad():
                return den(teacher_params, x_t, sigma, kw or {})

    def step_fn(state: CMTrainState, batch: dict, target_ema: float,
                generator: torch.Generator | None = None,
                indices: torch.Tensor | None = None,
                noise: torch.Tensor | None = None):
        x = batch["images"]
        B, dev = x.shape[0], x.device
        if generator is None and (indices is None or noise is None):
            raise ValueError("the step draws its indices and noise from "
                             "a generator; pass one, or both draws")
        if indices is None:
            indices = torch.randint(0, num_scales - 1, (B,),
                                    generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=dev)
        indices = indices.to(dev, torch.long)
        noise = noise.to(dev, torch.float32)
        kw = {"y": batch["labels"]} if class_cond else {}
        names = list(state.params)
        params = {n: v.detach().requires_grad_(True)
                  for n, v in state.params.items()}
        per_sample, _ = image_consistency_loss(
            apply_fn, params, state.target_params, x, noise, indices,
            num_scales, sched, loss_norm, weight_schedule, kw,
            teacher_denoise)
        loss = per_sample.mean()
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(list(grads.values()))))
        new_params, opt_state = opt.update(grads, state.opt_state,
                                           state.params)
        new_state = CMTrainState(
            step=state.step + 1, params=new_params, opt_state=opt_state,
            ema_params=tuple(tree_ema(e, new_params, r)
                             for e, r in zip(state.ema_params, ema_rates)),
            target_params=tree_ema(state.target_params, new_params,
                                   target_ema))
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step_fn
