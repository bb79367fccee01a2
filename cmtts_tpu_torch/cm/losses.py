"""Training losses (port of ``cmtts_tpu/cm/losses.py``): the variance-adaptor
losses, consistency training and distillation, EDM denoising score matching,
progressive distillation, and the eval-time masked mel L1/L2.

Every loss returns the per-sample total (B,) with an aux dict, so that the
loss-second-moment sampler can update its history.  ``apply_fn`` is
``(params, x_scaled, rescaled_t, batch, generator, deterministic) ->
(model output, cond_out)`` (see :mod:`cmtts_tpu_torch.train.loop`).
"""

from __future__ import annotations

from typing import Callable

import torch

from cmtts_tpu_torch.cm.karras import (
    KarrasSchedule,
    append_dims,
    get_weightings,
    mean_flat,
)
from cmtts_tpu_torch.core.config import Config


# ---------------------------------------------------------------------------
# Variance (TTS) losses
# ---------------------------------------------------------------------------

def _masked_mean(x, mask):
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def duration_loss(log_d_pred, d_targets, texts, src_valid, cfg: Config,
                  sil_ids: tuple[int, ...], sample_valid=None) -> dict:
    """Phone, word and sentence duration losses.  Words are the runs
    between silence phonemes (``sil_ids``); ``sample_valid`` (B,) zeros
    padded duplicate rows exactly."""
    ls = cfg.train.loss
    losses = {}
    nonpad = src_valid.float()
    dur_gt = d_targets.float() * nonpad

    pdur = (log_d_pred - torch.log(dur_gt + 1.0)) ** 2
    losses["pdur"] = _masked_mean(pdur, nonpad) * ls.lambda_ph_dur

    dur_pred = torch.clamp(torch.exp(log_d_pred) - 1.0, min=0.0)

    if ls.lambda_word_dur > 0:
        is_sil = torch.zeros_like(texts, dtype=torch.bool)
        for sid in sil_ids:
            is_sil = is_sil | (texts == sid)
        is_sil = is_sil.float()
        word_id = (torch.cumsum(is_sil, -1) * (1.0 - is_sil)).long()
        n_words = texts.shape[1] + 1

        def scatter(vals):
            out = vals.new_zeros(vals.shape[0], n_words)
            return out.scatter_add(1, word_id, vals)[:, 1:]

        word_dur_p, word_dur_g = scatter(dur_pred), scatter(dur_gt)
        wdur = (torch.log(word_dur_p + 1.0)
                - torch.log(word_dur_g + 1.0)) ** 2
        w_nonpad = (word_dur_g > 0).float()
        losses["wdur"] = _masked_mean(wdur, w_nonpad) * ls.lambda_word_dur

    if ls.lambda_sent_dur > 0:
        sent_p = dur_pred.sum(-1)
        sent_g = dur_gt.sum(-1)
        sdur = (torch.log(sent_p + 1.0) - torch.log(sent_g + 1.0)) ** 2
        if sample_valid is not None:
            losses["sdur"] = (_masked_mean(sdur, sample_valid)
                              * ls.lambda_sent_dur)
        else:
            losses["sdur"] = sdur.mean() * ls.lambda_sent_dur
    return losses


def _bce_with_logits(logits, labels):
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def pitch_loss(p_pred: dict, p_targets: dict, mel_valid, src_valid,
               cfg: Config, sample_valid=None) -> dict:
    """CWT (spectrogram, uv, f0 mean and std), frame (f0, uv) or ph (f0)
    pitch losses; uv by BCE with logits."""
    ls = cfg.train.loss
    pc = cfg.pitch
    losses = {}
    sv = sample_valid
    if pc.pitch_type == "cwt":
        cwt_pred = p_pred["cwt"][..., :10]
        cwt_gt = p_targets["cwt_spec"]
        cwt_err = (torch.abs(cwt_pred - cwt_gt) if ls.cwt_loss == "l1"
                   else (cwt_pred - cwt_gt) ** 2)
        if sv is not None:
            losses["C"] = _masked_mean(
                cwt_err, sv[:, None, None].expand(cwt_err.shape)
            ) * ls.lambda_f0
        else:
            losses["C"] = cwt_err.mean() * ls.lambda_f0
        if pc.use_uv:
            bce = _bce_with_logits(p_pred["cwt"][..., -1], p_targets["uv"])
            losses["uv"] = _masked_mean(bce, mel_valid) * ls.lambda_uv
        f0m_err = torch.abs(p_pred["f0_mean"] - p_targets["f0_mean"])
        f0s_err = torch.abs(p_pred["f0_std"] - p_targets["f0_std"])
        if sv is not None:
            losses["f0_mean"] = _masked_mean(f0m_err, sv) * ls.lambda_f0
            losses["f0_std"] = _masked_mean(f0s_err, sv) * ls.lambda_f0
        else:
            losses["f0_mean"] = f0m_err.mean() * ls.lambda_f0
            losses["f0_std"] = f0s_err.mean() * ls.lambda_f0
    elif pc.pitch_type == "frame":
        pred = p_pred["pitch_pred"]
        nonpad = mel_valid
        if pc.use_uv:
            bce = _bce_with_logits(pred[..., 1], p_targets["uv"])
            losses["uv"] = _masked_mean(bce, nonpad) * ls.lambda_uv
            nonpad = nonpad * (p_targets["uv"] == 0).float()
        diff = pred[..., 0] - p_targets["f0"]
        err = torch.abs(diff) if ls.pitch_loss == "l1" else diff ** 2
        losses["f0"] = _masked_mean(err, nonpad) * ls.lambda_f0
    else:  # 'ph'
        diff = p_pred["pitch_pred"][..., 0] - p_targets["f0"]
        err = torch.abs(diff) if ls.pitch_loss == "l1" else diff ** 2
        losses["f0"] = _masked_mean(err, src_valid) * ls.lambda_f0
    return losses


def energy_loss(e_pred, e_targets, src_valid, mel_valid, cfg: Config):
    """Masked L1 on energy, at phoneme or frame level."""
    mask = src_valid if cfg.energy.feature == "phoneme_level" else mel_valid
    return _masked_mean(torch.abs(e_pred - e_targets), mask)


def variance_loss(cond_out: dict, batch: dict, cfg: Config,
                  sil_ids: tuple[int, ...]):
    """(total, dict of terms): duration + pitch + energy.  The mel itself is
    learned by the consistency loss."""
    src_valid = 1.0 - cond_out["src_pad_mask"].float()
    mel_valid = 1.0 - cond_out["mel_pad_mask"].float()
    sample_valid = batch.get("sample_valid")
    if sample_valid is not None:
        # padded duplicate rows contribute zero to every masked mean
        src_valid = src_valid * sample_valid[:, None]
        mel_valid = mel_valid * sample_valid[:, None]

    losses = duration_loss(
        cond_out["log_d_pred"], batch["d_targets"], batch["texts"],
        src_valid, cfg, sil_ids, sample_valid=sample_valid)
    if cfg.model.variance_embedding.use_pitch_embed:
        losses.update(pitch_loss(
            cond_out["p_pred"], batch["p_targets"], mel_valid, src_valid,
            cfg, sample_valid=sample_valid))
    if cfg.model.variance_embedding.use_energy_embed:
        losses["energy"] = energy_loss(
            cond_out["e_pred"], batch["e_targets"], src_valid, mel_valid, cfg)
    return sum(losses.values()), losses


# ---------------------------------------------------------------------------
# Consistency, EDM and progressive-distillation losses
# ---------------------------------------------------------------------------

def make_denoise_fn(apply_fn: Callable, sched: KarrasSchedule):
    """Wrap ``apply_fn`` into the EDM-parameterised denoiser
    ``(params, x_t, sigma, batch, generator, deterministic) ->
    (denoised, cond_out)``."""

    def denoise(params, x_t, sigma, batch, generator, deterministic):
        c_skip, c_out, c_in = sched.active_scalings(sigma)
        model_out, cond_out = apply_fn(
            params, append_dims(c_in, x_t.ndim) * x_t, sched.rescale_t(sigma),
            batch, generator, deterministic)
        denoised = (append_dims(c_out, x_t.ndim) * model_out
                    + append_dims(c_skip, x_t.ndim) * x_t)
        return denoised, cond_out

    return denoise


def _twin_forward(generator):
    """Keep ``generator``'s state now and return a function that puts it
    back, so that a second forward draws the dropout masks of the first."""
    state = None if generator is None else generator.get_state()

    def replay():
        if generator is not None:
            generator.set_state(state)

    return replay


def consistency_loss(apply_fn: Callable, params, target_params,
                     x_start: torch.Tensor, noise: torch.Tensor,
                     indices: torch.Tensor, num_scales: int, batch: dict,
                     cfg: Config, sched: KarrasSchedule,
                     sil_ids: tuple[int, ...],
                     generator: torch.Generator | None,
                     mel_valid=None, teacher_denoise=None):
    """Consistency training (Euler step to t2 with the ground truth x0 as
    the denoiser) or distillation (Heun step with ``teacher_denoise``).

    The student denoises x_t at t; the target network denoises x_t2 at t2
    without gradient and with the student's dropout masks.  The distance
    (``loss_norm`` l1 / l2 / mel_loss, optionally ``+mel_loss``) is weighted
    by the weight schedule at t; total = 10 * cm + the variance losses.
    Returns (per-sample total (B,), aux)."""
    denoise = make_denoise_fn(apply_fn, sched)
    t = sched.t_of_index(indices, num_scales)
    t2 = sched.t_of_index(indices + 1, num_scales)
    dims = x_start.ndim
    x_t = x_start + noise * append_dims(t, dims)

    replay = _twin_forward(generator)
    distiller, cond_out = denoise(params, x_t, t, batch, generator, False)
    tts_total, tts_losses = variance_loss(cond_out, batch, cfg, sil_ids)

    with torch.no_grad():
        if teacher_denoise is None:
            d = (x_t - x_start) / append_dims(t, dims)
            x_t2 = x_t + d * append_dims(t2 - t, dims)
        else:
            den1 = teacher_denoise(x_t, t)
            d = (x_t - den1) / append_dims(t, dims)
            x_mid = x_t + d * append_dims(t2 - t, dims)
            den2 = teacher_denoise(x_mid, t2)
            d2 = (x_mid - den2) / append_dims(t2, dims)
            x_t2 = x_t + (d + d2) * append_dims((t2 - t) / 2.0, dims)
        replay()
        distiller_target, _ = denoise(target_params, x_t2, t2, batch,
                                      generator, False)

    weights = get_weightings(cfg.train.cm.weight_schedule, sched.snr(t),
                             sched.sigma_data)
    loss_norm = cfg.train.cm.loss_norm
    backward_mel = loss_norm.endswith("+mel_loss")
    if backward_mel:
        loss_norm = loss_norm.split("+")[0]

    diffs = distiller - distiller_target
    if loss_norm == "l1":
        cm = mean_flat(torch.abs(diffs)) * weights
    elif loss_norm == "l2":
        cm = mean_flat(diffs ** 2) * weights
    elif loss_norm == "mel_loss":
        if mel_valid is None:
            mel_valid = 1.0 - cond_out["mel_pad_mask"].float()
        w = mel_valid[..., None]
        cm = (torch.abs(diffs) * w).sum() / torch.clamp(
            w.sum() * diffs.shape[-1], min=1.0)
        cm = cm.expand(x_start.shape[0])
    else:
        raise ValueError(f"Unknown loss norm {loss_norm}")

    total = 10.0 * cm + tts_total
    if backward_mel:
        w = (torch.abs(x_start).sum(-1, keepdim=True) != 0).float()
        bm = (torch.abs(distiller - x_start) * w).sum() / torch.clamp(
            w.sum() * x_start.shape[-1], min=1.0)
        total = total + bm
    return total, {"cm_loss": cm, "tts_loss": tts_total, **tts_losses}


def edm_loss(apply_fn: Callable, params, x_start: torch.Tensor,
             noise: torch.Tensor, sigmas: torch.Tensor, batch: dict,
             cfg: Config, sched: KarrasSchedule, sil_ids: tuple[int, ...],
             generator: torch.Generator | None):
    """EDM denoising score matching at continuous ``sigmas`` (B,): trains
    the diffusion teacher for consistency distillation.  ``sched`` must use
    the plain (non-boundary) scalings.  loss = w(snr) * mean (D(x_t) - x0)^2
    + the variance losses."""
    denoise = make_denoise_fn(apply_fn, sched)
    dims = x_start.ndim
    x_t = x_start + noise * append_dims(sigmas, dims)
    denoised, cond_out = denoise(params, x_t, sigmas, batch, generator, False)
    tts_total, tts_losses = variance_loss(cond_out, batch, cfg, sil_ids)
    weights = get_weightings(cfg.train.cm.weight_schedule, sched.snr(sigmas),
                             sched.sigma_data)
    mse = mean_flat(append_dims(weights, dims) * (denoised - x_start) ** 2)
    return mse + tts_total, {"cm_loss": mse, "tts_loss": tts_total,
                             **tts_losses}


def progdist_loss(apply_fn: Callable, params, teacher_denoise: Callable,
                  x_start: torch.Tensor, noise: torch.Tensor,
                  indices: torch.Tensor, num_scales: int, batch: dict,
                  cfg: Config, sched: KarrasSchedule,
                  sil_ids: tuple[int, ...],
                  generator: torch.Generator | None):
    """Progressive distillation: the student at t matches the denoiser
    implied by two teacher Euler half-steps t -> t2 -> t3."""
    denoise = make_denoise_fn(apply_fn, sched)
    dims = x_start.ndim

    def t_of(idx):
        lo = sched.sigma_max ** (1 / sched.rho)
        hi = sched.sigma_min ** (1 / sched.rho)
        return (lo + idx / num_scales * (hi - lo)) ** sched.rho

    idx = indices.float()
    t, t2, t3 = t_of(idx), t_of(idx + 0.5), t_of(idx + 1.0)
    x_t = x_start + noise * append_dims(t, dims)
    denoised_x, cond_out = denoise(params, x_t, t, batch, generator, False)
    tts_total, tts_losses = variance_loss(cond_out, batch, cfg, sil_ids)

    def euler(x, ta, tb):
        d = (x - teacher_denoise(x, ta)) / append_dims(ta, dims)
        return x + d * append_dims(tb - ta, dims)

    with torch.no_grad():
        x_t2 = euler(x_t, t, t2)
        x_t3 = euler(x_t2, t2, t3)
        target_x = x_t - append_dims(t, dims) * (x_t3 - x_t) / append_dims(
            t3 - t, dims)

    weights = get_weightings(cfg.train.cm.weight_schedule, sched.snr(t),
                             sched.sigma_data)
    loss_norm = cfg.train.cm.loss_norm.split("+")[0]
    diffs = denoised_x - target_x
    if loss_norm == "l1":
        cm = mean_flat(torch.abs(diffs)) * weights
    elif loss_norm == "l2":
        cm = mean_flat(diffs ** 2) * weights
    else:
        raise ValueError(f"Unknown loss norm {loss_norm}")
    return 10.0 * cm + tts_total, {"cm_loss": cm, "tts_loss": tts_total,
                                   **tts_losses}


def _mel_masks(mel_pred, mel_target, mel_lens, max_len: int):
    mask = (torch.arange(max_len, device=mel_lens.device)[None, :]
            < mel_lens[:, None]).float()[..., None]
    mel_pred, mel_target = mel_pred * mask, mel_target * mask
    w = (torch.abs(mel_target).sum(-1, keepdim=True) != 0).float()
    return mel_pred, mel_target, w.expand(mel_target.shape)


def masked_mel_l1(mel_pred, mel_target, mel_lens, max_len: int):
    """Eval-time mel L1 over the valid frames whose target row is not all
    zero."""
    mel_pred, mel_target, w = _mel_masks(mel_pred, mel_target, mel_lens,
                                         max_len)
    return (torch.abs(mel_pred - mel_target) * w).sum() / torch.clamp(
        w.sum(), min=1.0)


def masked_mel_l2(mel_pred, mel_target, mel_lens, max_len: int):
    """Masked mel MSE, weighted as :func:`masked_mel_l1`."""
    mel_pred, mel_target, w = _mel_masks(mel_pred, mel_target, mel_lens,
                                         max_len)
    return (((mel_pred - mel_target) ** 2) * w).sum() / torch.clamp(
        w.sum(), min=1.0)
