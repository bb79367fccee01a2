"""Legacy DiffGAN-TTS / DiffSinger losses, adversarial and reconstruction
(port of ``cmtts_tpu/cm/gan_losses.py``).

Parity sources:
- LSGAN JCU losses: reference ``model/loss.py:11-35``
  (``get_lsgan_losses_fn`` / ``get_adversarial_losses_fn``);
- feature-matching loss: ``DiffGANTTSLoss.get_fm_loss``
  (``model/loss.py:728-736``);
- nonzero-weighted mel L1 and windowed SSIM loss:
  ``model/loss.py:737-776`` + ``utils/tools.py:825-869``;
- reconstruction routing (aux / naive / shallow):
  ``DiffGANTTSLoss.forward`` (``model/loss.py:629-706``) and
  ``DiffSingerLoss.forward`` (``model/loss.py:387-448``).

The variance (duration/pitch/energy) terms are the CM path's, from
:mod:`cmtts_tpu_torch.cm.losses`.  The discriminator is
:class:`cmtts_tpu_torch.models.discriminator.JCUDiscriminator`, whose
feature lists are (B, T', C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cmtts_tpu_torch.cm.losses import duration_loss, energy_loss, pitch_loss
from cmtts_tpu_torch.core.config import Config


# ---------------------------------------------------------------------------
# Adversarial (LSGAN, JCU) losses
# ---------------------------------------------------------------------------

def _jcu_loss(logit_cond, logit_uncond, label: float, mask=None):
    """0.5 * (MSE(cond, label) + MSE(uncond, label)), optionally masked
    (reference ``jcu_loss_fn``, model/loss.py:12-17)."""

    def mse(logit):
        err = (logit - label) ** 2
        if mask is None:
            return err.mean()
        return (err * mask).sum() / mask.sum()

    return 0.5 * (mse(logit_cond) + mse(logit_uncond))


def lsgan_d_loss(r_logit_cond, r_logit_uncond, f_logit_cond, f_logit_uncond,
                 mask=None):
    """Discriminator loss: real -> 1, fake -> 0.  Returns (r_loss, f_loss)
    like the reference ``d_loss_fn`` (model/loss.py:19-22)."""
    r_loss = _jcu_loss(r_logit_cond, r_logit_uncond, 1.0, mask)
    f_loss = _jcu_loss(f_logit_cond, f_logit_uncond, 0.0, mask)
    return r_loss, f_loss


def lsgan_g_loss(f_logit_cond, f_logit_uncond, mask=None):
    """Generator loss: fake -> 1 (model/loss.py:24-26)."""
    return _jcu_loss(f_logit_cond, f_logit_uncond, 1.0, mask)


def get_adversarial_losses_fn(mode: str):
    """(d_loss_fn, g_loss_fn) factory (model/loss.py:31-35)."""
    if mode == "lsgan":
        return lsgan_d_loss, lsgan_g_loss
    raise NotImplementedError(f"adversarial loss mode '{mode}'")


def feature_matching_loss(D_real_cond, D_real_uncond, D_fake_cond,
                          D_fake_uncond, n_layers: int):
    """L1 feature matching over all but the logit layer, averaged over the
    cond/uncond branches, scaled by 4/(n_layers+1) per layer (reference
    ``get_fm_loss``, model/loss.py:728-736).  ``n_layers`` is
    ``n_layer + n_cond_layer`` from the discriminator config.  Real
    features are constants only in that the caller differentiates with
    respect to the generator's params."""
    feat_w = 4.0 / (n_layers + 1)
    loss = 0.0
    for j in range(len(D_fake_cond) - 1):
        loss = loss + feat_w * 0.5 * (
            torch.abs(D_real_cond[j] - D_fake_cond[j]).mean()
            + torch.abs(D_real_uncond[j] - D_fake_uncond[j]).mean())
    return loss


# ---------------------------------------------------------------------------
# Reconstruction losses (nonzero-row weighting + SSIM)
# ---------------------------------------------------------------------------

def weights_nonzero_speech(target):
    """1.0 everywhere except all-zero (padding) mel rows, broadcast over
    the mel axis (model/loss.py:744-748)."""
    w = (torch.abs(target).sum(-1, keepdim=True) != 0).float()
    return w.expand(target.shape)


def weighted_mel_l1(pred, target, mel_valid=None):
    """Nonzero-row-weighted mel L1 (model/loss.py:737-750).  ``mel_valid``
    (B, T) optionally zeroes padded frames first (the reference's
    ``masked_fill`` by mel_masks)."""
    if mel_valid is not None:
        pred = pred * mel_valid[..., None]
        target = target * mel_valid[..., None]
    w = weights_nonzero_speech(target)
    return (torch.abs(pred - target) * w).sum() / torch.clamp(w.sum(),
                                                              min=1.0)


def _gaussian_window(size: int, sigma: float, device=None):
    g = torch.exp(-((torch.arange(size, device=device) - size // 2) ** 2)
                  / (2.0 * sigma ** 2))
    return g / g.sum()


def ssim_map(img1, img2, window_size: int = 11):
    """Windowed SSIM map over (B, T, M) images with an 11x11 gaussian
    (sigma 1.5) window and zero padding — the reference ``utils/tools.py:
    _ssim`` (conv2d with padding=window//2) as a separable filter, summed
    tap by tap as the JAX package sums it.

    Returns the per-position SSIM map (B, T, M)."""
    w1 = _gaussian_window(window_size, 1.5, img1.device)
    pad = window_size // 2

    def filt(x):
        T, M = x.shape[1], x.shape[2]
        xp = F.pad(x, (0, 0, pad, pad))
        acc_t = torch.zeros_like(x)
        for i in range(window_size):
            acc_t = acc_t + w1[i] * xp[:, i:i + T, :]
        xp2 = F.pad(acc_t, (pad, pad))
        acc = torch.zeros_like(x)
        for i in range(window_size):
            acc = acc + w1[i] * xp2[:, :, i:i + M]
        return acc

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))


def ssim_loss(pred, target, bias: float = 6.0):
    """Nonzero-weighted (1 - SSIM) loss (model/loss.py:752-762)."""
    w = weights_nonzero_speech(target)
    sm = 1.0 - ssim_map(pred + bias, target + bias)
    return (sm * w).sum() / torch.clamp(w.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Legacy total losses (DiffSinger / DiffGAN-TTS)
# ---------------------------------------------------------------------------

def _variance_losses(cond_out: dict, batch: dict, cfg: Config,
                     sil_ids: tuple[int, ...]):
    src_valid = 1.0 - cond_out["src_pad_mask"].float()
    mel_valid = 1.0 - cond_out["mel_pad_mask"].float()
    dur = duration_loss(cond_out["log_d_pred"], batch["d_targets"],
                        batch["texts"], src_valid, cfg, sil_ids)
    pit = {}
    if cfg.model.variance_embedding.use_pitch_embed:
        pit = pitch_loss(cond_out["p_pred"], batch["p_targets"],
                         mel_valid, src_valid, cfg)
    ene = torch.zeros((), device=src_valid.device)
    if cfg.model.variance_embedding.use_energy_embed:
        ene = energy_loss(cond_out["e_pred"], batch["e_targets"],
                          src_valid, mel_valid, cfg)
    return dur, pit, ene, mel_valid


def diffsinger_loss(mode: str, cond_out: dict, batch: dict, cfg: Config,
                    sil_ids: tuple[int, ...], mel_pred=None,
                    noise_loss=None):
    """DiffSinger total loss (model/loss.py:387-448).

    ``mode``: 'diff_aux' (explicit mel L1 on the aux decoder output) or
    'diff_naive'/'diff_shallow' (the diffusion noise-prediction loss
    carries the mel term).  Returns (total, parts dict).
    """
    dur, pit, ene, mel_valid = _variance_losses(cond_out, batch, cfg, sil_ids)
    total = sum(dur.values()) + sum(pit.values()) + ene

    parts = {f"dur_{k}": v for k, v in dur.items()}
    parts.update({f"pitch_{k}": v for k, v in pit.items()})
    parts["energy"] = ene

    if mode == "diff_aux":
        mel = weighted_mel_l1(mel_pred, batch["mels"], mel_valid)
        total = total + mel
        parts["mel"] = mel
    elif mode in ("diff_naive", "diff_shallow"):
        total = total + noise_loss
        parts["noise"] = noise_loss
    else:
        raise NotImplementedError(f"DiffSinger mode '{mode}'")
    return total, parts


def diffgan_recon_loss(mode: str, cond_out: dict, batch: dict, cfg: Config,
                       sil_ids: tuple[int, ...], mel_preds,
                       coarse_mels=None):
    """DiffGAN-TTS reconstruction part (model/loss.py:629-697): weighted
    mel L1 (list of decoded trace mels for 'aux'; vs coarse mels for
    'shallow'; vs targets for 'naive') + lambda-scaled variance losses
    ('shallow' freezes the variance adaptor -> zero variance terms).
    Returns (recon_loss, parts dict)."""
    ls = cfg.train.loss

    if mode == "aux":
        mel_valid = 1.0 - cond_out["mel_pad_mask"].float()
        mel = torch.zeros((), device=mel_valid.device)
        for mp in mel_preds:
            mel = mel + weighted_mel_l1(mp, batch["mels"], mel_valid)
    elif mode == "shallow":
        _, _, _, mel_valid = _variance_losses(cond_out, batch, cfg, sil_ids)
        mel = weighted_mel_l1(mel_preds, coarse_mels, mel_valid)
    elif mode == "naive":
        mel_valid = 1.0 - cond_out["mel_pad_mask"].float()
        mel = weighted_mel_l1(mel_preds, batch["mels"], mel_valid)
    else:
        raise NotImplementedError(f"DiffGAN mode '{mode}'")

    parts = {"mel": mel}
    if mode != "shallow":
        dur, pit, ene, _ = _variance_losses(cond_out, batch, cfg, sil_ids)
        recon = mel + ls.lambda_d * sum(dur.values()) + \
            ls.lambda_p * sum(pit.values()) + ls.lambda_e * ene
        parts.update({f"dur_{k}": v for k, v in dur.items()})
        parts.update({f"pitch_{k}": v for k, v in pit.items()})
        parts["energy"] = ene
    else:
        recon = mel
    return recon, parts


def fm_lambda(cfg: Config, mode: str) -> float:
    """lambda_fm selection (model/loss.py:625-626): 'shallow' uses the
    smaller lambda_fm_shallow."""
    ls = cfg.train.loss
    return ls.lambda_fm_shallow if mode == "shallow" else ls.lambda_fm
