"""Image-domain consistency-model sampling and zero-shot editing (port of
``cmtts_tpu/cm/image.py``).

Parity sources (reference ``model/cm_tool/karras_diffusion.py``):
- ``karras_sample`` image entry (:480-577 / image_sample.py:68-85) —
  here :func:`karras_sample_image`, over the shape-generic samplers of
  :mod:`cmtts_tpu_torch.cm.sampling`;
- ``iterative_colorization`` (:894-944), ``iterative_inpainting``
  (:947-1004), ``iterative_superres`` (:1006-1123) — zero-shot editing
  by projecting the denoised estimate onto a measurement-consistent
  subspace between sampler steps.

Images are NCHW tensors in [-1, 1].  Noise is an input: the samplers take
``x_T`` and the later draws as ``noise``, the editors their renoise draws
as ``noise`` (unit normals, one per step but the last), else they draw
from ``generator``.
"""

from __future__ import annotations

import math
import sys
from typing import Callable, Sequence

import numpy as np
import torch

from cmtts_tpu_torch.cm.karras import KarrasSchedule, append_dims
from cmtts_tpu_torch.cm.sampling import _Draws, sample_mel


def make_image_denoise_fn(model: Callable, sched: KarrasSchedule,
                          clip_denoised: bool = True, model_kwargs=None):
    """EDM-parameterized denoiser over an ImageUNet ``model(x, t, **kw)``
    (KarrasDenoiser.denoise, karras_diffusion.py:392-407 + the
    clip_denoised clamp of karras_sample :528-534): ``(x_t, sigma) -> x0``,
    sigma a float or a (B,) tensor."""
    model_kwargs = model_kwargs or {}

    def denoise(x_t, sigma):
        sigma = torch.as_tensor(sigma, dtype=torch.float32).to(
            x_t.device).expand(x_t.shape[0])
        c_skip, c_out, c_in = sched.active_scalings(sigma)
        out = model(append_dims(c_in, x_t.ndim) * x_t,
                    sched.rescale_t(sigma), **model_kwargs)
        x0 = append_dims(c_out, x_t.ndim) * out + \
            append_dims(c_skip, x_t.ndim) * x_t
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        return x0

    return denoise


@torch.no_grad()
def karras_sample_image(model: Callable, shape, sched: KarrasSchedule,
                        sampler: str = "heun", steps: int = 40, ts=None,
                        clip_denoised: bool = True, s_churn: float = 0.0,
                        s_tmin: float = 0.0, s_tmax: float = float("inf"),
                        s_noise: float = 1.0, model_kwargs=None,
                        x_T: torch.Tensor | None = None,
                        noise: Sequence[torch.Tensor] | None = None,
                        generator: torch.Generator | None = None,
                        device: torch.device | str = "cpu") -> torch.Tensor:
    """Sample images (B, 3, H, W) in [-1, 1] (image_sample.py:68-85).

    Delegates to the shape-generic
    :func:`cmtts_tpu_torch.cm.sampling.sample_mel` dispatch (``T`` for
    our_multistep follows the documented ts mapping: len(ts) - 1) and
    applies the image entry's final clamp (karras_diffusion.py:477 — the
    TTS entry has no clamp, mels are unbounded).  A given ``x_T`` and
    ``noise`` are moved to ``device``."""
    denoise = make_image_denoise_fn(model, sched, clip_denoised,
                                    model_kwargs)
    x0 = sample_mel(denoise, tuple(shape), sched, sampler=sampler,
                    T=(len(ts) - 1 if ts else 1), steps=steps, ts=ts,
                    x_T=None if x_T is None else x_T.to(device),
                    noise=noise, generator=generator, device=device,
                    s_churn=s_churn, s_tmin=s_tmin, s_noise=s_noise,
                    s_tmax=s_tmax)
    return torch.clamp(x0, -1.0, 1.0)


def to_uint8(sample: torch.Tensor) -> np.ndarray:
    """[-1, 1] float NCHW -> uint8 NHWC (image_sample.py:87-90)."""
    arr = ((sample + 1.0) * 127.5).permute(0, 2, 3, 1).cpu().numpy()
    return np.clip(arr, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Zero-shot editing
# ---------------------------------------------------------------------------

def _edit_schedule(ts, steps, sched: KarrasSchedule):
    lo = sched.sigma_max ** (1.0 / sched.rho)
    hi = sched.sigma_min ** (1.0 / sched.rho)
    return [float(np.clip((lo + t / (steps - 1) * (hi - lo)) ** sched.rho,
                          sched.sigma_min, sched.sigma_max)) for t in ts]


@torch.no_grad()
def _edit_loop(distill, replacement, images, x, ts, steps,
               sched: KarrasSchedule, noise, generator):
    """Shared projection loop (karras_diffusion.py:930-943 et al.):
    denoise -> clamp -> project onto the measurement subspace -> renoise
    to the next sigma."""
    draw = _Draws(noise, generator)
    sig = _edit_schedule(ts, steps, sched)
    for i in range(len(ts) - 1):
        x0 = torch.clamp(distill(x, sig[i]), -1.0, 1.0)
        x0 = replacement(images, x0)
        std = math.sqrt(max(sig[i + 1] ** 2 - sched.sigma_min ** 2, 0.0))
        x = x0 + draw(x) * std
    return x


def _gray_orthogonal_matrix() -> np.ndarray:
    """QR-completed basis whose first axis is the luminance direction
    (karras_diffusion.py:906-917)."""
    v = np.asarray([0.2989, 0.5870, 0.1140])
    v = v / np.linalg.norm(v)
    m = np.eye(3)
    m[:, 0] = v
    m = np.linalg.qr(m)[0]
    if np.sum(m[:, 0]) < 0:
        m = -m
    return m


def iterative_colorization(distill, images, x, ts, sched: KarrasSchedule,
                           steps: int = 40, noise=None, generator=None):
    """Colorize: keep the grayscale (luminance) component of ``images``,
    let the model fill the chroma plane (karras_diffusion.py:894-944).

    distill: (x (B,3,H,W), sigma float) -> x0; images/x NCHW in [-1,1].
    Returns (edited, projected measurement images)."""
    Q = torch.as_tensor(_gray_orthogonal_matrix(), dtype=torch.float32,
                        device=x.device)
    mask = torch.zeros(3, device=x.device)
    mask[0] = 1.0
    mask = mask[:, None, None]

    def replacement(x0, x1):
        a = torch.einsum("bchw,cd->bdhw", x0, Q)
        b = torch.einsum("bchw,cd->bdhw", x1, Q)
        mix = a * mask + b * (1.0 - mask)
        return torch.einsum("bdhw,cd->bchw", mix, Q)

    images = replacement(images, torch.zeros_like(images))
    return _edit_loop(distill, replacement, images, x, ts, steps, sched,
                      noise, generator), images


def letter_mask(image_size: int, letter: str = "S",
                font_path: str | None = None, font_size: int = 250,
                xy: tuple[int, int] = (50, 0)) -> np.ndarray:
    """(S, S) float {0,1} glyph mask (copied from the JAX package).
    ``font_size``/``xy`` default to the reference's literal constants
    (karras_diffusion.py:970-978 — sized for its 256x256 demo; scale them
    for other resolutions).  The reference draws with ``arial.ttf``; any
    available TTF is used (DejaVu by default) — same semantics, different
    glyph outline.  Without PIL a block-letter mask is returned, with a
    warning on stderr."""
    try:
        from PIL import Image, ImageDraw, ImageFont

        if font_path is None:
            import glob

            cands = ["arial.ttf"] + sorted(
                glob.glob("/usr/share/fonts/**/*Bold.ttf", recursive=True)
            ) + sorted(glob.glob("/usr/share/fonts/**/*.ttf", recursive=True))
        else:
            cands = [font_path]
        font = None
        for c in cands:
            try:
                font = ImageFont.truetype(c, font_size)
                break
            except OSError:
                continue
        if font is None:
            raise OSError("no TTF font found")
        img = Image.new("RGB", (image_size, image_size), color="white")
        ImageDraw.Draw(img).text(xy, letter, font=font, fill=(0, 0, 0))
        arr = np.array(img)[..., 0]
        # reference semantics (karras_diffusion.py:984-985): background =
        # any value > 0.5 on the uint8 canvas, glyph = pure black only
        return (arr <= 0.5).astype(np.float32)  # 1 inside the glyph
    except ImportError:
        print("letter_mask: PIL is not installed; using a block-letter "
              "mask", file=sys.stderr)
        m = np.zeros((image_size, image_size), np.float32)
        t = max(image_size // 8, 1)
        m[:t], m[-t:], m[image_size // 2 - t // 2: image_size // 2 + t // 2] = 1, 1, 1
        m[: image_size // 2, :t] = 1
        m[image_size // 2:, -t:] = 1
        return m


def iterative_inpainting(distill, images, x, ts, sched: KarrasSchedule,
                         steps: int = 40, mask=None, noise=None,
                         generator=None):
    """Inpaint: even batch rows keep the measurement OUTSIDE the glyph
    (the model paints the letter's interior), odd rows the inverse —
    the reference's alternating mask (karras_diffusion.py:979-990; there
    the alternation runs over groups of 7, an artifact of its demo batch
    — here it alternates per sample).  ``mask`` overrides the glyph
    ((H, W), 1 = glyph interior)."""
    B, C, H, W = x.shape
    if mask is None:
        mask = letter_mask(H)
    inside = torch.as_tensor(mask, dtype=torch.float32,
                             device=x.device)[None, None]
    rows = (torch.arange(B, device=x.device) % 2 == 0)[:, None, None, None]
    # 1 = keep the measurement pixel, 0 = model's to paint
    full = torch.where(rows, 1.0 - inside, inside).expand(B, C, H, W)

    def replacement(x0, x1):
        return x0 * full + x1 * (1.0 - full)

    images = replacement(images, -torch.ones_like(images))
    return _edit_loop(distill, replacement, images, x, ts, steps, sched,
                      noise, generator), images


def _patch_orthogonal_matrix(p: int) -> np.ndarray:
    """QR basis whose first axis is the patch mean
    (karras_diffusion.py:1020-1030)."""
    v = np.ones(p * p)
    v = v / np.linalg.norm(v)
    m = np.eye(p * p)
    m[:, 0] = v
    m = np.linalg.qr(m)[0]
    if np.sum(m[:, 0]) < 0:
        m = -m
    return m


def _to_patches(x, p):
    """(B, C, H, W) -> (B, (H/p)(W/p), C, p*p), patches in row-major order
    and each patch's pixels row-major, as the JAX package's NHWC layout."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // p, p, W // p, p)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(
        B, (H // p) * (W // p), C, p * p)


def _from_patches(x, p, H, W):
    B, _, C, _ = x.shape
    x = x.reshape(B, H // p, W // p, C, p, p)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(B, C, H, W)


def iterative_superres(distill, images, x, ts, sched: KarrasSchedule,
                       steps: int = 40, patch_size: int = 8, noise=None,
                       generator=None):
    """Super-resolve: constrain each pxp patch's mean to the low-res
    measurement, let the model fill intra-patch detail
    (karras_diffusion.py:1006-1123)."""
    B, C, H, W = x.shape
    p = patch_size
    Q = torch.as_tensor(_patch_orthogonal_matrix(p), dtype=torch.float32,
                        device=x.device)

    def replacement(x0, x1):
        a = torch.einsum("bncd,de->bnce", _to_patches(x0, p), Q)
        b = torch.einsum("bncd,de->bnce", _to_patches(x1, p), Q)
        mix = torch.cat([a[..., :1], b[..., 1:]], dim=-1)
        mix = torch.einsum("bnce,de->bncd", mix, Q)
        return _from_patches(mix, p, H, W)

    def average_patches(z):
        pt = _to_patches(z, p)
        return _from_patches(pt.mean(-1, keepdim=True).expand(pt.shape), p,
                             H, W)

    images = average_patches(images)
    return _edit_loop(distill, replacement, images, x, ts, steps, sched,
                      noise, generator), images
