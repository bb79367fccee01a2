"""Consistency-model and ODE samplers for inference (port of
``cmtts_tpu/cm/sampling.py``).

The conditioning network runs once outside; samplers drive only the bare
denoiser.  Noise is an input: ``x_T`` (already scaled by sigma_max) and
``noise``, the unit normals of every later draw in the order the sampler
makes them (the multistep re-noise, the heun/dpm churn, the ancestral
noise), may be passed in so that tests can feed JAX's draws; otherwise they
are drawn from ``generator``.  The ODE samplers' sigma grid stays host
floats: heun and dpm branch on concrete sigma values.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from cmtts_tpu_torch.cm.karras import KarrasSchedule

# (x_t, sigma[B]) -> x0_hat
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
SAMPLERS = ("onestep", "multistep", "our_multistep", "euler", "heun", "dpm",
            "ancestral")


def _bcast(sigma, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(sigma, dtype=torch.float32).to(device).expand(batch)


class _Draws:
    """Unit normals shaped like ``x``: the given ones in order, else drawn
    from ``generator``."""

    def __init__(self, noise: Sequence[torch.Tensor] | None,
                 generator: torch.Generator | None):
        self.noise = None if noise is None else iter(noise)
        self.generator = generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.noise is None:
            return torch.randn(x.shape, generator=self.generator,
                               dtype=x.dtype, device=x.device)
        n = next(self.noise, None)
        if n is None:
            raise ValueError("the sampler draws more noise than was given")
        return n.to(x.device, x.dtype)


def sample_onestep(denoise: DenoiseFn, x_T: torch.Tensor,
                   sched: KarrasSchedule) -> torch.Tensor:
    """Single denoise at sigma_max."""
    return denoise(x_T, _bcast(sched.sigma_max, x_T.shape[0], x_T.device))


def sample_our_multistep(denoise: DenoiseFn, x_T: torch.Tensor,
                         sched: KarrasSchedule, T: int) -> torch.Tensor:
    """Re-apply the one-step denoiser T times at sigma_max."""
    x = x_T
    for _ in range(T):
        x = denoise(x, _bcast(sched.sigma_max, x.shape[0], x.device))
    return x


def stochastic_iterative(denoise: DenoiseFn, x_T: torch.Tensor,
                         sched: KarrasSchedule, ts: Sequence[int], steps: int,
                         noise: Sequence[torch.Tensor] | None = None,
                         generator: torch.Generator | None = None,
                         s_noise_scale: float = 0.85) -> torch.Tensor:
    """Multistep consistency sampling: denoise, re-noise to the next level
    (one draw per step)."""
    draw = _Draws(noise, generator)
    B = x_T.shape[0]
    grid = sched.ts_grid(ts, steps)
    x = x_T
    for i in range(len(ts) - 1):
        x0 = denoise(x, _bcast(grid[i], B, x.device))
        next_t = grid[i + 1]
        scale = torch.sqrt(torch.clamp(next_t ** 2 - sched.sigma_min ** 2,
                                       min=0.0)).to(x.device)
        x = x0 + draw(x) * scale * s_noise_scale
    return x


def sample_euler(denoise: DenoiseFn, x_T: torch.Tensor,
                 sigmas: np.ndarray) -> torch.Tensor:
    """Euler ODE sampler."""
    x = x_T
    B = x_T.shape[0]
    for i in range(len(sigmas) - 1):
        sigma = sigmas[i]
        denoised = denoise(x, _bcast(sigma, B, x.device))
        d = (x - denoised) / float(sigma)
        x = x + d * float(sigmas[i + 1] - sigma)
    return x


def _churn(x, sigma, n, draw, s_churn, s_tmin, s_tmax, s_noise):
    """EDM churn: raise sigma by gamma and add the matching noise."""
    gamma = (min(s_churn / n, 2 ** 0.5 - 1) if s_tmin <= sigma <= s_tmax
             else 0.0)
    sigma_hat = sigma * (gamma + 1)
    if gamma > 0:
        x = x + draw(x) * s_noise * (sigma_hat ** 2 - sigma ** 2) ** 0.5
    return x, sigma_hat


def sample_heun(denoise: DenoiseFn, x_T: torch.Tensor, sigmas: np.ndarray,
                noise: Sequence[torch.Tensor] | None = None,
                generator: torch.Generator | None = None, s_churn=0.0,
                s_tmin=0.0, s_tmax=float("inf"),
                s_noise=1.0) -> torch.Tensor:
    """Heun (EDM Algorithm 2) sampler; one churn draw per step when
    ``s_churn > 0``."""
    draw = _Draws(noise, generator)
    x = x_T
    B = x_T.shape[0]
    n = len(sigmas) - 1
    for i in range(n):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x, sigma_hat = _churn(x, sigma, n, draw, s_churn, s_tmin, s_tmax,
                              s_noise)
        denoised = denoise(x, _bcast(sigma_hat, B, x.device))
        d = (x - denoised) / sigma_hat
        dt = sigma_next - sigma_hat
        if sigma_next == 0:
            x = x + d * dt
        else:
            x2 = x + d * dt
            denoised2 = denoise(x2, _bcast(sigma_next, B, x.device))
            d2 = (x2 - denoised2) / sigma_next
            x = x + (d + d2) / 2 * dt
    return x


def sample_dpm(denoise: DenoiseFn, x_T: torch.Tensor, sigmas: np.ndarray,
               noise: Sequence[torch.Tensor] | None = None,
               generator: torch.Generator | None = None, s_churn=0.0,
               s_tmin=0.0, s_tmax=float("inf"), s_noise=1.0) -> torch.Tensor:
    """DPM-Solver-2-style midpoint sampler; churn as in :func:`sample_heun`."""
    draw = _Draws(noise, generator)
    x = x_T
    B = x_T.shape[0]
    n = len(sigmas) - 1
    for i in range(n):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x, sigma_hat = _churn(x, sigma, n, draw, s_churn, s_tmin, s_tmax,
                              s_noise)
        denoised = denoise(x, _bcast(sigma_hat, B, x.device))
        d = (x - denoised) / sigma_hat
        sigma_mid = ((sigma_hat ** (1 / 3) + sigma_next ** (1 / 3)) / 2) ** 3
        dt_1 = sigma_mid - sigma_hat
        dt_2 = sigma_next - sigma_hat
        x2 = x + d * dt_1
        denoised2 = denoise(x2, _bcast(sigma_mid, B, x.device))
        d2 = (x2 - denoised2) / sigma_mid
        x = x + d2 * dt_2
    return x


def sample_euler_ancestral(denoise: DenoiseFn, x_T: torch.Tensor,
                           sigmas: np.ndarray,
                           noise: Sequence[torch.Tensor] | None = None,
                           generator: torch.Generator | None = None
                           ) -> torch.Tensor:
    """Ancestral Euler sampler; one draw per step that ends above 0."""
    draw = _Draws(noise, generator)
    x = x_T
    B = x_T.shape[0]
    for i in range(len(sigmas) - 1):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        denoised = denoise(x, _bcast(sigma, B, x.device))
        sigma_up = (sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2)
                    / sigma ** 2) ** 0.5
        sigma_down = (sigma_next ** 2 - sigma_up ** 2) ** 0.5
        d = (x - denoised) / sigma
        x = x + d * (sigma_down - sigma)
        if sigma_next > 0:
            x = x + draw(x) * sigma_up
    return x


def default_ts(T: int) -> tuple[int, ...]:
    """--T to multistep ts: T=2 -> (0,0,1); T=4 -> (0,0,0,0,1)."""
    if T == 2:
        return (0, 0, 1)
    if T == 4:
        return (0, 0, 0, 0, 1)
    return tuple([0] * T + [1])


def ode_sigmas(sched: KarrasSchedule, steps: int) -> np.ndarray:
    """Karras grid of ``steps`` levels from sigma_max down to sigma_min,
    then 0: host float64, as the ODE samplers branch on its values."""
    ramp = np.linspace(0.0, 1.0, steps)
    lo = sched.sigma_min ** (1 / sched.rho)
    hi = sched.sigma_max ** (1 / sched.rho)
    return np.append((hi + ramp * (lo - hi)) ** sched.rho, 0.0)


def sample_mel(denoise: DenoiseFn, shape: tuple, sched: KarrasSchedule,
               sampler: str = "onestep", T: int = 1, steps: int = 2,
               ts: Sequence[int] | None = None,
               x_T: torch.Tensor | None = None,
               noise: Sequence[torch.Tensor] | None = None,
               generator: torch.Generator | None = None,
               device: torch.device | str = "cpu", s_churn: float = 0.0,
               s_tmin: float = 0.0, s_noise: float = 1.0,
               s_tmax: float = float("inf")) -> torch.Tensor:
    """Draw x_T ~ N(0, sigma_max^2) (unless given) and run the sampler.
    ``steps`` is the multistep grid size and the ODE samplers' level
    count."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler}")
    if x_T is None:
        x_T = torch.randn(shape, generator=generator, dtype=torch.float32,
                          device=device) * sched.sigma_max
    if sampler == "onestep":
        return sample_onestep(denoise, x_T, sched)
    if sampler == "our_multistep":
        return sample_our_multistep(denoise, x_T, sched, T)
    if sampler == "multistep":
        return stochastic_iterative(denoise, x_T, sched, ts or default_ts(T),
                                    steps, noise=noise, generator=generator)
    sigmas = ode_sigmas(sched, steps)
    if sampler == "euler":
        return sample_euler(denoise, x_T, sigmas)
    if sampler == "ancestral":
        return sample_euler_ancestral(denoise, x_T, sigmas, noise, generator)
    fn = sample_heun if sampler == "heun" else sample_dpm
    return fn(denoise, x_T, sigmas, noise, generator, s_churn, s_tmin, s_tmax,
              s_noise)
