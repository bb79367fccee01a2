"""Consistency-model samplers for inference (port of the onestep and
multistep parts of ``cmtts_tpu/cm/sampling.py``).

The conditioning network runs once outside; samplers drive only the bare
denoiser.  Noise is an input: ``x_T`` (already scaled by sigma_max) and the
per-step unit normals may be passed in, so that tests can feed JAX's draws;
otherwise they are drawn from ``generator``.  The ODE samplers (euler,
heun, dpm, ancestral) and ``our_multistep`` are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from cmtts_tpu_torch.cm.karras import KarrasSchedule

# (x_t, sigma[B]) -> x0_hat
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _bcast(sigma, batch: int, device) -> torch.Tensor:
    return torch.as_tensor(sigma, dtype=torch.float32).to(device).expand(batch)


def sample_onestep(denoise: DenoiseFn, x_T: torch.Tensor,
                   sched: KarrasSchedule) -> torch.Tensor:
    """Single denoise at sigma_max."""
    return denoise(x_T, _bcast(sched.sigma_max, x_T.shape[0], x_T.device))


def stochastic_iterative(denoise: DenoiseFn, x_T: torch.Tensor,
                         sched: KarrasSchedule, ts: Sequence[int], steps: int,
                         noise: Sequence[torch.Tensor] | None = None,
                         generator: torch.Generator | None = None,
                         s_noise_scale: float = 0.85) -> torch.Tensor:
    """Multistep consistency sampling: denoise, re-noise to the next level.
    ``noise[i]`` is the unit normal of step i (drawn when not given)."""
    B = x_T.shape[0]
    grid = sched.ts_grid(ts, steps)
    x = x_T
    for i in range(len(ts) - 1):
        x0 = denoise(x, _bcast(grid[i], B, x.device))
        next_t = grid[i + 1]
        if noise is not None:
            n = noise[i].to(x.device, x.dtype)
        else:
            n = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                            device=x.device)
        scale = torch.sqrt(torch.clamp(next_t ** 2 - sched.sigma_min ** 2,
                                       min=0.0)).to(x.device)
        x = x0 + n * scale * s_noise_scale
    return x


def default_ts(T: int) -> tuple[int, ...]:
    """--T to multistep ts: T=2 -> (0,0,1); T=4 -> (0,0,0,0,1)."""
    if T == 2:
        return (0, 0, 1)
    if T == 4:
        return (0, 0, 0, 0, 1)
    return tuple([0] * T + [1])


def sample_mel(denoise: DenoiseFn, shape: tuple, sched: KarrasSchedule,
               sampler: str = "onestep", T: int = 1, steps: int = 2,
               ts: Sequence[int] | None = None,
               x_T: torch.Tensor | None = None,
               noise: Sequence[torch.Tensor] | None = None,
               generator: torch.Generator | None = None,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """Draw x_T ~ N(0, sigma_max^2) (unless given) and run the sampler."""
    if x_T is None:
        x_T = torch.randn(shape, generator=generator, dtype=torch.float32,
                          device=device) * sched.sigma_max
    if sampler == "onestep":
        return sample_onestep(denoise, x_T, sched)
    if sampler == "multistep":
        return stochastic_iterative(denoise, x_T, sched, ts or default_ts(T),
                                    steps, noise=noise, generator=generator)
    raise NotImplementedError(f"sampler {sampler!r} is not ported yet")
