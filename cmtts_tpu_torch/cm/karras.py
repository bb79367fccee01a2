"""Karras/EDM consistency-model math (port of ``cmtts_tpu/cm/karras.py``
and ``cmtts_tpu/train/loop.py::schedule_from_config``): the sampling
scalings and grids, and the training half (the index grid, loss weights).

Functions take tensors or Python floats and compute in the input's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cmtts_tpu_torch.core.config import Config


@dataclass(frozen=True)
class KarrasSchedule:
    sigma_data: float = 0.5
    sigma_max: float = 80.0
    sigma_min: float = 0.002
    rho: float = 7.0
    distillation: bool = True  # consistency modes use boundary scalings

    def scalings(self, sigma: torch.Tensor):
        """EDM pre/post-conditioning: (c_skip, c_out, c_in)."""
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = sigma * self.sigma_data / torch.sqrt(sigma ** 2 + sd2)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + sd2)
        return c_skip, c_out, c_in

    def boundary_scalings(self, sigma: torch.Tensor):
        """CM boundary-condition scalings: identity at sigma_min."""
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / ((sigma - self.sigma_min) ** 2 + sd2)
        c_out = ((sigma - self.sigma_min) * self.sigma_data
                 / torch.sqrt(sigma ** 2 + sd2))
        c_in = 1.0 / torch.sqrt(sigma ** 2 + sd2)
        return c_skip, c_out, c_in

    def active_scalings(self, sigma: torch.Tensor):
        if self.distillation:
            return self.boundary_scalings(sigma)
        return self.scalings(sigma)

    def rescale_t(self, sigma: torch.Tensor) -> torch.Tensor:
        """sigma -> network timestep input: 250 * ln(sigma + 1e-44)."""
        return 1000.0 * 0.25 * torch.log(sigma + 1e-44)

    def snr(self, sigma: torch.Tensor) -> torch.Tensor:
        return sigma ** -2.0

    def t_of_index(self, indices: torch.Tensor,
                   num_scales: int) -> torch.Tensor:
        """Training grid: index i in [0, num_scales - 1) -> sigma, from
        sigma_max (i = 0) toward sigma_min (float32)."""
        lo = self.sigma_min ** (1.0 / self.rho)
        hi = self.sigma_max ** (1.0 / self.rho)
        t = hi + indices.float() / (num_scales - 1) * (lo - hi)
        return t ** self.rho

    def ts_grid(self, ts, steps: int) -> torch.Tensor:
        """Multistep-sampler sigma grid over ``steps`` levels, clipped to
        [sigma_min, sigma_max] (float32, on the CPU)."""
        lo = self.sigma_min ** (1.0 / self.rho)
        hi = self.sigma_max ** (1.0 / self.rho)
        t = torch.as_tensor(ts, dtype=torch.float32)
        t = (hi + t / (steps - 1) * (lo - hi)) ** self.rho
        return torch.clamp(t, self.sigma_min, self.sigma_max)


def get_sigmas_karras(n: int, sigma_min: float, sigma_max: float,
                      rho: float = 7.0) -> torch.Tensor:
    """Karras noise schedule of ``n`` levels with a 0 appended (float32)."""
    ramp = torch.linspace(0.0, 1.0, n)
    lo = sigma_min ** (1.0 / rho)
    hi = sigma_max ** (1.0 / rho)
    return torch.cat([(hi + ramp * (lo - hi)) ** rho, torch.zeros(1)])


def get_weightings(weight_schedule: str, snrs: torch.Tensor,
                   sigma_data: float) -> torch.Tensor:
    """Loss weight per noise level."""
    if weight_schedule == "snr":
        return snrs
    if weight_schedule == "snr+1":
        return snrs + 1.0
    if weight_schedule == "karras":
        return snrs + 1.0 / sigma_data ** 2
    if weight_schedule == "truncated-snr":
        return torch.clamp(snrs, min=1.0)
    if weight_schedule == "uniform":
        return torch.ones_like(snrs)
    raise NotImplementedError(weight_schedule)


def append_dims(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Right-pad the shape with singleton dims up to ``ndim``."""
    return x.reshape(x.shape + (1,) * (ndim - x.ndim))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dims."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def schedule_from_config(cfg: Config) -> KarrasSchedule:
    cm = cfg.train.cm
    return KarrasSchedule(
        sigma_data=cm.sigma_data,
        sigma_max=cm.sigma_max,
        sigma_min=cm.sigma_min,
        rho=cm.rho,
        distillation="consistency" in cm.training_mode,
    )
