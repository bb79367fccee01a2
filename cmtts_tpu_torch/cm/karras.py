"""Karras/EDM consistency-model math (port of ``cmtts_tpu/cm/karras.py``
and ``cmtts_tpu/train/loop.py::schedule_from_config``).

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

    def ts_grid(self, ts, steps: int) -> torch.Tensor:
        """Multistep-sampler sigma grid over ``steps`` levels, clipped to
        [sigma_min, sigma_max] (float32, on the CPU)."""
        lo = self.sigma_min ** (1.0 / self.rho)
        hi = self.sigma_max ** (1.0 / self.rho)
        t = torch.as_tensor(ts, dtype=torch.float32)
        t = (hi + t / (steps - 1) * (lo - hi)) ** self.rho
        return torch.clamp(t, self.sigma_min, self.sigma_max)


def schedule_from_config(cfg: Config) -> KarrasSchedule:
    cm = cfg.train.cm
    return KarrasSchedule(
        sigma_data=cm.sigma_data,
        sigma_max=cm.sigma_max,
        sigma_min=cm.sigma_min,
        rho=cm.rho,
        distillation="consistency" in cm.training_mode,
    )
