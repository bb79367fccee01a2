# Copied from cmtts_tpu/train/resample.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Weighted timestep samplers — the CM-TTS paper's core contribution.

Parity source: reference ``model/cm_tool/resample.py:26-260``.  A sampler
owns a host-side weight vector over the ``num_scales - 1`` training
indices; the actual index draw happens *inside* the jitted train step
(``jax.random.categorical`` over the probability vector passed in as an
array argument), so the hot path stays on device while the
loss-second-moment history update stays host-side numpy — mirroring the
reference split (numpy weights, device sampling).

Cross-host synchronization of the LSM history (reference
``resample.py:117-153`` all_gather) is handled by updating from the
*globally addressable* per-sample loss vector under single-controller
jit; under multi-process JAX the caller routes losses through
``cmtts_tpu.parallel.sharding.gather_per_sample`` (process_allgather),
as ``cli/train_cm.py`` does — tested in
``tests/test_parallel.py::test_lsm_update_from_sharded_outputs``.
"""

from __future__ import annotations

import numpy as np


class ScheduleSampler:
    """Base: importance sampling over num_scales-1 indices
    (reference resample.py:46-81)."""

    def __init__(self, num_scales: int):
        self.n = num_scales - 1

    def weights(self) -> np.ndarray:
        raise NotImplementedError

    def probs(self) -> np.ndarray:
        w = np.asarray(self.weights(), dtype=np.float64)
        return (w / w.sum()).astype(np.float32)

    def update(self, indices: np.ndarray, losses: np.ndarray) -> None:
        """No-op for static samplers."""

    @property
    def needs_update(self) -> bool:
        return False


class UniformSampler(ScheduleSampler):
    def weights(self):
        return np.ones(self.n)


class Linear12Sampler(ScheduleSampler):
    """Weights rising 1..N toward sigma_min (reference resample.py:101-107)."""

    def weights(self):
        return np.arange(1, self.n + 1, dtype=np.float64)


class Linear21Sampler(ScheduleSampler):
    """Weights falling N..1 (reference resample.py:109-115)."""

    def weights(self):
        return np.arange(self.n, 0, -1, dtype=np.float64)


class LossSecondMomentSampler(ScheduleSampler):
    """LSM: importance weights sqrt(E[loss^2]) per index with uniform
    mixing, from a rolling per-index loss history
    (reference resample.py:206-237)."""

    def __init__(self, num_scales: int, history_per_term: int = 10,
                 uniform_prob: float = 1e-3):
        super().__init__(num_scales)
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob
        self._history = np.zeros((self.n, history_per_term), dtype=np.float64)
        self._counts = np.zeros(self.n, dtype=np.int64)

    @property
    def needs_update(self) -> bool:
        return True

    def _warmed_up(self) -> bool:
        return bool((self._counts == self.history_per_term).all())

    def weights(self):
        if not self._warmed_up():
            return np.ones(self.n, dtype=np.float64)
        w = np.sqrt((self._history ** 2).mean(axis=-1))
        w /= w.sum()
        w *= 1.0 - self.uniform_prob
        w += self.uniform_prob / len(w)
        return w

    def update(self, indices: np.ndarray, losses: np.ndarray) -> None:
        for t, loss in zip(np.asarray(indices).tolist(), np.asarray(losses).tolist()):
            if self._counts[t] == self.history_per_term:
                self._history[t, :-1] = self._history[t, 1:]
                self._history[t, -1] = loss
            else:
                self._history[t, self._counts[t]] = loss
                self._counts[t] += 1

    # checkpointable state --------------------------------------------------
    def state_dict(self) -> dict:
        return {"history": self._history.copy(), "counts": self._counts.copy()}

    def load_state_dict(self, state: dict) -> None:
        self._history = np.asarray(state["history"], dtype=np.float64)
        self._counts = np.asarray(state["counts"], dtype=np.int64)


class LogNormalSampler:
    """EDM lognormal sigma sampler (reference resample.py:240-260).
    Continuous sigmas — used by EDM-style training, not the CM grid."""

    def __init__(self, p_mean: float = -1.2, p_std: float = 1.2):
        self.p_mean = p_mean
        self.p_std = p_std

    def sample_sigmas(self, rng: np.random.RandomState, batch: int):
        log_sigmas = self.p_mean + self.p_std * rng.randn(batch)
        return np.exp(log_sigmas), np.ones(batch, dtype=np.float32)


def create_schedule_sampler(name: str, num_scales: int) -> ScheduleSampler:
    """Factory (reference resample.py:26-43)."""
    if name == "uniform":
        return UniformSampler(num_scales)
    if name == "linear12":
        return Linear12Sampler(num_scales)
    if name == "linear21":
        return Linear21Sampler(num_scales)
    if name == "loss-second-moment":
        return LossSecondMomentSampler(num_scales)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
