"""RNG discipline (port of ``cmtts_tpu/core/rng.py``): batch-size- and
world-size-invariant eval sampling.

Reference ``model/cm_tool/random_util.py``: ``DummyGenerator`` (plain
RNG), ``DeterministicGenerator`` / ``DeterministicIndividualGenerator``
give every *global sample index* its own seeded stream so evaluation
noise is identical regardless of per-host batch size or world size
(config pins ``generator: determ, seed: 42``,
config/LJSpeech/train.yaml:99-101).

Here sample i of a pass draws from a ``torch.Generator`` of its own on an
explicit device, seeded from ``(seed, offset + i * world_size + rank)``.
JAX's ``fold_in`` streams cannot be reproduced in torch, so the numbers
differ from the JAX package's (and between a CPU and a CUDA generator);
the invariance is what carries over.
"""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, index: int) -> int:
    """The seed of global sample ``index``'s stream: a 63-bit mix of
    ``(seed, index)`` (numpy's ``SeedSequence``), so that neighbouring
    indices seed unrelated streams."""
    state = np.random.SeedSequence([int(seed), int(index)]).generate_state(
        1, np.uint64)[0]
    return int(state) & ((1 << 63) - 1)


class DummyGenerator:
    """One plain stream (random_util.py:6-25)."""

    def __init__(self, seed: int = 0, device: str | torch.device = "cpu"):
        self.device = torch.device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def randn(self, *shape, dtype=torch.float32) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, dtype=dtype,
                           device=self.device)

    def randint(self, low, high, shape) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape),
                             generator=self.generator, device=self.device)


class DeterministicGenerator:
    """Per-global-sample-index streams (random_util.py:28-183).

    ``randn(n, *rest)`` treats the leading dim as the batch; sample i of
    the current eval pass draws from the stream of global index
    ``offset + i * world_size + rank``, invariant to how the eval set is
    batched or sharded.
    """

    def __init__(self, seed: int = 42, rank: int = 0, world_size: int = 1,
                 device: str | torch.device = "cpu"):
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.device = torch.device(device)
        self._offset = 0

    def set_offset(self, offset: int) -> None:
        """Global index of the first sample in the next batch."""
        self._offset = int(offset)

    def advance(self, n: int) -> None:
        self._offset += int(n) * self.world_size

    def _sample_generators(self, n: int) -> list[torch.Generator]:
        return [torch.Generator(self.device).manual_seed(stream_seed(
            self.seed, self._offset + i * self.world_size + self.rank))
            for i in range(n)]

    def randn(self, *shape, dtype=torch.float32) -> torch.Tensor:
        n, rest = shape[0], tuple(shape[1:])
        return torch.stack([
            torch.randn(rest, generator=g, dtype=dtype, device=self.device)
            for g in self._sample_generators(n)])

    def randint(self, low, high, shape) -> torch.Tensor:
        n, rest = shape[0], tuple(shape[1:])
        return torch.stack([
            torch.randint(low, high, rest, generator=g, device=self.device)
            for g in self._sample_generators(n)])


def get_generator(name: str, seed: int = 42, rank: int = 0,
                  world_size: int = 1, device: str | torch.device = "cpu"):
    """Factory (random_util.py:6-14): 'dummy' | 'determ' | 'determ-indiv'
    ('determ' and 'determ-indiv' coincide: every sample has its own
    stream)."""
    if name == "dummy":
        return DummyGenerator(seed, device)
    if name in ("determ", "determ-indiv"):
        return DeterministicGenerator(seed, rank, world_size, device)
    raise NotImplementedError(name)
