# Copied from cmtts_tpu/metrics/dtw.py (jax-free) so that the port imports nothing of cmtts_tpu.
"""Dynamic time warping: replacements for the reference's ``fastdtw``
(path) and ``librosa.sequence.dtw`` (accumulated cost).

``dtw_path`` is exact O(N*M) DP for short sequences and switches to the
FastDTW algorithm (Salvador & Chan 2007: recursive 2x coarsening +
radius-constrained banded DP) for long ones — the reference aligns raw
waveforms with fastdtw (all_metrics.py:281-304), where exact DP would be
O(22050^2).
"""

from __future__ import annotations

import numpy as np

_EXACT_LIMIT = 500 * 500


def _pairwise_dist(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.sqrt(np.maximum(
        (x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None, :] - 2 * x @ y.T, 0.0))


def _exact_path(x: np.ndarray, y: np.ndarray) -> list[tuple[int, int]]:
    N, M = len(x), len(y)
    d = _pairwise_dist(x, y)
    D = np.full((N + 1, M + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, N + 1):
        row = D[i]
        up = D[i - 1]
        di = d[i - 1]
        for j in range(1, M + 1):
            row[j] = di[j - 1] + min(up[j - 1], up[j], row[j - 1])
    path = []
    i, j = N, M
    while i > 1 or j > 1:
        path.append((i - 1, j - 1))
        steps = [(i - 1, j - 1), (i - 1, j), (i, j - 1)]
        costs = [D[a, b] if a >= 1 and b >= 1 else np.inf for a, b in steps]
        i, j = steps[int(np.argmin(costs))]
    path.append((0, 0))
    return path[::-1]


def _banded_path(x: np.ndarray, y: np.ndarray,
                 window: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """DP restricted to ``window`` cells (sorted lexicographically)."""
    INF = np.inf
    D: dict[tuple[int, int], float] = {(-1, -1): 0.0}
    P: dict[tuple[int, int], tuple[int, int]] = {}
    for i, j in window:
        dist = float(np.linalg.norm(x[i] - y[j]))
        best, arg = INF, None
        for pi, pj in ((i - 1, j - 1), (i - 1, j), (i, j - 1)):
            v = D.get((pi, pj), INF)
            if v < best:
                best, arg = v, (pi, pj)
        if (i, j) == (0, 0):
            best, arg = 0.0, (-1, -1)
        if arg is None:
            continue
        D[(i, j)] = best + dist
        P[(i, j)] = arg
    # backtrack
    node = (len(x) - 1, len(y) - 1)
    path = []
    while node != (-1, -1):
        path.append(node)
        node = P[node]
    return path[::-1]


def _expand_window(path: list[tuple[int, int]], n: int, m: int,
                   radius: int) -> list[tuple[int, int]]:
    cells = set()
    for i, j in path:
        for a in range(-radius, radius + 1):
            for b in range(-radius, radius + 1):
                cells.add((i + a, j + b))
    # project to the finer resolution (each coarse cell -> 2x2 fine cells)
    fine = set()
    for i, j in cells:
        for a in (0, 1):
            for b in (0, 1):
                ii, jj = 2 * i + a, 2 * j + b
                if 0 <= ii < n and 0 <= jj < m:
                    fine.add((ii, jj))
    return sorted(fine)


def _fastdtw(x: np.ndarray, y: np.ndarray, radius: int = 1) -> list[tuple[int, int]]:
    n, m = len(x), len(y)
    if n * m <= _EXACT_LIMIT or n <= radius + 2 or m <= radius + 2:
        return _exact_path(x, y)
    # coarsen by 2 (average adjacent pairs)
    def half(a):
        k = len(a) // 2
        return (a[: 2 * k : 2] + a[1 : 2 * k : 2]) / 2.0

    coarse_path = _fastdtw(half(x), half(y), radius)
    window = _expand_window(coarse_path, n, m, radius)
    return _banded_path(x, y, window)


def dtw_path(x: np.ndarray, y: np.ndarray,
             radius: int = 1) -> list[tuple[int, int]]:
    """DTW path between (N, D) and (M, D) sequences — drop-in for
    ``fastdtw(x, y)[1]``."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if y.ndim == 1:
        y = y[:, None]
    return _fastdtw(x, y, radius)


def dtw_cost(X: np.ndarray, Y: np.ndarray, metric) -> np.ndarray:
    """Accumulated-cost matrix a la ``librosa.sequence.dtw(X, Y, metric)``
    with feature-major inputs (D, N) / (D, M) and a custom frame metric.
    Returns D of shape (N, M); the reference uses ``np.mean(min_cost)``."""
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    N, M = X.shape[1], Y.shape[1]
    C = np.empty((N, M))
    for i in range(N):
        xi = X[:, i]
        for j in range(M):
            C[i, j] = metric(xi, Y[:, j])
    D = np.full((N + 1, M + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, N + 1):
        row = D[i]
        up = D[i - 1]
        ci = C[i - 1]
        for j in range(1, M + 1):
            row[j] = ci[j - 1] + min(up[j - 1], up[j], row[j - 1])
    return D[1:, 1:]


def align_by_path(f1: np.ndarray, f2: np.ndarray,
                  path: list[tuple[int, int]]) -> tuple[np.ndarray, np.ndarray]:
    """Index feature-major arrays (D, N) by a DTW path -> (L, D) pairs
    (the reference's ``aligned = f[:, [p[k] for p in path]].T``)."""
    i1 = [p[0] for p in path]
    i2 = [p[1] for p in path]
    return f1[:, i1].T, f2[:, i2].T
