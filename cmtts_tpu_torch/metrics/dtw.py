# Port of cmtts_tpu/metrics/dtw.py (jax-free): the same DP, costs and tie
# order, with the cell loops over Python floats and the FastDTW window
# built in numpy, so that a waveform alignment takes seconds, not minutes.
"""Dynamic time warping: replacements for the reference's ``fastdtw``
(path) and ``librosa.sequence.dtw`` (accumulated cost).

``dtw_path`` is exact O(N*M) DP for short sequences and switches to the
FastDTW algorithm (Salvador & Chan 2007: recursive 2x coarsening +
radius-constrained banded DP) for long ones — the reference aligns raw
waveforms with fastdtw (all_metrics.py:281-304), where exact DP would be
O(22050^2).  Every cost is the same float64 sum as the JAX package's, and
ties go to the first of (diagonal, up, left), so the paths are equal.
"""

from __future__ import annotations

import math

import numpy as np

_EXACT_LIMIT = 500 * 500


def _pairwise_dist(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return np.sqrt(np.maximum(
        (x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None, :] - 2 * x @ y.T, 0.0))


def _exact_path(x: np.ndarray, y: np.ndarray) -> list[tuple[int, int]]:
    N, M = len(x), len(y)
    d = _pairwise_dist(x, y).tolist()
    inf = math.inf
    D = [[0.0] + [inf] * M] + [[inf] * (M + 1) for _ in range(N)]
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
        costs = [D[a][b] if a >= 1 and b >= 1 else inf for a, b in steps]
        i, j = steps[int(np.argmin(costs))]
    path.append((0, 0))
    return path[::-1]


def _cell_dist(x: np.ndarray, y: np.ndarray, I: np.ndarray,
               J: np.ndarray) -> list[float]:
    """``np.linalg.norm(x[i] - y[j])`` (``sqrt(v @ v)``) of every window
    cell, bit for bit: one vector op for one feature, a row dot each
    otherwise."""
    v = x[I] - y[J]
    if v.shape[1] == 1:
        return np.sqrt(v[:, 0] * v[:, 0]).tolist()
    return [math.sqrt(r.dot(r)) for r in v]


def _banded_path(x: np.ndarray, y: np.ndarray, I: np.ndarray,
                 J: np.ndarray) -> list[tuple[int, int]]:
    """DP restricted to the window cells ``(I[k], J[k])`` (sorted
    lexicographically).  A cell is keyed ``(i + 1) * S + j + 1`` with
    ``S = len(y) + 1``, so that ``(-1, -1)`` is 0 and a column -1 is no
    cell."""
    S = len(y) + 1
    inf = math.inf
    D = {0: 0.0}
    P = {}
    get = D.get
    for i, j, dist in zip(I.tolist(), J.tolist(), _cell_dist(x, y, I, J)):
        k = (i + 1) * S + j + 1
        best, arg = inf, None
        for p in (k - S - 1, k - S, k - 1):        # diagonal, up, left
            v = get(p, inf)
            if v < best:
                best, arg = v, p
        if arg is None:
            continue
        D[k] = best + dist
        P[k] = arg
    # backtrack
    node = len(x) * S + len(y)
    path = []
    while node != 0:
        path.append((node // S - 1, node % S - 1))
        node = P[node]
    return path[::-1]


def _expand_window(path: list[tuple[int, int]], n: int, m: int,
                   radius: int) -> tuple[np.ndarray, np.ndarray]:
    """The coarse path widened by ``radius`` and projected to the finer
    resolution (each coarse cell -> 2x2 fine cells), clipped to n x m ->
    the cells' rows and columns, sorted lexicographically."""
    p = np.asarray(path, np.int64)
    r = np.arange(-radius, radius + 1)
    ci = (p[:, 0, None] + r[None, :])[:, :, None].repeat(len(r), 2)
    cj = (p[:, 1, None] + r[None, :])[:, None, :].repeat(len(r), 1)
    two = np.array([0, 1])
    fi = (2 * ci.reshape(-1, 1) + two[None, :])[:, :, None].repeat(2, 2)
    fj = (2 * cj.reshape(-1, 1) + two[None, :])[:, None, :].repeat(2, 1)
    fi, fj = fi.reshape(-1), fj.reshape(-1)
    keep = (fi >= 0) & (fi < n) & (fj >= 0) & (fj < m)
    cells = np.unique(fi[keep] * m + fj[keep])
    return cells // m, cells % m


def _fastdtw(x: np.ndarray, y: np.ndarray, radius: int = 1) -> list[tuple[int, int]]:
    n, m = len(x), len(y)
    if n * m <= _EXACT_LIMIT or n <= radius + 2 or m <= radius + 2:
        return _exact_path(x, y)
    # coarsen by 2 (average adjacent pairs)
    def half(a):
        k = len(a) // 2
        return (a[: 2 * k : 2] + a[1 : 2 * k : 2]) / 2.0

    coarse_path = _fastdtw(half(x), half(y), radius)
    return _banded_path(x, y, *_expand_window(coarse_path, n, m, radius))


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
