"""Shape bucketing for jit-compiled kernels.

XLA compiles one executable per input shape; SLAM's per-call problem sizes
(match counts, BA problem sizes, fuse candidate sets) vary every frame. All
host->device call sites pad their dynamic dimension to a power-of-two bucket
so the number of distinct compilations stays O(log N) for the session
(SURVEY.md §7 'padded/bucketed static shapes + recompile guard rails').
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)


def bucket(n: int, minimum: int = 64) -> int:
    """Smallest power-of-two >= n (and >= minimum)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def pad_rows(arr: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad (or truncate, with a warning) the leading axis to length n."""
    if len(arr) == n:
        return arr
    if len(arr) > n:
        log.warning("pad_rows: truncating %d -> %d rows (%s)", len(arr), n, arr.dtype)
        return arr[:n]
    pad = np.full((n - len(arr),) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)
