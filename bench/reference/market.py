"""A frozen copy of the engine's market tick for spot scenarios.

The engine draws every random number from a counter-based hash of
(seed, absolute tick, stream, lane): MurmurHash3's 32-bit finalizer over
words offset by multiples of the golden-ratio constant, and a float32
uniform from the hash's top 24 bits. This file repeats that arithmetic in
plain integer numpy, so a copy of it decides the same active masks, running
gates and iteration counters as the program, without reading the program's.

A spot worker is active on a tick when its bid covers the price; the tick
runs when at least one worker is active and the cell has iterations left.
Only uniform prices and single-bucket bid tables are covered: the cells'
scenarios use nothing else.
"""
from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
STREAM_PRICE, STREAM_DUR, STREAM_GRAD, STREAM_UP = 0, 1, 2, 3
BID_EPS = 1e-12


def fmix32(h: np.ndarray) -> np.ndarray:
    """MurmurHash3's 32-bit finalizer, on uint64 holding 32-bit values."""
    h = h.astype(np.uint64)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & np.uint64(M32)
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & np.uint64(M32)
    return h ^ (h >> np.uint64(16))


def hash_words(*words) -> np.ndarray:
    """The 32-bit hash of broadcastable integer words."""
    h = None
    for i, w in enumerate(words):
        w = np.asarray(w, dtype=np.int64).astype(np.uint64)
        x = fmix32((w + np.uint64(GOLDEN * (i + 1))) & np.uint64(M32))
        h = x if h is None else fmix32(h ^ x)
    return h


def uniform(h: np.ndarray) -> np.ndarray:
    """float32 uniform on [0, 1) from the top 24 bits of a hash."""
    return (h >> np.uint64(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))


def tick(seeds: np.ndarray, k: int, j: np.ndarray, bids: np.ndarray,
         lo: float, hi: float, J: int):
    """One spot tick for every seed: ``seeds`` (R,), iterations done ``j``
    (R,), the bid table ``bids`` (J_max, N) of one scenario. Returns
    (mask (R, N) bool, y (R,) float32, running (R,) bool)."""
    seeds = np.asarray(seeds, np.int64)
    u = uniform(hash_words(seeds, k, STREAM_PRICE, 0))
    price = np.float32(lo) + u * (np.float32(hi) - np.float32(lo))
    row = np.minimum(j, bids.shape[0] - 1)
    mask = bids[row] >= (price - np.float32(BID_EPS))[:, None]
    y = mask.astype(np.float32).sum(-1)
    running = (y >= 1.0) & (j < J)
    return mask, y, running


def replay(seeds, n_ticks: int, bids, lo, hi, J, tick0: int = 0,
           j0=None):
    """Ticks ``tick0 … tick0+n_ticks-1`` from iteration counts ``j0``.
    Returns (j after each tick (n_ticks, R), and per seed the list of
    (tick, mask (N,), y) of every iteration that ran)."""
    seeds = np.asarray(seeds, np.int64)
    j = np.zeros(len(seeds), np.int64) if j0 is None else np.array(j0)
    js, iters = [], [[] for _ in seeds]
    for k in range(tick0, tick0 + n_ticks):
        mask, y, running = tick(seeds, k, j, bids, lo, hi, J)
        for r in np.flatnonzero(running):
            iters[r].append((k, mask[r].copy(), float(y[r])))
        j = j + running
        js.append(j.copy())
    return np.array(js), iters
