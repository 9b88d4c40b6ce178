"""The yardstick's arithmetic: rates over a whole window, tails, the union
of device intervals, idle gaps and the table of peaks.  Kept here, apart
from the program, so that a change to the program cannot move it."""

from __future__ import annotations

import re

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # one NVIDIA H100 SXM's HBM3, NVIDIA's data sheet
ENCODE_BATCH_FRAMES = 768  # the encode batch the work is counted in (frames)
MB = 1e6  # x3-rust's MB: 10^6 bytes of int16 audio


def window_rate(nbytes: float, start: float, end: float) -> float:
    """MB/s of all the bytes of all completed calls over the whole window,
    from its start to the end of the last call in flight."""
    return nbytes / MB / (end - start)


def p95(values) -> float:
    """The 95th percentile (numpy's linear interpolation) of every value."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the merged intervals cover."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that the merged intervals leave uncovered."""
    out, t = [], lo
    for a, b in merged:
        if b <= t:
            continue
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def clean_name(name: str) -> str:
    """A profiler row's name as the breakdown gives it: runs of characters
    other than letters, digits, '_', '.', ':' and '-' made one '_', cut to
    64 characters."""
    return re.sub(r"[^A-Za-z0-9_.:\-]+", "_", name)[:64]


def top(sums: dict, k: int = 10) -> list[list]:
    return [[n, v] for n, v in sorted(sums.items(), key=lambda kv: -kv[1])[:k]]
