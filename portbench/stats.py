"""The arithmetic the readers share: percentiles, the union of intervals
and the gaps between them, a median from a cumulative histogram, and a
count in a time range. Plain Python, no program code."""

from __future__ import annotations

import bisect
import math


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0..100) by linear interpolation between the
    closest ranks (numpy's default); None for no values. ``inf`` values
    (failed requests) sort last."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals, overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float) -> list:
    """The ``(start, end)`` stretches of [start, end] that no interval
    covers, longest first."""
    out, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            out.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        out.append((cursor, end))
    return sorted((g for g in out if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])


def histogram_median(bounds, before, after) -> float | None:
    """The median of the observations a cumulative histogram gained
    between two snapshots (``before``/``after``: per-bucket counts on
    ``bounds``, the last bucket unbounded), interpolated linearly inside
    its bucket; None when it gained none."""
    counts = [a - b for a, b in zip(after, before)]
    n = sum(counts)
    if n <= 0:
        return None
    half, seen = n / 2.0, 0
    for i, c in enumerate(counts):
        if c and seen + c >= half:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else lo
            return lo + (hi - lo) * (half - seen) / c
        seen += c
    return None


def count_in(times, start: float, end: float) -> int:
    """How many of the sorted ``times`` lie in [start, end)."""
    return bisect.bisect_left(times, end) - bisect.bisect_left(times, start)
