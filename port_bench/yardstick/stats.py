"""Statistics over all the frames of a measured window."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, by linear interpolation
    between the two nearest ranks (numpy's default rule): no value is left
    out and no median of chunks is taken."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def per_item_ms(seconds: float, items: int) -> float:
    """Milliseconds per item over a whole window."""
    return 1e3 * seconds / items


def per_second(items: int, seconds: float) -> float:
    """Items per second over a whole window."""
    return items / seconds
