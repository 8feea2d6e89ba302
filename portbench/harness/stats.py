"""The arithmetic that turns timings into metrics.

`interval_union_us` is copied from the port's on-card smoke script
(`chip_smoke.interval_union_us`), so that a later change there cannot
move the yardstick.
"""

from __future__ import annotations


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of every value, by linear
    interpolation between the order statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    if len(v) == 1:
        return float(v[0])
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def interval_union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s0, e0 in sorted(spans):
        if cur_e is None or s0 > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def merged_intervals(spans) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s0, e0 in sorted(spans):
        if out and s0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e0)
        else:
            out.append([s0, e0])
    return out
