"""The benchmark's arithmetic, frozen here so that no change to the program
moves it: whole-window rates, percentiles over every sample, the union of
device intervals, roofline bounds from the card's published peaks, and the
trajectory error (a copy of the port's ``utils.metrics.ate_rmse``).
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM, published (data sheet, dense, at the full 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def rate(count: int, seconds: float) -> float:
    """Work completed over the whole window's seconds."""
    return count / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, interpolated
    linearly between order statistics (numpy's default, written out)."""
    v = sorted(float(x) for x in values)
    if not v:
        raise ValueError("percentile of no values")
    h = (len(v) - 1) * q / 100.0
    lo = int(h)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (h - lo)


def busy(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals, start: float, stop: float):
    """``(gap start, gap length)`` of every stretch of ``[start, stop]``
    that no interval covers."""
    out, end = [], start
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, s - end))
        end = max(end, e)
    if stop > end:
        out.append((end, stop - end))
    return out


def bound_ms(nbytes: float, nops: float, peak_ops: float = PEAK_FP32_PER_S):
    """``(ms, "bytes" or "operations")``: the least time the card could take
    for ``nbytes`` moved and ``nops`` operations at its published peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, nops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ate_rmse(poses_est, poses_ref) -> float:
    """RMSE of translation between 4x4 pose lists, each taken relative to
    its own first frame."""
    est = [np.asarray(p, np.float64) for p in poses_est]
    ref = [np.asarray(p, np.float64) for p in poses_ref]
    if len(est) != len(ref) or not est:
        raise ValueError("trajectory length mismatch")
    e0, r0 = np.linalg.inv(est[0]), np.linalg.inv(ref[0])
    err = [np.linalg.norm((e0 @ e)[:3, 3] - (r0 @ r)[:3, 3]) for e, r in zip(est, ref)]
    return float(np.sqrt(np.mean(np.square(err))))

