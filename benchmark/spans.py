"""What the span metrics read: the program's frame log
(``icet_tpu_torch.utils.profiling.frame_log``) lined up with the run.

Every ``session.step`` call of a run is one frame of the log, in order, so
the log's frame ``seq`` i is ``ctx.records[i]``.  The metrics read the
window's frames, which no profiler traces.  Where the program has no frame
log, or the log and the run do not line up, there is nothing to read: the
metrics return None, with a note.
"""

from __future__ import annotations

import numpy as np


def window(ctx) -> dict | None:
    """The frame log's records of the window's frames (the arrays of
    ``FrameLog.records()``, one row a window frame), or None."""
    from icet_tpu_torch.utils import profiling

    log = getattr(profiling, "frame_log", None)
    if log is None:
        ctx.note("frame log: the program has none")
        return None
    rec = log.records()
    seq = rec["seq"]
    frames = int(seq[-1]) + 1 if len(seq) else 0
    if frames != len(ctx.records):
        ctx.note(f"frame log: {frames} frames against the run's {len(ctx.records)} steps")
        return None
    idx = np.array([i for i, r in enumerate(ctx.records) if r["window"]], np.int64)
    if not len(idx) or idx[0] < seq[0]:
        ctx.note(f"frame log: the ring ({len(seq)} frames) does not hold the window")
        return None
    rows = idx - seq[0]
    return {k: v[rows] if isinstance(v, np.ndarray) else v for k, v in rec.items()}


def slots(rec: dict, name: str | None = None) -> np.ndarray:
    """``(frames, spans)`` mask of the span slots in use, named ``name``
    where given (the root is slot 0)."""
    used = np.arange(rec["name"].shape[1])[None, :] < rec["n_spans"][:, None]
    if name is None:
        return used
    if name not in rec["names"]:
        return np.zeros_like(used)
    return used & (rec["name"] == rec["names"].index(name))


def device_ms(ctx, name: str) -> float | None:
    """Device milliseconds a window frame of the spans named ``name``."""
    rec = window(ctx)
    if rec is None:
        return None
    mask = slots(rec, name)
    ms = np.where(mask, rec["device_ms"], 0.0)
    if not mask.any() or np.isnan(ms).any():
        ctx.note(f"frame log: no device times of '{name}' in the window")
        return None
    per = ms.sum(axis=1)
    ctx.note(f"frame log: '{name}' device ms a frame median {np.median(per):.6f}, "
             f"min {per.min():.6f}, max {per.max():.6f} over {len(per)} frames")
    return float(per.mean())
