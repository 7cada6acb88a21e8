"""What the value metrics read: the frame log's named per-frame values
(``FrameLog.values``: counts, and device milliseconds timed inside a
replay) of the window's frames, lined up with the run as
:mod:`benchmark.spans` lines up the spans.  Where the program's log has
no such value, there is nothing to read: None, with a note."""

from __future__ import annotations

import numpy as np

from benchmark import spans


def window(ctx, name: str) -> np.ndarray | None:
    """The value ``name`` of each window frame, or None."""
    rec = spans.window(ctx)
    if rec is None:
        return None
    names = rec.get("value_names", ())
    if name not in names:
        ctx.note(f"frame log: no value '{name}'")
        return None
    return rec["values"][:, list(names).index(name)]


def mean(ctx, name: str) -> float | None:
    """The mean of the value ``name`` over the window's frames, or None
    where a frame lacks it (NaN: no device time)."""
    per = window(ctx, name)
    if per is None or not len(per) or np.isnan(per).any():
        return None
    ctx.note(f"frame log: '{name}' a window frame median {np.median(per):.6f}, "
             f"min {per.min():.6f}, max {per.max():.6f} over {len(per)} frames")
    return float(per.mean())
