"""Host milliseconds of a window frame's ``snapshot`` span, averaged over
the frames that have one: the MapMaker's copy of its ring to the host."""

import numpy as np

from benchmark import spans


def read(ctx):
    rec = spans.window(ctx)
    if rec is None:
        return None
    mask = spans.slots(rec, "snapshot")
    if not mask.any():
        ctx.note("frame log: no snapshot in the window")
        return None
    ms = (rec["end_ns"] - rec["start_ns"])[mask] * 1e-6
    ctx.note(f"frame log: {len(ms)} snapshots, ms median {np.median(ms):.6f}, "
             f"max {ms.max():.6f}")
    return float(ms.mean())
