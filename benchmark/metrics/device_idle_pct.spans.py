"""The device's idle share of the window's frames, in percent: one minus
the device milliseconds of the program's device spans (the compiled
path's graph replays, each between two CUDA events) over the host
milliseconds of the frames' root spans (``odometry.step``, ``map.step``),
from the frame log.  The window is untraced, so the reading does not
stretch the frame.  It is biased both ways against a trace's idle: a
replay's span takes in the gaps between its graph's nodes, which reads
lower; the copies (upload, input loads, read-backs) and the kernels the
runner launches one at a time between replays (the seed, the divergence
read, the glue, the uniforms, the clones) have no device span and count
as idle, which reads higher."""

import numpy as np

from benchmark import spans


def read(ctx):
    rec = spans.window(ctx)
    if rec is None:
        return None
    used = spans.slots(rec)
    used[:, 0] = False
    timed = used & ~np.isnan(rec["device_ms"])
    if not timed.any(axis=1).all():
        ctx.note("frame log: a window frame has no device times")
        return None
    device = np.where(timed, rec["device_ms"], 0.0).sum()
    root = (rec["end_ns"][:, 0] - rec["start_ns"][:, 0]).sum() * 1e-6
    ctx.note(f"frame log: device spans {device / len(timed):.6f} ms, root spans "
             f"{root / len(timed):.6f} ms a window frame")
    return 100.0 * (1.0 - device / root)
