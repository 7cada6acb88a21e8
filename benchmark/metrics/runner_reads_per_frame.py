"""Blocking device-to-host reads the runner makes itself a window frame,
from the frame log's counts (odometry: the divergence flag, the packed
outputs and the correspondences; mapping: the packed outputs, and the ring
on the frames that copy it to the host).  Not in ``graphs.host_ops``."""

import numpy as np

from benchmark import spans


def read(ctx):
    rec = spans.window(ctx)
    if rec is None:
        return None
    reads = np.where(spans.slots(rec), rec["reads"], 0).sum(axis=1)
    ctx.note(f"frame log: runner reads a window frame {np.bincount(reads).tolist()} "
             "(frames by count)")
    return float(reads.mean())
