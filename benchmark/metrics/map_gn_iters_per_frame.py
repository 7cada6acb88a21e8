"""Gauss-Newton iterations a window frame of the MapMaker, from the frame
log's counts (``MapFrame.iterations``: the solve's own count on the card,
read back in the frame's one packed copy), averaged over the window."""

import numpy as np

from benchmark import spans


def read(ctx):
    rec = spans.window(ctx)
    if rec is None:
        return None
    its = rec["iterations"]
    ctx.note(f"frame log: iterations a window frame {np.bincount(its).tolist()} "
             "(frames by count)")
    return float(its.mean())
