"""Gauss-Newton iterations a window frame, as the runner reports them
(``OdometryFrame.iterations``), averaged over the window."""


def read(ctx):
    its = [r["out"]["iterations"] for r in ctx.window
           if r["out"] is not None and r["out"].get("iterations") is not None]
    return sum(its) / len(its) if its else None
