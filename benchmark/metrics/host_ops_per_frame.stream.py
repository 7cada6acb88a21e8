"""Host operations of the compiled path a window frame: the change of
``graphs.host_ops`` (graph replays, flag, spawn, overflow and block reads,
copies, draws, map writes, captures, tally reads) over the window, divided
by the window's frames."""


def read(ctx):
    before, after = ctx.probes["open"]["host_ops"], ctx.probes["close"]["host_ops"]
    if not ctx.window:
        return None
    return sum(after[k] - before[k] for k in after) / len(ctx.window)
