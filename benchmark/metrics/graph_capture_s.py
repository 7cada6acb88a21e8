"""Seconds of set-up spent warming up, capturing and instantiating CUDA
graphs (``graphs.capture_stats``), from the runner's build to the window."""


def read(ctx):
    a, b = ctx.probes["start"]["capture"], ctx.probes["open"]["capture"]
    if b["graphs"] == a["graphs"]:
        return None
    return (b["capture_s"] - a["capture_s"]) + (b["instantiate_s"] - a["instantiate_s"])
