"""Device milliseconds a window frame of the solve's graph replay (the
frame log's ``solve`` spans: the Gauss-Newton iterations and the finish)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "solve")
