"""Device milliseconds a window frame of the ring map stage's graph replay
(the frame log's ``map`` spans: the divergence guard, the ring's
re-expression, the downsample and the insert)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "map")
