"""Device milliseconds a window frame of the prepare's graph replay (the
frame log's ``prepare`` spans: the scan's own voxel model, kernel #1)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "prepare")
