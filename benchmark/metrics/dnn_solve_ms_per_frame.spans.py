"""Device milliseconds a window frame of the filtered solve's graph replay
(the frame log's ``dnn`` spans: the plain and the filtered Gauss-Newton
iterations, the filter's passes between them and the finish)."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "dnn")
