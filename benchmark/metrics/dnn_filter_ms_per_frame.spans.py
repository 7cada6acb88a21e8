"""Device milliseconds a window frame of the DNN filter's passes (the frame
log's value ``dnn_filter``: the time between timing events recorded
inside the filtered solve's graph around each pass, apart from its
Gauss-Newton iterations, summed over the frame's passes)."""

from benchmark import values


def read(ctx):
    return values.mean(ctx, "dnn_filter")
