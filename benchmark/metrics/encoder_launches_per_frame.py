"""Launches of the BiasNet encoder kernel (kernel #4,
``csrc/bias_encoder.cu``) a window frame: the frame log's
``encoder_launches`` value, which the odometry step takes from the kernel
wrapper's count (a graph replay adds the launches its capture held)."""

from benchmark import values


def read(ctx):
    return values.mean(ctx, "encoder_launches")
