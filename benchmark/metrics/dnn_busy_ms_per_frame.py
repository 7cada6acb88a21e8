"""Device milliseconds a frame of the filtered odometry cell in the stretch
traced on the device alone: ``busy_ms_per_frame``'s reading."""

from pathlib import Path

from benchmark.harness import load_module


def read(ctx):
    busy = load_module(Path(__file__).with_name("busy_ms_per_frame.py"),
                       "benchmark_metric_busy_ms_per_frame")
    return busy.read(ctx)
