"""Timing and tracing; the counterpart of ``icet_tpu/utils/profiling.py``.

(a) a stage timer that synchronises the device before it stops the clock,
(b) a per-call device time over back-to-back calls, by CUDA events on the
card and by the host clock for CPU tensors, and (c) a ``torch.profiler``
trace of a block, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


def _sync(obj) -> None:
    """Wait for the device of ``obj``: a ``torch.device``, a device name,
    a tensor, or a (nested) tuple/list/dict of tensors.  CPU work is done
    by the time the call returns, so only CUDA devices are waited on."""
    for dev in _devices(obj):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _devices(obj) -> set:
    if isinstance(obj, torch.Tensor):
        return {obj.device}
    if isinstance(obj, (str, torch.device)):
        return {torch.device(obj)}
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        out = set()
        for o in obj:
            out |= _devices(o)
        return out
    return set()


class StageTimer:
    """Accumulates wall-clock spans per named stage, with device sync."""

    def __init__(self):
        self.spans: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        """Time the block.  ``sync_on`` (a tensor, tensors, or a device)
        names the device whose queued work must finish before the clock
        stops; without it the span is the host's time to enqueue."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                _sync(sync_on)
            self.spans.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1000.0
            )

    def summary(self) -> dict[str, dict]:
        out = {}
        for name, xs in self.spans.items():
            a = np.asarray(xs)
            out[name] = {
                "n": len(xs),
                "mean_ms": float(a.mean()),
                "p50_ms": float(np.median(a)),
                "p95_ms": float(np.percentile(a, 95)),
            }
        return out


def device_time_ms(
    fn: Callable, *args, inner: int = 30, trials: int = 5
) -> float:
    """Median per-call time of ``fn(*args)`` over ``trials`` runs of
    ``inner`` back-to-back calls.  The device follows the tensor arguments
    (all on one device): on CUDA each run is timed between two CUDA events
    on the current stream; on the CPU by the host clock.  Raises when the
    arguments name no device or more than one."""
    devs = _devices(list(args))
    if len(devs) != 1:
        raise ValueError(
            f"device_time_ms: the arguments lie on {sorted(map(str, devs))}; "
            "pass tensors on exactly one device"
        )
    (dev,) = devs
    fn(*args)
    times = []
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            torch.cuda.synchronize(dev)
            for _ in range(trials):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(inner):
                    fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / inner)
    else:
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn(*args)
            times.append((time.perf_counter() - t0) / inner * 1000.0)
    return float(np.median(times))


@contextlib.contextmanager
def trace(log_dir: str = "icet_torch_trace"):
    """Profile the enclosed block with ``torch.profiler`` (CPU, and CUDA
    when the card is there) and write ``<log_dir>/trace.json``, a Chrome
    trace (chrome://tracing or Perfetto).  Yields the trace's path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
