"""``eigh6_launches_per_frame`` on a synthetic trace in the program's
place: the records of kernel #7's symbol over the profiled stretch's
frames; 0 where the trace has none (the parent's program, whose eigensystem
is a chain of PyTorch operations), None where there is no trace."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

KERNEL = ("void (anonymous namespace)::gn_eigh6_kernel<true>(float const*, float const*, "
          "float const*, float const*, float, float*)")


def read(profile):
    mod = harness.load_module(ROOT / "benchmark" / "metrics" / "eigh6_launches_per_frame.py",
                              "benchmark_metric_eigh6_launches_per_frame")
    return mod.read(SimpleNamespace(profile=profile))


def trace(frames: int, launches: int):
    events = [(KERNEL, 0.0, 1e-5)] * launches + [("gemmSN_NN_kernel", 0.0, 1e-6)] * 40
    return SimpleNamespace(frames=[{}] * frames, events=events, busy_s=0.5)


@pytest.mark.parametrize("frames, launches, want", [(30, 210, 7.0), (8, 96, 12.0),
                                                    (30, 0, 0.0)])
def test_launches_a_frame(frames, launches, want):
    assert read(trace(frames, launches)) == pytest.approx(want)


def test_no_trace_reads_nothing():
    assert read(None) is None
    assert read(SimpleNamespace(frames=[], events=[("x", 0.0, 1.0)], busy_s=0.0)) is None
