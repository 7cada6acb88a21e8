"""``model_fit_launches_per_frame`` on a synthetic trace in the program's
place: the records of kernel #8's symbol over the profiled stretch's
frames, both of its launches; 0 where the trace has none (the parent's
program, whose model fit is a chain of PyTorch operations), None where
there is no trace."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

KERNELS = ("void (anonymous namespace)::model_fit_kernel_sweeps((anonymous namespace)::Args)",
           "void (anonymous namespace)::model_fit_kernel_masks<false, false>("
           "(anonymous namespace)::Args)")


def read(profile):
    mod = harness.load_module(ROOT / "benchmark" / "metrics" / "model_fit_launches_per_frame.py",
                              "benchmark_metric_model_fit_launches_per_frame")
    return mod.read(SimpleNamespace(profile=profile))


def trace(frames: int, fits: int):
    events = ([(k, 0.0, 1e-5) for k in KERNELS] * fits
              + [("void at::native::vectorized_elementwise_kernel<4>", 0.0, 1e-6)] * 40)
    return SimpleNamespace(frames=[{}] * frames, events=events, busy_s=0.5)


@pytest.mark.parametrize("frames, fits, want", [(30, 30, 2.0), (8, 8, 2.0), (30, 0, 0.0)])
def test_launches_a_frame(frames, fits, want):
    assert read(trace(frames, fits)) == pytest.approx(want)


def test_no_trace_reads_nothing():
    assert read(None) is None
    assert read(SimpleNamespace(frames=[], events=[("x", 0.0, 1.0)], busy_s=0.0)) is None
