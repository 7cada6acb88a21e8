"""``correct`` comes out false when the timed path is broken underneath:
the rest of a run is driven as on the card (the look for a card skipped),
at a size a test holds, once for each fault a cell can have.  A step that
returns its state unchanged, half of the points left out of the moment
sums, an answer altered where it is produced (on every frame, and on a
third of them or on the MapMaker's snapshot frames alone), an iteration
skipped on a third of the frames; the cells run on one chip,
so there is no exchange between chips to leave out.  The same run
unbroken passes every check."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness


def run(root, workload):
    cell = harness.find_cell(root, workload)
    return harness.run_cell(cell, 2**31 + 99, 1.5, False, torch.device("cpu"),
                            time.perf_counter())


def failed(result) -> set:
    """The checks over their limits."""
    return {k for k, c in result["checks"].items() if not c["value"] <= c["limit"]}


def half_the_points(monkeypatch):
    from icet_tpu_torch import solver

    orig = solver.fused_moment_sums
    monkeypatch.setattr(solver, "fused_moment_sums",
                        lambda pts, *a: orig(pts[: pts.shape[0] // 2].contiguous(), *a))


def altered_answer(monkeypatch):
    from icet_tpu_torch import solver

    orig = solver.iteration_from_sums

    def shifted(*a, **k):
        X, *rest = orig(*a, **k)
        return (X + 1e-3, *rest)

    monkeypatch.setattr(solver, "iteration_from_sums", shifted)


def pose_unchanged(monkeypatch):
    from icet_tpu_torch import odometry

    monkeypatch.setattr(odometry, "compose_pose", lambda T, X: T)


def ring_unchanged(monkeypatch):
    from icet_tpu_torch import mapping

    monkeypatch.setattr(mapping, "_advance", lambda points, valid, trail, *a: (
        points, valid, trail))


def some_answers_altered(monkeypatch):
    """The solution altered where it is produced on every third frame
    only: well under half of the frames a check compares."""
    from icet_tpu_torch import odometry

    orig = odometry.OdometryPipeline.step
    calls = [0]

    def step(self, scan):
        frame = orig(self, scan)
        calls[0] += 1
        if frame is not None and calls[0] % 3 == 0:
            frame.X = frame.X + 1e-3
        return frame

    monkeypatch.setattr(odometry.OdometryPipeline, "step", step)


def some_iterations_skipped(monkeypatch):
    """Every third frame reports one Gauss-Newton iteration fewer than
    the configuration runs."""
    from icet_tpu_torch import odometry

    orig = odometry.OdometryPipeline.step
    calls = [0]

    def step(self, scan):
        frame = orig(self, scan)
        calls[0] += 1
        if frame is not None and calls[0] % 3 == 0:
            frame.iterations -= 1
        return frame

    monkeypatch.setattr(odometry.OdometryPipeline, "step", step)


def snapshot_frames_altered(monkeypatch):
    """The solution altered on the MapMaker's snapshot frames alone (one
    frame in ``snapshot_every``)."""
    from icet_tpu_torch import mapping

    orig = mapping.MapMaker.step

    def step(self, scan):
        frame = orig(self, scan)
        if frame is not None and self._index % self.snapshot_every == 0:
            frame.X = frame.X + 1e-3
        return frame

    monkeypatch.setattr(mapping.MapMaker, "step", step)


@pytest.mark.parametrize("workload", ["odo-os1.stream", "map-os1.stream"])
def test_unbroken_run_is_correct(tiny, workload):
    result = run(tiny, workload)
    assert not result["failed"] and not failed(result), result["checks"]


@pytest.mark.parametrize("workload, fault", [
    ("odo-os1.stream", half_the_points),
    ("odo-os1.stream", altered_answer),
    ("odo-os1.stream", pose_unchanged),
    ("map-os1.stream", half_the_points),
    ("map-os1.stream", altered_answer),
    ("map-os1.stream", ring_unchanged),
    ("odo-os1.stream", some_answers_altered),
    ("odo-os1.stream", some_iterations_skipped),
    ("map-os1.stream", snapshot_frames_altered),
])
def test_fault_is_not_correct(tiny, monkeypatch, workload, fault):
    fault(monkeypatch)
    result = run(tiny, workload)
    assert not result["correct"] and failed(result), result["checks"]
