"""The filtered odometry cell's metrics (``dnn_filter_ms_per_frame.spans``,
``dnn_solve_ms_per_frame.spans``, ``encoder_launches_per_frame``,
``k4_roofline``) on a synthetic frame log in the program's place: each
reads the window's frames (``k4_roofline`` the profiled stretch's), and
each returns None, without raising, where the program's log has no filter
values, as the parent commit's has none."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

NAMES = ["odometry.step", "load", "dnn", "prepare", "readback"]
#: per frame: (name, parent, device ms or None)
FRAME = [("odometry.step", -1, None), ("load", 0, 0.05), ("dnn", 0, 17.0), ("prepare", 0, 2.0),
         ("readback", 0, None)]
#: per frame: the filter's device ms (five passes of 0.9) and its counts
VALUES = {"filter_passes": 5, "encoder_launches": 10, "dnn_filter": 4.5, "n_rejected": 60}
CONFIG = {"n_theta": 75, "n_phi": 24, "dnn_sample_pts": 100}


def log_records(frames: int, filtered: bool = True, spans: int = 12) -> dict:
    rec = {"seq": np.arange(frames), "names": list(NAMES),
           "n_spans": np.full(frames, len(FRAME), np.int16),
           "name": np.zeros((frames, spans), np.int16),
           "parent": np.zeros((frames, spans), np.int16),
           "device_ms": np.full((frames, spans), np.nan)}
    for slot, (name, parent, dev) in enumerate(FRAME):
        rec["name"][:, slot] = NAMES.index(name)
        rec["parent"][:, slot] = parent
        if dev is not None:
            rec["device_ms"][:, slot] = dev
    if filtered:
        rec["value_names"] = list(VALUES)
        rec["values"] = np.tile(np.array(list(VALUES.values()), np.float64), (frames, 1))
    return rec


class Log:
    def __init__(self, rec):
        self.rec = rec

    def records(self) -> dict:
        return {k: v.copy() if isinstance(v, np.ndarray) else list(v) for k, v in self.rec.items()}


def ctx(steps: int = 12, window=range(4, 10), profile=None):
    notes = []
    records = [{"lap": k, "out": None, "latency": 0.0, "window": k in window}
               for k in range(steps)]
    return SimpleNamespace(records=records, note=lambda *a: notes.append(" ".join(a)),
                           notes=notes, config=CONFIG, profile=profile, card="a card")


def read(name, c):
    mod = harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                              f"benchmark_metric_{name}")
    return mod.read(c)


@pytest.fixture
def program(monkeypatch):
    from icet_tpu_torch.utils import profiling

    def put(rec):
        monkeypatch.setattr(profiling, "frame_log", Log(rec))

    return put


def profile(frames: int, launches: int, ms: float):
    events = [("(anonymous namespace)::bias_encoder_kernel(float const*, int)", 0.0, ms * 1e-3)
              ] * launches + [("other", 0.0, 1.0)]
    return SimpleNamespace(frames=[{}] * frames, events=events, busy_s=0.5)


def test_readers_read_the_window_and_the_stretch(program):
    program(log_records(12))
    c = ctx(profile=profile(3, 30, 0.12))
    assert read("dnn_filter_ms_per_frame.spans", c) == pytest.approx(4.5)
    assert read("dnn_solve_ms_per_frame.spans", c) == pytest.approx(17.0)
    assert read("encoder_launches_per_frame", c) == pytest.approx(10.0)
    # 2.97e10 bf16 operations at 989 TFLOP/s over 0.12 ms a launch
    assert read("k4_roofline", c) == pytest.approx(100.0 * 2.9690e10 / 989e12 / 0.12e-3,
                                                   rel=1e-3)
    assert any("trace 30, program 30" in n for n in c.notes)
    assert read("dnn_busy_ms_per_frame", c) == pytest.approx(500.0 / 3)


def test_readers_return_none_on_a_log_without_the_filter(program):
    """The parent's log: no values."""
    program(log_records(12, filtered=False))
    c = ctx(profile=profile(3, 30, 0.12))
    for name in ("dnn_filter_ms_per_frame.spans", "encoder_launches_per_frame", "k4_roofline"):
        assert read(name, c) is None
    assert read("dnn_solve_ms_per_frame.spans", c) == pytest.approx(17.0)


def test_roofline_needs_the_kernels_records(program):
    program(log_records(12))
    assert read("k4_roofline", ctx(profile=profile(3, 0, 0.12))) is None
    assert read("k4_roofline", ctx(profile=None)) is None


def test_filter_ms_needs_every_window_frames_device_time(program):
    """A window frame whose device times the log could not read (NaN)."""
    rec = log_records(12)
    rec["values"][6, list(VALUES).index("dnn_filter")] = np.nan
    program(rec)
    assert read("dnn_filter_ms_per_frame.spans", ctx()) is None
    assert read("encoder_launches_per_frame", ctx()) == pytest.approx(10.0)
