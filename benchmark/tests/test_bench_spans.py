"""The frame log's metrics (``metrics/*.spans.py``, ``runner_reads_per_frame``,
``map_gn_iters_per_frame``) on
a synthetic frame log in the program's place: each reads the window's
frames, and each returns None, with a note, where the program has no
frame log, where the log and the run do not line up, or where the ring no
longer holds the window."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

NAMES = ["map.step", "upload", "load", "solve", "map", "prepare", "readback", "snapshot"]
#: per frame: (name, parent, host ms, device ms or None, reads)
FRAME = [("map.step", -1, 10.0, None, 0), ("upload", 0, 0.2, 0.1, 0), ("load", 0, 0.1, 0.05, 0),
         ("solve", 0, 0.1, 6.0, 0), ("map", 0, 0.1, 0.2, 0), ("prepare", 0, 0.1, 1.0, 0),
         ("readback", 0, 0.3, 0.05, 1)]
SNAPSHOT = ("snapshot", 0, 2.0, None, 1)
METRICS = ("device_idle_pct.spans", "solve_ms_per_frame.spans", "prepare_ms_per_frame.spans",
           "map_update_ms_per_frame.spans", "runner_reads_per_frame", "snapshot_ms.spans",
           "map_gn_iters_per_frame")


class Log:
    """``FrameLog.records()`` of ``frames`` frames, the last ``held`` in
    the ring; a snapshot on every fourth frame, 12 iterations a frame and
    13 on every third."""

    def __init__(self, frames: int, held: int | None = None, spans: int = 10):
        f = held = frames if held is None else held
        self.rec = {"seq": np.arange(frames - held, frames), "names": list(NAMES),
                    "n_spans": np.zeros(f, np.int16), "name": np.zeros((f, spans), np.int16),
                    "parent": np.zeros((f, spans), np.int16),
                    "start_ns": np.zeros((f, spans), np.int64),
                    "end_ns": np.zeros((f, spans), np.int64),
                    "device_ms": np.full((f, spans), np.nan),
                    "reads": np.zeros((f, spans), np.int16)}
        self.rec["index"] = self.rec["seq"].copy()
        self.rec["iterations"] = 12 + (self.rec["seq"] % 3 == 0).astype(np.int64)
        for row, seq in enumerate(self.rec["seq"]):
            spans_ = FRAME + [SNAPSHOT] * int(seq % 4 == 0)
            t = int(seq) * 1_000_000_000
            for slot, (name, parent, host, dev, reads) in enumerate(spans_):
                self.rec["name"][row, slot] = NAMES.index(name)
                self.rec["parent"][row, slot] = parent
                self.rec["start_ns"][row, slot] = t
                self.rec["end_ns"][row, slot] = t + int(host * 1e6)
                if dev is not None:
                    self.rec["device_ms"][row, slot] = dev
                self.rec["reads"][row, slot] = reads
            self.rec["n_spans"][row] = len(spans_)

    def records(self) -> dict:
        return {k: v.copy() if isinstance(v, np.ndarray) else list(v) for k, v in self.rec.items()}


def ctx(steps: int = 12, window=range(4, 10)):
    notes = []
    records = [{"lap": k, "out": None, "latency": 0.0, "window": k in window}
               for k in range(steps)]
    return SimpleNamespace(records=records, note=lambda *a: notes.append(" ".join(a)),
                           notes=notes)


def read_all(c) -> dict:
    out = {}
    for name in METRICS:
        mod = harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                                  f"benchmark_metric_{name}")
        out[name] = mod.read(c)
    return out


@pytest.fixture
def program(monkeypatch):
    from icet_tpu_torch.utils import profiling

    def put(log):
        if log is None:
            monkeypatch.delattr(profiling, "frame_log", raising=False)
        else:
            monkeypatch.setattr(profiling, "frame_log", log)

    return put


def test_readers_read_the_window(program):
    program(Log(12))
    got = read_all(ctx())
    # Window frames 4-9: snapshots on 4 and 8.
    assert got["device_idle_pct.spans"] == pytest.approx(100.0 * (1.0 - 7.4 / 10.0))
    assert got["solve_ms_per_frame.spans"] == pytest.approx(6.0)
    assert got["prepare_ms_per_frame.spans"] == pytest.approx(1.0)
    assert got["map_update_ms_per_frame.spans"] == pytest.approx(0.2)
    assert got["runner_reads_per_frame"] == pytest.approx(8 / 6)
    assert got["snapshot_ms.spans"] == pytest.approx(2.0)
    assert got["map_gn_iters_per_frame"] == pytest.approx(12 + 2 / 6)  # frames 6 and 9


def test_readers_read_a_ring_that_holds_the_window(program):
    program(Log(12, held=8))
    got = read_all(ctx())
    assert got["solve_ms_per_frame.spans"] == pytest.approx(6.0)
    assert got["runner_reads_per_frame"] == pytest.approx(8 / 6)


@pytest.mark.parametrize("case", ["no_log", "more_frames", "fewer_frames", "ring_lost_window"])
def test_readers_return_none_when_log_and_run_do_not_line_up(program, case):
    log = {"no_log": None, "more_frames": Log(13), "fewer_frames": Log(11),
           "ring_lost_window": Log(12, held=7)}[case]
    program(log)
    c = ctx()
    assert read_all(c) == {name: None for name in METRICS}
    assert c.notes and all(n.startswith("frame log:") for n in c.notes)


def test_device_metrics_need_device_times(program):
    log = Log(12)
    log.rec["device_ms"][5, 3] = np.nan  # window frame 5's solve
    program(log)
    got = read_all(ctx())
    assert got["solve_ms_per_frame.spans"] is None
    assert got["device_idle_pct.spans"] == pytest.approx(
        100.0 * (1.0 - (7.4 * 6 - 6.0) / 60.0))
    assert got["prepare_ms_per_frame.spans"] == pytest.approx(1.0)
    log.rec["device_ms"][:] = np.nan  # a CPU run
    got = read_all(ctx())
    assert {k for k, v in got.items() if v is not None} == {
        "runner_reads_per_frame", "snapshot_ms.spans", "map_gn_iters_per_frame"}
