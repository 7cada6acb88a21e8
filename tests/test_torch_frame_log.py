"""The frame log (``utils/profiling.py``, ``frame_log``) on the CPU, through
both runners: one record a ``step`` with the documented spans, parents
and frame index; the runners' own reads (odometry 3 a frame, mapping 1
and 1 more on a snapshot frame); a step that raises leaves one record,
marked failed; the ring wraps at its size; with ``enabled`` off nothing is
recorded and no profiler record is made; under ``torch.profiler``
each ``icet.*`` span starts where the log's span of the same name does, on
the ``time.time_ns()`` clock, and the Chrome trace of ``profiling.trace``
nests the spans inside the frame's root.  A DNN-filtered odometry frame
records a ``dnn_filter`` span a filter pass inside its ``dnn`` span (on
the CPU; on the card the passes' device time is the frame's value
``dnn_filter``) and the values ``filter_passes``, ``encoder_launches`` and
``n_rejected``; a plain frame records none of them.  On the CPU no span has a device
time (those come from CUDA events on the card); a stub of the CUDA driver
stands in for the card where the log's own driver calls fail, which leaves
the frame's device times NaN and closes the frame all the same."""

import contextlib
import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from icet_tpu_torch import odometry as todo
from icet_tpu_torch.config import ICETConfig, MapConfig, OdometryConfig
from icet_tpu_torch.datasets.replay import SyntheticTrajectorySource
from icet_tpu_torch.mapping import MapMaker
from icet_tpu_torch.models.bias_net import load_pretrained
from icet_tpu_torch.utils import profiling
from icet_tpu_torch.utils.profiling import FrameLog, frame_log

torch.set_num_threads(2)

CFG = ICETConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
                 n_iters=4, min_pts=10, min_range=1.0)
ODO_SPANS = ["odometry.step", "upload", "seed", "load", "solve", "prepare", "divergence_read",
             "glue", "readback"]
MAP_SPANS = ["map.step", "upload", "uniforms", "load", "solve", "load", "map", "prepare",
             "readback"]


@pytest.fixture(scope="module")
def scans():
    src = SyntheticTrajectorySource(n_frames=5, speed=0.2, yaw_rate=0.01, n_beams=32,
                                    n_azimuth=256)
    return [s for s, _ in src]


@pytest.fixture
def log():
    frame_log.reset(profiling.FRAMES)
    frame_log.enabled = True
    yield frame_log
    frame_log.enabled = True
    frame_log.reset(profiling.FRAMES)


def _pipe():
    return todo.OdometryPipeline(CFG, OdometryConfig(), device="cpu")


def _maker(**kw):
    return MapMaker(CFG, MapConfig(capacity=5_000, points_per_scan=500),
                    OdometryConfig(divergence_clamp=0.9), device="cpu", **kw)


def _spans(rec, i):
    n = rec["n_spans"][i]
    return [rec["names"][k] for k in rec["name"][i, :n]]


def _assert_nested(rec, i):
    """Every span a child of the root, inside it in time, ended."""
    n = rec["n_spans"][i]
    assert rec["parent"][i, 0] == -1 and (rec["parent"][i, 1:n] == 0).all()
    start, end = rec["start_ns"][i, :n], rec["end_ns"][i, :n]
    assert (end >= start).all()
    assert (start[1:] >= start[0]).all() and (end[1:] <= end[0]).all()
    assert (start[2:] >= end[1:-1]).all()  # siblings in order
    assert np.isnan(rec["device_ms"][i, :n]).all()  # no device on the CPU


def test_odometry_one_record_a_step(log, scans):
    pipe = _pipe()
    frames = [pipe.step(s) for s in scans]
    rec = log.records()
    assert rec["seq"].tolist() == rec["index"].tolist() == list(range(len(scans)))
    assert not rec["failed"].any() and not rec["dropped"].any()
    assert _spans(rec, 0) == ["odometry.step", "upload", "load", "prepare"]
    for i in range(len(scans)):
        _assert_nested(rec, i)
        if i:
            assert _spans(rec, i) == ODO_SPANS
            assert frames[i].index == rec["index"][i]
            assert rec["iterations"][i] == frames[i].iterations > 0
    reads = rec["reads"].sum(axis=1)
    assert reads.tolist() == [0] + [3] * (len(scans) - 1)
    at = {name: rec["names"].index(name) for name in ("divergence_read", "readback")}
    assert (rec["reads"][1:][rec["name"][1:] == at["divergence_read"]] == 1).all()
    assert (rec["reads"][1:][rec["name"][1:] == at["readback"]] == 2).all()


def test_mapmaker_one_record_a_step_and_its_snapshots(log, scans):
    maker = _maker(snapshot_every=2)
    frames = [maker.step(s) for s in scans]
    rec = log.records()
    assert rec["seq"].tolist() == rec["index"].tolist() == list(range(len(scans)))
    assert _spans(rec, 0) == ["map.step", "upload", "uniforms", "load", "prepare", "load",
                              "load", "map"]
    snapshot = [(i + 1) % 2 == 0 for i in range(len(scans))]
    for i in range(len(scans)):
        _assert_nested(rec, i)
        if i:
            assert _spans(rec, i) == MAP_SPANS + ["snapshot"] * snapshot[i]
            assert rec["iterations"][i] == frames[i].iterations == CFG.n_iters
    reads = rec["reads"].sum(axis=1)
    assert reads.tolist() == [int(s) + (i > 0) for i, s in enumerate(snapshot)]


def test_a_step_that_raises_leaves_one_failed_record(log, scans, monkeypatch):
    pipe = _pipe()
    pipe.step(scans[0])

    def broken(*a, **k):
        raise ValueError("inside the glue")

    monkeypatch.setattr(todo, "compose_pose", broken)
    with pytest.raises(ValueError, match="glue"):
        pipe.step(scans[1])
    monkeypatch.undo()
    assert not log.active
    pipe.step(scans[2])
    rec = log.records()
    assert rec["seq"].tolist() == [0, 1, 2]
    assert rec["failed"].tolist() == [False, True, False]
    assert _spans(rec, 1) == ODO_SPANS[:-1]  # ended in the glue, which the close ended
    _assert_nested(rec, 1)
    assert rec["reads"][1].sum() == 1


def test_ring_wraps_at_its_size(log, scans):
    log.reset(3)
    pipe = _pipe()
    for s in scans:
        pipe.step(s)
    rec = log.records()
    assert log.count == len(scans)
    assert rec["seq"].tolist() == rec["index"].tolist() == [2, 3, 4]
    for i in range(3):
        assert _spans(rec, i) == ODO_SPANS
        _assert_nested(rec, i)


def test_disabled_log_records_nothing(log, scans, monkeypatch):
    entered = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    log.enabled = False
    pipe = _pipe()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for s in scans[:3]:
            pipe.step(s)
    assert log.count == 0 and len(log.records()["seq"]) == 0
    assert not any(n.startswith("icet.") for n in entered)
    assert not any(e.name().startswith("icet.") for e in prof.profiler.kineto_results.events())
    # The block runner opens no frame either.
    log.enabled = True
    todo.run_odometry_device(np.stack(scans[:3]), CFG, block=2, device="cpu")
    assert log.count == 0


#: the filter in the loop from iteration 7 of 12: five passes a frame
DNN_CFG = CFG.replace(n_iters=12, dnn_filter=True, dnn_start_iter=7, dnn_sample_pts=16,
                      dnn_refine_steps=2, dnn_in_loop=True)


def test_dnn_frame_records_filter_spans_and_counters(log, scans):
    pipe = todo.OdometryPipeline(DNN_CFG, OdometryConfig(), device="cpu",
                                 net=load_pretrained(100))
    frames = [pipe.step(s) for s in scans[:3]]
    rec = log.records()
    names = rec["value_names"]
    assert set(names) == {"filter_passes", "encoder_launches", "n_rejected"}
    col = {n: rec["values"][:, names.index(n)] for n in names}
    assert not rec["values"][0].any()  # the first frame fits its model only
    dnn = rec["names"].index("dnn")
    for i in (1, 2):
        spans = _spans(rec, i)
        assert spans.count("dnn_filter") == 5 and spans.count("dnn") == 1
        slots = [k for k, name in enumerate(spans) if name == "dnn_filter"]
        assert all(rec["name"][i, rec["parent"][i, k]] == dnn for k in slots)
        assert col["filter_passes"][i] == 5
        # Plain calls on the CPU launch no kernel, so the wrapper counts none.
        assert col["encoder_launches"][i] == 0
        assert col["n_rejected"][i] == frames[i].n_rejected
        assert frames[i].n_rejected == int((~frames[i].dnn_filter.keep).sum()) > 0
        # Every pass's flags and shifts, the last pass's among them.
        filt = frames[i].dnn_filter
        assert filt.keeps.shape[0] == filt.dnn_shifts.shape[0] == filt.icet_shifts.shape[0] == 5
        assert torch.equal(filt.keeps[-1], filt.keep)
        assert torch.equal(filt.dnn_shifts[-1], filt.dnn_shift)
        assert torch.equal(filt.icet_shifts[-1], filt.icet_shift)


def test_plain_frame_records_no_filter_span_or_counter(log, scans):
    pipe = _pipe()
    for s in scans[:2]:
        pipe.step(s)
    rec = log.records()
    assert not any("dnn_filter" in _spans(rec, i) for i in range(2))
    assert not rec["values"].any()


def test_counters_past_the_record_are_not_kept():
    log = FrameLog(frames=2, spans=4, values=2)
    log.add("outside", 5)  # no frame open: nothing
    root = log.open("runner.step", 0)
    for name, k in (("a", 1), ("b", 2), ("a", 3), ("c", 4)):
        log.add(name, k)
    log.close(root)
    rec = log.records()
    assert rec["value_names"] == ["a", "b"]
    assert rec["values"].tolist() == [[4, 2]]


def test_nested_spans_reads_and_dropped_slots():
    log = FrameLog(frames=4, spans=4)
    assert log.begin("outside") == -1  # no frame open
    root = log.open("runner.step", 7)
    assert log.open("other.step", 8) == -1  # no frame inside a frame
    a = log.begin("a")
    log.begin("b")
    log.read()
    log.begin("c")
    assert log.begin("dropped") == -1
    log.end(a)  # ends b and c too
    log.read()
    log.close(-1)  # what the inner open returned: closes nothing
    assert log.active
    log.close(root)
    rec = log.records()
    assert rec["index"].tolist() == [7] and rec["dropped"].tolist() == [1]
    assert _spans(rec, 0) == ["runner.step", "a", "b", "c"]
    assert rec["parent"][0].tolist() == [-1, 0, 1, 2]
    assert rec["reads"][0].tolist() == [1, 0, 1, 0]
    assert (rec["end_ns"][0, 1:] > 0).all() and rec["end_ns"][0, 2] <= rec["end_ns"][0, 1]


class StubDriver:
    """The CUDA driver's event calls as the log makes them: each recorded
    event reads the next millisecond; the calls named in ``fail`` return
    an error, or raise with ``raises``."""

    def __init__(self, fail=(), raises=False):
        self.fail, self.raises = set(fail), raises
        self.events, self.clock = {}, 0.0

    def _err(self, call):
        if call in self.fail:
            if self.raises:
                raise OSError(f"{call} broke")
            return 999
        return 0

    def cuEventCreate(self, ev, flags):
        ev._obj.value = len(self.events) + 1
        self.events[ev._obj.value] = None
        return self._err("create")

    def cuEventRecord(self, ev, stream):
        self.clock += 1.0
        self.events[ev] = self.clock
        return self._err("record")

    def cuEventRecordWithFlags(self, ev, stream, flags):
        return self.cuEventRecord(ev, stream)

    def cuEventSynchronize(self, ev):
        return self._err("synchronize")

    def cuEventElapsedTime(self, ms, start, end):
        ms._obj.value = self.events[end] - self.events[start]
        return self._err("elapsed")


def _cuda_frame(log, index):
    """One frame on a CUDA device: two timed replays and a read-back."""
    root = log.open("runner.step", index, torch.device("cuda", 0))
    for name in ("solve", "prepare"):
        log.end(log.begin(name, timed=True))
    span = log.begin("readback")
    log.read()
    log.end(span)
    log.close(root)


@pytest.fixture
def stub_card(monkeypatch):
    def put(driver):
        monkeypatch.setattr(profiling, "_driver", lambda: driver)
        monkeypatch.setattr(torch.cuda, "device", lambda i: contextlib.nullcontext())
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 0, raising=False)
        return FrameLog(frames=4, spans=8)

    return put


@pytest.mark.parametrize("fail", [(), ("create",), ("record",), ("synchronize",), ("elapsed",)])
def test_device_times_and_a_failing_driver(stub_card, fail):
    log = stub_card(StubDriver(fail))
    _cuda_frame(log, 0)
    _cuda_frame(log, 1)  # the log goes on after a failed call
    assert not log.active and log.count == 2
    rec = log.records()
    assert rec["index"].tolist() == [0, 1] and not rec["failed"].any()
    assert _spans(rec, 1) == ["runner.step", "solve", "prepare", "readback"]
    assert rec["reads"].sum(axis=1).tolist() == [1, 1]
    dev = rec["device_ms"]
    if fail:
        assert np.isnan(dev).all()
    else:  # start and end of each replay: one stub millisecond apart
        assert dev[:, 1:3].tolist() == [[1.0, 1.0]] * 2
        assert np.isnan(dev[:, [0, 3]]).all()


def test_device_spans_read_the_events_a_graph_records(stub_card):
    """The events a replayed graph records (two pairs here, each recorded
    as the replay would: start, then end two stub milliseconds later) add
    their device times to the frame's value, not as spans: they lie inside
    the replay's span, whose device time already holds them, and the spans'
    device times add up to the replays' alone.  A frame without device
    times adds nothing."""
    driver = StubDriver()
    log = stub_card(driver)
    pairs = profiling.graph_events(0, 2)
    root = log.open("runner.step", 0, torch.device("cuda", 0))
    span = log.begin("dnn", timed=True)
    for start, end in pairs:
        profiling.record_in_capture(start, 0)
        driver.clock += 1.0
        profiling.record_in_capture(end, 0)
    log.add_device([("dnn_filter", *p) for p in pairs])
    log.end(span)
    log.close(root)
    rec = log.records()
    assert _spans(rec, 0) == ["runner.step", "dnn"]
    assert rec["value_names"] == ["dnn_filter"]
    assert rec["values"][0].tolist() == [4.0] + [0.0] * (log.n_values - 1)
    assert rec["device_ms"][0, 1] == 7.0  # the replay's own events bracket both
    root = log.open("runner.step", 1)  # on the CPU: no device times
    log.add_device([("dnn_filter", *pairs[0])])
    log.close(root)
    rec = log.records()
    assert _spans(rec, 1) == ["runner.step"] and not rec["values"][1].any()


@pytest.mark.parametrize("fail", [("synchronize",), ("elapsed",)])
def test_device_values_are_nan_where_the_driver_fails(stub_card, fail):
    log = stub_card(StubDriver(fail))
    pairs = profiling.graph_events(0, 1)
    root = log.open("runner.step", 0, torch.device("cuda", 0))
    span = log.begin("dnn", timed=True)
    for ev in pairs[0]:
        profiling.record_in_capture(ev, 0)
    log.add_device([("dnn_filter", *pairs[0])])
    log.add("filter_passes", 5)
    log.end(span)
    log.close(root)
    rec = log.records()
    assert np.isnan(rec["values"][0, 0]) and rec["values"][0, 1] == 5
    assert np.isnan(rec["device_ms"][0]).all()


def test_a_close_whose_driver_call_raises_still_closes_the_frame(stub_card):
    log = stub_card(StubDriver(("synchronize",), raises=True))
    with pytest.raises(OSError, match="synchronize broke"):
        _cuda_frame(log, 0)
    assert not log.active and log.count == 1
    rec = log.records()
    assert _spans(rec, 0) == ["runner.step", "solve", "prepare", "readback"]
    assert np.isnan(rec["device_ms"]).all()


def test_profiler_spans_start_with_the_logs(log, scans):
    pipe, maker = _pipe(), _maker(snapshot_every=2)
    pipe.step(scans[0])
    maker.step(scans[0])
    log.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass  # the profiler's first record of a thread sets it up, ~1 ms at times
        for s in scans[1:4]:
            pipe.step(s)
            maker.step(s)
    events = sorted((e.start_ns(), e.end_ns(), e.name()[len("icet."):])
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("icet."))
    rec = log.records()
    spans = sorted((int(rec["start_ns"][i, j] + rec["clock_offset_ns"][i]),
                    int(rec["end_ns"][i, j] + rec["clock_offset_ns"][i]), _spans(rec, i)[j])
                   for i in range(len(rec["seq"])) for j in range(rec["n_spans"][i]))
    assert len(events) == len(spans) == 3 * (len(ODO_SPANS) + len(MAP_SPANS)) + 2
    for (p0, p1, pname), (s0, s1, sname) in zip(events, spans):
        assert pname == sname and abs(p0 - s0) <= 500_000, (pname, (p0 - s0) / 1e6)
    roots = [(a, b) for a, b, name in events if name.endswith(".step")]
    assert len(roots) == 6
    for a, b, name in events:
        assert any(r0 <= a and b <= r1 for r0, r1 in roots), name


def test_chrome_trace_nests_the_spans_in_the_root(log, scans, tmp_path):
    maker = _maker()
    maker.step(scans[0])
    with profiling.trace(str(tmp_path / "tr")) as path:
        maker.step(scans[1])
    with open(path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"]
             if e.get("ph") == "X" and e.get("name", "").startswith("icet.")]
    (root,) = [e for e in spans if e["name"] == "icet.map.step"]
    inner = [e for e in spans if e is not root]
    assert [e["name"] for e in sorted(inner, key=lambda e: e["ts"])] == [
        f"icet.{n}" for n in MAP_SPANS[1:]]
    for e in inner:
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"]
