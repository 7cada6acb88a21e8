"""Timing and tracing; the counterpart of ``icet_tpu/utils/profiling.py``.

(a) a stage timer that synchronises the device before it stops the clock,
(b) a per-call device time over back-to-back calls, by CUDA events on the
card and by the host clock for CPU tensors, (c) a ``torch.profiler``
trace of a block, written as a Chrome trace, and (d) the frame log
(:class:`FrameLog`, the process's :data:`frame_log`): the runners' frames
as spans and counts in fixed arrays, on by default, with the timing
events a captured graph records inside itself (:func:`graph_events`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


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


#: frames the frame log's ring holds: a 50-s stretch of frames at up to
#: ~650 frames a second (~1.1 KB a frame, ~35 MB in all)
FRAMES = 32768
#: span slots a frame record holds, its root among them
SPANS = 32
#: named values a frame record holds
VALUES = 8
#: ``CU_EVENT_RECORD_EXTERNAL``: an event recorded during stream capture
#: becomes an event-record node of the graph
_RECORD_EXTERNAL = 1


@functools.lru_cache(maxsize=None)
def _driver() -> ctypes.CDLL:
    """The CUDA driver's event calls, through ``ctypes``: on an H100 host
    they took the log's event work a frame from ~110 µs with
    ``torch.cuda.Event`` (its wrapper, device guard and checks) to ~60."""
    lib = ctypes.CDLL("libcuda.so.1")
    p = ctypes.c_void_p
    lib.cuEventCreate.argtypes = [ctypes.POINTER(p), ctypes.c_uint]
    lib.cuEventRecord.argtypes = [p, p]
    lib.cuEventRecordWithFlags.argtypes = [p, p, ctypes.c_uint]
    lib.cuEventSynchronize.argtypes = [p]
    lib.cuEventElapsedTime.argtypes = [ctypes.POINTER(ctypes.c_float), p, p]
    for f in (lib.cuEventCreate, lib.cuEventRecord, lib.cuEventRecordWithFlags,
              lib.cuEventSynchronize, lib.cuEventElapsedTime):
        f.restype = ctypes.c_int
    return lib


def _timing_event() -> int:
    """A CUDA timing event of the current device's context (a driver handle)."""
    ev = ctypes.c_void_p()
    err = _driver().cuEventCreate(ctypes.byref(ev), 0)
    if err:
        raise RuntimeError(f"cuEventCreate failed: CUDA driver error {err}")
    return ev.value


class _Events:
    """A start and an end CUDA timing event (driver handles) for each span
    slot, on one device, made once and kept for the process."""

    def __init__(self, device: int, spans: int):
        with torch.cuda.device(device):  # the device's context is current
            self.start = [_timing_event() for _ in range(spans)]
            self.end = [_timing_event() for _ in range(spans)]


def graph_events(device, n: int) -> list[tuple[int, int]]:
    """``n`` pairs of CUDA timing events (driver handles) on ``device`` for
    a graph to record inside itself (:func:`record_in_capture`), made for
    one capture and kept for the process; :meth:`FrameLog.add_device`
    reads them after each replay."""
    with torch.cuda.device(device):
        return [(_timing_event(), _timing_event()) for _ in range(n)]


def record_in_capture(event: int, stream: int) -> None:
    """Record ``event`` on the capturing ``stream`` (a raw stream handle):
    an event-record node of the graph being captured, which each replay
    records again at that point of its work."""
    err = _driver().cuEventRecordWithFlags(event, stream, _RECORD_EXTERNAL)
    if err:
        raise RuntimeError(f"cuEventRecordWithFlags failed: CUDA driver error {err}")


class FrameLog:
    """The runners' frames as spans and counts, in a fixed ring of
    preallocated arrays (a frame allocates no Python container that
    outlives it, so the collector gets no work from the log).

    A runner's ``step`` opens one frame (:meth:`open`: the root span, the
    pipeline's frame index, the frame's ``seq`` in the log) and closes it
    in a ``finally`` (:meth:`close`: failed or not, the Gauss-Newton
    iterations).  Inside it, :meth:`begin` and :meth:`end` bracket a named
    span (its parent the innermost open span); host times come from
    ``time.perf_counter_ns()``, and each record keeps the offset to
    ``time.time_ns()``, the clock of the profiler's records.  A span begun
    ``timed`` on a CUDA frame (the compiled path's graph replays) is also
    bracketed by two CUDA timing events on the frame device's current
    stream; the close reads their device milliseconds, after the runner's
    last blocking read has drained the stream.  Where one of the log's own
    driver calls fails, the frame's device times stay NaN and the runner
    goes on.  :meth:`read` counts a blocking device-to-host read of the
    runner's own in the innermost open span.

    Besides its spans a frame holds named values: counts (:meth:`add`)
    and the device milliseconds between timing events that a replayed
    graph records inside itself (:meth:`add_device`).  Those lie inside a
    replay's span, so they are values and not spans: the spans' device
    times never overlap.

    While ``torch.profiler`` records, each span is also a profiler record
    ``icet.<name>`` (``record_function``'s fast form), so a trace shows the
    program's phases inside each frame; the log's host span lies inside
    it.  Outside a frame, or with ``enabled`` off, a span costs a call and
    one attribute test; without a profiler the record costs one flag
    test.  :meth:`records` returns the
    frames the ring holds in ``seq`` order."""

    def __init__(self, frames: int = FRAMES, spans: int = SPANS, values: int = VALUES):
        #: whether :meth:`open` opens a frame
        self.enabled = True
        self._ids: dict[str, int] = {}
        self._labels: list[str] = []
        self._value_ids: dict[str, int] = {}
        self._pools: dict[int, _Events | None] = {}
        self._device = None
        self._device_index = -1
        self._ms = ctypes.c_float()
        #: span slots a frame record holds
        self.spans = spans
        #: named values a frame record holds
        self.n_values = values
        self.reset(frames)

    def reset(self, frames: int | None = None) -> None:
        """Drop every record (not while a frame is open), with a ring of
        ``frames`` frames where given."""
        #: frames the ring holds
        self.frames = frames or self.frames
        f, n = self.frames, self.spans
        #: frames closed so far: the next frame's ``seq``
        self.count = 0
        #: True while a frame is open (what every span tests)
        self.active = False
        self.seq = np.full(f, -1, np.int64)
        self.index = np.zeros(f, np.int64)
        self.failed = np.zeros(f, np.bool_)
        self.iterations = np.zeros(f, np.int64)
        self.clock_offset_ns = np.zeros(f, np.int64)
        self.n_spans = np.zeros(f, np.int16)
        self.dropped = np.zeros(f, np.int16)
        self.name = np.zeros((f, n), np.int16)
        self.parent = np.zeros((f, n), np.int16)
        self.start_ns = np.zeros((f, n), np.int64)
        self.end_ns = np.zeros((f, n), np.int64)
        self.device_ms = np.full((f, n), np.nan)
        self.reads = np.zeros((f, n), np.int16)
        self.values = np.zeros((f, self.n_values))
        # The open frame: its spans' record_function, whether each is
        # timed, the timed slots, the open spans.
        self._rf: list = [None] * n
        self._timed = [False] * n
        self._timing: list[int] = []
        #: the open frame's device values: (value, start event, end event)
        self._graph_events: list[tuple[int, int, int]] = []
        self._stack: list[int] = []
        self._n = self._row = self._dropped = 0
        self._events = None
        self._stream = 0

    def _id(self, name: str) -> int:
        nid = self._ids.get(name)
        if nid is None:
            nid = self._ids[name] = len(self._labels)
            self._labels.append(name)
        return nid

    # -- frames -----------------------------------------------------------

    def open(self, root: str, index: int, device=None) -> int:
        """Open a frame with the root span ``root`` for the pipeline's frame
        ``index`` on ``device`` (device spans only on CUDA).  Returns the
        token :meth:`close` takes: -1 when nothing is recorded (the log
        off, or a frame already open)."""
        if not self.enabled or self.active:
            return -1
        row = self._row = self.count % self.frames
        self.seq[row] = self.count
        self.index[row] = index
        self.device_ms[row] = np.nan
        self.values[row] = 0.0
        self._events = None
        if device is not self._device:
            self._device = device
            d = torch.device("cpu" if device is None else device)
            # -1: not CUDA; None: the current CUDA device
            self._device_index = -1 if d.type != "cuda" else d.index
        idx = self._device_index
        if idx is None:
            idx = torch.cuda.current_device()
        if idx >= 0:
            if idx not in self._pools:
                try:
                    self._pools[idx] = _Events(idx, self.spans)
                except (OSError, AttributeError, RuntimeError):
                    self._pools[idx] = None  # no device times on this device
            self._events = self._pools[idx]
            if self._events is not None:
                self._stream = torch._C._cuda_getCurrentRawStream(idx)
        self.clock_offset_ns[row] = time.time_ns() - time.perf_counter_ns()
        self.active = True
        self._n = self._dropped = 0
        self._stack.clear()
        self._timing.clear()
        self._graph_events.clear()
        return self.begin(root)

    def close(self, token: int, failed: bool = False, iterations: int = 0) -> None:
        """Close the frame :meth:`open` returned ``token`` for, with whether
        it ``failed`` and its Gauss-Newton ``iterations``; the spans a raise
        left open end with it.  The frame is closed whatever the log's own
        calls do."""
        if token != 0:
            return
        row = self._row
        try:
            self._pop(0)
            self.n_spans[row] = self._n
            self.dropped[row] = self._dropped
            self.failed[row] = failed
            self.iterations[row] = iterations
            if (self._timing or self._graph_events) and self._events is not None \
                    and not failed:
                self._device_times()
        finally:
            self.active = False
            self.count += 1

    # -- spans ------------------------------------------------------------

    def begin(self, name: str, timed: bool = False) -> int:
        """Begin the span ``name`` in the open frame (``timed``: with device
        times, on a CUDA frame).  Returns its slot for :meth:`end`, -1 when
        nothing is recorded."""
        if not self.active:
            return -1
        slot = self._n
        if slot == self.spans:
            self._dropped += 1
            return -1
        self._n = slot + 1
        row = self._row
        nid = self._ids.get(name)
        self.name[row, slot] = nid = self._id(name) if nid is None else nid
        stack = self._stack
        self.parent[row, slot] = stack[-1] if stack else -1
        stack.append(slot)
        self.end_ns[row, slot] = 0
        self.reads[row, slot] = 0
        if _autograd_profiler._is_profiler_enabled:
            # record_function without its operator call: ~20x less time
            # between the profiler's clock reading and the log's.
            rf = self._rf[slot] = torch._C._profiler._RecordFunctionFast(
                f"icet.{self._labels[nid]}")
            rf.__enter__()
        self.start_ns[row, slot] = time.perf_counter_ns()
        self._timed[slot] = timed and self._record(0, slot)
        return slot

    def end(self, slot: int) -> None:
        """End the span :meth:`begin` returned ``slot`` for, and any span
        begun inside it and left open."""
        if slot > 0 and self.active and not self.end_ns[self._row, slot]:
            self._pop(slot)

    def read(self) -> None:
        """Count one blocking device-to-host read of the runner's own, about
        to be made, in the innermost open span."""
        if self.active:
            self.reads[self._row, self._stack[-1]] += 1

    def _value(self, name: str) -> int:
        """The column of the value ``name``; -1 past the record's values."""
        vid = self._value_ids.get(name)
        if vid is None:
            if len(self._value_ids) == self.n_values:
                return -1
            vid = self._value_ids[name] = len(self._value_ids)
        return vid

    def add(self, name: str, k: float = 1) -> None:
        """Add ``k`` to the open frame's value ``name`` (a count)."""
        if self.active:
            vid = self._value(name)
            if vid >= 0:
                self.values[self._row, vid] += k

    def add_device(self, spans) -> None:
        """Add to the open frame's value ``name`` the device milliseconds
        between the two events of each ``(name, start event, end event)``
        that the graph just replayed records inside itself
        (:func:`graph_events`), read at the close; NaN where a driver call
        fails.  Nothing is added where the frame has no device times."""
        if not self.active or self._events is None:
            return
        for name, start, end in spans:
            vid = self._value(name)
            if vid >= 0:
                self._graph_events.append((vid, start, end))

    def _pop(self, slot: int) -> None:
        """End ``slot`` and the spans above it on the stack."""
        stack, row = self._stack, self._row
        while stack:
            top = stack.pop()
            if self._timed[top] and self._record(1, top):
                self._timing.append(top)
            self.end_ns[row, top] = time.perf_counter_ns()
            rf = self._rf[top]
            if rf is not None:
                self._rf[top] = None
                rf.__exit__(None, None, None)
            if top == slot:
                return

    # -- device times -----------------------------------------------------

    def _record(self, end: int, slot: int) -> bool:
        """Record ``slot``'s start (``end`` 0) or end event on the frame's
        stream; False where nothing is timed (not a CUDA frame, or a call
        of the log's failed, which leaves the frame untimed)."""
        pool = self._events
        if pool is None:
            return False
        if _driver().cuEventRecord((pool.end if end else pool.start)[slot], self._stream):
            self._events = None
            return False
        return True

    def _device_times(self) -> None:
        """The timed spans' and the device values' milliseconds, once the
        last end event has completed (at once after the runner's last
        blocking read); all NaN where a driver call fails."""
        drv, pool, row, ms = _driver(), self._events, self._row, self._ms
        # Every event is on the frame's stream, and a replay's events lie
        # inside its span: the last recorded ends last.
        last = pool.end[self._timing[-1]] if self._timing else self._graph_events[-1][2]
        ok = not drv.cuEventSynchronize(last)
        for slot in self._timing:
            ok = ok and not drv.cuEventElapsedTime(ctypes.byref(ms), pool.start[slot],
                                                    pool.end[slot])
            self.device_ms[row, slot] = ms.value if ok else np.nan
        for vid, start, end in self._graph_events:
            ok = ok and not drv.cuEventElapsedTime(ctypes.byref(ms), start, end)
            self.values[row, vid] += ms.value if ok else np.nan
        if not ok:
            self.device_ms[row] = np.nan

    # -- reading ----------------------------------------------------------

    def records(self) -> dict:
        """The closed frames the ring holds, in ``seq`` order, as copies:
        per frame ``seq``, ``index`` (the pipeline's frame), ``failed``,
        ``iterations``, ``clock_offset_ns`` (``time.time_ns() -
        time.perf_counter_ns()`` at the frame's open), ``n_spans`` and
        ``dropped`` (spans past the slots); per span slot, ``(frames,
        spans)`` arrays whose slots past ``n_spans`` are unused: ``name``
        (an index into ``names``; slot 0 is the root), ``parent`` (a slot,
        -1 for the root), ``start_ns`` and ``end_ns``
        (``time.perf_counter_ns()``), ``device_ms`` (NaN where the span has
        no device time) and ``reads``; ``values`` ``(frames, values)``,
        its columns named by ``value_names``."""
        lo = max(0, self.count - self.frames + int(self.active))
        rows = np.arange(lo, self.count) % self.frames
        out = {k: getattr(self, k)[rows].copy() for k in (
            "seq", "index", "failed", "iterations", "clock_offset_ns", "n_spans", "dropped",
            "name", "parent", "start_ns", "end_ns", "device_ms", "reads", "values")}
        out["names"] = list(self._labels)
        out["value_names"] = list(self._value_ids)
        return out


#: the process's frame log, which the runners and the compiled path record in
frame_log = FrameLog()
