"""The benchmark harness: one run of one cell.

``BENCHMARK.json`` names the cell; everything particular to it is found by
name under ``benchmark/``: the configuration (``configs/<config>.json``,
which names its runner, ``runners/<runner>.py``), the traffic mix
(``traffic/<traffic>.json``, read by the one generator in ``lap.py``) and
each per-layer metric (``metrics/<metric>.py``, a ``read(ctx)`` that returns
a number or None).  A new cell, configuration or metric is new files and
new entries, never an edit here.

A run: set-up (the lap raycast on the device from the seed, the runner
built, warm-up frames until no new graph is captured), then a closed loop
for ``--seconds``: each scan is handed to the runner as a host float32
array as soon as the previous pose is back on the host, timed around the
call.  With ``--trace 1`` two profiled stretches of frames follow the window.
Then the program's state is read and freed, and the runner's plain
reference judges what the program produced.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from benchmark import lap as lapgen
from benchmark import probe, stats

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "icet_tpu")
#: warm-up frames with no new capture before the window opens
STABLE_FRAMES = 3
#: frames run under a first, discarded profile before the traced stretch
PROFILER_WARMUP = 2


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in ``path`` (file names may hold dots, so by path)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell(SimpleNamespace):
    """One workload of ``BENCHMARK.json`` with its files loaded."""


def find_cell(root: Path, workload: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(root / entry["file"])
    bench = root / "benchmark"
    runner = load_module(bench / "runners" / f"{config['runner']}.py",
                         f"benchmark_runner_{config['runner']}")
    traffic = load_json(bench / "traffic" / f"{w['traffic']}.json")
    reported = {m["name"] for m in spec["end_to_end"]
                if workload in m.get("workloads", cells)}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", cells) and m["moves"] in reported]
    return Cell(name=workload, workload=w, config=config, traffic=traffic, runner=runner,
                end_to_end=[m for m in spec["end_to_end"] if m["name"] in reported],
                per_layer=per_layer, bench=bench)


def card_sample() -> str:
    """The card's name, SM clock, temperature, power draw and limit."""
    q = "name,clocks.sm,temperature.gpu,power.draw,power.limit"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def note(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _frame_record(lap_index: int, out, latency: float, window: bool) -> dict:
    return {"lap": lap_index, "out": out, "latency": latency, "window": window}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of ``cell``: returns the result object (without printing)."""
    import torch

    lap = lapgen.make_lap(cell.traffic, cell.config["sensor"], seed, device)
    n_lap = lap.scans.shape[0]
    session = cell.runner.build(cell.config, device, seed)
    records: list[dict] = []
    failures: list[str] = []

    def lap_index(k: int) -> int:
        return (lap.start + k) % n_lap

    def step(k: int, window: bool):
        scan = lap.scans[lap_index(k)]
        a = time.perf_counter()
        try:
            out = session.step(scan)
        except Exception:  # a failed frame is counted, the stream goes on
            failures.append(traceback.format_exc())
            out = None
        b = time.perf_counter()
        records.append(_frame_record(lap_index(k), out, b - a, window))
        return b

    # Set-up: warm up until every graph the window uses is captured.
    p0 = probe.read()
    k, stable = 0, 0
    while k < cell.config["min_warmup_frames"] or stable < STABLE_FRAMES:
        before = probe.captured()
        step(k, False)
        k += 1
        stable = stable + 1 if probe.captured() == before else 0
    warmup = k
    p_open = probe.read()
    card_before = card_sample()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # Collections in the window then walk only what the window allocates.
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    deadline = t0 + seconds
    while True:
        t_end = step(k, True)
        k += 1
        if t_end >= deadline:
            break
    window_s = t_end - t0
    gc.unfreeze()
    p_close = probe.read()
    card_after = card_sample()
    win = [r for r in records if r["window"]]

    prof = None
    if trace:
        prof = profile_frames(session, records, lap, lap_index, k,
                              cell.config["profile_frames"], device)
    memory_peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    snapshot = session.snapshot()
    session.close()
    del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    lat_ms = [r["latency"] * 1e3 for r in win]
    note(f"card before the window: {card_before}")
    note(f"card after the window: {card_after}")
    note(f"frames: {len(win)} in {window_s:.6f} s; frame_ms median "
         f"{stats.percentile(lat_ms, 50):.6f}, p90 {stats.percentile(lat_ms, 90):.6f}, "
         f"p95 {stats.percentile(lat_ms, 95):.6f}, p99 {stats.percentile(lat_ms, 99):.6f}, "
         f"samples {len(lat_ms)}; warm-up frames {warmup}")
    for label, part in (("warm-up", records[:warmup]), ("window", win)):
        ends = np.cumsum([r["latency"] for r in part])
        note(f"frames a second of the {label}: "
             f"{np.bincount((ends // 1.0).astype(int)).tolist()}")
    its = [r["out"].get("iterations") for r in win if r["out"] is not None]
    if its and None not in its:
        note(f"iterations a window frame: mean {sum(its) / len(its):.6f}, max {max(its)}")
    if failures:
        note(f"{len(failures)} frames failed; the first:\n{failures[0]}")

    e2e = {"setup_s": setup_s, "frames_per_s": stats.rate(len(win), window_s),
           "frame_ms_p95": stats.percentile(lat_ms, 95)}
    ctx = SimpleNamespace(config=cell.config, lap=lap, records=records,
                          window=win, window_s=window_s, probes={"start": p0, "open": p_open,
                                                                 "close": p_close},
                          profile=prof, device=device, note=note, card=card_after)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(cell.bench / "metrics" / f"{m['name']}.py",
                                 f"benchmark_metric_{m['name']}")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    t_ref = time.perf_counter()
    judged = cell.runner.judge(ctx, snapshot, seed)
    note(f"reference check: {time.perf_counter() - t_ref:.3f} s")
    for name, c in judged.items():
        if c["limit"] is None:
            note(f"reported, not compared: {name} {c['value']!r}")
    checks = {k: c for k, c in judged.items() if c["limit"] is not None}
    correct = not failures and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                   "count": int(cell.workload["chips"]), "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": len(win), "failed": len(failures),
              "metrics": metrics, "device": device_info}
    if prof is not None:
        device_info["busy_s"] = prof.busy_s
        device_info["window_s"] = prof.window_s
        result["breakdown"] = prof.breakdown
    for name, c in checks.items():
        note(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    result["checks"] = checks
    return result


def _device_records(prof):
    """``(name, start s, end s)`` of every kernel, copy and set of a trace
    (not the device-side copies of the host's annotations), and the
    benchmark's own host spans."""
    import torch

    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not (name.startswith("bench.") or e.is_user_annotation()):
                dev.append((name, e.start_ns() * 1e-9, e.end_ns() * 1e-9))
        elif name.startswith("bench."):
            spans.append((name, e.start_ns() * 1e-9, e.end_ns() * 1e-9))
    return dev, spans


def profile_frames(session, records, lap, lap_index, k0: int, n: int,
                   device) -> SimpleNamespace:
    """Run ``2 n`` more frames under torch.profiler, in two stretches.

    The first records the host too, with the benchmark's spans around each
    call: the top device operations and the longest idle gaps, each
    labelled by the span the host was in (``breakdown``).  The second
    records the device alone, with no spans, so that it runs as near the
    untraced window's pace as the tracing of each kernel lets it: the
    device's intervals, busy seconds and the CUDA-event wall time of that
    same stretch, and the program's counters around it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    host_and_device = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def run(k: int, frames: list, spans: bool):
        ctx = record_function if spans else (lambda _name: contextlib.nullcontext())
        with ctx("bench.next_scan"):
            scan = lap.scans[lap_index(k)]
        a = time.perf_counter()
        with ctx("bench.step"):
            out = session.step(scan)
        b = time.perf_counter()
        with ctx("bench.record"):
            frames.append(_frame_record(lap_index(k), out, b - a, False))

    # The profiler's first start in a process sets up its tracing: pay
    # that over frames of their own, outside the traced stretches.
    frames: list = []
    with profile(activities=host_and_device):
        for k in range(k0, k0 + PROFILER_WARMUP):
            run(k, frames, False)
    k0 += PROFILER_WARMUP
    labelled_frames: list = []
    with profile(activities=host_and_device) as prof:
        for k in range(k0, k0 + n):
            run(k, labelled_frames, True)
    k0 += n
    dev, spans = _device_records(prof)
    by_name: dict = {}
    for name, s, t in dev:
        c = by_name.setdefault(name, [0, 0.0])
        c[0] += 1
        c[1] += t - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    lo = min((s for _, s, _ in spans), default=0.0)
    hi = max((t for _, _, t in spans), default=0.0)
    labelled = []
    for g0, length in stats.gaps([(s, t) for _, s, t in dev], lo, hi):
        label = next((name for name, s, t in spans if s <= g0 < t), "bench.between_spans")
        labelled.append([label, length])
    labelled.sort(key=lambda x: -x[1])
    steps = [f["latency"] * 1e3 for f in labelled_frames]
    note(f"labelled stretch (host and device traced, spans): {len(labelled_frames)} frames, "
         f"step ms median {stats.percentile(steps, 50):.6f}, {len(dev)} device records")

    device_frames: list = []
    before = probe.read()
    device_only = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=device_only) as prof:
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for k in range(k0, k0 + n):
            run(k, device_frames, False)
        if cuda:
            stop.record()
            torch.cuda.synchronize(device)
        wall_s = start.elapsed_time(stop) * 1e-3 if cuda else time.perf_counter() - t0
    after = probe.read()
    records.extend(frames + labelled_frames + device_frames)
    dev, _ = _device_records(prof)
    busy_s = stats.busy([(s, t) for _, s, t in dev])
    steps = [f["latency"] * 1e3 for f in device_frames]
    note(f"device stretch (device traced alone): {len(device_frames)} frames in {wall_s:.6f} s "
         f"(CUDA events), {wall_s * 1e3 / len(device_frames):.6f} ms a frame, step ms median "
         f"{stats.percentile(steps, 50):.6f} max {max(steps):.6f}; {len(dev)} device records, "
         f"busy {busy_s:.6f} s")
    return SimpleNamespace(
        frames=device_frames, events=dev, busy_s=busy_s, window_s=wall_s, before=before,
        after=after, breakdown={"device_ops": [[name[:160], c[1]] for name, c in top],
                                "idle_gaps": labelled[:10]})


def main(argv, t_start: float, root: Path) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = find_cell(root, args.workload)

    import torch

    torch.set_num_threads(1)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        note(f"no CUDA device for this cell (needs {chips})")
        return 3
    import icet_tpu_torch

    if Path(icet_tpu_torch.__file__).resolve().parent.parent != root.resolve():
        note(f"icet_tpu_torch was loaded from outside the checkout: {icet_tpu_torch.__file__}")
        return 4
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    bad = forbidden_modules()
    if bad:
        note(f"forbidden modules loaded in the run: {bad}")
        return 5
    print(json.dumps(result), flush=True)
    return 0
