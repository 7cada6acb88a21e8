#!/usr/bin/env python3
"""The frame log (``utils/profiling.py``) of the two runners on one GPU.

Drives ``OdometryPipeline`` (75x24 bins, 7 fixed Gauss-Newton iterations
warm-started, min range 2 m), the same with the DNN filter in the loop (12
iterations, the last 5 filtered, 2 refinement passes, the bundled weights)
and ``MapMaker`` (``PROFILES["mapping"]`` at 12 fixed iterations, min range
0.2 m) over the first frames of the 64x1024 city drive (``CityDriveSource``,
repeated), and for each (or for those ``--runner`` names):

1. the cost of the log: after a warm-up of ``--warmup-s`` seconds of
   frames (a process runs slow for its first tens of seconds on the card),
   rounds of frames with the log on and off in turns (on, off, off, on,
   ...), each frame timed on the host around ``step`` (which ends in a
   blocking read), the medians a mode;
2. the log's frames: each span's host and device milliseconds (medians
   over the logged frames), each named value's median (the filter's
   device ms and counts), the runner's reads and the iterations a frame,
   and the device spans' sum against the root's;
3. three frames under ``profiling.trace()``: every ``icet.*`` span of the
   Chrome trace lies inside its frame's root span.

Prints one JSON object a runner; exits 1 where the trace does not nest.
Run from the repository root (it imports nothing of JAX or ``icet_tpu``):

    python3 tools/trace_frames.py [--frames 12] [--warmup-s 60] [--rounds 64]
        [--per-round 5] [--runner NAME ...] [--out DIR]

The Chrome traces (tens of MB each) go under ``--out``, by default the
temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from icet_tpu_torch.config import PROFILES, ICETConfig, MapConfig, OdometryConfig  # noqa: E402
from icet_tpu_torch.datasets.replay import CityDriveSource  # noqa: E402
from icet_tpu_torch.mapping import MapMaker  # noqa: E402
from icet_tpu_torch.odometry import OdometryPipeline  # noqa: E402
from icet_tpu_torch.utils import profiling  # noqa: E402
from icet_tpu_torch.utils.profiling import frame_log  # noqa: E402


def runners(device):
    odo = ICETConfig(n_iters=7, min_range=2.0, convergence_tol=0.0, convergence_stat_scale=0.0)
    mapping = PROFILES["mapping"].replace(n_iters=12, min_range=0.2, convergence_tol=0.0,
                                          convergence_stat_scale=0.0)
    dnn = odo.replace(n_iters=12, dnn_filter=True, dnn_start_iter=7, dnn_refine_steps=2,
                      dnn_in_loop=True)
    return {
        "odometry": lambda: OdometryPipeline(odo, OdometryConfig(divergence_clamp=2.5),
                                             device=device),
        "odometry_dnn": lambda: OdometryPipeline(dnn, OdometryConfig(divergence_clamp=2.5),
                                                 device=device),
        "mapping": lambda: MapMaker(mapping, MapConfig(), OdometryConfig(divergence_clamp=2.5),
                                    device=device),
    }


def cost(make, scans, warmup_s: float, rounds: int, per_round: int) -> dict:
    """Host ms a frame with the log on and off, in turns."""
    runner = make()
    k, t0 = 0, time.perf_counter()
    while k < len(scans) or time.perf_counter() - t0 < warmup_s:
        runner.step(scans[k % len(scans)])
        k += 1
    ms = {True: [], False: []}
    for r in range(rounds):
        on = r % 4 in (0, 3)
        frame_log.enabled = on
        for _ in range(per_round):
            scan = scans[k % len(scans)]
            k += 1
            a = time.perf_counter()
            runner.step(scan)
            ms[on].append((time.perf_counter() - a) * 1e3)
    frame_log.enabled = True
    on, off = float(np.median(ms[True])), float(np.median(ms[False]))
    return {"frame_ms_on": on, "frame_ms_off": off, "change_pct": 100.0 * (on / off - 1.0),
            "frames_each": len(ms[True])}


def spans(make, scans) -> dict:
    """The logged frames of a fresh runner after its first frames."""
    runner = make()
    for s in scans[:3]:
        runner.step(s)
    frame_log.reset()
    for s in scans:
        runner.step(s)
    rec = frame_log.records()
    names = rec["names"]
    per: dict = {}
    for i in range(len(rec["seq"])):
        for j in range(rec["n_spans"][i]):
            d = per.setdefault(names[rec["name"][i, j]], {"host": [], "device": [], "reads": 0})
            d["host"].append((rec["end_ns"][i, j] - rec["start_ns"][i, j]) * 1e-6)
            d["device"].append(rec["device_ms"][i, j])
            d["reads"] += int(rec["reads"][i, j])
    n = len(rec["seq"])
    out = {name: {"host_ms": float(np.median(d["host"])),
                  "device_ms": None if np.isnan(d["device"]).all()
                  else float(np.nanmedian(d["device"])),
                  "per_frame": len(d["host"]) / n, "reads_per_frame": d["reads"] / n}
           for name, d in per.items()}
    used = np.arange(rec["name"].shape[1])[None, :] < rec["n_spans"][:, None]
    used[:, 0] = False
    device = np.where(used & ~np.isnan(rec["device_ms"]), rec["device_ms"], 0.0).sum(axis=1)
    root = (rec["end_ns"][:, 0] - rec["start_ns"][:, 0]) * 1e-6
    vals = {name: float(np.median(rec["values"][:, k]))
            for k, name in enumerate(rec.get("value_names", ()))}
    return {"frames": n, "spans": out, "values": vals,
            "iterations_per_frame": float(rec["iterations"].mean()),
            "device_spans_ms_per_frame": float(device.mean()),
            "root_ms_per_frame": float(root.mean()),
            "device_idle_pct": float(100.0 * (1.0 - device.sum() / root.sum()))}


def nested(make, scans, out_dir: str) -> dict:
    """Three frames under profiling.trace(): each icet.* span inside a root."""
    runner = make()
    for s in scans[:3]:
        runner.step(s)
    with profiling.trace(out_dir) as path:
        for s in scans[3:6]:
            runner.step(s)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("name", "").startswith("icet.")
                  and e.get("cat") != "gpu_user_annotation"]
    roots = [e for e in events if e["name"].endswith(".step")]
    inner = [e for e in events if not e["name"].endswith(".step")]
    outside = [e["name"] for e in inner
               if not any(r["ts"] <= e["ts"] and e["ts"] + e["dur"] <= r["ts"] + r["dur"]
                          for r in roots)]
    return {"trace": path, "roots": len(roots), "spans": len(inner),
            "names": sorted({e["name"] for e in inner}), "outside_a_root": outside}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--warmup-s", type=float, default=60.0)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--per-round", type=int, default=5)
    ap.add_argument("--runner", nargs="*", default=None, help="the runners to drive (all)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "icet_trace_frames"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    src = CityDriveSource(n_frames=args.frames, n_beams=64, n_azimuth=1024)
    scans = [np.asarray(s, np.float32) for s, _ in src]
    ok = True
    for name, make in runners(device).items():
        if args.runner and name not in args.runner:
            continue
        rec = {"runner": name, "card": torch.cuda.get_device_name(0)}
        rec["cost"] = cost(make, scans, args.warmup_s, args.rounds, args.per_round)
        rec["log"] = spans(make, scans)
        rec["trace"] = nested(make, scans, os.path.join(args.out, name))
        ok &= rec["trace"]["roots"] == 3 and not rec["trace"]["outside_a_root"]
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
