#!/usr/bin/env python3
"""Where the port's sequence odometry spends its time on one GPU.

Runs the 24-frame 64x1024 city drive (the drive chip_smoke.py drives) at the
sequence-odometry config through ``odometry_step``, once to warm up and once
under ``torch.profiler``, and prints one JSON object: wall ms per frame
(CUDA events), CUDA kernels launched per frame, device busy ms per frame
(union of kernel and copy intervals), the device's idle share, and the
kernels with the most device time.  Run from the repository root:

    python3 tools/profile_torch_odometry.py

It imports nothing of JAX or of ``icet_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from icet_tpu_torch.config import ICETConfig  # noqa: E402
from icet_tpu_torch.datasets.replay import CityDriveSource  # noqa: E402
from icet_tpu_torch.ops.fused_moments import fused_moment_sums  # noqa: E402
from icet_tpu_torch.solver import odometry_step, prepare_reference  # noqa: E402


def _busy_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_odometry: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)
    scans = np.stack([s for s, _ in CityDriveSource(
        n_frames=24, speed=1.0, n_beams=64, n_azimuth=1024)]).astype(np.float32)
    drive = torch.from_numpy(scans).to(dev)
    n_steps = drive.shape[0] - 1

    def odometry_pass():
        iters = 0
        m, x = prepare_reference(drive[0], cfg), torch.zeros(6, device=dev)
        for k in range(1, drive.shape[0]):
            res, m = odometry_step(m, drive[k], x, cfg)
            x = res.X
            iters += res.iterations
        return iters

    odometry_pass()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    iters = odometry_pass()
    end.record()
    torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fused_moment_sums.launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        odometry_pass()
        torch.cuda.synchronize()
    launches = fused_moment_sums.launches
    intervals, by_name = [], defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        by_name[e.name][0] += 1
        by_name[e.name][1] += t - s
    n_dev = len(intervals)
    busy_ms = _busy_us(intervals) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    fused_us = sum(us for name, (_, us) in by_name.items() if "fused_moments" in name)
    out = {
        "card": card,
        "frames": n_steps,
        "iterations": iters,
        "wall_ms_per_frame": wall_ms / n_steps,
        "device_ops_per_frame": n_dev / n_steps if n_dev else None,
        "device_busy_ms_per_frame": busy_ms / n_steps if n_dev else None,
        "device_idle_share": 1.0 - busy_ms / wall_ms if n_dev else None,
        "fused_moments_launches_per_frame": launches / n_steps,
        "fused_moments_device_ms_per_frame": fused_us / 1e3 / n_steps if n_dev else None,
        "fused_moments_device_share": fused_us / 1e3 / busy_ms if n_dev else None,
        "top_device_ops": [
            {"name": name[:80], "count": c, "ms_per_frame": us / 1e3 / n_steps}
            for name, (c, us) in top
        ],
    }
    if not n_dev:
        out["note"] = "the profiler recorded no device activity: device numbers not measured"
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
