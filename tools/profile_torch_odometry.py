#!/usr/bin/env python3
"""Where the port's odometry spends its time on one GPU.

Runs the 24-frame 64x1024 city drive (the drive chip_smoke.py drives) at the
sequence-odometry config through ``odometry_step`` (with ``--dnn``, the
DNN-filtered ``odometry_step_dnn``; with ``--keyframe``, ``KeyframeOdometry``
at bench.py's keyframe config, filtered too with both), once to warm up and
once under
``torch.profiler``, and prints one JSON object: wall ms per frame (CUDA
events), CUDA kernels launched per frame, device busy ms per frame (union
of kernel and copy intervals), the device's idle share, each hand-written
kernel's launches and device time, and the kernels with the most device
time.  With ``--dnn`` it also profiles the filter's point sampling
(``model_voxel_samples``, called twice a frame) on its own, and reports its
device time and that of its sort as shares of the frame's busy time.  Run
from the repository root:

    python3 tools/profile_torch_odometry.py [--dnn] [--keyframe]

It imports nothing of JAX or of ``icet_tpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from icet_tpu_torch.config import BlockMapConfig, ICETConfig, KeyframeConfig  # noqa: E402
from icet_tpu_torch.datasets.replay import CityDriveSource  # noqa: E402
from icet_tpu_torch.filters import (  # noqa: E402
    model_voxel_samples,
    odometry_step_dnn,
    pretrained_dnn,
)
from icet_tpu_torch.keyframe import KeyframeOdometry  # noqa: E402
from icet_tpu_torch.ops.bias_encoder import bias_encoder_pool  # noqa: E402
from icet_tpu_torch.ops.fused_moments import fused_moment_sums  # noqa: E402
from icet_tpu_torch.solver import odometry_step, prepare_reference  # noqa: E402

#: the hand-written kernels: (wrapper with the launch count, kernel name part)
KERNELS = {
    "fused_moments": (fused_moment_sums, "fused_moments"),
    "bias_encoder": (bias_encoder_pool, "bias_encoder"),
}


def _busy_us(intervals) -> float:
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _device_events(fn):
    """(intervals, {name: [count, us]}) of the device work ``fn`` runs."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    intervals, by_name = [], defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        intervals.append((s, t))
        by_name[e.name][0] += 1
        by_name[e.name][1] += t - s
    return intervals, by_name


def _us_matching(by_name, part: str) -> float:
    return sum(us for name, (_, us) in by_name.items() if part in name.lower())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dnn", action="store_true", help="profile the DNN-filtered step")
    ap.add_argument("--keyframe", action="store_true",
                    help="profile keyframe odometry (KeyframeOdometry) instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_odometry: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0,
                     dnn_filter=args.dnn)
    scans = np.stack([s for s, _ in CityDriveSource(
        n_frames=24, speed=1.0, n_beams=64, n_azimuth=1024)]).astype(np.float32)
    drive = torch.from_numpy(scans).to(dev)
    n_steps = drive.shape[0] - 1
    net = pretrained_dnn(cfg, dev) if args.dnn else None

    kf_cfg = KeyframeConfig(spawn_distance=3.0, spawn_angle=0.3, delta_clamp=2.5)

    def keyframe_pass():
        frames = KeyframeOdometry(cfg, kf_cfg, BlockMapConfig(), device=dev).run(drive)
        return sum(f.iterations for f in frames)

    def odometry_pass():
        if args.keyframe:
            return keyframe_pass()
        iters = 0
        m, x = prepare_reference(drive[0], cfg), torch.zeros(6, device=dev)
        s = model_voxel_samples(m, drive[0], cfg) if args.dnn else None
        for k in range(1, drive.shape[0]):
            if args.dnn:
                res, m, s, _ = odometry_step_dnn(m, drive[k - 1], s, drive[k], x, cfg, net)
            else:
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

    for wrapper, _ in KERNELS.values():
        wrapper.launches = 0
    intervals, by_name = _device_events(odometry_pass)
    n_dev = len(intervals)
    busy_ms = _busy_us(intervals) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    out = {
        "card": card,
        "step": ("KeyframeOdometry" if args.keyframe else "odometry_step")
        + (" (dnn_filter)" if args.dnn else ""),
        "frames": n_steps,
        "iterations": iters,
        "wall_ms_per_frame": wall_ms / n_steps,
        "device_ops_per_frame": n_dev / n_steps if n_dev else None,
        "device_busy_ms_per_frame": busy_ms / n_steps if n_dev else None,
        "device_idle_share": 1.0 - busy_ms / wall_ms if n_dev else None,
    }
    for key, (wrapper, part) in KERNELS.items():
        us = _us_matching(by_name, part)
        out[f"{key}_launches_per_frame"] = wrapper.launches / n_steps
        out[f"{key}_device_ms_per_frame"] = us / 1e3 / n_steps if n_dev else None
        out[f"{key}_device_share"] = us / 1e3 / busy_ms if n_dev else None
    if args.dnn and not args.keyframe and n_dev:
        # The sampling pass on its own: the filter's aligned scan and the new
        # frame's model each take one call a frame.
        model = prepare_reference(drive[1], cfg)
        reps = 10
        _, s_names = _device_events(
            lambda: [model_voxel_samples(model, drive[1], cfg) for _ in range(reps)])
        per_call_ms = sum(us for _, us in s_names.values()) / 1e3 / reps
        sort_ms = _us_matching(s_names, "sort") / 1e3 / reps
        out["sampling_calls_per_frame"] = 2
        out["sampling_device_ms_per_frame"] = 2 * per_call_ms
        out["sampling_device_share"] = 2 * per_call_ms / (busy_ms / n_steps)
        out["sampling_sort_device_ms_per_frame"] = 2 * sort_ms
        out["sampling_sort_device_share"] = 2 * sort_ms / (busy_ms / n_steps)
    out["top_device_ops"] = [
        {"name": name[:80], "count": c, "ms_per_frame": us / 1e3 / n_steps}
        for name, (c, us) in top
    ]
    if not n_dev:
        out["note"] = "the profiler recorded no device activity: device numbers not measured"
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
