#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``icet_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA source of the port, compiled by nvcc;
3. kernel vs plain: the fused moments kernel against its plain PyTorch
   version on the card, on a 65,536-point 64x1024 city-drive frame with its
   75x24 (V = 1,800) voxel model, at three transforms, in shuffled point
   order, and with NaN and zero rows;
4. main path: the 24-frame drive through ``run_odometry_device`` at the
   sequence-odometry config, with the kernel's launches counted;
5. times: CUDA-event medians of the odometry frame, the kernel and its
   plain version.

It prints, before the last line, one JSON object with the kernel's numbers
and, as the last line, ``{"ok": true, "device": {...}}``.  It imports
nothing of JAX or of ``icet_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
#: kernel vs plain: float32 sums of up to a few thousand terms taken in two
#: different orders (shared-memory atomics vs index_add_)
RTOL, ATOL = 1e-4, 1e-3
#: points within this angle of a bin edge may bin differently when the
#: kernel and PyTorch's CUDA ops round theta/phi differently by an ulp
EDGE_RAD = 1e-5
#: at most this share of points may be that close to an edge
EDGE_CAP = 1e-3
#: trajectory accuracy bound on the drive (the JAX package reaches 1.083 cm
#: on it on the CPU)
ATE_MAX_M = 0.03


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def edge_points(pts, X, cfg) -> int:
    """Points past the raw range gate whose transformed theta or phi lies
    within EDGE_RAD of a bin edge (where an ulp of difference can move them
    to the next voxel); theta == 0 exactly (y == 0, x > 0) is not an edge
    case, as every atan2 returns 0 there."""
    from icet_tpu_torch.ops.geometry import (
        cart_to_spherical,
        point_norm,
        transform_points,
    )

    rtp = cart_to_spherical(transform_points(pts, X)).double()
    w_t = 2 * np.pi / cfg.n_theta
    w_p = (cfg.phi_max - cfg.phi_min) / cfg.n_phi
    ft = rtp[:, 1] / w_t
    fp = (rtp[:, 2] - cfg.phi_min) / w_p
    on_theta = ((ft - torch.round(ft)).abs() * w_t < EDGE_RAD) & (rtp[:, 1] > 0)
    on_phi = (fp - torch.round(fp)).abs() * w_p < EDGE_RAD
    return int(((on_theta | on_phi) & (point_norm(pts) >= cfg.min_range)).sum())


def compare(name, pts, X, model, cfg, report):
    """Kernel vs plain on one input; returns the max |error| over rows
    whose counts agree."""
    from icet_tpu_torch.ops.fused_moments import (
        fused_moment_sums,
        fused_moment_sums_reference,
    )

    got = fused_moment_sums(pts, X, model.bounds, model.anchors, cfg)
    again = fused_moment_sums(pts, X, model.bounds, model.anchors, cfg)
    want = fused_moment_sums_reference(pts, X, model.bounds, model.anchors, cfg)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel sums")
    check(bool((got[:, 10:] == 0).all()), f"{name}: columns 10-15 not zero")
    check(bool((got[-1] == 0).all()), f"{name}: sentinel row not zero")
    edges = edge_points(pts, X, cfg)
    check(edges <= EDGE_CAP * pts.shape[0],
          f"{name}: {edges} points within {EDGE_RAD} rad of a bin edge")
    dcount = (got[:, 0] - want[:, 0]).abs()
    check(float(dcount.sum()) <= 2 * edges,
          f"{name}: counts differ by {float(dcount.sum())} with {edges} edge points")
    same = dcount == 0
    err = (got[same, :10] - want[same, :10]).abs()
    tol = ATOL + RTOL * want[same, :10].abs()
    check(bool((err <= tol).all()),
          f"{name}: features differ by up to {float(err.max())}")
    run_to_run = float((got - again).abs().max())
    report.append(
        f"{name}: members {int(want[:, 0].sum())}, edge points {edges}, "
        f"count diffs {int(dcount.sum())}, max |err| {float(err.max()):.3e}, "
        f"run-to-run max |diff| {run_to_run:.3e}"
    )
    return float(err.max()), got


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from icet_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1
    from icet_tpu_torch.config import ICETConfig, OdometryConfig
    from icet_tpu_torch.datasets.replay import CityDriveSource
    from icet_tpu_torch.device import resolve_device
    from icet_tpu_torch.odometry import run_odometry_device
    from icet_tpu_torch.ops.fused_moments import (
        fused_moment_sums,
        fused_moment_sums_reference,
    )
    from icet_tpu_torch.solver import odometry_step, prepare_reference

    dev = resolve_device("cuda")
    card = device_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"nvcc {name}.cu:\n{log.strip()}")

    # -- data: the drive bench.py times -----------------------------------
    t0 = time.perf_counter()
    src = CityDriveSource(n_frames=24, speed=1.0, n_beams=64, n_azimuth=1024)
    frames = [(s, T) for s, T in src]
    scans = np.stack([s for s, _ in frames]).astype(np.float32)
    gt = [T for _, T in frames]
    print(f"data: {scans.shape} in {time.perf_counter() - t0:.1f} s")
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)

    # -- kernel vs plain --------------------------------------------------
    model = prepare_reference(torch.from_numpy(scans[0]).to(dev), cfg)
    pts = torch.from_numpy(scans[1]).to(dev)
    rng = np.random.default_rng(0)
    X_step = torch.tensor([1.0, 0.05, 0.0, 0.0, 0.0, 0.02], device=dev)
    cases = {
        "X=0": (pts, torch.zeros(6, device=dev)),
        "X=1m/0.02rad": (pts, X_step),
        "X=3m/0.1rad": (pts, torch.tensor([3.0, -0.2, 0.05, 0.01, -0.01, 0.1], device=dev)),
    }
    perm = torch.from_numpy(rng.permutation(pts.shape[0])).to(dev)
    cases["shuffled"] = (pts[perm].contiguous(), X_step)
    holes = scans[1].copy()
    rows = rng.permutation(holes.shape[0])
    holes[rows[:2000]] = np.nan
    holes[rows[2000:4000]] = 0.0
    holes[rows[4000:4100], 1] = np.nan
    cases["nan+zero rows"] = (torch.from_numpy(holes).to(dev), X_step)
    report = []
    max_err = 0.0
    outs = {}
    for name, (p, X) in cases.items():
        err, outs[name] = compare(name, p, X, model, cfg, report)
        max_err = max(max_err, err)
    check(bool((outs["shuffled"][:, 0] == outs["X=1m/0.02rad"][:, 0]).all()),
          "shuffled order changed the kernel's counts")
    for line in report:
        print(f"kernel vs plain, {line}")

    # -- main path --------------------------------------------------------
    odo = OdometryConfig(divergence_clamp=2.5)
    torch.cuda.synchronize()
    fused_moment_sums.launches = 0
    t0 = time.perf_counter()
    out = run_odometry_device(scans, cfg, odo, device="cuda")
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = fused_moment_sums.launches
    iters = [f.iterations for f in out]
    check(len(out) == len(scans) - 1, f"{len(out)} frames out of {len(scans) - 1}")
    check(all(np.isfinite(f.X).all() and np.isfinite(f.pred_stds).all() for f in out),
          "non-finite X or pred_stds")
    check(not any(f.diverged for f in out), "a frame diverged")
    check(launches == sum(iters) + len(scans),
          f"kernel launches {launches} != iterations {sum(iters)} + prepares {len(scans)}")
    est = [np.eye(4)] + [f.T_world.astype(np.float64) for f in out]
    ref = [np.linalg.inv(gt[0]) @ T for T in gt]
    err = [np.linalg.norm(e[:3, 3] - r[:3, 3]) for e, r in zip(est, ref)]
    ate = float(np.sqrt(np.mean(np.square(err))))
    print(f"main path: {len(out)} frames in {path_s:.2f} s, kernel launches "
          f"{launches} = {sum(iters)} iterations + {len(scans)} prepares, "
          f"mean iterations/frame {np.mean(iters):.3f}, ATE {ate * 100:.3f} cm")
    check(ate <= ATE_MAX_M, f"ATE {ate * 100:.3f} cm above {ATE_MAX_M * 100} cm")

    # -- times ------------------------------------------------------------
    drive = torch.from_numpy(scans).to(dev)
    model0 = prepare_reference(drive[0], cfg)

    def odometry_pass():
        m, x = model0, torch.zeros(6, device=dev)
        for k in range(1, drive.shape[0]):
            res, m = odometry_step(m, drive[k], x, cfg)
            x = res.X

    frame_ms = median_ms(odometry_pass, reps=1, rounds=3) / (drive.shape[0] - 1)
    X_t = X_step
    kernel_ms = median_ms(
        lambda: fused_moment_sums(pts, X_t, model.bounds, model.anchors, cfg), reps=100)
    plain_ms = median_ms(
        lambda: fused_moment_sums_reference(pts, X_t, model.bounds, model.anchors, cfg),
        reps=20)
    members = float(fused_moment_sums_reference(
        pts, X_t, model.bounds, model.anchors, cfg)[:, 0].sum())
    n, v1 = pts.shape[0], cfg.n_voxels + 1
    # Bytes: points, X, bounds, anchors read once; (V+1, 16) sums written.
    nbytes = n * 12 + 6 * 4 + v1 * 8 + v1 * 12 + v1 * 16 * 4
    # Operations: per point the raw norm (6), transform (18), nan scrub and
    # r' (6), theta/phi with atan2/acos counted as 20 each (43), binning and
    # gates (10); per member the anchor offset (3) and 10 accumulated
    # features (6 products + 10 adds).
    nops = n * 83 + members * 19
    bound_ms = max(nbytes / PEAK_BYTES_PER_S, nops / PEAK_FP32_PER_S) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES_PER_S >= nops / PEAK_FP32_PER_S else "operations"
    print(f"times ({card}): odometry frame {frame_ms:.4f} ms, kernel "
          f"{kernel_ms:.5f} ms/launch at N={n} V={cfg.n_voxels}, plain version "
          f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, "
          f"{nops:.0f} ops); no single PyTorch call computes this fused "
          f"function, so library_ms is null")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "fused_moment_sums",
        "route": "cuda",
        "source": "icet_tpu_torch/csrc/fused_moments.cu",
        "replaces": "icet_tpu/ops/pallas_fused.py:73",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
