#!/usr/bin/env python3
"""Trajectory accuracy of the loop-closure drive on the CPU: the JAX package
(``icet_tpu``, the reference) and, with ``--port``, the PyTorch port on its
CPU path.

The drive is the one ``chip_smoke.py`` phase 17 drives on the card, the
pipeline of ``examples/eval_citydrive.py`` on the block of
``tests/test_citydrive.py`` at full sensor width:
``CityDriveSource(n_frames=250, speed=1.0, scene=Scene(), rect=(-24, 24,
-19, 19), n_beams=64, n_azimuth=1024)``, about 1.5 laps of 64x1024 sweeps;
``ICETConfig()`` (the canonical 75x24 grid) and
``OdometryConfig(divergence_clamp=2.5)`` through ``OdometryPipeline``; loop
candidates on the estimated trajectory (``detect_loop_candidates``, radius
6.0 m, min_gap 80), verified by ``close_loops`` warm-started at the
estimated relative pose; then ``graph_from_odometry`` and
``optimize_poses_sparse(states0, graph, 10, 50, robust_delta=3.5)``.

It prints the odometry ATE, the RPE, the candidates, the verified loops and
the refined ATE of each package as JSON.  ``chip_smoke.py`` gates the
card's refined ATE at the JAX package's figure plus 0.5 cm.  Run from the
repository root (minutes for the JAX side):

    JAX_PLATFORMS=cpu python3 tools/loop_closure_ate_cpu.py [--port]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DRIVE = dict(n_frames=250, speed=1.0, rect=(-24, 24, -19, 19), n_beams=64, n_azimuth=1024)
RADIUS, MIN_GAP = 6.0, 80


def run(pg, pkg, metrics, pose_to_state, scans, gt, device_kw: dict) -> dict:
    """The drive through one package: ``pg`` its pose_graph module, ``pkg``
    its top level, ``metrics`` its utils.metrics, ``pose_to_state`` a numpy
    (4, 4) -> (6,) function."""
    t0 = time.perf_counter()
    pipe = pkg.OdometryPipeline(pkg.ICETConfig(), pkg.OdometryConfig(divergence_clamp=2.5),
                                **device_kw)
    frames = [f for f in (pipe.step(s) for s in scans) if f is not None]
    t_odo = time.perf_counter() - t0
    est = [np.eye(4)] + [np.asarray(f.T_world, np.float64) for f in frames]
    ref = [np.linalg.inv(gt[0]) @ T for T in gt]
    ate_odo = metrics.ate_rmse(est, ref)
    t_err, r_err = metrics.rpe(est, ref)
    cands = pg.detect_loop_candidates(np.stack([T[:3, 3] for T in est]), radius=RADIUS,
                                      min_gap=MIN_GAP)

    def x0_fn(i, j):
        return np.asarray(pose_to_state(np.linalg.inv(est[i]) @ est[j]), np.float32)

    t0 = time.perf_counter()
    loops = pg.close_loops(scans, cands, pkg.ICETConfig(), x0_fn=x0_fn, **device_kw)
    t_loops = time.perf_counter() - t0
    states0, graph = pg.graph_from_odometry(frames, loop_factors=loops)
    t0 = time.perf_counter()
    opt = pg.optimize_poses_sparse(states0, graph, 10, 50, robust_delta=3.5, **device_kw)
    opt = np.asarray(opt.cpu() if hasattr(opt, "cpu") else opt)
    t_pg = time.perf_counter() - t0
    ate_ref = metrics.ate_rmse(list(pg.states_to_poses(opt)), ref)
    return {
        "ate_odometry_m": ate_odo, "rpe_t_m": float(t_err.mean()),
        "rpe_r_deg": float(np.degrees(r_err.mean())),
        "diverged": sum(f.diverged for f in frames),
        "candidates": len(cands), "loops": len(loops), "ate_refined_m": ate_ref,
        "odometry_s": t_odo, "close_loops_s": t_loops, "pose_graph_s": t_pg,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true", help="also run the port's CPU path")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import icet_tpu
    from icet_tpu import pose_graph as jpg
    from icet_tpu.datasets.replay import CityDriveSource
    from icet_tpu.datasets.synthetic import Scene
    from icet_tpu.ops.geometry import pose_to_state
    from icet_tpu.utils import metrics as jmetrics

    t0 = time.perf_counter()
    drive = list(CityDriveSource(scene=Scene(), **DRIVE))
    scans = [s for s, _ in drive]
    gt = [T for _, T in drive]
    out = {"drive_s": time.perf_counter() - t0}
    out["icet_tpu"] = run(jpg, icet_tpu, jmetrics,
                          lambda T: pose_to_state(jnp.asarray(T, jnp.float32)), scans, gt, {})
    print(json.dumps({"icet_tpu": out["icet_tpu"]}), flush=True)
    if args.port:
        import torch

        import icet_tpu_torch
        from icet_tpu_torch import pose_graph as tpg
        from icet_tpu_torch.keyframe import np_pose_to_state
        from icet_tpu_torch.utils import metrics as tmetrics

        torch.set_num_threads(min(8, os.cpu_count() or 1))
        out["icet_tpu_torch_cpu"] = run(tpg, icet_tpu_torch, tmetrics, np_pose_to_state,
                                        scans, gt, {"device": "cpu"})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
