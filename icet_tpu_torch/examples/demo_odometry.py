"""Odometry + pose-graph demo on a synthetic trajectory with ground truth;
the port's counterpart of ``examples/demo_odometry.py``.

Runs the streaming odometry pipeline over a simulated drive, refines the
trajectory with pose-graph optimization, and reports ATE before and after.

Usage: python -m icet_tpu_torch.examples.demo_odometry [--frames 12] [--viz out_dir]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from icet_tpu_torch.examples import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--viz", default=None, help="directory for the trajectory PNG")
    add_device_arg(ap)
    return ap


def run(args) -> dict:
    """Returns ``{frames, ate_cm, ate_refined_cm, mean_solve_ms}``."""
    from icet_tpu_torch.config import ICETConfig
    from icet_tpu_torch.datasets.replay import SyntheticTrajectorySource
    from icet_tpu_torch.device import resolve_device
    from icet_tpu_torch.odometry import OdometryPipeline
    from icet_tpu_torch.pose_graph import graph_from_odometry, optimize_poses, states_to_poses
    from icet_tpu_torch.utils.metrics import ate_rmse

    dev = resolve_device(args.device)
    cfg = ICETConfig(
        n_theta=48, n_phi=16, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
        n_iters=6, min_pts=20, min_range=1.0,
    )
    src = SyntheticTrajectorySource(
        n_frames=args.frames, speed=0.25, yaw_rate=0.01, n_beams=48, n_azimuth=512
    )
    frames_gt = list(src)
    pipe = OdometryPipeline(cfg, device=dev)
    frames = list(pipe.run(s for s, _ in frames_gt))

    est = [np.eye(4)] + [f.T_world for f in frames]
    ref = [np.linalg.inv(frames_gt[0][1]) @ T for _, T in frames_gt]
    mean_solve = float(np.mean([f.solve_ms for f in frames]))
    ate = ate_rmse(est, ref)
    print(f"frames: {len(frames)};  mean solve {mean_solve:.1f} ms")
    print(f"odometry ATE RMSE: {ate * 100:.2f} cm")

    states0, graph = graph_from_odometry(frames)
    states = optimize_poses(states0, graph, 8, device=dev)
    refined = list(states_to_poses(states))
    ate_ref = ate_rmse(refined, ref)
    print(f"pose-graph ATE RMSE: {ate_ref * 100:.2f} cm")

    if args.viz:
        from icet_tpu_torch import viz

        os.makedirs(args.viz, exist_ok=True)
        viz.plot_trajectory(os.path.join(args.viz, "trajectory.png"), est, ref)
        print(f"wrote {args.viz}/trajectory.png")
    return {"frames": len(frames), "ate_cm": round(ate * 100, 4),
            "ate_refined_cm": round(ate_ref * 100, 4),
            "mean_solve_ms": round(mean_solve, 1)}


def main() -> None:
    print(json.dumps(run(build_parser().parse_args())))


if __name__ == "__main__":
    main()
