"""Trajectory evaluation harness: recorded scans or synthetic; the port's
counterpart of ``examples/eval_odometry.py``.

With a directory of KITTI velodyne .bin (or .npy) scans, replayed through
``ReplaySource``, and an optional ground-truth poses file (KITTI odometry
format: 12 numbers per line, the 3x4 world<-cam matrix), runs the
odometry pipeline and reports ATE/RPE.  Without data it falls back to the
synthetic simulator so the harness is always runnable.

Usage:
  python -m icet_tpu_torch.examples.eval_odometry --scans /path/to/velodyne --poses poses.txt
  python -m icet_tpu_torch.examples.eval_odometry --synthetic 25 --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from icet_tpu_torch.examples import add_device_arg


def load_kitti_poses(path):
    rows = np.loadtxt(path)
    out = []
    for r in rows:
        T = np.eye(4)
        T[:3, :4] = r.reshape(3, 4)
        out.append(T)
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", default=None, help="dir of .bin/.npy scans")
    ap.add_argument("--poses", default=None, help="ground-truth poses file")
    ap.add_argument("--synthetic", type=int, default=0, help="n synthetic frames")
    ap.add_argument("--max-frames", type=int, default=200)
    ap.add_argument("--profile", default="odometry", choices=["odometry", "mapping"])
    ap.add_argument("--out", default=None, help="write TUM trajectory here")
    add_device_arg(ap)
    ap.add_argument(
        "--clamp", type=float, default=2.5,
        help="divergence clamp (m) on the per-frame solution; must admit "
             "the sequence's real per-frame motion (KITTI at 10 Hz moves "
             "1-3 m/frame — the reference's 0.3 default rejects it and "
             "zeroes every solve)",
    )
    return ap


def run(args) -> dict:
    """Run the evaluation; returns ``{frames, divergences, iterations,
    mean_solve_ms}`` and, with ground truth, ``ate_cm``, ``rpe_t_cm`` and
    ``rpe_r_deg``."""
    from icet_tpu_torch.config import PROFILES, ICETConfig, OdometryConfig
    from icet_tpu_torch.device import resolve_device
    from icet_tpu_torch.odometry import OdometryPipeline
    from icet_tpu_torch.utils.metrics import ate_rmse, rpe, save_tum

    dev = resolve_device(args.device)
    if args.scans:
        from icet_tpu_torch.datasets.replay import ReplaySource

        src = ReplaySource(args.scans)
        scans = iter(src)
        gt = load_kitti_poses(args.poses) if args.poses else None
        cfg = PROFILES[args.profile]
        n_frames = min(len(src), args.max_frames)
    else:
        from icet_tpu_torch.datasets.replay import SyntheticTrajectorySource

        n_frames = args.synthetic or 15
        pairs = list(
            SyntheticTrajectorySource(
                n_frames=n_frames, speed=0.25, yaw_rate=0.01,
                n_beams=48, n_azimuth=512,
            )
        )
        scans = (s for s, _ in pairs)
        gt = [T for _, T in pairs]
        cfg = ICETConfig(
            n_theta=48, n_phi=16, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
            n_iters=6, min_pts=20, min_range=1.0,
        )

    pipe = OdometryPipeline(cfg, OdometryConfig(divergence_clamp=args.clamp), device=dev)
    frames = []
    for i, scan in enumerate(scans):
        if i >= n_frames:
            break
        f = pipe.step(scan)
        if f is not None:
            frames.append(f)
            if f.index % 10 == 0:
                print(
                    f"frame {f.index}: |t|={np.linalg.norm(f.X[:3]):.3f} m "
                    f"solve={f.solve_ms:.1f} ms diverged={f.diverged}"
                )

    est = [np.eye(4)] + [f.T_world for f in frames]
    mean_solve = float(np.mean([f.solve_ms for f in frames])) if frames else 0.0
    print(f"\nprocessed {len(frames)} registrations; mean solve {mean_solve:.1f} ms")
    summary = {
        "frames": len(frames),
        "divergences": int(sum(f.diverged for f in frames)),
        "iterations": int(sum(f.iterations for f in frames)),
        "mean_solve_ms": round(mean_solve, 1),
    }

    if gt is not None:
        ref = [np.linalg.inv(gt[0]) @ T for T in gt[: len(est)]]
        ate = ate_rmse(est, ref)
        t_err, r_err = rpe(est, ref)
        print(f"ATE RMSE: {ate * 100:.2f} cm")
        print(f"RPE: {t_err.mean() * 100:.2f} cm / "
              f"{np.degrees(r_err.mean()):.3f} deg per frame")
        summary.update(ate_cm=round(ate * 100, 4),
                       rpe_t_cm=round(float(t_err.mean()) * 100, 3),
                       rpe_r_deg=round(float(np.degrees(r_err.mean())), 4))

    if args.out:
        save_tum(args.out, est)
        print(f"wrote {args.out}")
    return summary


def main() -> None:
    print(json.dumps(run(build_parser().parse_args())))


if __name__ == "__main__":
    main()
