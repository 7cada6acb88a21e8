"""KITTI odometry-sequence evaluation harness; the port's counterpart of
``examples/eval_kitti.py``.

Scores the port's odometry on a KITTI odometry-benchmark sequence
(velodyne .bin directory + poses.txt ground truth): scans streamed through
the native prefetch queue, registration on the card, ATE/RPE against
ground truth, TUM export and an HTML map, optional loop closure +
block-sparse pose-graph refinement, and an optional per-pair head-to-head
against the reference C++ ICET run as a black-box oracle executable.

Usage:
  python -m icet_tpu_torch.examples.eval_kitti --sequence /data/kitti/sequences/00 \\
      --poses /data/kitti/poses/00.txt
  python -m icet_tpu_torch.examples.eval_kitti --sequence ... --keyframe --refine
  python -m icet_tpu_torch.examples.eval_kitti --sequence ... --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np

from icet_tpu_torch.examples import add_device_arg

#: map points the HTML viewer keeps (save_map_html's default)
MAP_POINTS = 300_000


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sequence", required=True,
                    help="KITTI sequence dir (contains velodyne/, calib.txt)")
    ap.add_argument("--poses", default=None,
                    help="ground-truth poses file (poses/NN.txt); omit to "
                         "run unscored")
    ap.add_argument("--frames", type=int, default=None,
                    help="cap the number of frames")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--max-points", type=int, default=131072)
    add_device_arg(ap)
    ap.add_argument("--prefetch", default="auto", choices=["auto", "on", "off"],
                    help="read scans through the native C prefetch queue: "
                         "'on' requires it, 'auto' falls back to numpy "
                         "reads when it cannot be built")
    ap.add_argument("--keyframe", action="store_true",
                    help="scan-to-keyframe odometry instead of frame-to-frame")
    ap.add_argument("--refine", action="store_true",
                    help="loop closure + block-sparse pose-graph refinement")
    ap.add_argument("--radius", type=float, default=8.0)
    ap.add_argument("--min-gap", type=int, default=100)
    ap.add_argument("--loop-k", type=int, default=1,
                    help="loop candidates kept per frame (k nearest)")
    ap.add_argument("--clamp", type=float, default=4.0,
                    help="divergence clamp (m); KITTI reaches ~3.3 m/frame")
    ap.add_argument("--n-iters", type=int, default=7)
    ap.add_argument("--min-range", type=float, default=2.0)
    ap.add_argument("--n-theta", type=int, default=75,
                    help="azimuth bins (scale down for low-res fixtures)")
    ap.add_argument("--n-phi", type=int, default=24)
    ap.add_argument("--min-pts", type=int, default=25)
    ap.add_argument("--phi-band", type=float, default=None,
                    help="half-width of the elevation band around the "
                         "horizon, radians (default: full sphere)")
    ap.add_argument("--out", default=None,
                    help="output prefix: TUM trajectories and an HTML map")
    ap.add_argument("--oracle", default=None,
                    help="path to the reference C++ oracle executable "
                         "(tools/oracle/build_oracle.sh) for a per-pair "
                         "head-to-head trajectory")
    ap.add_argument("--dnn", action="store_true",
                    help="engage the DNN perspective-shift filter in every "
                         "solve (cfg.dnn_filter; bundled pretrained net)")
    ap.add_argument("--oracle-thresh", type=float, default=0.1,
                    help="reference cluster jump threshold (its 0.1 indoor "
                         "default mis-clusters noisy sparse scans; the "
                         "reference's own code comments say 0.3-0.5 outdoor)")
    ap.add_argument("--oracle-buff", type=float, default=0.1)
    ap.add_argument("--strict-real", action="store_true",
                    help="real-data mode: fail fast on format surprises "
                         "(truncated .bin, scans over --max-points, "
                         "non-finite points, short poses file) instead of "
                         "silently padding/subsampling")
    return ap


def run(args) -> dict:
    """Run the evaluation; returns the summary (the JAX example's keys, plus
    ``iterations``, ``stages``, with ``--keyframe`` ``keyframes`` and with
    ``--refine`` ``loop_candidates``)."""
    from icet_tpu_torch.config import ICETConfig, OdometryConfig
    from icet_tpu_torch.datasets.kitti import KittiOdometrySource
    from icet_tpu_torch.device import resolve_device
    from icet_tpu_torch.odometry import OdometryPipeline
    from icet_tpu_torch.utils.metrics import ate_rmse, rpe, save_tum
    from icet_tpu_torch.utils.profiling import StageTimer

    dev = resolve_device(args.device)
    grid = {}
    if args.phi_band is not None:
        grid = dict(phi_min=np.pi / 2 - args.phi_band,
                    phi_max=np.pi / 2 + args.phi_band)
    if args.oracle and not (os.path.isfile(args.oracle)
                            and os.access(args.oracle, os.X_OK)):
        # Fail BEFORE the (long) odometry pass, not after it.
        raise SystemExit(
            f"--oracle {args.oracle!r} is not an executable; build it with "
            "sh tools/oracle/build_oracle.sh"
        )
    cfg = ICETConfig(n_iters=args.n_iters, min_range=args.min_range,
                     n_theta=args.n_theta, n_phi=args.n_phi,
                     min_pts=args.min_pts, convergence_tol=1e-4,
                     dnn_filter=args.dnn, **grid)
    src = KittiOdometrySource(
        args.sequence, poses_file=args.poses, max_points=args.max_points,
        start=args.start,
        end=None if args.frames is None else args.start + args.frames,
        prefetch={"auto": "auto", "on": True, "off": False}[args.prefetch],
        strict=args.strict_real,
    )

    if args.keyframe:
        from icet_tpu_torch.config import KeyframeConfig
        from icet_tpu_torch.keyframe import KeyframeOdometry

        pipe = KeyframeOdometry(
            cfg, KeyframeConfig(spawn_distance=3.0, spawn_angle=0.3,
                                delta_clamp=args.clamp),
            device=dev,
        )
    else:
        pipe = OdometryPipeline(cfg, OdometryConfig(divergence_clamp=args.clamp),
                                device=dev)

    timer = StageTimer()
    scans, gt, frames = [], [], []
    t0 = time.perf_counter()
    stream = iter(src)
    i = 0
    while True:
        with timer.stage("read"):
            item = next(stream, None)
        if item is None:
            break
        scan, T = item
        scans.append(scan)
        gt.append(T)
        with timer.stage("step", sync_on=dev):
            f = pipe.step(scan)
        if f is not None:
            frames.append(f)
        if i and i % 50 == 0:
            el = time.perf_counter() - t0
            print(f"  frame {i}/{len(src)}: {el / i * 1000:.0f} ms/frame wall")
        i += 1
    wall = time.perf_counter() - t0

    n_div = sum(f.diverged for f in frames)
    est = [np.eye(4)] + [f.T_world for f in frames]
    summary = {
        "frames": len(frames),
        "divergences": int(n_div),
        "ms_per_frame_wall": round(wall / max(len(frames), 1) * 1000, 1),
        "iterations": int(sum(f.iterations for f in frames)),
    }
    if args.keyframe:
        summary["keyframes"] = list(pipe.keyframe_indices)
    ref = None
    if args.poses is not None:
        ref = [np.linalg.inv(gt[0]) @ T for T in gt]
        ate = ate_rmse(est, ref)
        t_err, r_err = rpe(est, ref)
        summary.update(
            ate_odometry_cm=round(ate * 100, 2),
            rpe_t_cm=round(float(t_err.mean()) * 100, 3),
            rpe_r_deg=round(float(np.degrees(r_err.mean())), 4),
        )
        print(f"odometry: ATE RMSE {ate * 100:.1f} cm | "
              f"RPE {t_err.mean() * 100:.2f} cm / "
              f"{np.degrees(r_err.mean()):.4f} deg per frame, "
              f"{n_div} divergences")

    if args.refine:
        from icet_tpu_torch.keyframe import np_pose_to_state
        from icet_tpu_torch.pose_graph import (
            close_loops,
            detect_loop_candidates,
            graph_from_odometry,
            optimize_poses_sparse,
            states_to_poses,
        )

        with timer.stage("refine", sync_on=dev):
            positions = np.stack([T[:3, 3] for T in est])
            cands = detect_loop_candidates(
                positions, radius=args.radius, min_gap=args.min_gap,
                k=args.loop_k,
            )
            print(f"loop candidates: {len(cands)}")

            def x0_fn(i, j):
                rel = np.linalg.inv(est[i]) @ est[j]
                return np_pose_to_state(rel).astype(np.float32)

            loops = close_loops(scans, cands, cfg, x0_fn=x0_fn, device=dev)
            states0, graph = graph_from_odometry(frames, loop_factors=loops)
            opt = optimize_poses_sparse(states0, graph, 10, 50, robust_delta=3.5,
                                        device=dev).cpu().numpy()
        est_opt = list(states_to_poses(opt))
        summary["loop_candidates"] = len(cands)
        summary["loop_factors"] = len(loops)
        if ref is not None:
            summary["ate_refined_cm"] = round(ate_rmse(est_opt, ref) * 100, 2)
            print(f"pose graph: ATE RMSE {summary['ate_refined_cm']} cm")
        if args.out:
            save_tum(args.out + ".opt.tum", est_opt)

    if args.oracle:
        summary["oracle"] = _run_oracle(args, scans, ref)

    if args.out:
        save_tum(args.out + ".odo.tum", est)
        if ref is not None:
            save_tum(args.out + ".gt.tum", ref)
        _save_map(args.out + ".map.html", scans, est)
    summary["stages"] = timer.summary()
    return summary


def _save_map(path: str, scans, est) -> str:
    """The scans at their estimated poses, an even share of MAP_POINTS
    from each, with the trajectory as the trail: one HTML viewer file."""
    from icet_tpu_torch.viz_html import save_map_html

    per_scan = max(MAP_POINTS // max(len(scans), 1), 1)
    parts = []
    for scan, T in zip(scans, est):
        pts = np.asarray(scan, np.float32)
        pts = pts[np.any(pts != 0.0, axis=1)]
        if len(pts) > per_scan:
            pts = pts[np.linspace(0, len(pts) - 1, per_scan).astype(np.int64)]
        T = np.asarray(T, np.float64)
        parts.append((pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32))
    trail = np.stack([np.asarray(T)[:3, 3] for T in est])
    return save_map_html(path, np.concatenate(parts), trail=trail, title="KITTI map")


def _run_oracle(args, scans, ref) -> dict:
    """Per-pair reference C++ trajectory on the identical scans (head-to-head).

    The oracle executable (tools/oracle/) takes raw float32 xyz binaries
    and prints the reference's X; poses compose exactly as the port's own
    (pose_matrix of [t, -eulers]).
    """
    import torch

    from icet_tpu_torch.ops.geometry import pose_matrix

    t0 = time.perf_counter()
    poses = [np.eye(4)]
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i, scan in enumerate(scans):
            pts = np.asarray(scan, np.float32).reshape(-1, 3)
            pts = pts[np.linalg.norm(pts, axis=1) > args.min_range]
            p = os.path.join(td, f"{i:06d}.bin")
            pts.tofile(p)
            paths.append(p)
        failed = 0
        for a, b in zip(paths[:-1], paths[1:]):
            try:
                r = subprocess.run(
                    [args.oracle, a, b, str(args.n_iters), str(args.n_phi),
                     str(args.n_theta), str(args.min_pts),
                     str(args.oracle_thresh), str(args.oracle_buff)],
                    capture_output=True, text=True, timeout=600,
                )
            except (subprocess.TimeoutExpired, OSError):
                r = None
            X = None
            if r is not None and r.returncode == 0 and "X:" in r.stdout:
                try:
                    X = np.array(
                        [float(v) for v in
                         r.stdout.split("X:")[1].split("\n")[0].split()],
                        np.float32,
                    )
                except ValueError:
                    X = None
            if X is None or X.shape != (6,) or not np.isfinite(X).all():
                # One crashed/hung oracle pair must not lose the whole run:
                # treat it like a clamped divergence (identity step) and
                # count it.
                failed += 1
                X = np.zeros(6, np.float32)
            # Same divergence guard the port's pipeline gets (the
            # reference's mapping node has the identical clamp,
            # simpleMapMaker.cpp:129-137).
            if np.any(np.abs(X) > args.clamp):
                X = np.zeros(6, np.float32)
            T_rel = pose_matrix(torch.from_numpy(X)).numpy()
            poses.append(poses[-1] @ T_rel)
    wall = time.perf_counter() - t0
    out = {
        "ms_per_frame_wall": round(wall / max(len(poses) - 1, 1) * 1000, 1),
        "failed_pairs": failed,
    }
    if ref is not None:
        from icet_tpu_torch.utils.metrics import ate_rmse, rpe

        t_err, r_err = rpe(poses, ref)
        out.update(
            ate_cm=round(ate_rmse(poses, ref) * 100, 2),
            rpe_t_cm=round(float(t_err.mean()) * 100, 3),
            rpe_r_deg=round(float(np.degrees(r_err.mean())), 4),
        )
        print(f"reference oracle: ATE RMSE {out['ate_cm']} cm | "
              f"RPE {out['rpe_t_cm']} cm")
    return out


def main() -> None:
    args = build_parser().parse_args()
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()
