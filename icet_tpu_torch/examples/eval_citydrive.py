"""Long-sequence odometry + loop-closure evaluation on the city drive; the
port's counterpart of ``examples/eval_citydrive.py``.

The raycast city block (exact ground truth) reproduces the regime of the
reference's KITTI/Ford/CODD urban sequences: multi-lap drive -> streaming
odometry -> spatial-hash loop detection -> re-registration loop factors
-> block-sparse pose-graph refinement, with ATE/RPE reported before and
after refinement.

Usage:
  python -m icet_tpu_torch.examples.eval_citydrive --frames 550
  python -m icet_tpu_torch.examples.eval_citydrive --frames 550 --device cpu
  python -m icet_tpu_torch.examples.eval_citydrive --state ckpt/drive --chunk 100
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from icet_tpu_torch.examples import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=550)
    ap.add_argument("--seed", type=int, default=0,
                    help="drive fixture seed (scene layout + corruption "
                         "streams)")
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--beams", type=int, default=64)
    ap.add_argument("--azimuth", type=int, default=1024)
    ap.add_argument("--scene", default="city", choices=["city", "block"],
                    help="'city': the seeded city scene (default); 'block': "
                         "the plain block scene (datasets.synthetic.Scene)")
    ap.add_argument("--rect", type=float, nargs=4, default=None,
                    metavar=("X0", "X1", "Y0", "Y1"),
                    help="circuit rectangle (street centerlines, m); "
                         "default CityDriveSource's")
    add_device_arg(ap)
    ap.add_argument("--spawn", default="auto", choices=["auto", "fixed"],
                    help="keyframe spawn policy (KeyframeConfig.spawn): "
                         "'auto' (default) = the distance prior PLUS "
                         "health safety triggers; 'fixed' = distance/angle"
                         "/corr-drop only")
    ap.add_argument("--spawn-distance", type=float, default=None,
                    help="spawn distance prior (both policies; default "
                         "1.5 dynamic / 3.0 benign)")
    ap.add_argument("--stds-growth", type=float, default=None,
                    help="auto-spawn predicted-error growth trigger "
                         "(KeyframeConfig.stds_growth default when unset)")
    ap.add_argument("--keyframe", action="store_true",
                    help="use scan-to-keyframe odometry (KeyframeOdometry) "
                         "instead of frame-to-frame")
    ap.add_argument("--radius", type=float, default=8.0,
                    help="loop-candidate search radius (m) on the drifted "
                         "estimated trajectory")
    ap.add_argument("--min-gap", type=int, default=100,
                    help="minimum frame separation for a loop candidate")
    ap.add_argument("--loop-k", type=int, default=1,
                    help="loop candidates kept per frame (k nearest)")
    ap.add_argument("--out", default=None, help="write TUM trajectories here")
    ap.add_argument("--save-graph", default=None,
                    help="npz path to dump the pose graph (debugging)")
    ap.add_argument("--dynamic", action="store_true",
                    help="non-benign drive: 3 moving cars on the ring, 12%% "
                         "per-frame azimuth dropout, 2 cm per-frame range "
                         "bias jitter")
    ap.add_argument("--chained", action="store_true",
                    help="run the drive through the sequence runners "
                         "(run_odometry_device / run_keyframe_device: "
                         "64-frame uploads, results read back once a block) "
                         "instead of one step per frame; ignores --chunk "
                         "and has no DNN variant")
    ap.add_argument("--guarded", action="store_true",
                    help="enable the degeneracy guard (clip_fill=0.6, "
                         "condition_cutoff=1e4 — PROFILES['odometry_"
                         "guarded'])")
    ap.add_argument("--range-sigma", type=float, default=0.0,
                    help="per-scan common-mode range error in metres "
                         "(ICETConfig.range_sigma) — the --dynamic "
                         "fixture's jitter is 0.02")
    ap.add_argument("--dnn", action="store_true",
                    help="engage the DNN perspective-shift filter in every "
                         "solve (cfg.dnn_filter; bundled pretrained net)")
    ap.add_argument("--state", default=None,
                    help="chunked/resumable run: checkpoint prefix.  The "
                         "drive is generated once and cached beside it; each "
                         "invocation resumes where the last stopped")
    ap.add_argument("--chunk", type=int, default=0,
                    help="with --state: stop and checkpoint after this many "
                         "frames per invocation (0 = run to completion)")
    return ap


def run(args) -> dict:
    """Run the evaluation.  Returns the JAX example's summary (plus
    ``iterations``, ``loop_candidates`` and ``stages``), or, for a
    ``--chunk`` invocation that stopped early, ``{"chunk_done": True,
    "next_k", "frames_registered", "ms_per_frame_wall"}``."""
    from icet_tpu_torch.config import ICETConfig, OdometryConfig
    from icet_tpu_torch.datasets.replay import CityDriveSource
    from icet_tpu_torch.datasets.synthetic import Scene
    from icet_tpu_torch.device import resolve_device
    from icet_tpu_torch.odometry import OdometryFrame, OdometryPipeline
    from icet_tpu_torch.pose_graph import (
        detect_loop_candidates,
        graph_from_odometry,
        optimize_poses_sparse,
        states_to_poses,
    )
    from icet_tpu_torch.utils.metrics import ate_rmse, rpe, save_tum
    from icet_tpu_torch.utils.profiling import StageTimer

    dev = resolve_device(args.device)
    if args.chained and args.dnn:
        raise SystemExit("--chained has no DNN variant")
    cfg = ICETConfig()  # canonical 75x24, 7 iters (odometry profile)
    if args.dynamic:
        cfg = cfg.replace(remove_moving=True)
    if args.range_sigma > 0.0:
        cfg = cfg.replace(range_sigma=args.range_sigma)
    if args.guarded:
        cfg = cfg.replace(clip_fill=0.6, condition_cutoff=1e4)
    if args.dnn:
        cfg = cfg.replace(dnn_filter=True)
    # The reference's 0.3 m clamp assumes slow indoor motion
    # (simpleMapMaker.cpp:129-137); at KITTI speeds (~1 m/frame at 10 Hz)
    # legitimate motion exceeds it.
    odo_cfg = OdometryConfig(divergence_clamp=2.5)

    dyn = dict(moving_cars=3, dropout_frac=0.12, range_bias_std=0.02)
    src = CityDriveSource(
        n_frames=args.frames, speed=args.speed,
        n_beams=args.beams, n_azimuth=args.azimuth, seed=args.seed,
        scene=Scene() if args.scene == "block" else None,
        rect=None if args.rect is None else tuple(args.rect),
        **(dyn if args.dynamic else {}),
    )
    print(f"city drive: {args.frames} frames x {args.beams}x{args.azimuth} "
          f"rays, {src.lap_length:.0f} m/lap, "
          f"{args.frames * args.speed / src.lap_length:.1f} laps")

    if args.keyframe:
        from icet_tpu_torch.config import KeyframeConfig
        from icet_tpu_torch.keyframe import KeyframeOdometry

        # On corrupted scans the fixed spawn distance dominates keyframe-
        # mode ATE; the "auto" policy (default) adds the solver's own
        # health triggers on top of the distance prior (KeyframeConfig.spawn).
        if args.spawn_distance is not None:
            dist = args.spawn_distance
        else:
            dist = 1.5 if args.dynamic else 3.0
        kf_kw = {}
        if args.stds_growth is not None:
            kf_kw["stds_growth"] = args.stds_growth
        pipe = KeyframeOdometry(
            cfg,
            KeyframeConfig(spawn=args.spawn, spawn_distance=dist,
                           spawn_angle=0.3,
                           delta_clamp=odo_cfg.divergence_clamp, **kf_kw),
            device=dev,
        )
    else:
        pipe = OdometryPipeline(cfg, odo_cfg, device=dev)

    # ---- frame source: streamed, or disk-cached for chunked resume ------
    hist = {"X": [], "stds": [], "T": [], "div": [], "it": []}
    start_k = 0
    if args.state:
        from icet_tpu_torch.utils.checkpoint import (
            keyframe_state, load_checkpoint, odometry_state,
            restore_keyframe, restore_odometry, save_checkpoint,
        )

        sc_path, gt_path = args.state + ".scans.npy", args.state + ".gt.npy"
        if not (os.path.exists(sc_path) and os.path.exists(gt_path)):
            sl, gl = [], []
            for scan, T in src:
                sl.append(np.asarray(scan, np.float32))
                gl.append(np.asarray(T))
            os.makedirs(os.path.dirname(sc_path) or ".", exist_ok=True)
            np.save(sc_path, np.stack(sl))
            np.save(gt_path, np.stack(gl))
        scans = np.load(sc_path, mmap_mode="r")
        gt = list(np.load(gt_path))
        if os.path.exists(args.state + ".npz"):
            st = load_checkpoint(args.state)
            start_k = int(st["next_k"])
            for name in hist:
                if name in st["hist"]:
                    hist[name] = [v for v in np.asarray(st["hist"][name])]
            if len(hist["it"]) != len(hist["X"]):  # a JAX package checkpoint
                hist["it"] = [0] * len(hist["X"])
            if args.keyframe:
                restore_keyframe(pipe, st["pipe"], replay_overlap=True)
            else:
                restore_odometry(pipe, st["pipe"])
                pipe._index = start_k - 1
            # Re-seed on the last processed scan (returns None: the voxel
            # model is refit; keyframe mode re-spawns at the restored pose
            # without re-inserting map points).
            seed = pipe.step(np.asarray(scans[start_k - 1], np.float32))
            if seed is not None:
                raise RuntimeError("resume seed unexpectedly registered")
            print(f"resumed at frame {start_k} "
                  f"({len(hist['X'])} frames of history)")
        frame_iter = (
            (k, scans[k], gt[k]) for k in range(start_k, args.frames)
        )
    else:
        scans, gt = [], []

        def _stream():
            for i, (scan, T) in enumerate(src):
                scans.append(scan)
                gt.append(T)
                yield i, scan, T

        frame_iter = _stream()

    timer = StageTimer()
    if args.chained:
        if not args.state:
            sl, gl = [], []
            for s_, T_ in src:
                sl.append(np.asarray(s_, np.float32))
                gl.append(np.asarray(T_))
            scans, gt = np.stack(sl), gl
        hist = {"X": [], "stds": [], "T": [], "div": [], "it": []}  # full re-run
        t0 = time.perf_counter()
        with timer.stage("step", sync_on=dev):
            if args.keyframe:
                from icet_tpu_torch.keyframe import run_keyframe_device

                recs, _bm = run_keyframe_device(
                    np.asarray(scans), cfg, pipe.kf_cfg, pipe.bm_cfg, device=dev
                )
            else:
                from icet_tpu_torch.odometry import run_odometry_device

                recs = run_odometry_device(np.asarray(scans), cfg, odo_cfg, device=dev)
        for f in recs:
            _record(hist, f)
        processed = len(recs)
        frame_iter = iter(())
    else:
        t0 = time.perf_counter()
        processed = 0
    for i, scan, T in frame_iter:
        with timer.stage("step", sync_on=dev):
            f = pipe.step(np.asarray(scan, np.float32))
        processed += 1
        if f is not None:
            _record(hist, f)
        if i and i % 50 == 0:
            el = time.perf_counter() - t0
            print(f"  frame {i}: {el / processed * 1000:.0f} ms/frame wall "
                  f"(divergences so far: {sum(hist['div'])})")
        if (args.state and args.chunk and processed >= args.chunk
                and i + 1 < args.frames):
            save_checkpoint(args.state, {
                "next_k": np.int64(i + 1),
                "pipe": (keyframe_state(pipe) if args.keyframe
                         else odometry_state(pipe)),
                "hist": {k: np.stack(v) for k, v in hist.items()},
            })
            out = {
                "chunk_done": True, "next_k": i + 1,
                "frames_registered": len(hist["X"]),
                "ms_per_frame_wall": round(
                    (time.perf_counter() - t0) / processed * 1000, 1),
            }
            print(json.dumps(out))
            return out
    wall = time.perf_counter() - t0

    # Rebuild frame records (mode-agnostic) from the accumulated history so
    # fresh, chunked, and resumed runs share one downstream path.
    z6 = np.zeros(6, np.float32)
    frames = [
        OdometryFrame(
            index=i + 1, X=hist["X"][i], pred_stds=hist["stds"][i],
            T_world=hist["T"][i], pose=z6, twist=z6,
            diverged=bool(hist["div"][i]), n_corr=np.zeros(1, np.int32),
            solve_ms=0.0, iterations=int(hist["it"][i]),
        )
        for i in range(len(hist["X"]))
    ]
    n_div = sum(f.diverged for f in frames)
    est = [np.eye(4)] + [f.T_world for f in frames]
    ref = [np.linalg.inv(gt[0]) @ T for T in gt]

    ate_odo = ate_rmse(est, ref)
    t_err, r_err = rpe(est, ref)
    print(f"\nodometry: {len(frames)} registrations, {n_div} divergences, "
          f"{wall / max(processed, 1) * 1000:.0f} ms/frame wall (this invocation)")
    print(f"  ATE RMSE {ate_odo * 100:.1f} cm | RPE {t_err.mean() * 100:.2f} cm"
          f" / {np.degrees(r_err.mean()):.4f} deg per frame")

    # Loop closure on the ESTIMATED trajectory (drifted positions are what a
    # real system has available).
    positions = np.stack([T[:3, 3] for T in est])
    cands = detect_loop_candidates(
        positions, radius=args.radius, min_gap=args.min_gap, k=args.loop_k
    )
    print(f"\nloop candidates: {len(cands)}")
    t0 = time.perf_counter()
    with timer.stage("loops", sync_on=dev):
        loops = _close(scans, cands, est, cfg, dev)
    print(f"verified loop factors: {len(loops)} "
          f"({time.perf_counter() - t0:.1f} s)")

    states0, graph = graph_from_odometry(frames, loop_factors=loops)
    if args.save_graph:
        np.savez(
            args.save_graph,
            states0=states0,
            idx_i=graph.idx_i.numpy(),
            idx_j=graph.idx_j.numpy(),
            meas=graph.meas.numpy(),
            info=graph.info.numpy(),
            gt=np.stack(ref),
        )
    # Cauchy robust kernel at the 6-DOF 95% chi-square radius: inconsistent
    # or overconfident loop factors degrade gracefully.
    with timer.stage("solve", sync_on=dev):
        opt = optimize_poses_sparse(states0, graph, 10, 50, robust_delta=3.5,
                                    device=dev).cpu().numpy()
    est_opt = states_to_poses(opt)
    ate_opt = ate_rmse(list(est_opt), ref)
    print(f"pose graph: ATE RMSE {ate_opt * 100:.1f} cm "
          f"(odometry was {ate_odo * 100:.1f} cm)")

    if args.out:
        save_tum(args.out + ".odo.tum", est)
        save_tum(args.out + ".opt.tum", list(est_opt))

    summary = {
        "frames": len(frames),
        "divergences": n_div,
        "ate_odometry_cm": round(ate_odo * 100, 2),
        "ate_refined_cm": round(ate_opt * 100, 2),
        "rpe_t_cm": round(float(t_err.mean()) * 100, 3),
        "rpe_r_deg": round(float(np.degrees(r_err.mean())), 4),
        "loop_factors": len(loops),
        "ms_per_frame_wall": round(wall / max(processed, 1) * 1000, 1),
        "iterations": int(sum(f.iterations for f in frames)),
        "loop_candidates": len(cands),
        "stages": timer.summary(),
    }
    return summary


def _record(hist: dict, f) -> None:
    hist["X"].append(np.asarray(f.X))
    hist["stds"].append(np.asarray(f.pred_stds))
    hist["T"].append(np.asarray(f.T_world))
    hist["div"].append(bool(f.diverged))
    hist["it"].append(int(f.iterations))


def _close(scans, cands, est, cfg, dev):
    """Verify loop candidates with the estimated relative pose as warm start."""
    from icet_tpu_torch.keyframe import np_pose_to_state
    from icet_tpu_torch.pose_graph import close_loops

    def x0_fn(i, j):
        rel = np.linalg.inv(est[i]) @ est[j]
        return np_pose_to_state(rel).astype(np.float32)

    return close_loops(scans, cands, cfg, x0_fn=x0_fn, device=dev)


def main() -> None:
    print(json.dumps(run(build_parser().parse_args())))


if __name__ == "__main__":
    main()
