"""Write a synthetic KITTI-odometry-format sequence to disk; the port's
counterpart of ``examples/make_kitti_sequence.py``.

Generates the raycast city drive (exact ground truth, optional moving
cars / dropout / range bias) and writes it in the benchmark's layout:
``<out>/velodyne/%06d.bin`` (float32 x,y,z,reflectance records),
``<out>/poses.txt`` and, with ``--calib``, a ``<out>/calib.txt`` whose
``Tr`` is not the identity (the poses are then written in the camera
frame, as KITTI's are):

    python -m icet_tpu_torch.examples.make_kitti_sequence --out seq --frames 50
    python -m icet_tpu_torch.examples.eval_kitti --sequence seq \\
        --poses seq/poses.txt --out seq/traj
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

#: the camera-to-velodyne transform ``--calib`` writes: KITTI's axis swap
#: (camera z forward = velodyne x) with a small lever arm
CALIB_TR = np.array([
    [0.0, -1.0, 0.0, -0.004],
    [0.0, 0.0, -1.0, -0.076],
    [1.0, 0.0, 0.0, -0.272],
    [0.0, 0.0, 0.0, 1.0],
])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="sequence directory to write")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--speed", type=float, default=1.0, help="metres/frame")
    ap.add_argument("--beams", type=int, default=64)
    ap.add_argument("--azimuth", type=int, default=1024)
    ap.add_argument("--moving-cars", type=int, default=0)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--range-bias-std", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calib", action="store_true",
                    help="write calib.txt (Tr = CALIB_TR) and camera-frame poses")
    return ap


def run(args) -> dict:
    """Write the sequence; returns ``{"dir", "frames", "bytes"}``."""
    from icet_tpu_torch.datasets.kitti import write_kitti_sequence
    from icet_tpu_torch.datasets.replay import CityDriveSource

    src = CityDriveSource(
        n_frames=args.frames, speed=args.speed, n_beams=args.beams,
        n_azimuth=args.azimuth, seed=args.seed,
        moving_cars=args.moving_cars, dropout_frac=args.dropout,
        range_bias_std=args.range_bias_std,
    )
    scans, poses = [], []
    for scan, T in src:
        scans.append(np.asarray(scan, np.float32))
        poses.append(np.asarray(T))
    tr = None
    if args.calib:
        # T_w<-cam0 = T_w<-velo @ Tr^-1, so that T_w<-cam0 @ Tr reads back
        # the velodyne poses.
        tr = CALIB_TR
        poses = [T @ np.linalg.inv(tr) for T in poses]
    d = write_kitti_sequence(args.out, scans, poses, calib_tr=tr)
    n_bytes = sum(
        os.path.getsize(os.path.join(d, "velodyne", f))
        for f in os.listdir(os.path.join(d, "velodyne"))
    )
    print(f"wrote {len(scans)} frames ({n_bytes / 1e6:.1f} MB) to {d}")
    print(f"score it:\n  python -m icet_tpu_torch.examples.eval_kitti --sequence {d} "
          f"--poses {os.path.join(d, 'poses.txt')} --out {os.path.join(d, 'traj')}")
    return {"dir": d, "frames": len(scans), "bytes": n_bytes}


def main() -> None:
    print(json.dumps(run(build_parser().parse_args())))


if __name__ == "__main__":
    main()
