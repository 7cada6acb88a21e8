#!/usr/bin/env python3
"""Trajectory accuracy of the keyframe, DNN-keyframe and MapMaker drives on
the CPU: the JAX package (``icet_tpu``, the reference) and, with
``--port``, the PyTorch port on its CPU path.

The drives are the ones ``chip_smoke.py`` drives on the card: the 24-frame
64x1024 city drive (``CityDriveSource(n_frames=24, speed=1.0, n_beams=64,
n_azimuth=1024)``).

* keyframe: ``KeyframeOdometry`` at bench.py's keyframe config,
  ``ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)``,
  ``KeyframeConfig(spawn_distance=3.0, spawn_angle=0.3, delta_clamp=2.5)``
  and the default ``BlockMapConfig()``;
* dnn_keyframe: the same with ``dnn_filter=True``;
* mapmaker: ``MapMaker`` at ``PROFILES["mapping"]``,
  ``OdometryConfig(divergence_clamp=2.5)`` and the default ``MapConfig()``;
  its trajectory is the composition of the frames' guarded ``X``.

``chip_smoke.py`` gates the card's ATE on each drive at the JAX package's
figure printed here plus 0.5 cm.  Run from the repository root:

    JAX_PLATFORMS=cpu python3 tools/keyframe_drive_ate_cpu.py [--port] [--fused-reference] [--eager-reference]

``--fused-reference`` runs the JAX package's BiasNet through its fused
Pallas encoder in interpret mode; ``--eager-reference`` runs the JAX
package's drives under ``jax.disable_jit()``, which rounds the BiasNet's
bf16 stages as the code states (see ``tools/dnn_drive_ate_cpu.py``); with
``--port`` each drive's output also holds both packages' per-frame X and
correspondence counts and the first frame where they differ.
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

from tools.dnn_drive_ate_cpu import (  # noqa: E402
    first_difference,
    force_fused_reference,
    reference_mode,
)

DRIVES = ("keyframe", "dnn_keyframe", "mapmaker")


def _euler_R(angs) -> np.ndarray:
    phi, theta, psi = angs
    cf, sf = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(psi), np.sin(psi)
    return np.array([
        [ct * cp, sp * cf + sf * st * cp, sf * sp - st * cf * cp],
        [-sp * ct, cf * cp - sf * st * sp, sf * cp + st * sp * cf],
        [st, -sf * ct, cf * ct],
    ])


def pose_matrix(X) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = _euler_R(-np.asarray(X[3:6], np.float64))
    T[:3, 3] = X[:3]
    return T


def ate(poses, gt) -> float:
    """RMS translation error of ``[I] + poses`` against the drive's poses
    relative to its first frame."""
    est = [np.eye(4)] + [np.asarray(T, np.float64) for T in poses]
    ref = [np.linalg.inv(gt[0]) @ T for T in gt[: len(est)]]
    err = [np.linalg.norm(e[:3, 3] - r[:3, 3]) for e, r in zip(est, ref)]
    return float(np.sqrt(np.mean(np.square(err))))


def composed(frames) -> list[np.ndarray]:
    T, out = np.eye(4), []
    for f in frames:
        T = T @ pose_matrix(f.X)
        out.append(T)
    return out


def run(pkg, name: str, scans, gt, device_kw: dict) -> dict:
    cfg_kw = dict(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)
    t0 = time.perf_counter()
    if name == "mapmaker":
        maker = pkg.MapMaker(pkg.PROFILES["mapping"], pkg.MapConfig(),
                             pkg.OdometryConfig(divergence_clamp=2.5), **device_kw)
        frames = [f for f in (maker.step(s) for s in scans) if f is not None]
        return {"ate_m": ate(composed(frames), gt), "s": time.perf_counter() - t0,
                "diverged": sum(f.diverged for f in frames),
                "n_map_points": int(frames[-1].n_map_points), "frames": frames}
    cfg = pkg.ICETConfig(dnn_filter=name == "dnn_keyframe", **cfg_kw)
    kf = pkg.KeyframeOdometry(
        cfg, pkg.KeyframeConfig(spawn_distance=3.0, spawn_angle=0.3, delta_clamp=2.5),
        pkg.BlockMapConfig(), **device_kw)
    frames = kf.run(scans)
    return {"ate_m": ate([f.T_world for f in frames], gt), "s": time.perf_counter() - t0,
            "diverged": sum(f.diverged for f in frames),
            "keyframe_indices": [int(i) for i in kf.keyframe_indices],
            "map_points": int(kf.map_points().shape[0]), "frames": frames}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true", help="also run the port's CPU path")
    ap.add_argument("--fused-reference", action="store_true",
                    help="run the JAX package's BiasNet on its fused kernel (interpret mode)")
    ap.add_argument("--eager-reference", action="store_true",
                    help="run the JAX package's drives without jit (jax.disable_jit)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.fused_reference:
        force_fused_reference()
    import icet_tpu
    from icet_tpu.datasets.replay import CityDriveSource

    drive = list(CityDriveSource(n_frames=24, speed=1.0, n_beams=64, n_azimuth=1024))
    scans = [s for s, _ in drive]
    gt = [T for _, T in drive]
    out = {}
    for name in DRIVES:
        with reference_mode(args.eager_reference):
            ref = run(icet_tpu, name, scans, gt, {})
        out[name] = {"icet_tpu": ref}
        if args.port:
            import torch

            import icet_tpu_torch

            torch.set_num_threads(min(8, os.cpu_count() or 1))
            port = run(icet_tpu_torch, name, scans, gt, {"device": "cpu"})
            out[name]["icet_tpu_torch_cpu"] = port
            out[name]["per_frame"] = first_difference(ref.pop("frames"), port.pop("frames"))
        ref.pop("frames", None)
        out[name]["fused_reference"] = args.fused_reference
        out[name]["eager_reference"] = args.eager_reference
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
