"""Keyframe block-map demo: city-scale mapping with pose-graph feedback;
the port's counterpart of ``examples/demo_keyframe_map.py``.

Drives the raycast city block with ``KeyframeOdometry`` (scan-to-keyframe
registration; prepare paid once per keyframe), accumulates the keyframe
BLOCK map (points stored per keyframe in their keyframe's own frame), then
shows the map's headline property: refining the trajectory moves ONLY the
(B, 6) block poses, no point is rewritten (``blockmap_refresh_poses``).

Writes the world-frame map before and after the refinement as HTML
viewers; ``--viz`` adds PLY exports and a top-down PNG (matplotlib).

Usage: python -m icet_tpu_torch.examples.demo_keyframe_map [--frames 120] [--out out_dir] [--viz]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from icet_tpu_torch.examples import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default="icet_keyframe_demo")
    ap.add_argument("--viz", action="store_true", help="also write PLY and PNG exports")
    add_device_arg(ap)
    return ap


def run(args) -> dict:
    """Returns ``{map_points, keyframes, divergences, dz, files}``, ``dz``
    the mean z shift of the map after lifting every block pose 0.5 m."""
    from icet_tpu_torch.config import ICETConfig, KeyframeConfig
    from icet_tpu_torch.datasets.replay import CityDriveSource
    from icet_tpu_torch.device import resolve_device
    from icet_tpu_torch.keyframe import (
        KeyframeOdometry,
        blockmap_refresh_poses,
        blockmap_world_points,
    )
    from icet_tpu_torch.viz_html import save_map_html

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    cfg = ICETConfig(
        n_theta=48, n_phi=16, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
        n_iters=6, min_pts=20, min_range=1.0, convergence_tol=1e-4,
    )
    kf = KeyframeOdometry(
        cfg, KeyframeConfig(spawn_distance=3.0, spawn_angle=0.3, delta_clamp=2.5),
        device=dev,
    )

    src = CityDriveSource(n_frames=args.frames, speed=1.0, n_beams=48,
                          n_azimuth=512)
    n_div = 0
    for i, (scan, _T) in enumerate(src):
        f = kf.step(np.asarray(scan, np.float32))
        if f is not None:
            n_div += int(f.diverged)
        if (i + 1) % 40 == 0:
            print(f"  frame {i + 1}/{args.frames} "
                  f"({len(kf.keyframe_states)} keyframes)")

    pts = kf.map_points()
    print(f"map: {pts.shape[0]} points in {len(kf.keyframe_states)} "
          f"keyframe blocks, {n_div} divergences")
    files = [save_map_html(os.path.join(args.out, "map.html"), pts,
                           title="keyframe block map")]

    # Pose-graph feedback without touching a single map point: nudge every
    # keyframe pose (as a refinement would) and re-export — only the (B, 6)
    # pose table changed.
    nudged = np.stack(kf.keyframe_states).astype(np.float32)
    nudged[:, 2] += 0.5  # lift the whole map 0.5 m
    bm2 = blockmap_refresh_poses(kf.blockmap, nudged)
    pts2, ok2 = blockmap_world_points(bm2)
    pts2 = pts2[ok2].cpu().numpy()
    files.append(save_map_html(os.path.join(args.out, "map_refined.html"), pts2,
                               title="keyframe block map, refined poses"))
    if args.viz:
        from icet_tpu_torch import viz

        files.append(viz.save_ply(os.path.join(args.out, "map.ply"), pts))
        files.append(viz.plot_map(os.path.join(args.out, "map.png"), pts,
                                  title="keyframe block map"))
        files.append(viz.save_ply(os.path.join(args.out, "map_refined.ply"), pts2))
    dz = float(pts2[:, 2].mean() - pts[:, 2].mean())
    print(f"refreshed poses: mean z shift {dz:+.3f} m "
          f"(expected +0.500) -> {args.out}")
    return {"map_points": int(pts.shape[0]), "keyframes": len(kf.keyframe_states),
            "divergences": n_div, "dz": dz, "files": files}


def main() -> None:
    print(json.dumps(run(build_parser().parse_args())))


if __name__ == "__main__":
    main()
