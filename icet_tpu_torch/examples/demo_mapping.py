"""HD-map accumulation demo (the reference's map_maker_node, headless);
the port's counterpart of ``examples/demo_mapping.py``.

Builds a device-resident ring map from a simulated drive and writes an HTML
viewer of it; ``--viz`` adds the PNG (matplotlib) and PLY exports.

Usage: python -m icet_tpu_torch.examples.demo_mapping [--frames 10] [--out out_dir] [--viz]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from icet_tpu_torch.examples import add_device_arg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default="icet_map_demo")
    ap.add_argument("--viz", action="store_true", help="also write hd_map.png and hd_map.ply")
    add_device_arg(ap)
    return ap


def run(args) -> dict:
    """Returns ``{frames, map_points, divergences, files}``."""
    from icet_tpu_torch.config import ICETConfig, MapConfig
    from icet_tpu_torch.datasets.replay import SyntheticTrajectorySource
    from icet_tpu_torch.device import resolve_device
    from icet_tpu_torch.mapping import MapMaker
    from icet_tpu_torch.viz_html import save_map_html

    dev = resolve_device(args.device)
    cfg = ICETConfig(
        n_theta=48, n_phi=16, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
        n_iters=8, min_pts=20, min_range=1.0,
    )
    mm = MapMaker(cfg, MapConfig(capacity=100_000, points_per_scan=4_000), device=dev)
    src = SyntheticTrajectorySource(
        n_frames=args.frames, speed=0.25, yaw_rate=0.015, n_beams=48,
        n_azimuth=512,
    )
    n, n_div = 0, 0
    for scan, _ in src:
        f = mm.step(scan)
        if f:
            n += 1
            n_div += int(f.diverged)
            print(
                f"frame {f.index}: X={np.round(f.X, 3).tolist()} "
                f"map={f.n_map_points} pts diverged={f.diverged}"
            )

    os.makedirs(args.out, exist_ok=True)
    pts, trail = mm.map_points(), mm.snail_trail()
    files = [save_map_html(os.path.join(args.out, "hd_map.html"), pts, trail)]
    if args.viz:
        from icet_tpu_torch import viz

        files.append(viz.plot_map(os.path.join(args.out, "hd_map.png"), pts, trail))
        files.append(viz.save_ply(os.path.join(args.out, "hd_map.ply"), pts))
    print(f"wrote {', '.join(files)} ({len(pts)} pts)")
    return {"frames": n, "map_points": int(len(pts)), "divergences": n_div, "files": files}


def main() -> None:
    print(json.dumps(run(build_parser().parse_args())))


if __name__ == "__main__":
    main()
