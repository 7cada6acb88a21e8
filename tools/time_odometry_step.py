#!/usr/bin/env python3
"""Time the odometry step of one tree of the port on the card: the eager
``odometry_step``, its ``prepare_reference`` and ``register`` halves and,
where the tree has it, the compiled ``odometry_step_jit``, each by CUDA
events over repeated calls on frame 4 of the 64x1024 city drive (from
frame 3's model and solution, bench.py's config).

To compare two trees in one call, unpack the earlier one into the
gitignored ``_checkout/`` and run them in turns, for example:

    mkdir -p _checkout/parent && git archive <commit> | tar -x -C _checkout/parent
    for r in _checkout/parent . . _checkout/parent; do
        python3 tools/time_odometry_step.py --root $r; done

Each run prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".", help="the tree whose icet_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_odometry_step: CUDA is not available", file=sys.stderr)
        return 1
    from icet_tpu_torch import _build, solver
    from icet_tpu_torch.config import ICETConfig
    from icet_tpu_torch.datasets.replay import CityDriveSource
    from icet_tpu_torch.device import resolve_device

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    dev = resolve_device("cuda")
    _build.build()
    src = CityDriveSource(n_frames=5, speed=1.0, n_beams=64, n_azimuth=1024)
    scans = [torch.from_numpy(np.asarray(s, np.float32)).to(dev) for s, _ in src]
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)
    model, x = solver.prepare_reference(scans[0], cfg), torch.zeros(6, device=dev)
    for k in range(1, 4):
        res, model = solver.odometry_step(model, scans[k], x, cfg)
        x = res.X

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / args.reps

    out = {
        "root": args.root,
        "iterations": solver.register(model, scans[4], x, cfg).iterations,
        "step_ms": ms(lambda: solver.odometry_step(model, scans[4], x, cfg)),
        "prepare_ms": ms(lambda: solver.prepare_reference(scans[4], cfg)),
        "register_ms": ms(lambda: solver.register(model, scans[4], x, cfg,
                                                  want_static_mask=False)),
    }
    if hasattr(solver, "odometry_step_jit"):
        out["step_jit_ms"] = ms(lambda: solver.odometry_step_jit(model, scans[4], x, cfg))
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
