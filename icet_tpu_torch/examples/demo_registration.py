"""Registration demo (the reference's python/ICET_demo.ipynb, headless);
the port's counterpart of ``examples/demo_registration.py``.

Registers two clouds at the notebook's configuration and prints the solved
transform and predicted error stds; ``--viz`` writes PNG visualizations
(matplotlib) and an HTML viewer.  Without ``--cloud1``/``--cloud2`` the
pair is a raycast scan pair with a known transform.

Usage: python -m icet_tpu_torch.examples.demo_registration [--cloud1 a.npy --cloud2 b.npy] [--viz out_dir]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from icet_tpu_torch.examples import add_device_arg

#: the synthetic pair's relative pose when no clouds are given
X_DEMO = np.array([0.5, -0.2, 0.02, 0.01, -0.01, 0.05])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--viz", default=None, help="directory for PNG/HTML artifacts")
    ap.add_argument("--cloud1", default=None, help="(N, 3) .npy cloud")
    ap.add_argument("--cloud2", default=None, help="(N, 3) .npy cloud")
    add_device_arg(ap)
    return ap


def run(args) -> dict:
    """Register the pair; returns ``{X, pred_stds, n_corr, solve_ms}``
    (and ``X_true`` for the synthetic pair)."""
    import torch

    from icet_tpu_torch.config import PROFILES
    from icet_tpu_torch.device import resolve_device
    from icet_tpu_torch.solver import prepare_reference, register_pair

    dev = resolve_device(args.device)
    cfg = PROFILES["notebook"]
    out = {}
    if args.cloud1 and args.cloud2:
        c1 = np.load(args.cloud1).astype(np.float32)
        c2 = np.load(args.cloud2).astype(np.float32)
    else:
        from icet_tpu_torch.datasets.synthetic import scan_pair_with_ground_truth

        c1, c2 = scan_pair_with_ground_truth(X_DEMO, seed=0)
        out["X_true"] = X_DEMO.tolist()

    t0 = time.perf_counter()
    res = register_pair(c1, c2, np.zeros(6, np.float32), cfg, device=dev)
    X = res.X.cpu().numpy()
    t1 = time.perf_counter()

    print(f"device: {dev}")
    print(f"solve: {(t1 - t0) * 1e3:.1f} ms")
    print("estimated solution vector X:\n", X)
    print("pred_stds:\n", res.pred_stds.cpu().numpy())
    print("correspondences per iteration:", res.diagnostics.n_corr.cpu().numpy())
    out.update(X=X.tolist(), pred_stds=res.pred_stds.cpu().numpy().tolist(),
               n_corr=res.diagnostics.n_corr.cpu().numpy().tolist(),
               solve_ms=round((t1 - t0) * 1e3, 1))

    if args.viz:
        from icet_tpu_torch import viz
        from icet_tpu_torch.viz_html import save_registration_html

        os.makedirs(args.viz, exist_ok=True)
        viz.plot_registration(os.path.join(args.viz, "registration.png"), c1, c2, X)
        model = prepare_reference(torch.from_numpy(c1).to(dev), cfg)
        viz.plot_voxel_model(os.path.join(args.viz, "voxel_model.png"), model,
                             scale=cfg.sigma_scale)
        save_registration_html(os.path.join(args.viz, "registration.html"), c1, c2, X)
        print(f"wrote {args.viz}/registration.png, voxel_model.png, registration.html")
    return out


def main() -> None:
    print(json.dumps(run(build_parser().parse_args())))


if __name__ == "__main__":
    main()
