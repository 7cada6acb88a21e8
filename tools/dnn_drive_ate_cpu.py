#!/usr/bin/env python3
"""ATE of the DNN-filtered odometry drive on the CPU: the JAX package
(``icet_tpu``, the reference) and, with ``--port``, the PyTorch port on its
CPU path.

The drive is the one ``chip_smoke.py`` drives on the card: 24 frames of the
64x1024 city drive at ``ICETConfig(n_iters=7, convergence_tol=1e-4,
convergence_stat_scale=1.0, dnn_filter=True)`` and
``OdometryConfig(divergence_clamp=2.5)``, through each package's
``OdometryPipeline``.  ``chip_smoke.py`` gates the card's ATE at the JAX
package's figure printed here plus 0.5 cm.  Run from the repository root:

    JAX_PLATFORMS=cpu python3 tools/dnn_drive_ate_cpu.py [--port] [--fused-reference] [--eager-reference]

``--fused-reference`` makes the JAX package's filter run its BiasNet
through the fused Pallas encoder in interpret mode (``apply_bias_net(...,
fused=True, interpret=True)``) in place of the flax forward it takes off
the TPU.  ``--eager-reference`` runs the JAX package's pipeline under
``jax.disable_jit()`` (~2.5 min): its jitted CPU program evaluates the
BiasNet's bf16 bias adds in float32 (XLA drops the bf16 rounding the code
states, in the flax forward and the interpret-mode kernel alike), its eager
evaluation rounds as the code, the TPU and the port do.  With ``--port``
the output also holds both packages' per-frame X and correspondence
counts, and the first frame where they differ.
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


def ate(frames, gt) -> float:
    est = [np.eye(4)] + [f.T_world.astype(np.float64) for f in frames]
    ref = [np.linalg.inv(gt[0]) @ T for T in gt]
    err = [np.linalg.norm(e[:3, 3] - r[:3, 3]) for e, r in zip(est, ref)]
    return float(np.sqrt(np.mean(np.square(err))))


def force_fused_reference() -> None:
    """The JAX package's ``apply_bias_net`` on its fused kernel, in
    interpret mode, whatever the backend."""
    from icet_tpu.models import bias_net

    plain = bias_net.apply_bias_net
    bias_net.apply_bias_net = lambda net, params, x, **kw: plain(
        net, params, x, fused=True, interpret=True)


def reference_mode(eager: bool):
    """``jax.disable_jit()`` when ``eager``, else a context that does
    nothing."""
    import contextlib

    import jax

    return jax.disable_jit() if eager else contextlib.nullcontext()


def first_difference(a, b, atol: float = 1e-5) -> dict:
    """Per-frame X and n_corr of two runs, and the first frame where X
    differs by more than ``atol`` or the counts differ (None if none)."""
    xa = np.stack([f.X for f in a]).astype(np.float64)
    xb = np.stack([f.X for f in b]).astype(np.float64)
    dx = np.abs(xa - xb).max(axis=1)
    corr = [bool(np.array_equal(np.asarray(getattr(f, "n_corr", [])),
                                np.asarray(getattr(g, "n_corr", []))))
            for f, g in zip(a, b)]
    bad = [k for k in range(len(a)) if dx[k] > atol or not corr[k]]
    return {"max_abs_dX_per_frame": dx.tolist(), "n_corr_equal_per_frame": corr,
            "first_differing_frame": bad[0] + 1 if bad else None}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true", help="also run the port's CPU path")
    ap.add_argument("--fused-reference", action="store_true",
                    help="run the JAX package's BiasNet on its fused kernel (interpret mode)")
    ap.add_argument("--eager-reference", action="store_true",
                    help="run the JAX package's pipeline without jit (jax.disable_jit)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.fused_reference:
        force_fused_reference()
    from icet_tpu.config import ICETConfig, OdometryConfig
    from icet_tpu.datasets.replay import CityDriveSource
    from icet_tpu.odometry import OdometryPipeline

    drive = list(CityDriveSource(n_frames=24, speed=1.0, n_beams=64, n_azimuth=1024))
    scans = [s for s, _ in drive]
    gt = [T for _, T in drive]
    kw = dict(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0, dnn_filter=True)
    out = {}
    t0 = time.perf_counter()
    with reference_mode(args.eager_reference):
        frames = list(OdometryPipeline(ICETConfig(**kw), OdometryConfig(divergence_clamp=2.5))
                      .run(scans))
    out["icet_tpu"] = {"ate_m": ate(frames, gt), "s": time.perf_counter() - t0,
                       "diverged": sum(f.diverged for f in frames),
                       "fused_reference": args.fused_reference,
                       "eager_reference": args.eager_reference}
    ref_frames = frames
    if args.port:
        import torch

        import icet_tpu_torch as it

        torch.set_num_threads(min(8, os.cpu_count() or 1))
        t0 = time.perf_counter()
        pipe = it.OdometryPipeline(it.ICETConfig(**kw), it.OdometryConfig(divergence_clamp=2.5),
                                   device="cpu")
        frames = list(pipe.run(scans))
        out["icet_tpu_torch_cpu"] = {
            "ate_m": ate(frames, gt), "s": time.perf_counter() - t0,
            "diverged": sum(f.diverged for f in frames),
            "iterations": [f.iterations for f in frames],
            "n_rejected": [f.n_rejected for f in frames],
        }
        out["per_frame"] = first_difference(ref_frames, frames)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
