#!/usr/bin/env python3
"""The KITTI evaluation of ``chip_smoke.py`` phase 22 on the CPU: the JAX
package's ``examples/eval_kitti.py`` (the reference) and, with
``--port``, the port's ``icet_tpu_torch.examples.eval_kitti`` on its CPU
path, on the same fixture.

The fixture is the one phase 22 writes: the 24-frame city drive at
KITTI scale, ``CityDriveSource(n_frames=24, speed=1.0, n_beams=64,
n_azimuth=2048)`` (131,072 rays a sweep), written as a KITTI odometry
sequence by ``icet_tpu_torch.examples.make_kitti_sequence --calib``
(camera-frame poses and a non-identity ``calib.txt``; the writer and the
drive are bit-identical to the JAX package's, tests/test_torch_kitti.py
and tests/test_torch_package.py).  Each mode runs ``eval_kitti`` at its
defaults (75x24 grid, 7 iterations, ``--max-points 131072``) with
``--clamp 2.5``: plain, ``--keyframe`` and ``--dnn``.

``chip_smoke.py`` gates the card's ATE in each mode at the JAX package's
figure printed here plus 0.5 cm.  Run from the repository root:

    JAX_PLATFORMS=cpu python3 tools/kitti_eval_ate_cpu.py [--port] [--eager-reference]
    JAX_PLATFORMS=cpu python3 tools/kitti_eval_ate_cpu.py --per-frame

``--eager-reference`` runs the JAX package under ``jax.disable_jit()``
(see ``tools/dnn_drive_ate_cpu.py``: its jitted CPU program drops a bf16
rounding of the BiasNet).  The last line is one JSON object
``{mode: {"jax": summary, "port": summary, "jax_s": s, "port_s": s}}``.

``--per-frame`` traces the plain mode frame by frame instead: the same
scans (read once by the JAX package's reader) go through the JAX
package's ``OdometryPipeline`` jitted and under ``jax.disable_jit()`` and
through the port's on the CPU.  It prints each pair's per-frame
``max |dX|`` and first frame past 1e-5 m; at the port's first such frame
against the eager reference, it compares the two packages' voxel models of
the previous scan, then replays that frame's registration from one seed
and one model (the JAX package's, carried across by ``convert.py``),
lists the voxels whose member counts differ at the seed and at each
package's solution, and, at the reference's first-iteration X, assembles
the normal equations from each package's moment sums with one assembly
(the port's): the smallest eigenvalues of each, and the voxels whose own
contribution to ``H^T W H`` differs most between the two sums.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the fixture: make_kitti_sequence's arguments, shared with chip_smoke.py
FIXTURE = ["--frames", "24", "--speed", "1.0", "--beams", "64", "--azimuth", "2048",
           "--calib"]
#: eval_kitti's arguments in every mode (the sequence and poses added)
EVAL = ["--clamp", "2.5"]
MODES = {"plain": [], "keyframe": ["--keyframe"], "dnn": ["--dnn"]}


def write_fixture(out_dir: str) -> str:
    from icet_tpu_torch.examples import make_kitti_sequence

    return make_kitti_sequence.run(
        make_kitti_sequence.build_parser().parse_args(["--out", out_dir, *FIXTURE]))["dir"]


def _first_past(dx, atol: float = 1e-5):
    bad = [k for k, d in enumerate(dx) if d > atol]
    return bad[0] if bad else None


def per_frame(seq: str, base: list) -> dict:
    """The ``--per-frame`` trace of the plain mode (the module docstring)."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np
    import torch

    import icet_tpu_torch as it
    from icet_tpu import solver as jsolver
    from icet_tpu.config import ICETConfig, OdometryConfig
    from icet_tpu.datasets.kitti import KittiOdometrySource
    from icet_tpu.odometry import OdometryPipeline
    from icet_tpu_torch import solver as tsolver
    from icet_tpu_torch.convert import config_from_icet, voxel_model_from_numpy
    from icet_tpu_torch.examples import eval_kitti
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums_reference
    from tools.dnn_drive_ate_cpu import reference_mode

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    a = eval_kitti.build_parser().parse_args(base)
    cfg = ICETConfig(n_iters=a.n_iters, min_range=a.min_range, n_theta=a.n_theta,
                     n_phi=a.n_phi, min_pts=a.min_pts, convergence_tol=1e-4)
    tcfg = config_from_icet(dataclasses.asdict(cfg))
    odo = OdometryConfig(divergence_clamp=a.clamp)
    scans = [s for s, _ in KittiOdometrySource(seq, poses_file=a.poses,
                                               max_points=a.max_points, prefetch=False)]
    pipes = {"jit": OdometryPipeline(cfg, odo), "eager": OdometryPipeline(cfg, odo),
             "port": it.OdometryPipeline(tcfg, it.OdometryConfig(divergence_clamp=a.clamp),
                                         device="cpu")}
    xs = {k: [] for k in pipes}
    models, seeds = [], []
    t0 = time.perf_counter()
    for s in scans:
        models.append((pipes["eager"]._model, pipes["port"]._model))
        seeds.append(np.asarray(pipes["eager"]._X_prev))
        for name, p in pipes.items():
            with reference_mode(name == "eager"):
                f = p.step(s)
            if f is not None:
                xs[name].append(np.asarray(f.X, np.float64))
    out = {"s": round(time.perf_counter() - t0, 1), "pairs": {}}
    for x, y in (("jit", "eager"), ("port", "eager"), ("port", "jit")):
        dx = [float(np.abs(p - q).max()) for p, q in zip(xs[x], xs[y])]
        first = _first_past(dx)
        out["pairs"][f"{x}-{y}"] = {"max_abs_dX": dx,
                                    "first_frame": None if first is None else first + 1}
    first = out["pairs"]["port-eager"]["first_frame"]
    if first is None:
        return out
    jm, tm = models[first]
    jm_np = {k: np.asarray(v) for k, v in jm._asdict().items()}
    out["model_at_first"] = {k: bool(np.array_equal(jm_np[k], v.numpy()))
                             for k, v in tm._asdict().items()}
    # Replay the frame from the eager reference's seed and model.
    scan = scans[first]
    x0 = seeds[first]
    with reference_mode(True):
        jres = jsolver.register(jm, jnp.asarray(scan), jnp.asarray(x0), cfg,
                                want_static_mask=False)
    tmodel = voxel_model_from_numpy(jm_np)
    tres = tsolver.register(tmodel, torch.from_numpy(scan), torch.from_numpy(x0), tcfg,
                            want_static_mask=False)
    out["replay"] = {
        "X_jax": np.asarray(jres.X).tolist(), "X_port": tres.X.tolist(),
        "n_corr_jax": np.asarray(jres.diagnostics.n_corr).tolist(),
        "n_corr_port": tres.diagnostics.n_corr.tolist(),
        "dx_norm_jax": np.asarray(jres.diagnostics.dx_norm).tolist(),
        "dx_norm_port": tres.diagnostics.dx_norm.tolist(),
    }
    # Member counts of the two packages' moment sums at the seed and at
    # each package's solution, on the same model.
    pts = torch.from_numpy(scan)
    diffs = {}
    for name, X in (("seed", x0), ("X_jax", np.asarray(jres.X)), ("X_port", tres.X.numpy())):
        with reference_mode(True):
            js = np.asarray(jsolver._jnp_sums(jnp.asarray(scan), jnp.asarray(X, jnp.float32),
                                              jm.bounds, jm.anchors, cfg))
        ts = fused_moment_sums_reference(pts, torch.from_numpy(np.asarray(X, np.float32)),
                                         tmodel.bounds, tmodel.anchors, tcfg).numpy()
        rows = np.flatnonzero(js[:, 0] != ts[:, 0])
        diffs[name] = {"voxels": rows.tolist(), "count_jax": js[rows, 0].tolist(),
                       "count_port": ts[rows, 0].tolist(),
                       "max_abs_sum_diff": float(np.abs(js[:, :10] - ts[:, :10]).max())}
    out["membership"] = diffs
    out["assembly"] = _assembly_split(jm, tmodel, scan, x0, cfg, tcfg)
    return out


def _assembly_split(jm, tmodel, scan, x0, cfg, tcfg, top: int = 5) -> dict:
    """At the eager reference's first-iteration X: both packages' moment
    sums, each assembled by the port's ``assemble_normal_equations``."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from icet_tpu import solver as jsolver
    from icet_tpu_torch import solver as tsolver
    from icet_tpu_torch.ops.geometry import rotation_jacobian
    from icet_tpu_torch.ops.moments import finalize_moments_planes
    from icet_tpu_torch.ops.wls_planes import assemble_normal_equations
    from tools.dnn_drive_ate_cpu import reference_mode

    with reference_mode(True):
        X1 = jsolver._iteration(jm, jnp.asarray(scan), jnp.asarray(x0), 0, cfg, None, None,
                                None, jsolver._pack_model_planes(jm))[0]
        jsums = torch.from_numpy(np.asarray(jsolver._jnp_sums(
            jnp.asarray(scan), X1, jm.bounds, jm.anchors, cfg)))
    X1 = torch.from_numpy(np.asarray(X1))
    tsums = tsolver._sums(torch.from_numpy(scan), X1, tmodel.bounds, tmodel.anchors, tcfg)
    m = tmodel

    def assemble(sums, only=None):
        count2, mean2, cov2 = finalize_moments_planes(sums, m.anchors)
        cm = (m.valid & (count2 >= tcfg.min_pts)).float()
        if only is not None:
            cm = torch.where(torch.arange(cm.shape[0]) == only, cm, 0.0)
        H = assemble_normal_equations(m.basis, m.lmask, m.cov, m.count, cov2, count2, m.mean,
                                      mean2, rotation_jacobian(X1[3:6]), cm,
                                      tcfg.pinv_rcond)[0]
        return H.double().numpy(), cov2, count2, cm

    Hj, cov_j, count2, cm = assemble(jsums)
    Ht, cov_t, _, _ = assemble(tsums)
    rows = []
    for v in np.flatnonzero(cm.numpy()):
        hj, ht = assemble(jsums, v)[0], assemble(tsums, v)[0]
        rows.append((float(np.abs(hj - ht).max()), int(v), float(np.abs(hj).max())))
    rows.sort(reverse=True)
    return {
        "max_abs_sum_diff": float((jsums - tsums).abs().max()),
        "counts_equal": bool(torch.equal(jsums[:, 0], tsums[:, 0])),
        "eig_jax_sums": np.linalg.eigvalsh(Hj)[:3].tolist(),
        "eig_port_sums": np.linalg.eigvalsh(Ht)[:3].tolist(),
        "voxels": [{"voxel": v, "max_abs_dH": d, "max_abs_H": h, "count2": float(count2[v]),
                    "cov2_jax": cov_j[v].tolist(), "cov2_port": cov_t[v].tolist(),
                    "lmask": m.lmask[v].tolist(),
                    "model_cov_eigvals": np.linalg.eigvalsh(m.cov[v].double().numpy()).tolist()}
                   for d, v, h in rows[:top]],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true", help="also run the port's CPU path")
    ap.add_argument("--eager-reference", action="store_true",
                    help="run the JAX package without jit (jax.disable_jit)")
    ap.add_argument("--per-frame", action="store_true",
                    help="trace the plain mode frame by frame (see the docstring)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import examples.eval_kitti as jek
    from tools.dnn_drive_ate_cpu import reference_mode

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        seq = write_fixture(os.path.join(tmp, "seq"))
        print(f"fixture written in {time.perf_counter() - t0:.1f} s")
        base = ["--sequence", seq, "--poses", os.path.join(seq, "poses.txt"), *EVAL]
        if args.per_frame:
            out = per_frame(seq, base)
            print(json.dumps(out))
            return 0
        for mode, extra in MODES.items():
            row = {}
            t0 = time.perf_counter()
            with reference_mode(args.eager_reference):
                row["jax"] = jek.run(jek.build_parser().parse_args(base + extra))
            row["jax_s"] = round(time.perf_counter() - t0, 1)
            if args.port:
                import torch

                from icet_tpu_torch.examples import eval_kitti

                torch.set_num_threads(min(8, os.cpu_count() or 1))
                t0 = time.perf_counter()
                row["port"] = eval_kitti.run(eval_kitti.build_parser().parse_args(
                    base + extra + ["--device", "cpu", "--prefetch", "on"]))
                row["port"].pop("stages")
                row["port_s"] = round(time.perf_counter() - t0, 1)
            print(f"{mode}: {json.dumps(row)}")
            out[mode] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
