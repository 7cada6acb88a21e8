"""The port's solver against the JAX package on a small grid.

Same numpy scans into both.  The grid has 25 azimuth bins against a
256-column sweep, so no point sits on a bin edge (asserted), and both
packages bin every point the same way; what remains is float32 rounding in
another order.  Tolerances: with fixed run length (``convergence_tol=0``)
X within 1e-5 absolute and ``pred_stds`` within 1e-4 relative; with the
early exit, X within 1e-4 and ``pred_stds`` within 1e-3 (the exit
threshold is compared on float32 step norms, so a step norm within
rounding of the threshold could end one iteration apart: the tolerance
covers the sub-threshold step that iteration would add).  In fixed radial
mode ``pred_stds`` are held to 1e-3: its thin shells hold few points each,
and the smallest predicted std (~2e-5 m) moves by up to 3e-4 relative when
the float32 sums are taken in another order.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import solver as js
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import scan_pair_with_ground_truth
from icet_tpu_torch import solver as ts
from icet_tpu_torch.convert import (
    config_from_icet,
    voxel_model_from_numpy,
    voxel_model_to_numpy,
)

torch.set_num_threads(2)

CFG = JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=7, min_pts=15, min_range=1.0)
BENCH = CFG.replace(convergence_tol=1e-4, convergence_stat_scale=1.0)
X_TRUE = np.array([0.3, -0.1, 0.02, 0.01, -0.01, 0.03])


def _tc(cfg):
    return config_from_icet(dataclasses.asdict(cfg))


def _edge_distance(scan, cfg):
    """Smallest angular distance (rad) of a ranged point to a bin edge;
    theta == 0 exactly (y == 0, x > 0) bins the same way everywhere."""
    p = scan.astype(np.float64)
    r = np.linalg.norm(p, axis=1)
    ok = r >= cfg.min_range
    theta = np.mod(np.arctan2(p[ok, 1], p[ok, 0]), 2 * np.pi)
    phi = np.arccos(np.clip(p[ok, 2] / r[ok], -1, 1))
    wt = 2 * np.pi / cfg.n_theta
    wp = (cfg.phi_max - cfg.phi_min) / cfg.n_phi
    ft, fp = theta[theta > 0] / wt, (phi - cfg.phi_min) / wp
    return min(np.min(np.abs(ft - np.round(ft))) * wt,
               np.min(np.abs(fp - np.round(fp))) * wp)


@pytest.fixture(scope="module")
def pair():
    s1, s2 = scan_pair_with_ground_truth(X_TRUE, seed=3, n_beams=32, n_azimuth=256)
    assert _edge_distance(s1, CFG) > 1e-4 and _edge_distance(s2, CFG) > 1e-4
    return s1, s2


def _model_close(tm, jm):
    j = {k: np.asarray(v) for k, v in jm._asdict().items()}
    t = voxel_model_to_numpy(tm)
    for k in ("count", "valid", "lmask"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # bf16-rounded anchors: an ulp of float32 difference in sin/cos can
    # round to the neighbouring bf16 value (2^-8 relative).
    np.testing.assert_allclose(t["anchors"], j["anchors"], rtol=2**-7, atol=1e-5)
    for k in ("bounds", "mean"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(t["cov"], j["cov"], rtol=0, atol=1e-5)
    # Eigenvectors of the same Jacobi schedule, column for column, on the
    # voxels that enter the solve (an invalid voxel of a few points can have
    # near-zero eigenvalues whose vectors float32 rounding turns freely).
    v = j["valid"]
    np.testing.assert_allclose(t["basis"][v], j["basis"][v], rtol=0, atol=1e-4)


VARIANTS = {
    "default": {},
    "segsum": {"moment_method": "segsum"},
    "ndt": {"suppression": "ndt"},
    "clip_fill": {"clip_fill": 0.7},
    "fixed": {"radial_mode": "fixed", "n_shells": 12},
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_prepare_reference(pair, name):
    cfg = CFG.replace(**VARIANTS[name])
    jm = js.prepare_reference_jit(jnp.asarray(pair[0]), cfg)
    tm = ts.prepare_reference(torch.from_numpy(pair[0]), _tc(cfg))
    assert np.asarray(jm.valid).sum() > 20
    _model_close(tm, jm)


def _result_close(t, j, x_atol, stds_rtol):
    np.testing.assert_allclose(t.X.numpy(), np.asarray(j.X), rtol=0, atol=x_atol)
    np.testing.assert_allclose(t.pred_stds.numpy(), np.asarray(j.pred_stds),
                               rtol=stds_rtol)
    Q = np.asarray(j.Q)
    np.testing.assert_allclose(t.Q.numpy(), Q, rtol=0, atol=stds_rtol * np.abs(Q).max())
    np.testing.assert_array_equal(t.diagnostics.n_corr.numpy(),
                                  np.asarray(j.diagnostics.n_corr))
    assert (t.diagnostics.windowed_overflow.numpy() == 0).all()


@pytest.mark.parametrize("masked", [False, True], ids=["all_voxels", "corr_mask"])
def test_register_on_jax_model(pair, masked):
    """The JAX package's own prepared model, carried across by convert.py;
    optionally with an external per-voxel correspondence mask."""
    jm = js.prepare_reference_jit(jnp.asarray(pair[0]), CFG)
    model = voxel_model_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    x0 = np.zeros(6, np.float32)
    if masked:
        mask = np.random.default_rng(0).random(CFG.n_voxels + 1) > 0.3
        reg = jax.jit(js.register, static_argnums=(3, 4))
        j = reg(jm, jnp.asarray(pair[1]), jnp.asarray(x0), CFG, None, jnp.asarray(mask))
        t = ts.register(model, torch.from_numpy(pair[1]), torch.from_numpy(x0), _tc(CFG),
                        corr_mask=torch.from_numpy(mask))
    else:
        j = js.register_jit(jm, jnp.asarray(pair[1]), jnp.asarray(x0), CFG)
        t = ts.register(model, torch.from_numpy(pair[1]), torch.from_numpy(x0), _tc(CFG))
    _result_close(t, j, 1e-5, 1e-4)
    assert t.iterations == CFG.n_iters
    np.testing.assert_array_equal(t.static_mask.numpy(), np.asarray(j.static_mask))


@pytest.mark.parametrize("cfg,x_atol,stds_rtol", [(CFG, 1e-5, 1e-4), (BENCH, 1e-4, 1e-3)],
                         ids=["fixed_runlen", "early_exit"])
def test_register_pair(pair, cfg, x_atol, stds_rtol):
    j = js.register_pair(jnp.asarray(pair[0]), jnp.asarray(pair[1]),
                         jnp.zeros(6, jnp.float32), cfg)
    t = ts.register_pair(pair[0], pair[1], np.zeros(6, np.float32), _tc(cfg), device="cpu")
    _result_close(t, j, x_atol, stds_rtol)
    np.testing.assert_allclose(t.diagnostics.dx_norm.numpy(),
                               np.asarray(j.diagnostics.dx_norm), rtol=1e-2, atol=1e-5)
    if cfg is BENCH:
        assert 1 < t.iterations < cfg.n_iters
        dx = t.diagnostics.dx_norm.numpy()
        assert (dx[t.iterations - 1:] == dx[-1]).all()  # repeated after exit


def test_register_pair_options(pair):
    """Moving-object rejection (from iteration 2) and the range-calibration
    covariance term, both on in one solve."""
    cfg = CFG.replace(remove_moving=True, rm_start_iter=2, rm_residual_thresh=0.05,
                      range_sigma=0.02)
    j = js.register_pair(jnp.asarray(pair[0]), jnp.asarray(pair[1]),
                         jnp.zeros(6, jnp.float32), cfg)
    t = ts.register_pair(pair[0], pair[1], np.zeros(6, np.float32), _tc(cfg), device="cpu")
    _result_close(t, j, 1e-5, 1e-4)
    rejected = t.diagnostics.n_rejected_moving.numpy()
    np.testing.assert_array_equal(rejected, np.asarray(j.diagnostics.n_rejected_moving))
    assert rejected.max() > 0


def test_register_pair_fixed_mode(pair):
    """Fixed radial mode at ``moment_method="auto"``: the sums go to the
    plain ``index_add_`` version on every device, as the JAX package
    routes fixed mode to segsum."""
    cfg = CFG.replace(radial_mode="fixed", n_shells=12)
    j = js.register_pair(jnp.asarray(pair[0]), jnp.asarray(pair[1]),
                         jnp.zeros(6, jnp.float32), cfg)
    t = ts.register_pair(pair[0], pair[1], np.zeros(6, np.float32), _tc(cfg), device="cpu")
    _result_close(t, j, 1e-5, 1e-3)
    assert t.diagnostics.n_corr.numpy()[-1] > 20


def test_unported_moment_methods_raise(pair):
    """``moment_method="onehot"`` (blocked one-hot products of three bf16
    parts, in float32) against the JAX package's onehot solve, at the
    fixed-run-length tolerances."""
    cfg = CFG.replace(moment_method="onehot")
    j = js.register_pair(jnp.asarray(pair[0]), jnp.asarray(pair[1]),
                         jnp.zeros(6, jnp.float32), cfg)
    t = ts.register_pair(pair[0], pair[1], np.zeros(6, np.float32), _tc(cfg), device="cpu")
    _result_close(t, j, 1e-5, 1e-4)
    assert t.iterations == cfg.n_iters
    with pytest.raises(ValueError):
        ts.register_pair(pair[0], pair[1], np.zeros(6), _tc(CFG.replace(
            moment_method="dense")), device="cpu")
