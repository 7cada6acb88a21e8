"""Geometry and voxel-grid ops of the port against the JAX package.

Inputs are made with numpy from a seed and fed to both.  Tolerances: the
two run the same float32 formulas on the CPU, but XLA and PyTorch may
evaluate transcendentals and fused products a few ulps apart, so values
agree to 1e-5 absolute at the unit scale used here (2e-5 on ranges up to
~50 m, whose ulp is 4e-6).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.ops import geometry as jgeo
from icet_tpu.ops import grid as jgrid
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.ops import geometry as tgeo
from icet_tpu_torch.ops import grid as tgrid

torch.set_num_threads(2)


def _points(seed, n=512, scale=20.0):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    pts[:8] = 0.0  # r == 0 rows
    pts[8:16] = np.nan  # NaN rows
    pts[16:20, 1] = np.nan  # partial NaN rows
    return pts


def _angles(seed, n=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.6, 0.6, size=(n, 3)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cart_to_spherical_with_nan_and_zero_rows(seed):
    pts = _points(seed)
    want = np.asarray(jgeo.cart_to_spherical(jnp.asarray(pts)))
    got = tgeo.cart_to_spherical(_t(pts)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:16], 0.0)  # r == 0 and NaN rows
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_spherical_to_cart(seed):
    rng = np.random.default_rng(seed)
    rtp = np.stack([rng.uniform(0, 30, 256), rng.uniform(0, 2 * np.pi, 256),
                    rng.uniform(0, np.pi, 256)], -1).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.spherical_to_cart(_t(rtp)).numpy(),
        np.asarray(jgeo.spherical_to_cart(jnp.asarray(rtp))), rtol=0, atol=2e-5)


@pytest.mark.parametrize("fn", ["euler_R", "pose_to_state_of_matrix",
                                "rotation_jacobian", "euler_from_R",
                                "rotmat_to_euler"])
@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_functions(fn, seed):
    angs = _angles(seed)
    if fn == "euler_R":
        want = np.asarray(jgeo.euler_R(jnp.asarray(angs)))
        got = tgeo.euler_R(_t(angs)).numpy()
    elif fn == "rotation_jacobian":
        jac = jax.jit(jax.vmap(jgeo.rotation_jacobian))
        want = np.asarray(jac(jnp.asarray(angs)))
        got = np.stack([tgeo.rotation_jacobian(_t(a)).numpy() for a in angs])
    elif fn == "euler_from_R":
        rot = np.asarray(jgeo.euler_R(jnp.asarray(angs)))
        want = np.asarray(jgeo.euler_from_R(jnp.asarray(rot)))
        got = tgeo.euler_from_R(_t(rot)).numpy()
        np.testing.assert_allclose(got, angs, atol=1e-5)
    elif fn == "rotmat_to_euler":
        rot = np.asarray(jgeo.euler_R(jnp.asarray(angs)))
        want = np.asarray(jgeo.rotmat_to_euler(jnp.asarray(rot)))
        got = tgeo.rotmat_to_euler(_t(rot)).numpy()
    else:
        X = np.concatenate([angs[:, :3] * 10, angs], -1)
        Ts = np.asarray(jax.vmap(jgeo.pose_matrix)(jnp.asarray(X)))
        got_T = np.stack([tgeo.pose_matrix(_t(x)).numpy() for x in X])
        np.testing.assert_allclose(got_T, Ts, atol=1e-5)
        want = np.asarray(jgeo.pose_to_state(jnp.asarray(Ts)))
        got = tgeo.pose_to_state(_t(Ts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_points(seed):
    pts = _points(seed)[20:]
    X = np.concatenate([[1.0, -0.4, 0.2], _angles(seed, 1)[0]]).astype(np.float32)
    np.testing.assert_allclose(
        tgeo.transform_points(_t(pts), _t(X)).numpy(),
        np.asarray(jgeo.transform_points(jnp.asarray(pts), jnp.asarray(X))),
        rtol=0, atol=2e-5)


@pytest.mark.parametrize("fn", ["compose_pose", "compose_states", "relative_state"])
def test_pose_composition(fn):
    rng = np.random.default_rng(5)
    xa = np.concatenate([rng.normal(size=3), rng.uniform(-0.3, 0.3, 3)]).astype(np.float32)
    xb = np.concatenate([rng.normal(size=3), rng.uniform(-0.3, 0.3, 3)]).astype(np.float32)
    if fn == "compose_pose":
        T = np.asarray(jgeo.pose_matrix(jnp.asarray(xa)))
        want = np.asarray(jgeo.compose_pose(jnp.asarray(T), jnp.asarray(xb)))
        got = tgeo.compose_pose(_t(T), _t(xb)).numpy()
    else:
        want = np.asarray(getattr(jgeo, fn)(jnp.asarray(xa), jnp.asarray(xb)))
        got = getattr(tgeo, fn)(_t(xa), _t(xb)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


GRIDS = [
    JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
            min_range=1.0),
    JConfig(),
    JConfig(radial_mode="fixed", n_theta=13, n_phi=5, n_shells=9, min_range=0.5),
]


def _edge_free_rtp(cfg, seed, n=2000):
    """Spherical points with every angle at least 1e-3 of a bin width away
    from a bin edge, so both packages must bin them identically."""
    rng = np.random.default_rng(seed)
    itheta = rng.integers(0, cfg.n_theta, n)
    iphi = rng.integers(-1, cfg.n_phi + 1, n)
    ft = rng.uniform(1e-3, 1 - 1e-3, n)
    fp = rng.uniform(1e-3, 1 - 1e-3, n)
    theta = (itheta + ft) / cfg.n_theta * 2 * np.pi
    phi = cfg.phi_min + (iphi + fp) / cfg.n_phi * (cfg.phi_max - cfg.phi_min)
    phi = np.clip(phi, 1e-3, np.pi - 1e-3)
    r = rng.uniform(0.0, 60.0, n)
    return np.stack([r, theta, phi], -1).astype(np.float32)


@pytest.mark.parametrize("cfg", GRIDS, ids=["small", "default", "fixed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_voxel_ids(cfg, seed):
    rtp = _edge_free_rtp(cfg, seed)
    tcfg = config_from_icet(dataclasses.asdict(cfg))
    want = np.asarray(jgrid.voxel_ids(jnp.asarray(rtp), cfg))
    got = tgrid.voxel_ids(_t(rtp), tcfg).numpy()
    assert got.dtype == np.int32
    assert (want == cfg.n_voxels).any() and (want < cfg.n_voxels).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", GRIDS, ids=["small", "default", "fixed"])
def test_grid_tables(cfg):
    tcfg = config_from_icet(dataclasses.asdict(cfg))
    tc, pc = tgrid.voxel_angle_centers(tcfg)
    jt, jp = jgrid.voxel_angle_centers(cfg)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jt), atol=1e-6)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jp), atol=1e-6)
    if cfg.radial_mode == "fixed":
        np.testing.assert_array_equal(tgrid.shell_edges(tcfg).numpy(),
                                      np.asarray(jgrid.shell_edges(cfg)))
        bounds = np.asarray(jgrid.fixed_shell_bounds(cfg))
        np.testing.assert_array_equal(tgrid.fixed_shell_bounds(tcfg).numpy(), bounds)
    else:
        rng = np.random.default_rng(3)
        lo = rng.uniform(1, 40, cfg.n_voxels)
        bounds = np.zeros((cfg.n_voxels + 1, 2), np.float32)
        bounds[:-1] = np.stack([lo, lo + rng.uniform(0, 5, cfg.n_voxels)], -1)
        bounds[::7] = 0.0
    # The anchors keep the JAX package's bf16 rounding: identical tables.
    np.testing.assert_array_equal(
        tgrid.voxel_anchors(_t(bounds), tcfg).numpy(),
        np.asarray(jgrid.voxel_anchors(jnp.asarray(bounds), cfg)))
