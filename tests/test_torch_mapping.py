"""The port's ring-map MapMaker against the JAX package's
(``icet_tpu/mapping.py``).

``map_update`` takes the JAX package's own uniforms (``jax.random.uniform``
of the same key), so the downsample picks the same rows and the ring,
validity and trail must agree: indices and flags exactly, coordinates to
float32 rounding of the re-expression (1e-5 m at these ranges, as
tests/test_mapping.py holds them).  ``map_step`` and ``MapMaker`` solve on a
25x8 grid against 256-column sweeps (coprime, no column on a bin edge) and
are held as tests/test_torch_solver.py holds a registration: X to 1e-4,
pred_stds to 1e-3 relative, divergence flags equal.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import mapping as jmap
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.config import MapConfig as JMapConfig
from icet_tpu.config import OdometryConfig as JOdo
from icet_tpu.datasets.replay import SyntheticTrajectorySource
from icet_tpu.solver import prepare_reference_jit
from icet_tpu_torch import mapping as tmap
from icet_tpu_torch.config import MapConfig, OdometryConfig
from icet_tpu_torch.convert import (
    config_from_icet,
    map_state_from_numpy,
    map_state_to_numpy,
    voxel_model_from_numpy,
)

torch.set_num_threads(2)

CFG = JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=4, min_pts=15, min_range=1.0)
TCFG = config_from_icet(dataclasses.asdict(CFG))
MCFG = dict(capacity=2_500, points_per_scan=1_000)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _assert_state_equal(tstate, jstate, atol=1e-5):
    got, want = map_state_to_numpy(tstate), _np(jstate)
    for name in ("write_ptr", "trail_len"):
        assert int(got[name]) == int(want[name]), name
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["points"], want["points"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["trail"], want["trail"], rtol=0, atol=atol)


@pytest.fixture(scope="module")
def drive():
    src = SyntheticTrajectorySource(n_frames=4, speed=0.3, yaw_rate=0.02,
                                    n_beams=32, n_azimuth=256)
    return [(s.astype(np.float32), T) for s, T in src]


def test_map_update_matches_jax():
    """Re-expression, the ring wrap (3 x 1,000 rows into 2,500), a short
    scan (fewer valid points than points_per_scan), and the snail trail at
    its capacity."""
    jcfg, tcfg = JMapConfig(**MCFG), MapConfig(**MCFG)
    rng = np.random.default_rng(1)
    jstate = jmap.init_map(jcfg, trail_capacity=3)
    tstate = tmap.init_map(tcfg, trail_capacity=3)
    short = np.zeros((2000, 3), np.float32)
    short[:300] = rng.normal(size=(300, 3)) * 5 + 20
    for i in range(4):
        scan = short if i == 2 else (rng.normal(size=(2000, 3)) * 5 + 10).astype(np.float32)
        X = (rng.uniform(-0.1, 0.1, 6) * [5, 5, 1, 0.2, 0.2, 1]).astype(np.float32)
        key = jax.random.PRNGKey(i)
        u = np.asarray(jax.random.uniform(key, (scan.shape[0],)))
        want = _np(jstate)  # map_update donates its input
        jstate = jmap.map_update(jstate, jnp.asarray(scan), jnp.asarray(X), key, jcfg, 0.2)
        tstate = tmap.map_update(map_state_from_numpy(want), _t(scan), _t(X), _t(u), tcfg, 0.2)
        _assert_state_equal(tstate, jstate)
    # Rows 500-1999 from the last two scans; of the short scan's 1,000 rows
    # (2000-2499, 0-499) only its 300 valid points, the rest marked invalid.
    assert int(tstate.valid.sum()) == 1_800
    assert tstate.write_ptr == 4_000 % 2_500 and tstate.trail_len == 3


def test_map_step_matches_jax(drive):
    jcfg, tcfg = JMapConfig(**MCFG), MapConfig(**MCFG)
    (scan0, _), (scan1, _) = drive[0], drive[1]
    jmodel = prepare_reference_jit(jnp.asarray(scan0), CFG)
    tmodel = voxel_model_from_numpy({k: np.asarray(v) for k, v in jmodel._asdict().items()})
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (scan1.shape[0],)))
    state = jmap.map_update(jmap.init_map(jcfg), jnp.asarray(scan0), jnp.zeros(6), key, jcfg, 1.0)
    for clamp in (0.9, 1e-6):  # the second trips the divergence guard
        start = _np(state)
        jres, jX, jdiv, jstate, jnext = jmap.map_step_jit(
            jmodel, jax.tree.map(jnp.copy, state), jnp.asarray(scan1), key, jnp.float32(clamp),
            CFG, jcfg)
        tres, tX, tdiv, tstate, tnext = tmap.map_step(
            tmodel, map_state_from_numpy(start), _t(scan1), _t(u), clamp, TCFG, tcfg)
        assert bool(tdiv) == bool(jdiv) == (clamp < 0.5)
        np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=1e-4)
        np.testing.assert_allclose(tres.pred_stds.numpy(), np.asarray(jres.pred_stds), rtol=1e-3)
        _assert_state_equal(tstate, jstate, atol=1e-4)
        np.testing.assert_array_equal(tnext.valid.numpy(), np.asarray(jnext.valid))
        np.testing.assert_allclose(tnext.mean.numpy(), np.asarray(jnext.mean), rtol=0, atol=1e-4)


def test_mapmaker_matches_jax(drive):
    scans = [s for s, _ in drive]
    jmm = jmap.MapMaker(CFG, JMapConfig(**MCFG), JOdo(divergence_clamp=0.9))
    want = [f for f in (jmm.step(s) for s in scans) if f is not None]
    tmm = tmap.MapMaker(TCFG, MapConfig(**MCFG), OdometryConfig(divergence_clamp=0.9),
                        device="cpu")
    got = [f for f in (tmm.step(s) for s in scans) if f is not None]
    assert len(got) == len(want) == len(scans) - 1
    assert not any(g.diverged for g in got)
    for g, w in zip(got, want):
        assert (g.index, g.diverged, g.n_map_points) == (w.index, w.diverged, w.n_map_points)
        np.testing.assert_allclose(g.X, w.X, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.pred_stds, w.pred_stds, rtol=1e-3)
    assert got[-1].n_map_points == min(MCFG["capacity"], 1_000 * len(scans))
    assert tmm.map_points().shape == jmm.map_points().shape
    np.testing.assert_allclose(tmm.snail_trail(), jmm.snail_trail(), rtol=0, atol=1e-4)
