"""The port's odometry against the JAX package on a short small-grid drive.

Same numpy scans into both, at the early-exit config.  49 azimuth bins
against a 512-column sweep keep every point off the bin edges.  Per-frame
X within 1e-4 (float32 rounding in another order; see
tests/test_torch_solver.py), world poses within 1e-4, divergence flags
identical.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import odometry as jodo
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.config import OdometryConfig as JOdo
from icet_tpu.datasets.replay import SyntheticTrajectorySource
from icet_tpu_torch import odometry as todo
from icet_tpu_torch.config import OdometryConfig
from icet_tpu_torch.convert import config_from_icet

torch.set_num_threads(2)

CFG = JConfig(n_theta=49, n_phi=16, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=7, min_pts=20, min_range=1.0, convergence_tol=1e-4,
              convergence_stat_scale=1.0)
TCFG = config_from_icet(dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def scans():
    src = SyntheticTrajectorySource(n_frames=6, speed=0.2, yaw_rate=0.01,
                                    n_beams=48, n_azimuth=512)
    return np.stack([s for s, _ in src])


@pytest.fixture(scope="module")
def jax_frames(scans):
    """The JAX package's device runner at two divergence clamps: 0.3 (no
    frame diverges at 0.2 m/frame) and 0.1 (every frame does)."""
    return {clamp: jodo.run_odometry_device(scans, CFG, JOdo(divergence_clamp=clamp),
                                            block=3)
            for clamp in (0.3, 0.1)}


def _frames_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.index == w.index and g.diverged == w.diverged
        np.testing.assert_allclose(g.X, w.X, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.T_world, w.T_world, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.pose, w.pose, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.twist, w.twist, rtol=0, atol=1e-3)
        np.testing.assert_allclose(g.pred_stds, w.pred_stds, rtol=1e-3)


@pytest.mark.parametrize("clamp", [0.3, 0.1])
@pytest.mark.parametrize("runner", ["device", "pipeline"])
def test_matches_jax_device_runner(scans, jax_frames, clamp, runner):
    odo = OdometryConfig(divergence_clamp=clamp)
    if runner == "device":
        got = todo.run_odometry_device(scans, TCFG, odo, block=3, device="cpu")
    else:
        got = todo.run_odometry(iter(scans), TCFG, odo, device="cpu")
    want = jax_frames[clamp]
    _frames_close(got, want)
    assert all(f.diverged == (clamp < 0.2) for f in got)
    assert all(1 <= f.iterations <= CFG.n_iters for f in got)
    if runner == "pipeline":
        assert all(f.n_corr.shape == (CFG.n_iters,) and f.solve_ms > 0 for f in got)


def test_warm_start_seed_modes():
    d1 = np.array([0.10, 0.00, 0.0, 0.0, 0.0, 0.00], np.float32)
    d2 = np.array([0.14, 0.02, 0.01, 0.003, -0.002, 0.02], np.float32)
    for mode in ("previous", "extrapolate"):
        want = np.asarray(jodo.warm_start_seed(jnp.asarray(d2), jnp.asarray(d1), mode))
        got = todo.warm_start_seed(torch.from_numpy(d2), torch.from_numpy(d1), mode)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    with pytest.raises(ValueError):
        todo.warm_start_seed(torch.from_numpy(d2), torch.from_numpy(d1), "nope")


def test_dnn_filter_not_ported():
    """The sequence runner refuses the DNN filter, as the JAX package's
    does (the per-frame sample state lives in OdometryPipeline)."""
    with pytest.raises(NotImplementedError):
        todo.run_odometry_device(np.zeros((2, 64, 3), np.float32),
                                 TCFG.replace(dnn_filter=True), device="cpu")
