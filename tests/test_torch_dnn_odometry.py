"""The port's DNN-filtered odometry against the JAX package's.

Both ``OdometryPipeline``s run the same numpy scans with the filter on and
the same bundled BiasNet weights (the s100 weights serve S = 32, put into
each package's process cache).  The JAX side's encoder runs as its fused
Pallas kernel in interpret mode, as in tests/test_torch_filters.py.  49
azimuth bins against a 512-column sweep keep every point off the bin
edges.  Per-frame X within 2e-3 (a bf16 rounding can move a voxel across
the filter's threshold; see tests/test_torch_filters.py), divergence flags
identical.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import icet_tpu.filters as jf
import icet_tpu.models.bias_net as jbn
from icet_tpu import odometry as jodo
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.config import OdometryConfig as JOdo
from icet_tpu.datasets.replay import CityDriveSource, SyntheticTrajectorySource
from icet_tpu_torch import filters as tf
from icet_tpu_torch import odometry as todo
from icet_tpu_torch.config import OdometryConfig
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.models.bias_net import load_pretrained

torch.set_num_threads(2)

CFG = JConfig(n_theta=49, n_phi=16, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=7, min_pts=20, min_range=1.0, convergence_tol=1e-4,
              convergence_stat_scale=1.0, dnn_filter=True, dnn_start_iter=4,
              dnn_sample_pts=32)


@pytest.fixture
def s100_weights(monkeypatch):
    """Both packages' pretrained caches hold the s100 weights for S = 32,
    and the JAX filter's encoder is its fused kernel in interpret mode."""
    monkeypatch.setitem(jf._PRETRAINED_CACHE, 32, jbn.load_pretrained(100))
    monkeypatch.setitem(tf._PRETRAINED_CACHE, (32, "cpu"), load_pretrained(100))
    plain = jbn.apply_bias_net
    monkeypatch.setattr(jbn, "apply_bias_net", lambda net, params, x, **kw: plain(
        net, params, x, fused=True, interpret=True))


def _drive(cfg, scans, odo):
    want = list(jodo.OdometryPipeline(cfg, JOdo(divergence_clamp=odo)).run(scans))
    pipe = todo.OdometryPipeline(config_from_icet(dataclasses.asdict(cfg)),
                                 OdometryConfig(divergence_clamp=odo), device="cpu")
    assert pipe._dnn is not None
    return list(pipe.run(scans)), want


@pytest.mark.parametrize("in_loop", [True, False], ids=["in_loop", "one_shot"])
def test_pipeline_matches_jax(s100_weights, in_loop):
    src = SyntheticTrajectorySource(n_frames=4, speed=0.2, yaw_rate=0.01,
                                    n_beams=48, n_azimuth=512)
    scans = [s for s, _ in src]
    got, want = _drive(CFG.replace(dnn_in_loop=in_loop), scans, 0.3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.index == w.index and g.diverged == w.diverged is False
        np.testing.assert_allclose(g.X, w.X, rtol=0, atol=2e-3)
        np.testing.assert_allclose(g.T_world, w.T_world, rtol=0, atol=5e-3)
        assert g.n_corr.shape == w.n_corr.shape
        # In-loop: the plain phase's iterations + every filtered one; one
        # shot: both phases may exit early, each after at least one.
        n_post = CFG.n_iters - CFG.dnn_start_iter
        assert (n_post + 1 if in_loop else 2) <= g.iterations <= CFG.n_iters


@pytest.mark.slow
def test_full_width_drive():
    """75x24 grid, S = 100, the first 4 frames of the city drive; the JAX
    side runs its CPU default, the flax apply, whose bf16 roundings differ
    from the fused path's within the same 2e-2 output bound."""
    cfg = JConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0,
                  dnn_filter=True)
    scans = [s for s, _ in CityDriveSource(n_frames=4, speed=1.0, n_beams=64,
                                           n_azimuth=1024)]
    got, want = _drive(cfg, scans, 2.5)
    for g, w in zip(got, want):
        assert g.diverged == w.diverged is False
        np.testing.assert_allclose(g.X, w.X, rtol=0, atol=2e-3)
    assert np.isfinite(np.stack([g.pred_stds for g in got])).all()
