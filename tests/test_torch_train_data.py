"""The BiasNet training data of the port (``models/train_data.py``) against
``icet_tpu/models/train_data.py``.

Scenes, poses and scans come from numpy's rng in both packages, so the
voxel samples can be compared directly.  At a grid of 45 azimuth bins (not
a divisor of the sweep's 1,024 columns) no column sits on a bin edge, and
both packages pick the same voxels with samples equal to 1e-6 m.  At the
default 48x16 grid (48 shares the factor 16 with 1,024) whole columns sit
on bin edges, where any two float32 evaluations may bin differently (the
JAX package's jitted and eager paths included): there the voxel counts are
held within 2% of each other.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.models import train_data as jt
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.models import train_data as tt

torch.set_num_threads(2)

COPRIME = JConfig(n_theta=45, n_phi=16, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
                  min_pts=20, min_range=1.0, moment_method="segsum")


def _tc(cfg):
    return config_from_icet(dataclasses.asdict(cfg))


@pytest.mark.slow
def test_raycast_pairs_match_on_a_coprime_grid():
    kw = dict(n_pairs=2, samples_per_voxel=16, min_pts=10, seed=1)
    j1, j2 = jt.make_raycast_voxel_pairs(cfg=COPRIME, **kw)
    t1, t2 = tt.make_raycast_voxel_pairs(cfg=_tc(COPRIME), device="cpu", **kw)
    assert t1.shape == j1.shape and t2.shape == j2.shape and len(t1) > 100
    np.testing.assert_allclose(t1, j1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t2, j2, rtol=0, atol=1e-6)


def test_real_pair_samples_match_on_a_coprime_grid():
    from icet_tpu.datasets.synthetic import scan_pair_with_ground_truth

    X = np.array([0.3, -0.2, 0.05, 0.01, -0.01, 0.02], np.float32)
    s1, s2 = scan_pair_with_ground_truth(X, seed=4, n_beams=32, n_azimuth=512)
    j1, j2 = jt.make_real_pair_voxel_samples(s1, s2, X, COPRIME, 16, 10)
    t1, t2 = tt.make_real_pair_voxel_samples(s1, s2, X, _tc(COPRIME), 16, 10, device="cpu")
    assert t1.shape == j1.shape and len(t1) > 50
    np.testing.assert_allclose(t1, j1, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t2, j2, rtol=0, atol=1e-6)


@pytest.mark.slow
def test_raycast_pairs_default_grid_voxel_count():
    kw = dict(n_pairs=1, samples_per_voxel=16, min_pts=10, seed=2)
    j1, j2 = jt.make_raycast_voxel_pairs(**kw)
    t1, t2 = tt.make_raycast_voxel_pairs(device="cpu", **kw)
    assert t1.shape == t2.shape and t1.shape[1:] == (16, 3)
    assert abs(len(t1) - len(j1)) <= 0.02 * len(j1), (len(t1), len(j1))
    # Aligned pairs: per-voxel means of the first 16 points agree about as
    # well in both packages (the JAX package's own gate is 0.3 m).
    d = np.median(np.linalg.norm(t1.mean(axis=1) - t2.mean(axis=1), axis=1))
    dj = np.median(np.linalg.norm(j1.mean(axis=1) - j2.mean(axis=1), axis=1))
    assert d < 0.3 and abs(d - dj) <= 0.1 * dj, (d, dj)


@pytest.mark.parametrize("seed", range(6))
def test_training_scene_kinds(seed):
    a = jt.training_scene(np.random.default_rng(seed))
    b = tt.training_scene(np.random.default_rng(seed))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_raycast_batch_iter():
    rng = np.random.default_rng(0)
    s1 = rng.normal(size=(40, 8, 3)).astype(np.float32)
    s2 = s1 + 0.01
    it = tt.raycast_batch_iter(s1, s2, torch.Generator().manual_seed(0), batch=32,
                               shift_scale=0.2)
    for _ in range(2):
        x, d = next(it)
        assert x.shape == (32, 16, 4) and d.shape == (32, 3)
        assert float(d.abs().max()) <= 0.2
        np.testing.assert_array_equal(x[:, :8, 3].numpy(), -1.0)
        np.testing.assert_array_equal(x[:, 8:, 3].numpy(), 1.0)
        shift = (x[:, 8:, :3].mean(dim=1) - x[:, :8, :3].mean(dim=1)).numpy()
        np.testing.assert_allclose(shift, d.numpy() + 0.01, atol=1e-5)


def test_train_bias_net_mixed_runs():
    st, losses, (s1, s2) = tt.train_bias_net_mixed(steps=2, batch=8, sample_pts=32, n_pairs=1,
                                                   seed=3, device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses)) and st.step == 2
    assert s1.shape == s2.shape and s1.shape[1:] == (32, 3) and len(s1) > 0
