"""Radial clustering and membership of the port against the JAX package.

The clustering picks points by comparisons only, so bounds (a picked range
+- the buffer) and ``found`` must agree exactly for the same input.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import simulate_scan
from icet_tpu.ops import clustering as jcl
from icet_tpu.ops import geometry as jgeo
from icet_tpu.ops import grid as jgrid
from icet_tpu_torch.ops import clustering as tcl

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


_jax_bounds = jax.jit(jcl.radial_cluster_bounds, static_argnums=(3, 4, 5, 6))


def _both(vid, r, valid, n_voxels, min_pts, gap, buff):
    j = _jax_bounds(jnp.asarray(vid), jnp.asarray(r), jnp.asarray(valid),
                    n_voxels, min_pts, gap, buff)
    t = tcl.radial_cluster_bounds(_t(vid), _t(r), _t(valid), n_voxels, min_pts, gap, buff)
    return (np.asarray(j.bounds), np.asarray(j.found)), (t.bounds.numpy(), t.found.numpy())


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("min_pts,gap", [(5, 0.3), (1, 0.1), (12, 0.5)])
def test_random_spikes(seed, min_pts, gap):
    rng = np.random.default_rng(seed)
    n, V = 3000, 40
    vid = rng.integers(0, V + 1, n).astype(np.int32)  # includes the sentinel
    # Clumps of ranges per voxel so runs of every length occur.
    r = (rng.integers(0, 6, n) * 2.0 + rng.exponential(0.15, n)).astype(np.float32)
    valid = rng.random(n) > 0.1
    (jb, jf), (tb, tf) = _both(vid, r, valid, V, min_pts, gap, 0.1)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tb, jb)
    assert jf.any() and not jf.all()
    assert not tf[V]  # sentinel row never found


def test_scan_clusters_and_membership():
    cfg = JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
                  min_pts=15, min_range=1.0)
    scan = simulate_scan(seed=4, n_beams=32, n_azimuth=256)
    rtp = np.asarray(jgeo.cart_to_spherical(jnp.asarray(scan)))
    vid = np.asarray(jgrid.voxel_ids(jnp.asarray(rtp), cfg))
    r = rtp[:, 0]
    valid = r >= cfg.min_range
    (jb, jf), (tb, tf) = _both(vid, r, valid, cfg.n_voxels, cfg.min_pts,
                               cfg.cluster_gap, cfg.cluster_buffer)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tb, jb)
    want = np.asarray(jcl.membership(jnp.asarray(vid), jnp.asarray(r), jnp.asarray(valid),
                                     jnp.asarray(jb), cfg.n_voxels))
    got = tcl.membership(_t(vid), _t(r), _t(valid), _t(tb), cfg.n_voxels)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 1000
