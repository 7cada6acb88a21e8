"""The fused moment sums of the port against the JAX package.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against its plain version there).  Here its plain version,
``fused_moment_sums_reference``, which the wrapper takes for CPU tensors,
is held against ``icet_tpu.solver._jnp_sums`` (the function the kernel
computes) and, secondarily, against the TPU kernel ``fused_moment_sums`` in
Pallas interpret mode.  The scan has no point near ``min_range`` (the
Pallas kernel gates on the transformed range, the production path on the
raw one) and no point near a bin edge (13 azimuth bins against a
128-column sweep), so the count column must agree exactly; the other
columns are float32 sums taken in another order, held to atol 2e-3 as
tests/test_pallas_fused.py holds them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import simulate_scan
from icet_tpu.ops import moments as jmom
from icet_tpu.ops.pallas_fused import fused_moment_sums as pallas_fused_moment_sums
from icet_tpu.solver import _jnp_sums, prepare_reference_jit
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.ops import moments as tmom
from icet_tpu_torch.ops.fused_moments import (
    fused_moment_sums,
    fused_moment_sums_reference,
)

torch.set_num_threads(2)

CFG = JConfig(
    n_theta=13, n_phi=4, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
    n_iters=3, min_pts=10, min_range=1.0,
)
TCFG = config_from_icet(dataclasses.asdict(CFG))
XS = {
    "zero": np.zeros(6, np.float32),
    "small": np.array([0.12, -0.05, 0.02, 0.01, -0.004, 0.006], np.float32),
    "large": np.array([1.5, 0.4, -0.1, 0.02, 0.01, 0.2], np.float32),
}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    scan = simulate_scan(seed=7, n_beams=16, n_azimuth=128)
    model = prepare_reference_jit(jnp.asarray(scan), CFG.replace(moment_method="segsum"))
    return scan, np.asarray(model.bounds), np.asarray(model.anchors)


def _holey(scan):
    rng = np.random.default_rng(3)
    out = scan[rng.permutation(scan.shape[0])].copy()
    out[:100] = np.nan
    out[100:200] = 0.0
    out[200:220, 2] = np.nan
    return out


def _check(got, want, atol=2e-3):
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, :10], want[:, :10], rtol=0, atol=atol)
    assert (got[:, 10:] == 0).all() and (got[-1] == 0).all()


@pytest.mark.parametrize("xname", sorted(XS))
@pytest.mark.parametrize("holes", [False, True], ids=["scan", "shuffled_nan_zero"])
def test_reference_matches_jnp_sums(scene, xname, holes):
    scan, bounds, anchors = scene
    pts = _holey(scan) if holes else scan
    X = XS[xname]
    want = np.asarray(_jnp_sums(jnp.asarray(pts), jnp.asarray(X), jnp.asarray(bounds),
                                jnp.asarray(anchors), CFG))
    got = fused_moment_sums_reference(_t(pts), _t(X), _t(bounds), _t(anchors), TCFG).numpy()
    assert want[:, 0].sum() > 50  # members exist at every X
    _check(got, want)


@pytest.mark.parametrize("xname", ["zero", "small"])
def test_reference_matches_pallas_interpret(scene, xname):
    scan, bounds, anchors = scene
    X = XS[xname]
    want = np.asarray(pallas_fused_moment_sums(
        jnp.asarray(scan), jnp.asarray(X), jnp.asarray(bounds), jnp.asarray(anchors),
        CFG, block=256))
    got = fused_moment_sums_reference(_t(scan), _t(X), _t(bounds), _t(anchors), TCFG).numpy()
    _check(got, want)


def test_wrapper_takes_plain_version_on_cpu(scene):
    scan, bounds, anchors = scene
    args = (_t(scan), _t(XS["small"]), _t(bounds), _t(anchors), TCFG)
    before = fused_moment_sums.launches
    np.testing.assert_array_equal(fused_moment_sums(*args).numpy(),
                                  fused_moment_sums_reference(*args).numpy())
    assert fused_moment_sums.launches == before  # no kernel launch on the CPU


def test_wrapper_refuses_devices_without_kernel(scene):
    scan, bounds, anchors = scene
    args = [_t(a).to("meta") for a in (scan, XS["small"], bounds, anchors)]
    with pytest.raises(ValueError):
        fused_moment_sums(*args, TCFG)


@pytest.mark.parametrize("xname", ["zero", "large"])
def test_segsum_and_finalize(scene, xname):
    scan, bounds, anchors = scene
    rng = np.random.default_rng(1)
    n, V = scan.shape[0], CFG.n_voxels
    vid = rng.integers(0, V + 1, n).astype(np.int32)
    member = (rng.random(n) > 0.2) & (vid < V)
    pts = (scan + XS[xname][:3]).astype(np.float32)
    want = np.asarray(jmom.voxel_moment_sums(jnp.asarray(pts), jnp.asarray(vid),
                                             jnp.asarray(member), jnp.asarray(anchors), V))
    got = tmom.voxel_moment_sums(_t(pts), _t(vid), _t(member), _t(anchors), V).numpy()
    _check(got, want)
    jm = jmom.finalize_moments(jnp.asarray(want), jnp.asarray(anchors))
    tm = tmom.finalize_moments(_t(want), _t(anchors))
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    jc, jmean, jcov6 = jmom.finalize_moments_planes(jnp.asarray(want), jnp.asarray(anchors))
    tc, tmean, tcov6 = tmom.finalize_moments_planes(_t(want), _t(anchors))
    np.testing.assert_allclose(tcov6.numpy(), np.asarray(jcov6), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tmom.cov6_to_matrix(tcov6).numpy(),
                                  np.asarray(jmom.cov6_to_matrix(jnp.asarray(tcov6.numpy()))))
    # "onehot": blocked one-hot products of the three bf16 parts, as the
    # JAX package's accumulator; float32 sums in another order, within 1e-6
    # of each column's largest magnitude, the counts exact.
    j1h = np.asarray(jmom.voxel_moment_sums(jnp.asarray(pts), jnp.asarray(vid),
                                            jnp.asarray(member), jnp.asarray(anchors), V,
                                            method="onehot", block=CFG.moment_block))
    t1h = tmom.voxel_moment_sums(_t(pts), _t(vid), _t(member), _t(anchors), V, "onehot",
                                 CFG.moment_block).numpy()
    np.testing.assert_array_equal(t1h[:, 0], j1h[:, 0])
    err = np.abs(t1h - j1h) / np.maximum(np.abs(j1h).max(axis=0), 1e-30)
    assert err.max() <= 1e-6, err.max(axis=0)
    np.testing.assert_array_equal(
        tmom.voxel_moment_sums(_t(pts), _t(vid), _t(member), _t(anchors), V, "pallas").numpy(),
        got)
