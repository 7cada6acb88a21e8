"""The port's windowed fused moment sums against the JAX package's TPU
kernel ``fused_moment_sums_windowed`` in Pallas interpret mode (as
tests/test_pallas_fused.py runs it on the CPU).

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against its plain version there).  Here its plain version, which the
wrapper takes for CPU tensors, must give the TPU kernel's overflow count
and counts exactly, and the other columns to atol 2e-3 (float32 sums in
another order, as tests/test_torch_fused_moments.py holds them).  The
TPU kernel bins with a polynomial atan that differs from the exact one
within about 1e-6 rad of a bin edge, so each case first asserts that no
point lies within 1e-5 rad of an edge (13 and 25 azimuth bins against
sweeps of 128 and 256 columns: coprime, so no column sits on an edge).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import simulate_scan
from icet_tpu.ops.pallas_fused import fused_moment_sums_windowed as pallas_windowed
from icet_tpu.solver import prepare_reference_jit
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.ops import fused_moments as tfm
from icet_tpu_torch.ops.geometry import cart_to_spherical, transform_points

torch.set_num_threads(2)

X_STEP = np.array([0.1, -0.04, 0.02, 0.01, -0.004, 0.004], np.float32)
GRID = dict(phi_min=np.pi / 3, phi_max=2 * np.pi / 3, min_pts=10, min_range=1.0)
#: name: (grid, radial mode, azimuth columns, shuffled, block, window)
CASES = {
    "beam_major_no_overflow": ((13, 4), "adaptive", 128, False, 256, 64),
    "beam_major_overflow": ((25, 8), "adaptive", 256, False, 256, 64),
    "shuffled": ((25, 8), "adaptive", 256, True, 256, 8),
    "fixed_radial": ((25, 8), "fixed", 256, False, 512, 256),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _edge_points(pts, X, cfg) -> int:
    rtp = cart_to_spherical(transform_points(_t(pts), _t(X))).double().numpy()
    w_t, w_p = 2 * np.pi / cfg.n_theta, (cfg.phi_max - cfg.phi_min) / cfg.n_phi
    ft, fp = rtp[:, 1] / w_t, (rtp[:, 2] - cfg.phi_min) / w_p
    near = (np.abs(ft - np.round(ft)) * w_t < 1e-5) & (rtp[:, 1] > 0)
    near |= np.abs(fp - np.round(fp)) * w_p < 1e-5
    return int(near.sum())


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas_interpret(case):
    (n_theta, n_phi), radial, cols, shuffled, block, window = CASES[case]
    cfg = JConfig(n_theta=n_theta, n_phi=n_phi, radial_mode=radial, n_shells=12, **GRID)
    scan = simulate_scan(seed=7, n_beams=16, n_azimuth=cols)
    model = prepare_reference_jit(jnp.asarray(scan), cfg.replace(moment_method="segsum"))
    bounds, anchors = np.asarray(model.bounds), np.asarray(model.anchors)
    pts = scan[np.random.default_rng(1).permutation(scan.shape[0])] if shuffled else scan
    assert _edge_points(pts, X_STEP, cfg) == 0

    want, want_ovf = pallas_windowed(jnp.asarray(pts), jnp.asarray(X_STEP), jnp.asarray(bounds),
                                     jnp.asarray(anchors), cfg, block, window)
    got, got_ovf = tfm.fused_moment_sums_windowed(
        _t(pts), _t(X_STEP), _t(bounds), _t(anchors), config_from_icet(dataclasses.asdict(cfg)),
        block, window)
    want = np.asarray(want)
    got = got.numpy()
    assert got_ovf.dtype == torch.int32 and got_ovf.shape == ()
    assert int(got_ovf) == int(want_ovf)
    if case == "beam_major_no_overflow":
        assert int(got_ovf) == 0
    else:
        assert int(got_ovf) > 0
    if not shuffled:  # at window 8 a shuffled block keeps almost nothing
        assert got[:, 0].sum() > 50
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, :10], want[:, :10], rtol=0, atol=2e-3)
    assert (got[:, 10:] == 0).all() and (got[-1] == 0).all()


def test_no_overflow_equals_unwindowed_sums():
    """With nothing off-window and no point near min_range (the two range
    gates then agree), the windowed sums are the unwindowed ones."""
    cfg = config_from_icet(dataclasses.asdict(JConfig(n_theta=13, n_phi=4, **GRID)))
    scan = simulate_scan(seed=7, n_beams=16, n_azimuth=128)
    pts, X = _t(scan), torch.zeros(6)
    from icet_tpu_torch.solver import prepare_reference

    model = prepare_reference(pts, cfg)
    got, ovf = tfm.fused_moment_sums_windowed(pts, X, model.bounds, model.anchors, cfg, 256, 64)
    want = tfm.fused_moment_sums_reference(pts, X, model.bounds, model.anchors, cfg)
    assert int(ovf) == 0
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrapper_takes_plain_version_on_cpu():
    cfg = config_from_icet(dataclasses.asdict(JConfig(n_theta=13, n_phi=4, **GRID)))
    scan = _t(simulate_scan(seed=7, n_beams=16, n_azimuth=128))
    bounds = torch.zeros(cfg.n_voxels + 1, 2)
    bounds[:-1, 1] = 100.0
    anchors = torch.zeros(cfg.n_voxels + 1, 3)
    before = tfm.fused_moment_sums_windowed.launches
    got = tfm.fused_moment_sums_windowed(scan, _t(X_STEP), bounds, anchors, cfg, 256, 16)
    want = tfm.fused_moment_sums_windowed_reference(scan, _t(X_STEP), bounds, anchors, cfg, 256, 16)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    assert int(got[1]) == int(want[1]) > 0
    assert tfm.fused_moment_sums_windowed.launches == before  # no kernel launch on the CPU


def test_wrapper_checks():
    cfg = config_from_icet(dataclasses.asdict(JConfig(n_theta=13, n_phi=4, **GRID)))
    v1 = cfg.n_voxels + 1
    pts, X = torch.zeros(300, 3), torch.zeros(6)
    bounds, anchors = torch.zeros(v1, 2), torch.zeros(v1, 3)
    with pytest.raises(ValueError):  # no kernel for this device
        tfm.fused_moment_sums_windowed(*(t.to("meta") for t in (pts, X, bounds, anchors)), cfg)
    tfm._check_windowed(pts, X, bounds, anchors, cfg, 512, 64)
    for args, exc in (
        ((pts.double(), X, bounds, anchors, cfg, 512, 64), TypeError),
        ((pts, X, bounds[:-1], anchors, cfg, 512, 64), ValueError),
        ((pts, X[:5], bounds, anchors, cfg, 512, 64), ValueError),
        ((torch.zeros(3, 300).T, X, bounds, anchors, cfg, 512, 64), ValueError),  # strided
        ((pts, X, bounds, anchors, cfg, 0, 64), ValueError),
        ((pts, X, bounds, anchors, cfg, 512, 6_000), ValueError),  # shared memory
    ):
        with pytest.raises(exc):
            tfm._check_windowed(*args)
    # No point is staged in shared memory any more: any block is taken, as
    # the TPU kernel takes it (tests/test_torch_fused_windowed_edges.py
    # holds the plain version at such a block against the TPU kernel).
    tfm._check_windowed(pts, X, bounds, anchors, cfg, 16_384, 64)
