"""Kernel #1's large tables on the CPU: fixed radial mode (75x24 bins x 50
shells, V + 1 = 90,001 rows) and adaptive grids above one block's shared
memory (150x48, V = 7,200), which the kernel sums by its sorted parts.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` phase 3a
holds its sorted parts against the plain version there).  Here the plain
version, ``fused_moment_sums_reference``, which the wrapper takes for CPU
tensors, is held against ``icet_tpu.solver._jnp_sums`` (the function the
kernel computes) on a 64x1024 city-drive frame at three transforms, and
against the TPU kernel ``fused_moment_sums`` in Pallas interpret mode at a
small fixed grid (13 x 7 bins x 6 shells, where its one-hot stays small).
Both packages bin in float32, and ``log``, ``atan2`` and ``acos`` may round
an ulp apart, so points whose transformed angle lies within 1e-5 rad of a
bin edge, or whose shell index lies within 1e-5 of a shell edge, are left
out of the inputs (a few in 65,536; asserted below 0.1%).  Then the count
column must agree exactly and the other columns within atol 2e-3 (float32
sums taken in another order), as tests/test_torch_fused_moments.py holds
them.  The Pallas kernel gates on the transformed range and the production
path on the raw one: the small scene has no point near ``min_range``.

The sorted parts' plan is checked on the Python side (parts covering every
point, scratch holding every part's rows, bitmap and prefixes), and a
fixed-mode registration through the fused route equals the JAX package's
segsum solve at the solver parity tolerances of tests/test_torch_routing.py
(which holds the 150x48 one): X within 1e-5 absolute, ``pred_stds`` within
1e-4 relative at fixed run length.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import solver as js
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import scan_pair_with_ground_truth, simulate_scan
from icet_tpu.ops.pallas_fused import fused_moment_sums as pallas_fused_moment_sums
from icet_tpu.solver import _jnp_sums
from icet_tpu_torch import solver as ts
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.datasets.replay import CityDriveSource
from icet_tpu_torch.ops import fused_moments as fm
from icet_tpu_torch.ops import moment_scatter as tsc
from icet_tpu_torch.ops.geometry import transform_points
from icet_tpu_torch.ops.grid import fixed_shell_bounds, voxel_anchors
from tests.test_torch_routing import _edge_distance

torch.set_num_threads(2)

FIXED = JConfig(radial_mode="fixed")                  # 75x24x50, V = 90,000
BIG = JConfig(n_theta=150, n_phi=48, min_pts=10)     # V = 7,200
SMALL_FIXED = JConfig(n_theta=13, n_phi=7, n_shells=6, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
                      radial_mode="fixed", min_range=1.0)
XS = {
    "zero": np.zeros(6, np.float32),
    "small": np.array([0.12, -0.05, 0.02, 0.01, -0.004, 0.006], np.float32),
    "large": np.array([1.5, 0.4, -0.1, 0.02, 0.01, 0.2], np.float32),
}
#: points this close to a bin edge (rad) or a shell edge (shell index)
#: are left out, and at most this share of them
EDGE, EDGE_SHARE = 1e-5, 1e-3
#: atol of the feature columns (tests/test_torch_fused_moments.py)
ATOL = 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _check(got, want, atol=ATOL):
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, :10], want[:, :10], rtol=0, atol=atol)
    assert (got[:, 10:] == 0).all() and (got[-1] == 0).all()


def _off_edges(pts, X, cfg):
    """``pts`` without the points past the range gates whose transformed
    angles (or, in fixed radial mode, shell index) lie within EDGE of a bin
    edge (points short of a gate are no member in either package)."""
    p2 = transform_points(_t(pts).double(), _t(X).double()).numpy()
    r = np.linalg.norm(p2, axis=1)
    gated = (np.linalg.norm(pts.astype(np.float64), axis=1) >= cfg.min_range) \
        & (r >= cfg.min_range)
    theta = np.mod(np.arctan2(p2[:, 1], p2[:, 0]), 2 * np.pi)
    phi = np.arccos(np.clip(p2[:, 2] / np.maximum(r, 1e-30), -1, 1))
    ft = theta / (2 * np.pi / cfg.n_theta)
    fp = (phi - cfg.phi_min) / ((cfg.phi_max - cfg.phi_min) / cfg.n_phi)
    wt, wp = 2 * np.pi / cfg.n_theta, (cfg.phi_max - cfg.phi_min) / cfg.n_phi
    near = ((np.abs(ft - np.round(ft)) * wt < EDGE) & (theta > 0)) \
        | (np.abs(fp - np.round(fp)) * wp < EDGE)
    if cfg.radial_mode == "fixed":
        fs = np.log(np.maximum(r, cfg.min_range) / cfg.min_range) / np.log(cfg.shell_growth)
        near |= np.abs(fs - np.round(fs)) < EDGE
    near &= gated
    assert near.mean() <= EDGE_SHARE
    return np.ascontiguousarray(pts[~near])


@pytest.fixture(scope="module")
def drive():
    """Frames 0 and 1 of the 64x1024 city drive."""
    src = CityDriveSource(n_frames=2, speed=1.0, n_beams=64, n_azimuth=1024)
    return [s.astype(np.float32) for s, _ in src]


def _tables(cfg, drive):
    """(bounds, anchors) as numpy: fixed mode's shell bounds, or the adaptive
    grid's from frame 0 prepared by the port (both packages get the same)."""
    tcfg = config_from_icet(dataclasses.asdict(cfg))
    if cfg.radial_mode == "fixed":
        bounds = fixed_shell_bounds(tcfg)
        return bounds.numpy(), voxel_anchors(bounds, tcfg).numpy()
    model = ts.prepare_reference(_t(drive[0]), tcfg)
    return model.bounds.numpy(), model.anchors.numpy()


@pytest.mark.parametrize("xname", sorted(XS))
@pytest.mark.parametrize("grid", ["fixed", "150x48"])
def test_reference_matches_jnp_sums(drive, grid, xname):
    cfg = FIXED if grid == "fixed" else BIG
    tcfg = config_from_icet(dataclasses.asdict(cfg))
    assert fm.large_table(tcfg) and ts.moment_route(tcfg) == "fused"
    bounds, anchors = _tables(cfg, drive)
    assert bounds.shape == (cfg.n_voxels + 1, 2)
    X = XS[xname]
    pts = _off_edges(drive[1], X, cfg)
    want = np.asarray(_jnp_sums(jnp.asarray(pts), jnp.asarray(X), jnp.asarray(bounds),
                                jnp.asarray(anchors), cfg))
    got = fm.fused_moment_sums(_t(pts), _t(X), _t(bounds), _t(anchors), tcfg).numpy()
    assert got.shape == (cfg.n_voxels + 1, 16)
    assert want[:, 0].sum() > 5_000
    _check(got, want)


@pytest.fixture(scope="module")
def small_scene():
    scan = simulate_scan(seed=7, n_beams=32, n_azimuth=128)
    tcfg = config_from_icet(dataclasses.asdict(SMALL_FIXED))
    bounds = fixed_shell_bounds(tcfg)
    return scan, bounds.numpy(), voxel_anchors(bounds, tcfg).numpy()


@pytest.mark.parametrize("xname", sorted(XS))
def test_reference_matches_pallas_interpret_fixed(small_scene, xname):
    scan, bounds, anchors = small_scene
    X = XS[xname]
    # The scan's dropouts (r = 0) are left out: the production path never
    # counts them, the Pallas kernel does once X moves them past min_range
    # (or, at r = 0, into the sentinel row, whose bounds are (0, 0)).
    scan = scan[np.linalg.norm(scan, axis=1) >= SMALL_FIXED.min_range]
    # N a multiple of the Pallas block: the TPU kernel pads the scan with
    # points at the origin, which X moves past min_range (or, at X = 0,
    # into the sentinel row) and counts.
    pts = _off_edges(scan, X, SMALL_FIXED)
    pts = np.ascontiguousarray(pts[:pts.shape[0] // 256 * 256])
    assert pts.shape[0] > 3_500
    # No point near min_range, raw or transformed (the two gates differ).
    p2 = transform_points(_t(pts), _t(X)).numpy()
    for r in (np.linalg.norm(pts, axis=1), np.linalg.norm(p2, axis=1)):
        assert np.all(np.abs(r - SMALL_FIXED.min_range) > 1e-3)
    want = np.asarray(pallas_fused_moment_sums(
        jnp.asarray(pts), jnp.asarray(X), jnp.asarray(bounds), jnp.asarray(anchors),
        SMALL_FIXED, block=256))
    tcfg = config_from_icet(dataclasses.asdict(SMALL_FIXED))
    got = fm.fused_moment_sums(_t(pts), _t(X), _t(bounds), _t(anchors), tcfg).numpy()
    assert want[:, 0].sum() > 1_000
    _check(got, want)


@pytest.mark.parametrize("n", [0, 1, 1023, 1025, 65_536, 131_072])
@pytest.mark.parametrize("n_voxels", [5774, 5775, 7200, 90_000])
def test_large_plan(n, n_voxels):
    """The sorted parts: one block an SM, parts of 1,024 consecutive points
    covering every point, each part's compacted rows, bitmap and prefixes
    in the scratch, as the moment scatter plans its large tables."""
    blocks, chunk, parts, cap = fm.large_plan(n, n_voxels, 132)
    assert blocks == 132 and chunk == tsc.SORT_POINTS == 1024
    assert parts == max(1, -(-n // chunk))
    assert parts * chunk >= n and (parts - 1) * chunk < max(n, 1)
    # A part touches at most its points' rows and never more than V + 1.
    assert cap == min(n_voxels + 1, chunk)
    words = fm.bitmap_words(n_voxels)
    assert tsc.scratch_words(parts, cap, n_voxels) == parts * cap * 16 + 2 * parts * words
    assert (chunk, parts, cap) == tsc.part_plan(n, n_voxels, blocks, -(-n // blocks), False)


def test_register_pair_through_fused_route():
    """A fixed-mode registration through the fused route equals the JAX
    package's segsum solve (the 150x48 grid's is in test_torch_routing.py).
    509 columns share no factor with 75 azimuth bins."""
    cfg = FIXED.replace(n_iters=5, min_pts=10, min_range=1.0)
    x_true = np.array([0.3, -0.1, 0.02, 0.01, -0.01, 0.03])
    s1, s2 = scan_pair_with_ground_truth(x_true, seed=3, n_beams=32, n_azimuth=509)
    assert _edge_distance(s1, cfg) > 1e-5 and _edge_distance(s2, cfg) > 1e-5
    tcfg = config_from_icet(dataclasses.asdict(cfg))
    assert ts.moment_route(tcfg) == "fused" and fm.large_table(tcfg)
    j = js.register_pair(jnp.asarray(s1), jnp.asarray(s2), jnp.zeros(6, jnp.float32),
                         cfg.replace(moment_method="segsum"))
    t = ts.register_pair(s1, s2, np.zeros(6, np.float32), tcfg, device="cpu")
    np.testing.assert_allclose(t.X.numpy(), np.asarray(j.X), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t.pred_stds.numpy(), np.asarray(j.pred_stds), rtol=1e-4)
    np.testing.assert_array_equal(t.diagnostics.n_corr.numpy(),
                                  np.asarray(j.diagnostics.n_corr))
    assert t.diagnostics.n_corr.numpy()[-1] > 100
    np.testing.assert_allclose(t.X.numpy()[:3], x_true[:3], atol=0.05)
