"""Edge inputs of the fused moment sums, and the launch plan of the
one-launch CUDA kernel, on the CPU.

``chip_smoke.py`` holds the kernel against its plain version on the card at
these inputs (all points in one voxel, no member, N = 1, a ragged N).  Here
the plain version, ``fused_moment_sums_reference``, which the wrapper takes
for CPU tensors, is held against ``icet_tpu.solver._jnp_sums`` (the
function the kernel computes) and the TPU kernel in Pallas interpret mode
at the same kinds of input.  As in tests/test_torch_fused_moments.py the
count column must agree exactly (no point near a bin edge or near
``min_range``) and the other columns within atol 2e-3 (float32 sums in
other orders); the one-voxel case uses dyadic offsets whose sums are exact,
so there every column agrees exactly with ``_jnp_sums``.  The plan tests
check the Python side of the kernel: its grid, the size of its scratch
against the rows blocks really touch, and its refusals.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import simulate_scan
from icet_tpu.ops.pallas_fused import fused_moment_sums as pallas_fused_moment_sums
from icet_tpu.solver import _jnp_sums, prepare_reference_jit
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.ops import fused_moments as fm
from icet_tpu_torch.ops.clustering import membership
from icet_tpu_torch.ops.geometry import cart_to_spherical, point_norm, transform_points
from icet_tpu_torch.ops.grid import voxel_ids

torch.set_num_threads(2)

CFG = JConfig(
    n_theta=13, n_phi=4, phi_min=np.pi / 3, phi_max=2 * np.pi / 3,
    n_iters=3, min_pts=10, min_range=1.0,
)
TCFG = config_from_icet(dataclasses.asdict(CFG))
X_SMALL = np.array([0.12, -0.05, 0.02, 0.01, -0.004, 0.006], np.float32)
CASES = ["one_voxel", "no_member", "n1", "ragged"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    scan = simulate_scan(seed=7, n_beams=16, n_azimuth=128)
    model = prepare_reference_jit(jnp.asarray(scan), CFG.replace(moment_method="segsum"))
    return scan, np.asarray(model.bounds), np.asarray(model.anchors)


def _one_voxel(n, seed=0):
    """``n`` points in voxel (it=5, ip=2) on a 1/16 lattice around its
    centre at 20 m, bounds admitting every range, the anchor at the centre."""
    it, ip = 5, 2
    theta = (it + 0.5) * 2 * np.pi / CFG.n_theta
    phi = CFG.phi_min + (ip + 0.5) * (CFG.phi_max - CFG.phi_min) / CFG.n_phi
    c = np.round(20.0 * np.array([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                                  np.cos(phi)]) * 16) / 16
    pts = (c + np.random.default_rng(seed).integers(-4, 5, size=(n, 3)) / 16).astype(np.float32)
    v1 = CFG.n_voxels + 1
    bounds = np.tile(np.array([[0.0, 1000.0]], np.float32), (v1, 1))
    anchors = np.zeros((v1, 3), np.float32)
    anchors[ip * CFG.n_theta + it] = c
    return pts, np.zeros(6, np.float32), bounds, anchors


def _case(name, scene):
    scan, bounds, anchors = scene
    if name == "one_voxel":
        return _one_voxel(2048)
    if name == "no_member":
        return scan, X_SMALL, np.full_like(bounds, 1e4), anchors
    if name == "n1":
        member, _ = _member_mask(scan, X_SMALL, bounds)
        k = int(torch.nonzero(member)[0])
        return scan[k:k + 1], X_SMALL, bounds, anchors
    # a point count that no block size divides
    return np.concatenate([scan, scan[:517]]), X_SMALL, bounds, anchors


def _member_mask(pts, X, bounds):
    p = _t(pts)
    p2 = transform_points(p, _t(X))
    rtp = cart_to_spherical(p2)
    vid = voxel_ids(rtp, TCFG)
    return membership(vid, rtp[..., 0], point_norm(p) >= TCFG.min_range, _t(bounds),
                      TCFG.n_voxels), vid


def _check(got, want, atol=2e-3):
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, :10], want[:, :10], rtol=0, atol=atol)
    assert (got[:, 10:] == 0).all() and (got[-1] == 0).all()


@pytest.mark.parametrize("name", CASES)
def test_reference_matches_jnp_sums(scene, name):
    pts, X, bounds, anchors = _case(name, scene)
    want = np.asarray(_jnp_sums(jnp.asarray(pts), jnp.asarray(X), jnp.asarray(bounds),
                                jnp.asarray(anchors), CFG))
    got = fm.fused_moment_sums_reference(_t(pts), _t(X), _t(bounds), _t(anchors), TCFG).numpy()
    if name == "one_voxel":
        # Dyadic offsets: every sum is exact in float32, in any order.
        np.testing.assert_array_equal(got, want)
        assert got[:, 0].sum() == pts.shape[0] and (got[:, 0] > 0).sum() == 1
    else:
        _check(got, want)
    if name == "no_member":
        assert (got == 0).all()
    if name == "n1":
        assert got[:, 0].sum() == 1.0


@pytest.mark.parametrize("name", CASES)
def test_reference_matches_pallas_interpret(scene, name):
    pts, X, bounds, anchors = _case(name, scene)
    want = np.asarray(pallas_fused_moment_sums(
        jnp.asarray(pts), jnp.asarray(X), jnp.asarray(bounds), jnp.asarray(anchors),
        CFG, block=256))
    got = fm.fused_moment_sums_reference(_t(pts), _t(X), _t(bounds), _t(anchors), TCFG).numpy()
    _check(got, want)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 65536, 65537, 131072])
def test_launch_plan_covers_points(n):
    blocks, per_block, cap = fm.launch_plan(n, 1800, 132)
    assert 1 <= blocks <= 132
    assert blocks * per_block >= n
    assert (blocks - 1) * per_block < max(n, 1)  # no block is left without points
    # One block an SM at most, and none with fewer than ~128 points.
    assert blocks == max(1, min(132, -(-n // fm.MIN_POINTS_PER_BLOCK)))
    assert blocks == 1 or per_block > fm.MIN_POINTS_PER_BLOCK // 2
    assert 1 <= cap <= 1800 and cap >= min(1800, per_block)
    assert fm.scratch_floats(blocks, cap, 1800) == blocks * cap * 10 + 2 * blocks * 57


def test_scratch_holds_every_block_rows(scene):
    """On a beam-major scan and on its shuffle, the rows each block of the
    plan touches never exceed ``cap``; far fewer than V+1 on the scan."""
    scan = scene[0]
    bounds = scene[1]
    for pts in (scan, scan[np.random.default_rng(2).permutation(scan.shape[0])]):
        member, vid = _member_mask(pts, X_SMALL, bounds)
        blocks, per_block, cap = fm.launch_plan(pts.shape[0], CFG.n_voxels, 8)
        touched = [torch.unique(vid[b * per_block:(b + 1) * per_block][
            member[b * per_block:(b + 1) * per_block]]).numel() for b in range(blocks)]
        assert max(touched) <= cap
    assert fm.bitmap_words(1800) == 57 and fm.bitmap_words(31) == 1 and fm.bitmap_words(32) == 2


def test_shared_memory_sizing():
    assert fm.shared_bytes(1800) == 1801 * 40 + 57 * 8
    # A small table: the combine's run sums take more.
    assert fm.shared_bytes(10) == fm.THREADS * 10 * 4
    # The largest table that fits one block, and the first that does not.
    v = max(v for v in range(5000, 6000) if fm.shared_bytes(v) <= fm.MAX_SHARED_BYTES)
    assert fm.shared_bytes(v + 1) > fm.MAX_SHARED_BYTES
    too_big = TCFG.replace(n_theta=v + 1, n_phi=1)
    pts = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        fm._check(pts, torch.zeros(6), torch.zeros((v + 2, 2)), torch.zeros((v + 2, 3)),
                  too_big)
    ok = TCFG.replace(n_theta=v, n_phi=1)
    fm._check(pts, torch.zeros(6), torch.zeros((v + 1, 2)), torch.zeros((v + 1, 3)), ok)


def test_check_refusals(scene):
    scan, bounds, anchors = (_t(a) for a in scene)
    X = _t(X_SMALL)
    fm._check(scan, X, bounds, anchors, TCFG)
    with pytest.raises(NotImplementedError):
        fm._check(scan, X, bounds, anchors, TCFG.replace(radial_mode="fixed"))
    with pytest.raises(TypeError):
        fm._check(scan.double(), X, bounds, anchors, TCFG)
    for bad in (
        lambda: fm._check(scan, X[:5], bounds, anchors, TCFG),
        lambda: fm._check(scan, X, bounds[:-1], anchors, TCFG),
        lambda: fm._check(scan, X, bounds, anchors.t().contiguous().t(), TCFG),
        lambda: fm._check(scan, X, bounds, anchors.to("meta"), TCFG),
    ):
        with pytest.raises(ValueError):
            bad()
