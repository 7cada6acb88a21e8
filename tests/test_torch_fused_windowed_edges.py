"""Edge inputs of the windowed fused moment sums, and the launch plan of its
one-launch CUDA kernel, on the CPU.

``chip_smoke.py`` holds the kernel against its plain version on the card at
these kinds of input (more point blocks than SMs, narrower and wider
windows, a ragged last block, one voxel, no member).  Here the plain
version, which the wrapper takes for CPU tensors, is held against the TPU
kernel ``fused_moment_sums_windowed`` in Pallas interpret mode, as
tests/test_torch_fused_windowed.py holds it: the overflow count and the
counts exactly, the other columns to atol 2e-3; in the one-voxel case the
offsets are dyadic and every column agrees exactly.  A block larger than
the scan, which the kernel took only within shared memory before, is one
of the cases.  The plan tests check the Python side of the kernel: its
threads, the rows a point block can touch (``cap``) against the rows
point blocks really touch, its scratch and its shared memory.
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
from icet_tpu_torch.ops.clustering import membership
from icet_tpu_torch.ops.geometry import cart_to_spherical, transform_points
from icet_tpu_torch.ops.grid import voxel_ids

torch.set_num_threads(2)

CFG = JConfig(n_theta=25, n_phi=8, phi_min=np.pi / 3, phi_max=2 * np.pi / 3, min_pts=10,
              min_range=1.0)
TCFG = config_from_icet(dataclasses.asdict(CFG))
X_STEP = np.array([0.1, -0.04, 0.02, 0.01, -0.004, 0.004], np.float32)
#: name: (block, window)
CASES = {
    "block_64": (64, 64),
    "window_128": (256, 128),
    "window_512": (256, 512),
    "ragged": (256, 64),
    "one_voxel": (256, 64),
    "no_member": (256, 64),
    "block_above_scan": (16_384, 64),
}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    scan = simulate_scan(seed=7, n_beams=16, n_azimuth=256)
    model = prepare_reference_jit(jnp.asarray(scan), CFG.replace(moment_method="segsum"))
    return scan, np.asarray(model.bounds), np.asarray(model.anchors)


def _edge_points(pts, X) -> int:
    rtp = cart_to_spherical(transform_points(_t(pts), _t(X))).double().numpy()
    w_t, w_p = 2 * np.pi / CFG.n_theta, (CFG.phi_max - CFG.phi_min) / CFG.n_phi
    ft, fp = rtp[:, 1] / w_t, (rtp[:, 2] - CFG.phi_min) / w_p
    near = (np.abs(ft - np.round(ft)) * w_t < 1e-5) & (rtp[:, 1] > 0)
    near |= np.abs(fp - np.round(fp)) * w_p < 1e-5
    return int(near.sum())


def _case(name, scene):
    scan, bounds, anchors = scene
    if name == "ragged":  # a point count that the block does not divide
        return np.concatenate([scan, scan[:77]]), X_STEP, bounds, anchors
    if name == "no_member":
        return scan, X_STEP, np.full_like(bounds, 1e4), anchors
    if name == "one_voxel":
        # 1,000 points in voxel (it=5, ip=2) on a 1/16 lattice around its
        # centre at 20 m, bounds admitting every range, the anchor at the
        # centre, X = 0: dyadic offsets, exact sums in any order.
        it, ip = 5, 2
        theta = (it + 0.5) * 2 * np.pi / CFG.n_theta
        phi = CFG.phi_min + (ip + 0.5) * (CFG.phi_max - CFG.phi_min) / CFG.n_phi
        c = np.round(20.0 * np.array([np.sin(phi) * np.cos(theta),
                                      np.sin(phi) * np.sin(theta), np.cos(phi)]) * 16) / 16
        rng = np.random.default_rng(0)
        pts = (c + rng.integers(-4, 5, size=(1000, 3)) / 16).astype(np.float32)
        bounds = np.tile(np.array([[0.0, 1000.0]], np.float32), (CFG.n_voxels + 1, 1))
        anchors = np.zeros((CFG.n_voxels + 1, 3), np.float32)
        anchors[ip * CFG.n_theta + it] = c
        return pts, np.zeros(6, np.float32), bounds, anchors
    return scan, X_STEP, bounds, anchors


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_matches_pallas_interpret(scene, name):
    block, window = CASES[name]
    pts, X, bounds, anchors = _case(name, scene)
    assert _edge_points(pts, X) == 0
    want, want_ovf = pallas_windowed(jnp.asarray(pts), jnp.asarray(X), jnp.asarray(bounds),
                                     jnp.asarray(anchors), CFG, block, window)
    got, got_ovf = tfm.fused_moment_sums_windowed(_t(pts), _t(X), _t(bounds), _t(anchors),
                                                  TCFG, block, window)
    want, got = np.asarray(want), got.numpy()
    assert int(got_ovf) == int(want_ovf)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    if name == "one_voxel":
        np.testing.assert_array_equal(got[:, :10], want[:, :10])
        assert got[:, 0].sum() == pts.shape[0] and int(got_ovf) == 0
    else:
        np.testing.assert_allclose(got[:, :10], want[:, :10], rtol=0, atol=2e-3)
    assert (got[:, 10:] == 0).all() and (got[-1] == 0).all()
    if name == "no_member":
        assert (got == 0).all() and int(got_ovf) > 0
    if name in ("block_64", "window_128", "window_512", "ragged"):
        assert got[:, 0].sum() > 50


@pytest.mark.parametrize("block", [1, 31, 32, 64, 100, 512, 513, 16_384])
@pytest.mark.parametrize("window", [1, 64, 256, 512])
def test_windowed_plan(block, window):
    n = 65_536 + 217
    nb, threads, cap, words = tfm.windowed_plan(n, block, window)
    assert nb == -(-n // block) and (nb - 1) * block < n <= nb * block
    # A block of threads: whole warps, at most WIN_THREADS, no more than one
    # warp beyond the point block.
    assert threads % 32 == 0 and 32 <= threads <= tfm.WIN_THREADS
    assert threads == tfm.WIN_THREADS or threads - block < 32
    # A point block touches at most its points and the window's first
    # window - 1 columns (the last is the overflow slot).
    assert cap == max(1, min(block, window - 1))
    assert words * 32 >= window > (words - 1) * 32
    assert tfm.windowed_scratch_words(nb, cap, words) == nb * (cap * 12 + 2 * words + 2)
    assert tfm.windowed_plan(0, block, window)[0] == 0


def test_cap_holds_every_point_block_rows(scene):
    """On a beam-major scan and on its shuffle, at the TPU kernel's own
    block and window and at block 64, the rows each point block sums never
    exceed the plan's ``cap``."""
    scan, bounds = scene[0], _t(scene[1])
    V = TCFG.n_voxels
    for pts in (scan, scan[np.random.default_rng(2).permutation(scan.shape[0])]):
        p2 = transform_points(_t(pts), _t(X_STEP))
        rtp = cart_to_spherical(p2)
        vid = voxel_ids(rtp, TCFG)
        for block, window in ((512, 256), (64, 256), (256, 8)):
            nb, _, cap, _ = tfm.windowed_plan(pts.shape[0], block, window)
            v_pad = tfm._windowed_v_pad(V, window)
            for b in range(nb):
                v = vid[b * block:(b + 1) * block]
                ok = v < V
                vmin = int(v[ok].min()) if ok.any() else 0
                start = max(min(vmin // 128 * 128, v_pad - window), 0)
                in_win = ok & (v >= start) & (v < start + window - 1)
                member = membership(v, rtp[b * block:(b + 1) * block, 0], in_win, bounds, V)
                assert torch.unique(v[member]).numel() <= cap


def test_shared_memory_sizing():
    assert tfm.windowed_shared_bytes(256) == 256 * 40 + 8 * 8
    assert tfm.windowed_shared_bytes(1) == 40 + 8
    # The widest window one block holds beside the kernel's static shared
    # memory, and the first that it does not.
    w = max(w for w in range(5000, 6000)
            if tfm.windowed_shared_bytes(w) <= tfm.MAX_SHARED_BYTES - tfm.WIN_STATIC_SHARED)
    pts, X = torch.zeros(300, 3), torch.zeros(6)
    v1 = TCFG.n_voxels + 1
    bounds, anchors = torch.zeros(v1, 2), torch.zeros(v1, 3)
    tfm._check_windowed(pts, X, bounds, anchors, TCFG, 512, w)
    with pytest.raises(ValueError):
        tfm._check_windowed(pts, X, bounds, anchors, TCFG, 512, w + 1)
