"""The port's in-process device mesh (``icet_tpu_torch/parallel/sharding.py``)
against the JAX package's sharded registration on its 8 virtual CPU
devices, and against the port's own unsharded solve.

The port's mesh repeats the CPU device, as one card stands in for several
on the H100.  Sharded sums are added in another order than one pass over
the cloud, so results are held to the JAX package's own tolerances
(tests/test_parallel.py): X within 5e-4, pred_stds rtol 0.05 / atol 1e-5,
at most 5 static-mask flips a pair.  The distributed radial clustering only
sorts and selects, so it is bit-identical to the replicated one, in its
sharded path and in its overflow fallback.  49 azimuth bins against the
1024-column sweeps keep every point off the bin edges.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import pose_graph as jpg
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import scan_pair_with_ground_truth
from icet_tpu.ops.clustering import radial_cluster_bounds as j_radial
from icet_tpu.parallel.sharding import make_sharded_register as j_make
from icet_tpu.parallel.sharding import registration_mesh as j_mesh
from icet_tpu.parallel.sharding import shard_scan_batch as j_shard
from icet_tpu_torch import pose_graph as tpg
from icet_tpu_torch import solver as ts
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.keyframe import np_pose_matrix, np_pose_to_state
from icet_tpu_torch.ops.clustering import distributed_radial_cluster_bounds, radial_cluster_bounds
from icet_tpu_torch.ops.geometry import cart_to_spherical
from icet_tpu_torch.ops.grid import voxel_ids
from icet_tpu_torch.parallel.sharding import (
    DeviceAxis,
    make_sharded_register,
    registration_mesh,
    shard_scan_batch,
)

torch.set_num_threads(2)

CFG = JConfig(n_theta=49, n_phi=16, phi_min=np.pi / 3, phi_max=2 * np.pi / 3, n_iters=6,
              min_pts=20, min_range=1.0)
TCFG = config_from_icet(dataclasses.asdict(CFG))


@pytest.fixture(scope="module")
def batch():
    xs = [np.array([0.4, 0.1, 0.0, 0.0, 0.0, 0.01], np.float32),
          np.array([-0.2, 0.3, 0.05, 0.0, 0.0, -0.02], np.float32)]
    pairs = [scan_pair_with_ground_truth(x, seed=10 + i) for i, x in enumerate(xs)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]), np.stack(xs)


@pytest.fixture(scope="module")
def unsharded(batch):
    s1, s2, _ = batch
    return [ts.register_pair(s1[b], s2[b], np.zeros(6), TCFG, device="cpu") for b in range(2)]


def _mesh(dp, sp):
    return registration_mesh(dp, sp, ["cpu"] * (dp * sp))


def _assert_close(X, stds, mask, want_X, want_stds, want_mask):
    np.testing.assert_allclose(X, want_X, rtol=0, atol=5e-4)
    np.testing.assert_allclose(stds, want_stds, rtol=0.05, atol=1e-5)
    assert int((mask != want_mask).sum()) <= 5


def _check(res, jres, unsharded, xs_true):
    for b in range(2):
        one = unsharded[b]
        _assert_close(res.X[b].numpy(), res.pred_stds[b].numpy(), res.static_mask[b].numpy(),
                      one.X.numpy(), one.pred_stds.numpy(), one.static_mask.numpy())
        _assert_close(res.X[b].numpy(), res.pred_stds[b].numpy(), res.static_mask[b].numpy(),
                      np.asarray(jres.X)[b], np.asarray(jres.pred_stds)[b],
                      np.asarray(jres.static_mask)[b])
        assert int(res.iterations[b]) == one.iterations
    np.testing.assert_allclose(res.X[:, :3].numpy(), xs_true[:, :3], atol=0.03)
    np.testing.assert_allclose(res.X[:, 3:].numpy(), xs_true[:, 3:], atol=0.01)


def _jax_step(batch, dp, sp):
    s1, s2, _ = batch
    mesh = j_mesh(dp=dp, sp=sp, devices=jax.devices()[: dp * sp])
    return j_make(CFG, mesh)(*j_shard(s1, s2, np.zeros((2, 6), np.float32), mesh))


def test_sharded_matches_jax_and_unsharded(batch, unsharded):
    s1, s2, xs = batch
    res = make_sharded_register(TCFG, _mesh(1, 4))(s1, s2, np.zeros((2, 6), np.float32))
    assert res.X.shape == (2, 6) and res.static_mask.shape == (2, s1.shape[1])
    assert res.diagnostics.n_corr.shape == (2, CFG.n_iters)
    _check(res, _jax_step(batch, 1, 4), unsharded, xs)


@pytest.mark.slow
@pytest.mark.parametrize("dp,sp", [(2, 2), (2, 1)])
def test_sharded_shapes_match_jax_and_unsharded(batch, unsharded, dp, sp):
    s1, s2, xs = batch
    mesh = _mesh(dp, sp)
    res = make_sharded_register(TCFG, mesh)(*shard_scan_batch(s1, s2, np.zeros((2, 6)), mesh))
    _check(res, _jax_step(batch, dp, sp), unsharded, xs)


def test_moments_pass_runs_once_a_shard(batch, monkeypatch):
    """Every prepare and every iteration runs the moments pass once on
    each shard, on the shard's points; the sums meet in one collective."""
    s1, s2, _ = batch
    seen = []
    real = ts._moment_sums

    def spy(pts, *a, **kw):
        seen.append(pts.shape[0])
        return real(pts, *a, **kw)

    monkeypatch.setattr(ts, "_moment_sums", spy)
    mesh = _mesh(1, 4)
    axis = mesh.axis("sp")
    monkeypatch.setattr(mesh, "axis", lambda name, row=0: axis)
    res = make_sharded_register(TCFG, mesh)(s1[:1], s2[:1], np.zeros((1, 6)))
    n_pass = 1 + int(res.iterations[0])
    assert seen == [s1.shape[1] // 4] * (4 * n_pass)
    # prepare: overflow count, the bucket exchange or the fallback gather,
    # the bounds gather (sharded path only), the sums; then one a pass.
    assert axis.collectives in (n_pass + 2, n_pass + 3)


def test_mesh_refuses_what_does_not_divide(batch):
    s1, s2, _ = batch
    with pytest.raises(ValueError):
        shard_scan_batch(s1[:, :-1], s2[:, :-1], np.zeros((2, 6)), _mesh(1, 4))
    with pytest.raises(ValueError):
        shard_scan_batch(s1[:1], s2[:1], np.zeros((1, 6)), _mesh(2, 1))
    with pytest.raises(ValueError):
        registration_mesh(2, 3, ["cpu"] * 4)
    assert registration_mesh(2, None, ["cpu"] * 4).shape == {"dp": 2, "sp": 2}


def _cluster_inputs(scan):
    rtp = cart_to_spherical(torch.from_numpy(scan))
    r = rtp[..., 0]
    return voxel_ids(rtp, TCFG), r, r >= TCFG.min_range


@pytest.mark.parametrize("capacity_factor", [2.0, 0.02])
@pytest.mark.parametrize("order", ["beam_major", "shuffled"])
def test_distributed_clustering_bitmatches_replicated(batch, capacity_factor, order):
    """Bit-identical to the port's replicated clustering and to the JAX
    package's, on 8 shards.  Beam-major shards each hold a few beams, so
    their buckets are skewed and even capacity 2.0 takes the fallback; a
    shuffled cloud takes the sharded path at 2.0 and the fallback at
    0.02."""
    vid, r, ok = _cluster_inputs(batch[0][0])
    if order == "shuffled":
        perm = torch.from_numpy(np.random.default_rng(0).permutation(r.shape[0]))
        vid, r, ok = vid[perm], r[perm], ok[perm]
    args = (TCFG.n_voxels, TCFG.min_pts, TCFG.cluster_gap, TCFG.cluster_buffer)
    golden = radial_cluster_bounds(vid, r, ok, *args)
    jgold = j_radial(jnp.asarray(np.where(ok, vid, TCFG.n_voxels)), jnp.asarray(r.numpy()),
                     jnp.asarray(ok.numpy()), *args)
    axis = DeviceAxis(["cpu"] * 8)
    n = r.shape[0] // 8
    cut = [slice(i * n, (i + 1) * n) for i in range(8)]
    dist = distributed_radial_cluster_bounds([vid[c] for c in cut], [r[c] for c in cut],
                                             [ok[c] for c in cut], *args, axis,
                                             capacity_factor=capacity_factor)
    assert torch.equal(dist.bounds, golden.bounds) and torch.equal(dist.found, golden.found)
    np.testing.assert_array_equal(dist.bounds.numpy(), np.asarray(jgold.bounds))
    np.testing.assert_array_equal(dist.found.numpy(), np.asarray(jgold.found))
    sharded_path = axis.collectives == 3
    assert sharded_path == (order == "shuffled" and capacity_factor == 2.0)


def _chain_graph(K=9):
    """tests/test_distributed.py's graph: a noisy 9-pose chain."""
    rng = np.random.default_rng(0)
    states = np.zeros((K, 6), np.float32)
    states[:, 0] = np.arange(K)
    states[:, 5] = 0.05 * np.arange(K)
    meas = [np_pose_to_state(np.linalg.inv(np_pose_matrix(states[k]))
                             @ np_pose_matrix(states[k + 1])) + rng.normal(0, 0.01, 6)
            for k in range(K - 1)]
    arrays = (np.arange(K - 1), np.arange(1, K), np.stack(meas).astype(np.float32),
              np.tile(np.eye(6, dtype=np.float32) * 1e4, (K - 1, 1, 1)))
    s0 = (states + rng.normal(0, 0.05, (K, 6))).astype(np.float32)
    return arrays, s0


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_sharded_pose_graph_matches_single_and_jax(n_shards):
    (ii, jj, meas, info), s0 = _chain_graph()
    tg = tpg.PoseGraph(*(torch.from_numpy(np.asarray(a)) for a in (ii, jj, meas, info)))
    jg = jpg.PoseGraph(jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32),
                       jnp.asarray(meas), jnp.asarray(info))
    mesh = registration_mesh(n_shards, 1, ["cpu"] * n_shards)
    single = tpg.optimize_poses(s0, tg, 5, device="cpu").numpy()
    dense = tpg.optimize_poses_sharded(s0, tg, mesh, 5).numpy()
    sparse = tpg.optimize_poses_sparse_sharded(s0, tg, mesh, 5, 50).numpy()
    want = np.asarray(jpg.optimize_poses_sharded(
        jnp.asarray(s0), jg, jax.sharding.Mesh(np.array(jax.devices()[:n_shards]), ("f",)), 5))
    assert np.abs(dense - single).max() < 1e-3
    assert np.abs(sparse - tpg.optimize_poses_sparse(s0, tg, 5, 50, device="cpu").numpy()).max() < 1e-4
    assert np.abs(sparse - single).max() < 1e-3
    assert np.abs(dense - want).max() < 1e-3


def test_sharded_blockmap_matches_unsharded():
    """The block axis split over the mesh's two dp devices: spawns and
    inserts land on the owning device, and the map, its world points and
    its checkpoint equal an unsharded run's (4 blocks, so blocks are
    evicted and reused across the chunks)."""
    from icet_tpu.datasets.replay import SyntheticTrajectorySource

    from icet_tpu_torch.config import BlockMapConfig, KeyframeConfig
    from icet_tpu_torch.keyframe import BlockShards, KeyframeOdometry, shard_blockmap, whole_table
    from icet_tpu_torch.utils.checkpoint import keyframe_state

    cfg = TCFG.replace(n_theta=25, n_phi=8, n_iters=4, min_pts=15)
    scans = [s for s, _ in SyntheticTrajectorySource(n_frames=8, speed=0.4, n_beams=16,
                                                     n_azimuth=256)]
    kw = dict(kf_cfg=KeyframeConfig(spawn_distance=0.5, spawn_angle=0.15, delta_clamp=2.0),
              bm_cfg=BlockMapConfig(n_blocks=4, block_capacity=2048, points_per_scan=400),
              device="cpu")
    plain = KeyframeOdometry(cfg, **kw)
    sharded = KeyframeOdometry(cfg, **kw)
    sharded.blockmap = shard_blockmap(sharded.blockmap, _mesh(2, 1))
    assert isinstance(sharded.blockmap.points, BlockShards)
    assert [c.shape[0] for c in sharded.blockmap.points.chunks] == [2, 2]
    a, b = plain.run(scans), sharded.run(scans)
    assert plain.blockmap.n_blocks > 4  # evicted
    assert [f.T_world.tolist() for f in a] == [f.T_world.tolist() for f in b]
    for name in ("points", "valid", "poses"):
        assert torch.equal(whole_table(getattr(sharded.blockmap, name)),
                           getattr(plain.blockmap, name))
    np.testing.assert_array_equal(sharded.map_points(), plain.map_points())
    sa, sb = keyframe_state(plain), keyframe_state(sharded)
    assert all(np.array_equal(sa[k], sb[k]) for k in sa)
    with pytest.raises(ValueError):
        shard_blockmap(plain.blockmap, _mesh(3, 1))
