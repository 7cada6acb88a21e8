"""The port's sharded pose-graph solves as captured stages
(``pose_graph.optimize_poses_sharded``, ``optimize_poses_sparse_sharded``
over ``graphs.ShardedPoseGraphs``), run here on the CPU, where the stages
are plain calls on the same buffers.

1. Against their eager loops (``optimize_poses_sharded_eager``,
   ``optimize_poses_sparse_sharded_eager``) bit for bit: 2 and 3 factor
   shards (the factors padded to a multiple of the shard count), the
   Cauchy reweighting on and off, a split row of two distinct devices;
   one graph set a shape, reused by a second solve.
2. Against the JAX package's sharded solves on its virtual CPU devices,
   within tests/test_torch_parallel.py's bound (1e-3).
3. A process mesh: a one-process gloo group takes the eager loop; forced
   to the compiled stages (what an NCCL group runs), its stages over the
   group's axis equal the eager loop bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from icet_tpu import pose_graph as jpg
from icet_tpu_torch import graphs
from icet_tpu_torch import pose_graph as tpg
from icet_tpu_torch.keyframe import np_pose_matrix, np_pose_to_state
from icet_tpu_torch.parallel import distributed as tdist
from icet_tpu_torch.parallel.sharding import registration_mesh

torch.set_num_threads(2)


def _rel(a, b):
    return np_pose_to_state(np.linalg.inv(np_pose_matrix(a)) @ np_pose_matrix(b))


@pytest.fixture(scope="module")
def ring():
    """A noisy 13-pose chain with two loop factors (15 factors: padding at
    2 shards, none at 3)."""
    K = 13
    rng = np.random.default_rng(0)
    states = np.zeros((K, 6), np.float32)
    states[:, 0] = np.arange(K)
    states[:, 5] = 0.05 * np.arange(K)
    ii = list(range(K - 1)) + [0, 2]
    jj = list(range(1, K)) + [9, 12]
    meas = [_rel(states[i], states[j]) + rng.normal(0, 0.01, 6) for i, j in zip(ii, jj)]
    info = np.tile(np.eye(6, dtype=np.float32) * 1e4, (len(ii), 1, 1))
    arrays = (np.asarray(ii), np.asarray(jj), np.stack(meas).astype(np.float32), info)
    s0 = (states + rng.normal(0, 0.05, (K, 6))).astype(np.float32)
    return arrays, s0


def _graphs(arrays):
    ii, jj, meas, info = arrays
    tg = tpg.PoseGraph(*(torch.from_numpy(np.asarray(a)) for a in arrays))
    jg = jpg.PoseGraph(jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32),
                       jnp.asarray(meas), jnp.asarray(info))
    return tg, jg


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# 1. Against the eager loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 3])
def test_dense_equals_eager(ring, shards):
    arrays, s0 = ring
    tg, _ = _graphs(arrays)
    mesh = registration_mesh(shards, 1, ["cpu"] * shards)
    _equal(tpg.optimize_poses_sharded(s0, tg, mesh, 4),
           tpg.optimize_poses_sharded_eager(s0, tg, mesh, 4))


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("robust", [0.0, 0.5], ids=["plain", "cauchy"])
def test_sparse_equals_eager(ring, shards, robust):
    arrays, s0 = ring
    tg, _ = _graphs(arrays)
    mesh = registration_mesh(shards, 1, ["cpu"] * shards)
    got = tpg.optimize_poses_sparse_sharded(s0, tg, mesh, 4, 20, robust_delta=robust)
    _equal(got, tpg.optimize_poses_sparse_sharded_eager(s0, tg, mesh, 4, 20,
                                                        robust_delta=robust))
    # A second solve from other states replays the same set.
    n_sets = len(graphs._CACHE)
    again = tpg.optimize_poses_sparse_sharded(s0 + 0.01, tg, mesh, 4, 20, robust_delta=robust)
    assert len(graphs._CACHE) == n_sets
    _equal(again, tpg.optimize_poses_sparse_sharded_eager(s0 + 0.01, tg, mesh, 4, 20,
                                                          robust_delta=robust))


def test_split_row_equals_eager(ring):
    """Two distinct devices on the factor axis: per-part stages with the
    joins between them."""
    arrays, s0 = ring
    tg, _ = _graphs(arrays)
    mesh = registration_mesh(2, 1, ["cpu", "cpu:0"])
    axis = mesh.axis("dp")
    got = tpg.optimize_poses_sparse_sharded(s0, tg, mesh, 3, 15)
    pg = graphs.sharded_pose_graphs(axis, 13, 8, 15, "tridiag", 0.0, 1e-6, 1e8)
    assert pg.split
    _equal(got, tpg.optimize_poses_sparse_sharded_eager(s0, tg, mesh, 3, 15))
    _equal(tpg.optimize_poses_sharded(s0, tg, mesh, 3),
           tpg.optimize_poses_sharded_eager(s0, tg, mesh, 3))


def test_collectives_counted_a_step(ring):
    """One ``(K, 78)`` sum a GN step and one ``(K, 6)`` sum a CG iteration,
    as the eager loop's, counted on the bound axis."""
    arrays, s0 = ring
    tg, _ = _graphs(arrays)
    mesh = registration_mesh(2, 1, ["cpu"] * 2)
    axis = mesh.axis("dp")
    mesh.axis = lambda name, row=0: axis
    tpg.optimize_poses_sparse_sharded(s0, tg, mesh, 3, 10)
    assert axis.collectives == 3 * (1 + 10)
    assert axis.bytes == 3 * (13 * 78 * 4 + 10 * 13 * 6 * 4)


# ---------------------------------------------------------------------------
# 2. Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_solves_match_jax(ring, shards):
    arrays, s0 = ring
    tg, jg = _graphs(arrays)
    mesh = registration_mesh(shards, 1, ["cpu"] * shards)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:shards]), ("f",))
    dense = tpg.optimize_poses_sharded(s0, tg, mesh, 5).numpy()
    sparse = tpg.optimize_poses_sparse_sharded(s0, tg, mesh, 5, 40).numpy()
    jdense = np.asarray(jpg.optimize_poses_sharded(jnp.asarray(s0), jg, jmesh, 5))
    jsparse = np.asarray(jpg.optimize_poses_sparse_sharded(jnp.asarray(s0), jg, jmesh, 5, 40))
    assert np.abs(dense - jdense).max() < 1e-3
    assert np.abs(sparse - jsparse).max() < 1e-3


# ---------------------------------------------------------------------------
# 3. A process mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def gloo_mesh(tmp_path):
    tdist.init_distributed(num_processes=1, process_id=0,
                           init_method=f"file://{tmp_path}/store", device="cpu",
                           timeout_s=60)
    try:
        yield tdist.global_registration_mesh(sp=1)
    finally:
        dist.destroy_process_group()


def test_process_mesh_routes(ring, gloo_mesh, monkeypatch):
    arrays, s0 = ring
    tg, _ = _graphs(arrays)
    mesh = gloo_mesh
    assert not mesh.compiled
    n_sets = len(graphs._CACHE)
    dense_e = tpg.optimize_poses_sharded(s0, tg, mesh, 3)
    sparse_e = tpg.optimize_poses_sparse_sharded(s0, tg, mesh, 3, 15)
    assert len(graphs._CACHE) == n_sets  # gloo: the eager loops, no set
    _equal(dense_e, tpg.optimize_poses_sharded_eager(s0, tg, mesh, 3))
    _equal(sparse_e, tpg.optimize_poses_sparse_sharded_eager(s0, tg, mesh, 3, 15))
    monkeypatch.setattr(mesh, "compiled", True)
    _equal(tpg.optimize_poses_sharded(s0, tg, mesh, 3), dense_e)
    _equal(tpg.optimize_poses_sparse_sharded(s0, tg, mesh, 3, 15), sparse_e)
    assert len(graphs._CACHE) == n_sets + 2
