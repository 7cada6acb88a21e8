"""The compiled sharded registration step (``parallel.sharding.
make_sharded_register``, ``sharded_pair`` over ``graphs.ShardedGraphs``) on
the CPU, where its capture-safe stages run as plain calls on the static
buffers of each mesh row.

1. On in-process meshes of repeated CPU devices, (1, 1), (1, 2), (2, 1)
   and (2, 2), the compiled step equals the eager one
   (``make_sharded_register_eager``: ``register_pair_impl`` with the row's
   axis) bit for bit, in adaptive and fixed radial mode and with the
   moving-object test and the range sensitivity on; so does the split
   layout of a row of distinct devices (``"cpu"`` and ``"cpu:0"``), whose
   shard steps, replicated steps and joins run as separate parts.
2. It matches the JAX package's ``make_sharded_register`` on its virtual
   CPU devices at tests/test_torch_parallel.py's tolerances (X within
   5e-4, pred_stds rtol 0.05 / atol 1e-5, at most 5 static-mask flips).
3. The distributed clustering's two branches through the compiled
   prepare: a beam-major cloud overflows its buckets and takes the gather,
   a shuffled one fits and takes the bucket exchange; one overflow read a
   prepare; bit-identical either way.
4. The elastic runner runs on the compiled step, and a ``refresh`` drops
   the old mesh's graph sets and captures new ones.
5. A one-process gloo group: ``run_distributed_registration`` takes the
   eager route (decided from the backend: only NCCL compiles), and the
   compiled stages over its ``GroupAxis`` equal it bit for bit.

49 azimuth bins against 1024-column sweeps keep every point off the bin
edges (ROADMAP C1).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.synthetic import scan_pair_with_ground_truth
from icet_tpu.parallel.sharding import make_sharded_register as j_make
from icet_tpu.parallel.sharding import registration_mesh as j_mesh
from icet_tpu.parallel.sharding import shard_scan_batch as j_shard
from icet_tpu_torch import graphs
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.parallel import distributed as tdist
from icet_tpu_torch.parallel import elastic
from icet_tpu_torch.parallel.sharding import (
    make_sharded_register,
    make_sharded_register_eager,
    registration_mesh,
    shard_scan_batch,
    sharded_pair,
)

torch.set_num_threads(2)

CFG = JConfig(n_theta=49, n_phi=16, phi_min=np.pi / 3, phi_max=2 * np.pi / 3, n_iters=6,
              min_pts=20, min_range=1.0)
TCFG = config_from_icet(dataclasses.asdict(CFG))
VARIANTS = {
    "adaptive": TCFG,
    "fixed": TCFG.replace(radial_mode="fixed", n_shells=26),
    "moving_range": TCFG.replace(remove_moving=True, rm_start_iter=2, rm_residual_thresh=0.05,
                                 range_sigma=0.02),
}


@pytest.fixture(scope="module")
def batch():
    xs = [np.array([0.4, 0.1, 0.0, 0.0, 0.0, 0.01], np.float32),
          np.array([-0.2, 0.3, 0.05, 0.0, 0.0, -0.02], np.float32)]
    pairs = [scan_pair_with_ground_truth(x, seed=10 + i) for i, x in enumerate(xs)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]), np.stack(xs)


def _results_equal(got, want):
    for name in ("X", "pred_stds", "Q", "static_mask", "iterations"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for name, a, b in zip(want.diagnostics._fields, got.diagnostics, want.diagnostics):
        assert torch.equal(a, b), f"diagnostics.{name}"


def _mesh(dp, sp, devices=None):
    return registration_mesh(dp, sp, devices or ["cpu"] * (dp * sp))


# ---------------------------------------------------------------------------
# 1. Compiled against eager, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("dp,sp", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_compiled_step_equals_eager(batch, dp, sp, variant):
    s1, s2, _ = batch
    cfg = VARIANTS[variant]
    mesh = _mesh(dp, sp)
    x0 = np.zeros((2, 6), np.float32)
    step = make_sharded_register(cfg, mesh)
    replays = graphs.host_ops["copies"]
    got = step(*shard_scan_batch(s1, s2, x0, mesh))
    assert graphs.host_ops["copies"] > replays  # through the rows' buffers
    # One set a row's devices: rows of the same repeated device share it.
    assert len(step.sets) == 1 and not any(sg.split for sg in step.sets.values())
    _results_equal(got, make_sharded_register_eager(cfg, mesh)(s1, s2, x0))
    assert got.static_mask.shape == (2, s1.shape[1])


@pytest.mark.parametrize("dp,sp", [(1, 2), (2, 2)])
def test_split_layout_equals_eager(batch, dp, sp):
    """A row of distinct devices: no stage is one graph; each shard step
    runs on its shard's part, the joins between the parts."""
    s1, s2, _ = batch
    mesh = _mesh(dp, sp, ["cpu", "cpu:0"] * dp)
    x0 = np.zeros((2, 6), np.float32)
    step = make_sharded_register(TCFG, mesh)
    got = step(s1, s2, x0)
    assert all(sg.split for sg in step.sets.values())
    _results_equal(got, make_sharded_register_eager(TCFG, mesh)(s1, s2, x0))


def test_moments_pass_once_a_shard_through_the_stages(batch, monkeypatch):
    """Each prepare and iteration runs the moments pass once a shard on the
    shard's points, and the collectives are the eager step's."""
    from icet_tpu_torch import solver as ts

    s1, s2, _ = batch
    seen = []
    real = ts._moment_sums
    monkeypatch.setattr(ts, "_moment_sums",
                        lambda pts, *a, **kw: seen.append(pts.shape[0]) or real(pts, *a, **kw))
    mesh = _mesh(1, 4)
    axis = mesh.axis("sp")
    monkeypatch.setattr(mesh, "axis", lambda name, row=0: axis)
    res = make_sharded_register(TCFG, mesh)(s1[:1], s2[:1], np.zeros((1, 6)))
    n_pass = 1 + int(res.iterations[0])
    assert seen == [s1.shape[1] // 4] * (4 * n_pass)
    assert axis.collectives in (n_pass + 2, n_pass + 3)


# ---------------------------------------------------------------------------
# 2. Against the JAX package
# ---------------------------------------------------------------------------


def test_compiled_step_matches_jax(batch):
    s1, s2, xs = batch
    x0 = np.zeros((2, 6), np.float32)
    jmesh = j_mesh(dp=1, sp=2, devices=jax.devices()[:2])
    jres = j_make(CFG, jmesh)(*j_shard(s1, s2, x0, jmesh))
    res = make_sharded_register(TCFG, _mesh(1, 2))(s1, s2, x0)
    for b in range(2):
        np.testing.assert_allclose(res.X[b].numpy(), np.asarray(jres.X)[b], rtol=0, atol=5e-4)
        np.testing.assert_allclose(res.pred_stds[b].numpy(), np.asarray(jres.pred_stds)[b],
                                   rtol=0.05, atol=1e-5)
        assert int((res.static_mask[b].numpy() != np.asarray(jres.static_mask)[b]).sum()) <= 5
    np.testing.assert_allclose(res.X[:, :3].numpy(), xs[:, :3], atol=0.03)


# ---------------------------------------------------------------------------
# 3. The clustering's two branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", ["beam_major", "shuffled"])
def test_prepare_branches(batch, order):
    """On four shards, beam-major shards each hold a few beams, so their
    buckets overflow and the prepare gathers the cloud; a shuffled cloud
    fits its buckets and the prepare exchanges them."""
    s1, s2, _ = batch
    if order == "shuffled":
        perm = np.random.default_rng(0).permutation(s1.shape[1])
        s1, s2 = s1[:, perm], s2[:, perm]
    mesh = _mesh(1, 4)
    step = make_sharded_register(TCFG, mesh)
    reads = graphs.host_ops["overflow_reads"]
    got = step(s1[:1], s2[:1], np.zeros((1, 6)))
    assert graphs.host_ops["overflow_reads"] - reads == 1
    (sg,) = step.sets.values()
    assert bool(sg.buffers.rep.overflow) == (order == "beam_major")
    _results_equal(got, make_sharded_register_eager(TCFG, mesh)(s1[:1], s2[:1], np.zeros((1, 6))))


# ---------------------------------------------------------------------------
# 4. The elastic runner
# ---------------------------------------------------------------------------


def test_elastic_runner_on_the_compiled_step(batch):
    s1, s2, _ = batch
    x0 = np.zeros((2, 6), np.float32)
    runner = elastic.ElasticRegistrationRunner(TCFG, prefer_dp=2, devices=["cpu"] * 4)
    assert runner.shape == (2, 2) and runner._step is runner.sharded
    got = runner.run(s1, s2, x0)
    want = make_sharded_register_eager(TCFG, runner.mesh)(s1, s2, x0)
    np.testing.assert_array_equal(got.X, want.X.numpy())
    old = runner.sharded
    assert len(old.sets) == 1
    runner.refresh(devices=["cpu"] * 2)
    assert old.sets == {} and runner.sharded is not old and runner.sharded.sets == {}
    assert runner.shape == (2, 1) and runner.rebuilds == 1
    got = runner.run(s1, s2, x0)
    assert len(runner.sharded.sets) == 1
    np.testing.assert_array_equal(
        got.X, make_sharded_register_eager(TCFG, runner.mesh)(s1, s2, x0).X.numpy())


# ---------------------------------------------------------------------------
# 5. A one-process gloo group
# ---------------------------------------------------------------------------


@pytest.fixture
def gloo_group(tmp_path):
    tdist.init_distributed(num_processes=1, process_id=0,
                           init_method=f"file://{tmp_path}/store", device="cpu",
                           timeout_s=60)
    try:
        yield tdist.global_registration_mesh(sp=1)
    finally:
        dist.destroy_process_group()


def test_gloo_takes_the_eager_route(batch, gloo_group):
    s1, s2, _ = batch
    mesh = gloo_group
    assert not mesh.compiled
    x0 = np.zeros((2, 6), np.float32)
    ops = dict(graphs.host_ops)
    res, rows = tdist.run_distributed_registration(s1, s2, x0, TCFG, mesh)
    assert graphs.host_ops == ops and mesh._sets == {}
    assert rows == slice(0, 2)
    # A one-rank group sums like a one-shard axis.
    _results_equal(res, make_sharded_register(TCFG, _mesh(1, 1))(s1, s2, x0))


@pytest.mark.parametrize("backend", ["nccl", "gloo", "mpi", "ucc"])
def test_only_nccl_compiles(gloo_group, backend, monkeypatch):
    """The route is chosen from the group's backend when the mesh is built:
    the captured step on NCCL alone, the eager functions on every other."""
    monkeypatch.setattr(tdist.dist, "get_backend", lambda *a: backend)
    mesh = tdist.global_registration_mesh(sp=1, device="cpu")
    assert mesh.compiled == (backend == "nccl")


def test_process_mesh_stages_equal_eager(batch, gloo_group):
    """The compiled stages over a process group's axis (what an NCCL group
    runs), here on the gloo group's CPU tensors, against its eager route."""
    s1, s2, _ = batch
    mesh = gloo_group
    x0 = np.zeros((2, 6), np.float32)
    want, _ = tdist.run_distributed_registration(s1, s2, x0, TCFG, mesh)
    mesh.compiled = True
    got, _ = tdist.run_distributed_registration(s1, s2, x0, TCFG, mesh)
    assert len(mesh._sets) == 1
    _results_equal(got, want)
    # The same stages, called directly on the row's set.
    sg = mesh.row_graphs(s1.shape[1], TCFG)
    one = sharded_pair(sg, mesh.axis("sp"), [torch.from_numpy(s1[0])],
                       [torch.from_numpy(s2[0])], torch.zeros(6))
    assert torch.equal(one.X, want.X[0])
