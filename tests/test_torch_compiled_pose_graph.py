"""The port's compiled HD-mapping back end on the CPU: the pose-graph solves
(``pose_graph.optimize_poses``, ``optimize_poses_sparse``) as staged
graphs, ``solver.register_pair_jit`` and ``pose_graph.close_loops`` in
chunks of ``batch`` pairs.  On the CPU the capture-safe stages run as plain
calls on the static buffers of ``icet_tpu_torch.graphs``.

1. The staged solves (one dense Gauss-Newton step a graph; the sparse
   solve's assembly, one CG iteration and the update) equal the eager
   loops ``optimize_poses_eager`` / ``optimize_poses_sparse_eager`` bit
   for bit, tridiag and jacobi, ``robust_delta`` 0 and 3.5; against the
   JAX package within tests/test_torch_pose_graph.py's 2e-3.
2. The staged ``register_pair`` equals ``register_pair_impl`` bit for bit.
3. ``close_loops`` at ``batch`` 16 and 3 equals the pair-by-pair result (a
   last chunk shorter than ``batch``, a pair the gate rejects), takes the
   JAX package's positional call, and verifies unfiltered under a
   ``dnn_filter=True`` config.
4. The ``"scatter"`` and ``"onehot"`` routes take the staged pair too,
   equal to the eager functions bit for bit.

The registration cases use a 25x8 grid against 256-column sweeps
(coprime: no column on a bin edge, ROADMAP C1).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import pose_graph as jp
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.replay import SyntheticTrajectorySource
from icet_tpu_torch import graphs
from icet_tpu_torch import pose_graph as tp
from icet_tpu_torch import solver as ts
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.keyframe import np_pose_matrix, np_pose_to_state
from icet_tpu_torch.ops.linalg import psd_pinv
from icet_tpu_torch.ops.tridiag import tridiag_apply, tridiag_factor

torch.set_num_threads(2)

CFG = JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=4, min_pts=15, min_range=1.0)
TCFG = config_from_icet(dataclasses.asdict(CFG))


def _rel_state(a, b):
    return np_pose_to_state(np.linalg.inv(np_pose_matrix(a)) @ np_pose_matrix(b))


def _circle_graph(K=12, loops=((0, 11), (1, 10))):
    """tests/test_torch_pose_graph.py's circle: noisy odometry factors and
    confident loop factors (numpy seed 42), the states chained from the
    odometry, and the same factors as numpy arrays."""
    rng = np.random.default_rng(42)
    states = []
    for k in range(K):
        a = 2 * np.pi * k / K * 0.9
        states.append(np.array([5 * np.cos(a), 5 * np.sin(a), 0, 0, 0, -a], np.float32))
    idx_i, idx_j, meas, info = [], [], [], []
    for k in range(K - 1):
        m = np.array(_rel_state(states[k], states[k + 1]))
        m[:3] += rng.normal(0, 0.05, 3)
        m[3:] += rng.normal(0, 0.005, 3)
        idx_i.append(k)
        idx_j.append(k + 1)
        meas.append(m)
        info.append(np.diag([1 / 0.05**2] * 3 + [1 / 0.005**2] * 3))
    for i, j in loops:
        idx_i.append(i)
        idx_j.append(j)
        meas.append(_rel_state(states[i], states[j]))
        info.append(np.diag([1e4] * 3 + [1e6] * 3))
    arrays = (np.asarray(idx_i, np.int32), np.asarray(idx_j, np.int32),
              np.stack(meas).astype(np.float32), np.stack(info).astype(np.float32))
    T, s0 = np.eye(4), [np.zeros(6, np.float32)]
    for m in arrays[2][:K - 1]:
        T = T @ np_pose_matrix(m)
        s0.append(np_pose_to_state(T))
    return arrays, np.stack(s0).astype(np.float32)


@pytest.fixture(scope="module")
def circle():
    arrays, s0 = _circle_graph()
    tg = tp.PoseGraph(*(torch.from_numpy(np.array(a)) for a in arrays)).to("cpu")
    jg = jp.PoseGraph(*(jnp.asarray(a) for a in arrays))
    return s0, tg, jg


# ---------------------------------------------------------------------------
# 1. The solves
# ---------------------------------------------------------------------------


def test_dense_staged_equals_eager_and_jax(circle):
    s0, tg, jg = circle
    got = tp.optimize_poses(s0, tg, 10, device="cpu")
    assert torch.equal(got, tp.optimize_poses_eager(s0, tg, 10, device="cpu"))
    want = np.asarray(jp.optimize_poses(jnp.asarray(s0), jg, 10))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("precond,cg", [("tridiag", 120), ("jacobi", 120), ("tridiag", 5)])
@pytest.mark.parametrize("robust", [0.0, 3.5])
def test_sparse_staged_equals_eager_and_jax(circle, precond, cg, robust):
    s0, tg, jg = circle
    got = tp.optimize_poses_sparse(s0, tg, 10, cg, precond=precond, robust_delta=robust,
                                   device="cpu")
    eager = tp.optimize_poses_sparse_eager(s0, tg, 10, cg, precond=precond,
                                           robust_delta=robust, device="cpu")
    assert torch.equal(got, eager)
    want = np.asarray(jp.optimize_poses_sparse(jnp.asarray(s0), jg, 10, cg, precond=precond,
                                               robust_delta=robust))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


def test_sparse_staging_replays_and_buffers(circle):
    """One set a ``(device, K, F, cg_iters, precond, robust)``; a second
    solve of another graph of the same shapes reuses it, its buffers
    overwritten, and the returned states are a copy no later solve
    changes."""
    s0, tg, _ = circle
    first = tp.optimize_poses_sparse(s0, tg, 2, 7, device="cpu")
    kept = first.clone()
    pg = graphs.pose_graphs("cpu", 12, 13, 7, "tridiag", 0.0)
    assert pg.buffers.factor[0].shape == (12, 6, 6) and pg.buffers.factor[1].shape == (11, 6, 6)
    moved = tg._replace(meas=tg.meas * 1.01)
    second = tp.optimize_poses_sparse(s0, moved, 2, 7, device="cpu")
    assert graphs.pose_graphs("cpu", 12, 13, 7, "tridiag", 0.0) is pg
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert torch.equal(second, tp.optimize_poses_sparse_eager(s0, moved, 2, 7, device="cpu"))


def test_backbone_kernels_are_counted_in_graphs():
    assert tridiag_factor in graphs.COUNTED and tridiag_apply in graphs.COUNTED
    assert {"tridiag_factor", "tridiag_apply"} <= set(graphs.warmup_launches)


def test_unknown_preconditioner_raises(circle):
    s0, tg, _ = circle
    with pytest.raises(ValueError):
        tp.optimize_poses_sparse(s0, tg, 1, 1, precond="ilu", device="cpu")


@pytest.mark.slow
def test_sparse_staged_equals_eager_loop_closure_size():
    """The loop-closure drive's solve size and options: 250 poses, a loop
    factor every 10 poses to the pose 100 later, 10 x 50, robust 3.5."""
    K = 250
    loops = [(i, i + 100) for i in range(0, K - 100, 10)]
    arrays, s0 = _circle_graph(K, loops)
    tg = tp.PoseGraph(*(torch.from_numpy(np.array(a)) for a in arrays)).to("cpu")
    got = tp.optimize_poses_sparse(s0, tg, 10, 50, robust_delta=3.5, device="cpu")
    assert torch.equal(got, tp.optimize_poses_sparse_eager(s0, tg, 10, 50, robust_delta=3.5,
                                                           device="cpu"))


# ---------------------------------------------------------------------------
# 2-3. register_pair and close_loops
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drive():
    src = SyntheticTrajectorySource(n_frames=7, speed=0.3, yaw_rate=0.02,
                                    n_beams=32, n_azimuth=256)
    scans, poses = zip(*[(s.astype(np.float32), T) for s, T in src])
    return list(scans), list(poses)


def _results_equal(a, b):
    assert a.iterations == b.iterations
    for name in ("X", "pred_stds", "Q", "static_mask"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert all(torch.equal(x, y) for x, y in zip(a.diagnostics, b.diagnostics))


@pytest.mark.parametrize("want_static_mask", [True, False])
def test_register_pair_jit_equals_impl(drive, want_static_mask):
    scans, _ = drive
    s1, s2 = torch.from_numpy(scans[0]), torch.from_numpy(scans[2])
    x0 = torch.tensor([0.5, 0, 0, 0, 0, 0.03])
    got = ts.register_pair_jit(s1, s2, x0, TCFG, want_static_mask)
    _results_equal(got, ts.register_pair_impl(s1, s2, x0, TCFG,
                                              want_static_mask=want_static_mask))
    # The user entry takes it on a captured route.
    _results_equal(ts.register_pair(scans[0], scans[2], x0, TCFG, device="cpu"),
                   ts.register_pair_impl(s1, s2, x0, TCFG))


def test_register_pair_jit_scans_of_two_sizes(drive):
    """Scan 1's prepare runs in the set of its own size and hands its model
    over to the set of scan 2's."""
    scans, _ = drive
    s1, s2 = torch.from_numpy(scans[0][::2].copy()), torch.from_numpy(scans[1])
    x0 = torch.zeros(6)
    _results_equal(ts.register_pair_jit(s1, s2, x0, TCFG),
                   ts.register_pair_impl(s1, s2, x0, TCFG))


#: candidate pairs of the drive; (0, 6) is warm-started 3 m and 0.3 rad off
CANDIDATES = [(0, 2), (1, 3), (2, 4), (0, 6), (3, 5), (1, 5), (4, 6)]
BAD = (0, 6)


def _x0_fn(poses):
    def x0(i, j):
        x = np_pose_to_state(np.linalg.inv(poses[i]) @ poses[j]).astype(np.float32)
        return x + (np.array([3.0, 0, 0, 0, 0, 0.3], np.float32) if (i, j) == BAD else 0)
    return x0


def _pair_by_pair(scans, cands, cfg, x0_fn):
    """Each candidate registered on its own by the eager functions, gated."""
    out = []
    for i, j in cands:
        res = ts.register_pair_impl(torch.from_numpy(scans[i]), torch.from_numpy(scans[j]),
                                    torch.from_numpy(x0_fn(i, j)), cfg, want_static_mask=False)
        dx = float(res.diagnostics.dx_norm[-1])
        if np.isfinite(dx) and dx <= tp.LOOP_DX_GATE:
            out.append((i, j, res.X.numpy(), psd_pinv(res.Q[None])[0].numpy()))
    return out


def _factors_equal(got, want):
    assert [(i, j) for i, j, _, _ in got] == [(i, j) for i, j, _, _ in want]
    for (_, _, gx, gi), (_, _, wx, wi) in zip(got, want):
        assert np.array_equal(gx, wx) and np.array_equal(gi, wi)
        assert gx.dtype == np.float32 and gi.shape == (6, 6)


@pytest.mark.parametrize("batch", [16, 3])
def test_close_loops_chunks_equal_pair_by_pair(drive, batch):
    scans, poses = drive
    x0_fn = _x0_fn(poses)
    want = _pair_by_pair(scans, CANDIDATES, TCFG, x0_fn)
    assert BAD not in [(i, j) for i, j, _, _ in want] and len(want) == len(CANDIDATES) - 1
    got = tp.close_loops(scans, CANDIDATES, TCFG, x0_fn=x0_fn, batch=batch, device="cpu")
    _factors_equal(got, want)


def test_close_loops_positional_call_and_reads(drive, monkeypatch):
    """The JAX package's positional call ``close_loops(s, c, cfg, f, 16)``
    (here with the port's ``device`` after it); one read back to the host
    a chunk (7 candidates at batch 3: 3)."""
    scans, poses = drive
    x0_fn = _x0_fn(poses)
    reads = {"n": 0}
    real = torch.Tensor.cpu

    def cpu(t, *args, **kw):
        reads["n"] += 1
        return real(t, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    got = tp.close_loops(scans, CANDIDATES, TCFG, x0_fn, 3, device="cpu")
    monkeypatch.setattr(torch.Tensor, "cpu", real)
    assert reads["n"] == 3
    _factors_equal(got, tp.close_loops(scans, CANDIDATES, TCFG, x0_fn, 16, "cpu"))
    assert tp.close_loops(scans, [], TCFG, x0_fn, 16, "cpu") == []


def test_close_loops_dnn_config_verifies_unfiltered(drive, monkeypatch):
    """Loop verification under a ``dnn_filter=True`` config registers
    without the filter, as ``register`` does in both packages."""
    import icet_tpu_torch.filters as tf

    def no_filter(*args, **kw):
        raise AssertionError("the filter ran")

    for name in ("pretrained_dnn", "dnn_reject_mask", "solve_dnn"):
        monkeypatch.setattr(tf, name, no_filter)
    scans, poses = drive
    x0_fn = _x0_fn(poses)
    dcfg = TCFG.replace(dnn_filter=True)
    _factors_equal(tp.close_loops(scans, CANDIDATES, dcfg, x0_fn, device="cpu"),
                   _pair_by_pair(scans, CANDIDATES, TCFG, x0_fn))


# ---------------------------------------------------------------------------
# 4. The scatter and one-hot routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["pallas", "onehot"], ids=["scatter", "onehot"])
def test_scatter_and_onehot_routes_take_the_compiled_pair(drive, monkeypatch, method):
    """The scatter and one-hot routes, once left to the eager pair, are
    captured now: ``register_pair_jit``, ``register_pair`` and
    ``close_loops`` take the staged graphs and equal the eager functions
    bit for bit."""
    scans, poses = drive
    cfg = TCFG.replace(moment_method=method)
    s1, s2 = torch.from_numpy(scans[0]), torch.from_numpy(scans[2])
    x0 = torch.tensor([0.5, 0, 0, 0, 0, 0.03])
    _results_equal(ts.register_pair_jit(s1, s2, x0, cfg), ts.register_pair_impl(s1, s2, x0, cfg))
    runs = []
    real = graphs.FrameGraphs.run
    monkeypatch.setattr(graphs.FrameGraphs, "run",
                        lambda self, *a: runs.append(1) or real(self, *a))
    _results_equal(ts.register_pair(scans[0], scans[2], x0, cfg, device="cpu"),
                   ts.register_pair_impl(s1, s2, x0, cfg))
    assert runs
    x0_fn = _x0_fn(poses)
    runs.clear()
    _factors_equal(tp.close_loops(scans, CANDIDATES[:3], cfg, x0_fn, device="cpu"),
                   _pair_by_pair(scans, CANDIDATES[:3], cfg, x0_fn))
    assert runs
