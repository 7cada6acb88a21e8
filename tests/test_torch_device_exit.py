"""The compiled solve's early exit and the sharded prepare's clustering
branch as schedules (``icet_tpu_torch.graphs``): a list of stages and
``If`` entries, captured with IF conditional nodes on CUDA and run here, on
the CPU, by the host executor, each guard a read of its CPU flag.

1. The executor: a guard read false is skipped unread until a stage runs
   (the eager loop's reads), an if/else reads its flag once.
2. A registration's schedule (iteration 0, the iterations below
   ``min_it``, each later one guarded by ``go``, the finish) against the
   JAX package's jitted ``register`` at tolerances that stop after 1, 2-6
   and 7 iterations and with moving-object rejection's ``min_it``: the
   iterations, X, pred_stds and Q within tests/test_torch_compiled.py's
   early-exit bounds (X 1e-4, pred_stds 1e-3 relative, Q 1e-3 of its
   largest entry), every diagnostics row (n_corr, n_dropped_axes and
   n_rejected_moving equal, dx_norm and condition 1e-2 relative); and
   against the eager port bit for bit, with the eager loop's flag reads.
3. The DNN-filtered solve as one schedule: every phase carries its global
   iteration index (the moving-object schedule switches on inside a
   phase), equal to the eager ``register_with_dnn`` bit for bit.
4. The sharded pair's if/else on the summed overflow, forced both ways:
   the branch taken (its collectives), one overflow read, the eager
   step's result bit for bit.

49 azimuth bins against 512-column sweeps keep every point off the bin
edges (ROADMAP C1).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import solver as js
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.replay import SyntheticTrajectorySource
from icet_tpu_torch import filters as tf
from icet_tpu_torch import graphs
from icet_tpu_torch import solver as ts
from icet_tpu_torch.convert import config_from_icet, voxel_model_from_numpy
from icet_tpu_torch.models.bias_net import load_pretrained
from icet_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(2)

CFG = JConfig(n_theta=49, n_phi=16, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=7, min_pts=20, min_range=1.0, convergence_tol=1e-4,
              convergence_stat_scale=1.0)
#: exit tolerances by the iterations they stop after on the drive's pair
STOPS = {
    "stop_1": dict(convergence_tol=10.0, convergence_stat_scale=0.0),
    "stop_mid": {},
    "stop_7": dict(convergence_tol=1e-12, convergence_stat_scale=0.0),
    "rm_min_it": dict(convergence_tol=10.0, convergence_stat_scale=0.0, remove_moving=True,
                      rm_start_iter=3, rm_residual_thresh=0.05),
}


@pytest.fixture(scope="module")
def scans():
    src = SyntheticTrajectorySource(n_frames=3, speed=0.2, yaw_rate=0.01,
                                    n_beams=48, n_azimuth=512)
    return np.stack([s for s, _ in src])


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


def _rows(diag) -> np.ndarray:
    return np.stack([np.asarray(c, np.float64) for c in diag[:5]], 1)


def _jax_iterations(diag) -> int:
    """The iterations the JAX package's solve executed: its diagnostics
    repeat the last executed row after the exit."""
    rows = _rows(diag)
    k = len(rows)
    while k > 1 and (rows[k - 1] == rows[k - 2]).all():
        k -= 1
    return k


# ---------------------------------------------------------------------------
# 1. The host executor
# ---------------------------------------------------------------------------


def test_host_executor_reads_like_the_eager_loop():
    """Guarded entries after a false flag are skipped unread; a stage that
    runs makes the next guard read again; an if/else reads once."""
    b = type("B", (), {})()
    b.go = torch.tensor(True)
    b.flag = torch.tensor(False)
    ran = []

    def stage(name, go=None):
        def fn(bb):
            ran.append(name)
            if go is not None:
                bb.go.fill_(go)
        return fn

    def go(bb):
        return bb.go

    schedule = [stage("first"), graphs.If(go, stage("w1", go=False)), graphs.If(go, stage("w2")),
                graphs.If(go, stage("w3")), stage("mid", go=True), graphs.If(go, stage("w4")),
                graphs.If(lambda bb: bb.flag, stage("then"), stage("else"), "overflow_reads")]
    ops = dict(graphs.host_ops)
    graphs.run_on_host(b, schedule, lambda key, fn: fn(b))
    assert ran == ["first", "w1", "mid", "w4", "else"]
    assert graphs.host_ops["flag_reads"] - ops["flag_reads"] == 3
    assert graphs.host_ops["overflow_reads"] - ops["overflow_reads"] == 1


def test_solve_schedule_layout(scans):
    """Iteration 0 and those below ``min_it`` unguarded, the rest guarded by
    ``go``, the finish last; no guard without an early exit."""
    fg = graphs.frame_graphs("cpu", scans.shape[1], config_from_icet(dataclasses.asdict(CFG)))
    cfg = fg.cfg.replace(remove_moving=True, rm_start_iter=3)
    kinds = [isinstance(e, graphs.If) for e in fg.solve_schedule(True, cfg)]
    assert kinds == [False] * 4 + [True] * 3 + [False]
    fixed = fg.cfg.replace(convergence_tol=0.0, convergence_stat_scale=0.0)
    assert not any(isinstance(e, graphs.If) for e in fg.solve_schedule(True, fixed))
    assert len(fg.solve_schedule(False, fixed, finish=False)) == fixed.n_iters


# ---------------------------------------------------------------------------
# 2. A registration against the JAX package and the eager port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stop", sorted(STOPS))
def test_schedule_matches_jax_register(scans, stop):
    cfg = CFG.replace(**STOPS[stop])
    tcfg = config_from_icet(dataclasses.asdict(cfg))
    jm = js.prepare_reference_jit(jnp.asarray(scans[0]), cfg)
    model = voxel_model_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    x0 = np.array([0.1, 0.0, 0.0, 0.0, 0.0, 0.005], np.float32)
    j = js.register_jit(jm, jnp.asarray(scans[1]), jnp.asarray(x0), cfg)
    reads = graphs.host_ops["flag_reads"]
    t = ts.register_jit(model, _t(scans[1]), _t(x0), tcfg)
    compiled_reads = graphs.host_ops["flag_reads"] - reads
    want = {"stop_1": 1, "stop_7": 7, "rm_min_it": 4}.get(stop)
    n = int(t.iterations)
    assert n == _jax_iterations(j.diagnostics)
    assert n == want if want else 1 < n < 7
    np.testing.assert_allclose(t.X.numpy(), np.asarray(j.X), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.pred_stds.numpy(), np.asarray(j.pred_stds), rtol=1e-3)
    Q = np.asarray(j.Q)
    np.testing.assert_allclose(t.Q.numpy(), Q, rtol=0, atol=1e-3 * np.abs(Q).max())
    got, jrows = _rows(t.diagnostics), _rows(j.diagnostics)
    np.testing.assert_array_equal(got[:, [0, 3, 4]], jrows[:, [0, 3, 4]])
    np.testing.assert_allclose(got[:, 1:3], jrows[:, 1:3], rtol=1e-2, atol=1e-5)
    # Against the eager port: the same solve bit for bit, the same reads.
    reads = graphs.host_ops["flag_reads"]
    e = ts.register(model, _t(scans[1]), _t(x0), tcfg)
    eager_reads = n - 1 + (n < 7) - (stop == "rm_min_it") * 3
    for name in ("X", "pred_stds", "Q", "static_mask"):
        _assert_equal(getattr(t, name), getattr(e, name), name)
    for name, a, b in zip(e.diagnostics._fields, t.diagnostics, e.diagnostics):
        _assert_equal(a, b, name)
    assert n == e.iterations and graphs.host_ops["flag_reads"] == reads
    assert compiled_reads == eager_reads


# ---------------------------------------------------------------------------
# 3. The DNN-filtered solve's phases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_loop", [True, False], ids=["in_loop", "one_shot"])
def test_dnn_phases_carry_global_indices(scans, in_loop):
    """The filtered solve's plain phase (3 iterations), then its filtered
    ones, with moving-object rejection from global iteration 4: its
    diagnostics switch on there, and the schedule equals the eager
    ``register_with_dnn`` (each phase given its ``it_offset``) bit for bit."""
    cfg = config_from_icet(dataclasses.asdict(CFG)).replace(
        dnn_filter=True, dnn_start_iter=3, dnn_sample_pts=100, dnn_in_loop=in_loop,
        remove_moving=True, rm_start_iter=4, rm_residual_thresh=0.05, convergence_tol=1e-12,
        convergence_stat_scale=0.0)
    net = load_pretrained(100)
    s1, s2 = _t(scans[0]), _t(scans[1])
    model = ts.prepare_reference(s1, cfg)
    samples = tf.model_voxel_samples(model, s1, cfg)
    x0 = torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 0.005])
    want, wfilt = tf.register_with_dnn(model, s1, s2, x0, cfg, net, samples1=samples)
    fg = graphs.frame_graphs("cpu", s2.shape[0], cfg)
    fg.load(scan=s2, x0=x0, model=model, samples=samples)
    n_final = tf.solve_dnn(fg, net, True)
    got = fg.result(True, n_final)
    for name in ("X", "pred_stds", "Q", "static_mask"):
        _assert_equal(getattr(got, name), getattr(want, name), name)
    for name, a, b in zip(want.diagnostics._fields, got.diagnostics, want.diagnostics):
        _assert_equal(a, b, name)
    assert int(got.iterations) == want.iterations == 7
    _assert_equal(fg.buffers.filt["keep"], wfilt.keep, "keep")
    rejected = got.diagnostics.n_rejected_moving.numpy()
    if not in_loop:
        # One phase of 4 filtered iterations from global index 3.
        assert rejected[0] == 0 and rejected[1:].max() > 0
    else:
        # The last filtered iteration, global 6, is the only row kept.
        assert n_final == 1 and rejected.shape == (1,)


# ---------------------------------------------------------------------------
# 4. The sharded pair's clustering branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overflow", [True, False], ids=["gather", "sharded"])
def test_sharded_branch_forced(scans, monkeypatch, overflow):
    """The prepare's if/else with the summed overflow forced: the gather
    (one all_gather) or the bucket exchange (an all_to_all and an
    all_gather) runs, the other not, and both give the eager step's result,
    whose clustering is bit-identical either way."""
    tcfg = config_from_icet(dataclasses.asdict(CFG))
    forced = torch.tensor(overflow)
    monkeypatch.setattr(tsh, "_rep_overflow", lambda b: forced)
    mesh = tsh.registration_mesh(1, 2, ["cpu"] * 2)
    step = tsh.make_sharded_register(tcfg, mesh)
    (axis,) = step.axes
    calls = []
    for name in ("all_gather", "all_to_all"):
        real = getattr(axis, name)
        monkeypatch.setattr(axis, name, lambda xs, _r=real, _n=name: calls.append(_n) or _r(xs))
    reads = graphs.host_ops["overflow_reads"]
    x0 = np.zeros((1, 6), np.float32)
    got = step(scans[:1], scans[1:2], x0)
    assert graphs.host_ops["overflow_reads"] - reads == 1
    prepare = calls[:calls.index("all_gather") + 1]
    assert prepare == (["all_gather"] if overflow else ["all_to_all", "all_gather"])
    want = tsh.make_sharded_register_eager(tcfg, mesh)(scans[:1], scans[1:2], x0)
    for name in ("X", "pred_stds", "Q", "static_mask"):
        _assert_equal(getattr(got, name), getattr(want, name), name)
    assert torch.equal(got.iterations.to(torch.int64), want.iterations)
