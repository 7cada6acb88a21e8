"""The port's compiled entry points (``prepare_reference_jit``,
``register_jit``, ``odometry_step_jit``, ``odometry_sequence_jit``) on the
CPU, where their capture-safe stages run as plain calls on the static
buffers of ``icet_tpu_torch.graphs``.

1. The device-side branches (the masked 3x3 eigen safeguard, the selected
   warm 6x6 sweep) equal the host-branch versions bit for bit, where the
   extra sweeps fire and where they do not.
2. The compiled functions equal the eager port bit for bit: X, pred_stds,
   Q, every diagnostics column, the static mask, the iterations and the
   prepared model.
3. They stay within tests/test_torch_solver.py's early-exit tolerances of
   the JAX package's jitted functions (X within 1e-4, pred_stds within
   1e-3 relative) on the JAX package's own model carried across by
   ``convert.py``, and the sequence runner within
   tests/test_torch_odometry.py's (X and poses within 1e-4).
4. The scatter and one-hot routes are captured too and equal the eager
   functions bit for bit; a sharded scan (a list of shards) still raises
   NotImplementedError before any launch.

The grid (49 azimuth bins against 512-column sweeps) keeps every point
off the bin edges, as in tests/test_torch_odometry.py.
"""

import dataclasses
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import odometry as jodo
from icet_tpu import solver as js
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.replay import SyntheticTrajectorySource
from icet_tpu_torch import graphs
from icet_tpu_torch import odometry as todo
from icet_tpu_torch import solver as ts
from icet_tpu_torch.config import OdometryConfig
from icet_tpu_torch.convert import config_from_icet, voxel_model_from_numpy
from icet_tpu_torch.ops import linalg as tlin
from icet_tpu_torch.ops import wls_planes as twls
from tests import eager_chains

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = JConfig(n_theta=49, n_phi=16, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=7, min_pts=20, min_range=1.0, convergence_tol=1e-4,
              convergence_stat_scale=1.0)
TCFG = config_from_icet(dataclasses.asdict(CFG))
#: configs whose compiled path takes another branch: no early exit, the
#: moving-object schedule switching on inside the solve (a second warm
#: graph) with the range-sensitivity finish, and fixed radial mode (the
#: plain route)
VARIANTS = {
    "early_exit": TCFG,
    "fixed_runlen": TCFG.replace(convergence_tol=0.0, convergence_stat_scale=0.0),
    "moving_range": TCFG.replace(remove_moving=True, rm_start_iter=2, rm_residual_thresh=0.05,
                                 range_sigma=0.02),
    "fixed_mode": TCFG.replace(radial_mode="fixed", n_shells=26),
}


@pytest.fixture(scope="module")
def scans():
    src = SyntheticTrajectorySource(n_frames=6, speed=0.2, yaw_rate=0.01,
                                    n_beams=48, n_azimuth=512)
    return np.stack([s for s, _ in src])


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


def _results_equal(got, want):
    for name in ("X", "pred_stds", "Q", "static_mask"):
        _assert_equal(getattr(got, name), getattr(want, name), name)
    for name, a, b in zip(want.diagnostics._fields, got.diagnostics, want.diagnostics):
        _assert_equal(a, b, f"diagnostics.{name}")
    assert got.iterations == want.iterations


def _models_equal(got, want):
    for name, a, b in zip(want._fields, got, want):
        _assert_equal(a, b, name)


# ---------------------------------------------------------------------------
# 1. Device-side branches against the host branches
# ---------------------------------------------------------------------------


def _host_extra_sweeps(cov, sweeps, rtol=1e-5, max_extra=2) -> int:
    """Extra 3x3 sweeps the host-read safeguard runs (one flag read each)."""
    A = [list(row) for row in twls._sym_planes(cov)]
    Vm = twls._identity_planes(A[0][0])
    for _ in range(sweeps):
        A, Vm = twls._sweep3(A, Vm)
    extra = 0
    while extra < max_extra and bool(twls._unconverged3(A, rtol)):
        A, Vm = twls._sweep3(A, Vm)
        extra += 1
    return extra


def _spd(rng, n, b, spread):
    q, _ = np.linalg.qr(rng.normal(size=(b, n, n)))
    w = np.exp(rng.uniform(0.0, spread, size=(b, n)))
    return (q * w[:, None, :]) @ np.swapaxes(q, -1, -2)


@pytest.mark.parametrize("sweeps,fires", [(1, True), (4, False)], ids=["fires", "quiet"])
def test_eigh3_safeguard_masked_equals_host_branch(sweeps, fires):
    """After one sweep random covariances keep off-diagonal mass (the
    extra sweeps fire); after four, well-separated ones do not."""
    rng = np.random.default_rng(3)
    cov = _t(_spd(rng, 3, 300, 4.0 if fires else 8.0).astype(np.float32))
    extra = _host_extra_sweeps(cov, sweeps)
    assert (extra > 0) == fires
    got = twls.eigh3_planes(cov, sweeps=sweeps)
    want = twls.eigh3_planes(cov, sweeps=sweeps + extra, safeguard=False)
    for a, b in zip(got, want):
        _assert_equal(a, b, "eigh3_planes")


def _warm_host_branch(A, V0, rtol=1e-5):
    """``eigh_small_warm_safe`` with its branch read on the host."""
    A0 = V0.T @ A @ V0
    w1, V1 = tlin.eigh_small(A0, sweeps=1)
    R = V1.T @ A0 @ V1
    dg = torch.diagonal(R)
    off = torch.linalg.norm(R - dg[:, None] * torch.eye(6))
    if bool(off <= rtol * torch.clamp(torch.linalg.norm(dg), min=1e-30)):
        return (w1, V0 @ V1), True
    w2, V2 = tlin.eigh_small(R, sweeps=1)
    return (w2, V0 @ (V1 @ V2)), False


@pytest.mark.parametrize("converged", [True, False], ids=["first_sweep", "second_sweep"])
def test_warm_sweep_selected_equals_host_branch(converged):
    """From the matrix's own eigenbasis one sweep converges; from the
    identity a second one runs."""
    rng = np.random.default_rng(5)
    A = _t(_spd(rng, 6, 1, 6.0)[0].astype(np.float32))
    V0 = tlin.eigh_small(A)[1] if converged else torch.eye(6)
    want, took_first = _warm_host_branch(A, V0)
    assert took_first == converged
    for a, b in zip(tlin.eigh_small_warm_safe(A, V0), want):
        _assert_equal(a, b, "eigh_small_warm_safe")


def test_round_robin_plan_cached():
    """The 6x6 solver's plan is built once per (n, dtype, device): no
    host-to-device copy inside a captured iteration."""
    a = tlin._round_robin_plan(6, torch.float32, torch.device("cpu"))
    assert tlin._round_robin_plan(6, torch.float32, torch.device("cpu")) is a
    assert len(a) == 5 and all(len(r) == 4 for r in a)


# ---------------------------------------------------------------------------
# 2. Compiled against eager, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_register_jit_equals_eager(scans, name):
    cfg = VARIANTS[name]
    s1, s2 = _t(scans[0]), _t(scans[1])
    model = ts.prepare_reference(s1, cfg)
    _models_equal(ts.prepare_reference_jit(s1, cfg), model)
    x0 = torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 0.005])
    want = ts.register(model, s2, x0, cfg)
    got = ts.register_jit(model, s2, x0, cfg)
    _results_equal(got, want)
    assert got.static_mask.shape == (s2.shape[0],) and got.static_mask.any()
    assert got.diagnostics.n_corr[-1] > 20
    if name == "moving_range":
        assert got.diagnostics.n_rejected_moving.max() > 0


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_odometry_step_jit_equals_eager(scans, name):
    """Three chained steps; the compiled chain carries its own (packed)
    models, the eager one its own."""
    cfg = VARIANTS[name]
    m_e = ts.prepare_reference(_t(scans[0]), cfg)
    m_c = ts.prepare_reference_jit(_t(scans[0]), cfg)
    x = torch.zeros(6)
    for k in range(1, 4):
        r_e, m_e = ts.odometry_step(m_e, _t(scans[k]), x, cfg)
        r_c, m_c = ts.odometry_step_jit(m_c, _t(scans[k]), x, cfg)
        _results_equal(r_c, r_e)
        _models_equal(m_c, m_e)
        assert r_c.static_mask.shape == (0,)
        x = r_e.X


def test_results_are_not_overwritten(scans):
    """Each call returns its own tensors: a later call leaves them alone."""
    s1 = _t(scans[0])
    model = ts.prepare_reference_jit(s1, TCFG)
    first = ts.register_jit(model, _t(scans[1]), torch.zeros(6), TCFG)
    X1, n1 = first.X.clone(), first.diagnostics.n_corr.clone()
    other = ts.prepare_reference_jit(_t(scans[3]), TCFG)
    ts.register_jit(other, _t(scans[4]), torch.full((6,), 0.01), TCFG)
    _assert_equal(first.X, X1, "X")
    _assert_equal(first.diagnostics.n_corr, n1, "n_corr")
    _models_equal(model, ts.prepare_reference(s1, TCFG))


def test_packed_model_loads_with_one_copy(scans):
    """A model the compiled path returned goes back in as one device copy;
    any other model field by field."""
    fg = graphs.frame_graphs("cpu", scans.shape[1], TCFG)
    packed = ts.prepare_reference_jit(_t(scans[0]), TCFG)
    c0 = graphs.host_ops["copies"]
    fg.load(model=packed)
    assert graphs.host_ops["copies"] - c0 == 1
    fg.load(model=ts.prepare_reference(_t(scans[0]), TCFG))
    assert graphs.host_ops["copies"] - c0 == 1 + len(packed)
    fg.load(model=fg.buffers.model)
    assert graphs.host_ops["copies"] - c0 == 1 + len(packed)
    _models_equal(fg.buffers.model, packed)


@pytest.mark.parametrize("warm_start,mode", [(True, "previous"), (True, "extrapolate"),
                                             (False, "previous")])
@pytest.mark.parametrize("clamp", [0.3, 0.1])
def test_run_odometry_device_equals_eager_chain(scans, warm_start, mode, clamp):
    """The runner against the eager steps chained with its semantics on the
    same config, over two blocks (the carry handed from one to the next),
    bit for bit."""
    odo = OdometryConfig(warm_start=warm_start, warm_start_mode=mode, divergence_clamp=clamp)
    got = todo.run_odometry_device(scans, TCFG, odo, block=3, device="cpu")
    want = eager_chains.odometry_device(_t(scans), TCFG, odo, block=3)
    assert [f.iterations for f in got] == [f.iterations for f in want]
    for g, w in zip(got, want):
        for name in ("X", "pred_stds", "T_world", "pose"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        assert g.diverged == w.diverged == (clamp < 0.2)


def test_sequence_jit_bitwise_against_steps(scans):
    """``odometry_sequence_jit`` over a block against the same chain of
    ``odometry_step`` calls with its guard and pose written out."""
    frames = _t(scans[1:])
    model0 = ts.prepare_reference(_t(scans[0]), TCFG)
    x0, T0 = torch.zeros(6), torch.eye(4)
    (model, X_last, T_last), (X, stds, div, Tw), iters = todo.odometry_sequence_jit(
        frames, model0, x0, T0, TCFG, 0.3, True, "previous", return_iterations=True)
    m, x, T = model0, x0, T0
    for k in range(frames.shape[0]):
        res, m = ts.odometry_step(m, frames[k], x, TCFG)
        d = torch.any(torch.abs(res.X) > 0.3)
        Xg = torch.where(d, torch.zeros_like(res.X), res.X)
        T = todo.compose_pose(T, Xg)
        _assert_equal(X[k], Xg, "X")
        _assert_equal(stds[k], res.pred_stds, "pred_stds")
        _assert_equal(Tw[k], T, "T_world")
        assert bool(div[k]) == bool(d) and iters[k] == res.iterations
        x = Xg
    _models_equal(model, m)
    _assert_equal(X_last, x, "X_last")
    _assert_equal(T_last, T, "T_last")


# ---------------------------------------------------------------------------
# 3. Against the JAX package's jitted functions
# ---------------------------------------------------------------------------


def _jax_model(scan):
    jm = js.prepare_reference_jit(jnp.asarray(scan), CFG)
    return jm, voxel_model_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})


def _close(t, j):
    np.testing.assert_allclose(t.X.numpy(), np.asarray(j.X), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.pred_stds.numpy(), np.asarray(j.pred_stds), rtol=1e-3)


def test_register_jit_matches_jax(scans):
    jm, model = _jax_model(scans[0])
    x0 = np.zeros(6, np.float32)
    j = js.register_jit(jm, jnp.asarray(scans[1]), jnp.asarray(x0), CFG)
    t = ts.register_jit(model, _t(scans[1]), _t(x0), TCFG)
    _close(t, j)
    assert 1 <= t.iterations <= CFG.n_iters
    assert (t.diagnostics.windowed_overflow == 0).all()
    agree = (t.static_mask.numpy() == np.asarray(j.static_mask)).mean()
    assert agree > 0.999


def test_odometry_step_jit_matches_jax(scans):
    jm, model = _jax_model(scans[0])
    x0 = np.zeros(6, np.float32)
    j, jnext = js.odometry_step_jit(jm, jnp.asarray(scans[1]), jnp.asarray(x0), CFG)
    t, tnext = ts.odometry_step_jit(model, _t(scans[1]), _t(x0), TCFG)
    _close(t, j)
    for k in ("count", "valid", "lmask"):
        np.testing.assert_array_equal(getattr(tnext, k).numpy(), np.asarray(getattr(jnext, k)))
    np.testing.assert_allclose(tnext.mean.numpy(), np.asarray(jnext.mean), rtol=0, atol=1e-5)


@pytest.mark.parametrize("clamp", [0.3, 0.1])
def test_sequence_jit_matches_jax(scans, clamp):
    """One block from the JAX package's model: at 0.3 no frame diverges
    (0.2 m a frame), at 0.1 every frame does."""
    jm, model = _jax_model(scans[0])
    (jmodel, jx, jT), (jX, jstds, jdiv, jTw) = jodo.odometry_sequence_jit(
        jnp.asarray(scans[1:]), jm, jnp.zeros(6), jnp.eye(4), CFG, clamp, True, "previous")
    (tmodel, tx, tT), (X, stds, div, Tw), iters = todo.odometry_sequence_jit(
        _t(scans[1:]), model, torch.zeros(6), torch.eye(4), TCFG, clamp, True, "previous",
        return_iterations=True)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-4)
    np.testing.assert_allclose(Tw.numpy(), np.asarray(jTw), rtol=0, atol=1e-4)
    np.testing.assert_allclose(stds.numpy(), np.asarray(jstds), rtol=1e-3)
    np.testing.assert_array_equal(div.numpy(), np.asarray(jdiv))
    assert bool(div.all()) == (clamp < 0.2)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tmodel.count.numpy(), np.asarray(jmodel.count))
    assert all(1 <= i <= CFG.n_iters for i in iters)


def test_sequence_jit_unpacks_as_jax(scans):
    """C8: both packages' ``odometry_sequence_jit`` results unpack the same
    way, ``(model, X_last, T_last), (X, pred_stds, diverged, T_world)``."""
    jm, model = _jax_model(scans[0])
    results = (
        jodo.odometry_sequence_jit(jnp.asarray(scans[1:3]), jm, jnp.zeros(6), jnp.eye(4), CFG),
        todo.odometry_sequence_jit(_t(scans[1:3]), model, torch.zeros(6), torch.eye(4), TCFG),
    )
    for result in results:
        assert len(result) == 2
        (m, x_last, T_last), (X, stds, div, Tw) = result
        assert tuple(X.shape) == (2, 6) and tuple(Tw.shape) == (2, 4, 4)
        assert tuple(div.shape) == (2,) and tuple(x_last.shape) == (6,)
    (_, jx, jT), (jX, _, _, _) = results[0]
    (_, tx, tT), (tX, _, _, _) = results[1]
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-4)


@pytest.mark.parametrize("clamp", [0.3, 0.1])
def test_run_odometry_device_compiled_matches_jax(scans, clamp):
    want = jodo.run_odometry_device(scans, CFG, jodo.OdometryConfig(divergence_clamp=clamp),
                                    block=4)
    copies = graphs.host_ops["copies"]
    got = todo.run_odometry_device(scans, TCFG, OdometryConfig(divergence_clamp=clamp),
                                   block=4, device="cpu")
    assert graphs.host_ops["copies"] > copies  # through the compiled runner
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.X, w.X, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.T_world, w.T_world, rtol=0, atol=1e-4)
        np.testing.assert_allclose(g.pred_stds, w.pred_stds, rtol=1e-3)
        assert g.diverged == w.diverged


# ---------------------------------------------------------------------------
# 4. The other moment routes, and what is not captured
# ---------------------------------------------------------------------------


def _eager_sequence(frames, model, x0, T0, cfg, clamp=0.3):
    """``odometry_sequence_jit``'s outputs from the chain of eager steps
    (warm start "previous", the divergence guard, the world pose)."""
    m, x, T = model, x0, T0
    X, stds, div, Tw = [], [], [], []
    for k in range(frames.shape[0]):
        res, m = ts.odometry_step(m, frames[k], x, cfg)
        d = torch.any(torch.abs(res.X) > clamp)
        x = torch.where(d, torch.zeros_like(res.X), res.X)
        T = todo.compose_pose(T, x)
        X.append(x), stds.append(res.pred_stds), div.append(d), Tw.append(T)
    return (m, x, T), tuple(torch.stack(v) for v in (X, stds, div, Tw))


@pytest.mark.parametrize("change", [{"moment_method": "pallas"}, {"moment_method": "onehot"},
                                    {"dnn_filter": True, "moment_method": "pallas"}],
                         ids=["scatter", "onehot", "dnn"])
@pytest.mark.parametrize("entry", ["prepare", "register", "step", "sequence"])
def test_uncaptured_configs_raise(scans, change, entry):
    """Once refused with NotImplementedError, the scatter and one-hot routes
    (and the DNN config on the scatter route, whose plain solve these entry
    points run) are captured now: each compiled entry point equals the
    eager function bit for bit."""
    cfg = TCFG.replace(**change)
    s = _t(scans[1])
    model = ts.prepare_reference(_t(scans[0]), cfg)
    x0 = torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 0.005])
    if entry == "prepare":
        _models_equal(ts.prepare_reference_jit(s, cfg), ts.prepare_reference(s, cfg))
    elif entry == "register":
        _results_equal(ts.register_jit(model, s, x0, cfg), ts.register(model, s, x0, cfg))
    elif entry == "step":
        (r_c, m_c), (r_e, m_e) = (ts.odometry_step_jit(model, s, x0, cfg),
                                  ts.odometry_step(model, s, x0, cfg))
        _results_equal(r_c, r_e)
        _models_equal(m_c, m_e)
    else:
        frames = _t(scans[1:3])
        (m_c, x_c, T_c), outs_c = todo.odometry_sequence_jit(frames, model, x0, torch.eye(4), cfg)
        (m_e, x_e, T_e), outs_e = _eager_sequence(frames, model, x0, torch.eye(4), cfg)
        _models_equal(m_c, m_e)
        for name, a, b in zip(("X", "pred_stds", "diverged", "T_world"), outs_c, outs_e):
            _assert_equal(a, b, name)
        _assert_equal(x_c, x_e, "X_last")
        _assert_equal(T_c, T_e, "T_last")


def test_sharded_scan_raises(scans):
    model = ts.prepare_reference(_t(scans[0]), TCFG)
    halves = list(_t(scans[1]).chunk(2))
    with pytest.raises(NotImplementedError):
        ts.register_jit(model, halves, torch.zeros(6), TCFG)


def test_recovery_captures_anew(scans):
    """Recovery drops the device's graph sets; the refit and the next
    frame run on a new set."""
    pipe = todo.OdometryPipeline(TCFG, device="cpu")
    pipe.step(scans[0])
    pipe.step(scans[1])
    before = graphs.frame_graphs("cpu", scans.shape[1], TCFG)
    pipe._recover()
    assert graphs.frame_graphs("cpu", scans.shape[1], TCFG) is not before
    assert pipe.step(scans[2]) is not None


def test_layout_views_round_trip():
    lay = graphs.result_layout(10, 7, True)
    buf = lay.empty("cpu")
    views = lay.views(buf)
    views["X"].copy_(torch.arange(6.0))
    views["n_corr"].fill_(-3)
    views["static_mask"][::2] = True
    rows = torch.stack([buf, buf.clone()])
    stacked = lay.stacked_views(rows)
    assert torch.equal(stacked["X"][1], torch.arange(6.0))
    assert stacked["n_corr"].dtype == torch.int32 and (stacked["n_corr"] == -3).all()
    assert stacked["static_mask"].shape == (2, 10) and stacked["static_mask"][0, 0]
    assert all(off % graphs.Layout.ALIGN == 0 for *_, off, _ in lay.fields)


def test_graphs_module_leaves_jax_out():
    code = ("import sys, icet_tpu_torch.graphs, icet_tpu_torch.odometry, icet_tpu_torch.solver\n"
            "import icet_tpu_torch.filters, icet_tpu_torch.keyframe, icet_tpu_torch.ops.bias_encoder\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'icet_tpu')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
