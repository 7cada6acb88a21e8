"""The compiled entry points on the scatter (``moment_method="pallas"``,
kernel #3 on the card) and one-hot moment routes, on the CPU, where their
capture-safe stages run as plain calls on the static buffers of
``icet_tpu_torch.graphs``.

1. Every compiled entry point equals its eager function bit for bit on
   both routes: ``prepare_reference_jit``, ``register_jit``,
   ``odometry_step_jit``, ``odometry_sequence_jit`` (through
   ``run_odometry_device``), ``register_pair_jit``,
   ``model_voxel_samples_jit``, ``odometry_step_dnn_jit``,
   ``keyframe_step_jit``, ``keyframe_step_dnn_jit``, ``keyframe_spawn_jit``,
   ``keyframe_sequence_jit``, ``map_update_jit``, ``map_step_jit`` and
   ``close_loops``; the scatter route also in fixed radial mode, whose
   table is larger than the kernel's shared-memory one.
2. They stay within tests/test_torch_compiled.py's tolerances of the JAX
   package's jitted functions on the same route (X within 1e-4, pred_stds
   within 1e-3 relative; the JAX scatter is its Pallas kernel in interpret
   mode on the CPU).
3. The runners (``OdometryPipeline`` plain and DNN, ``KeyframeOdometry``
   plain and DNN, ``run_keyframe_device``, ``MapMaker``) take the compiled
   steps on both routes (the pipeline on the default route too) and equal
   the eager functions chained with their semantics (``tests/
   eager_chains.py``) bit for bit.

Drive A is tests/test_torch_compiled.py's (48x512 sweeps, 49 azimuth
bins); drive B tests/test_torch_compiled_keyframe.py's (32x256 sweeps, 25
bins): coprime, so no column sits on a bin edge (ROADMAP C1), and away
from the ill-posed pair of ROADMAP C4.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import odometry as jodo
from icet_tpu import solver as js
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.datasets.replay import SyntheticTrajectorySource
from icet_tpu_torch import filters as tf
from icet_tpu_torch import graphs
from icet_tpu_torch import keyframe as tkf
from icet_tpu_torch import mapping as tmap
from icet_tpu_torch import odometry as todo
from icet_tpu_torch import pose_graph as tp
from icet_tpu_torch import solver as ts
from icet_tpu_torch.config import BlockMapConfig, KeyframeConfig, MapConfig, OdometryConfig
from icet_tpu_torch.convert import config_from_icet, voxel_model_from_numpy
from icet_tpu_torch.keyframe import np_pose_to_state
from icet_tpu_torch.models.bias_net import load_pretrained
from icet_tpu_torch.ops.moment_scatter import SHARED_ROWS
from tests import eager_chains

torch.set_num_threads(2)

METHODS = pytest.mark.parametrize("method", ["pallas", "onehot"], ids=["scatter", "onehot"])

CFG_A = JConfig(n_theta=49, n_phi=16, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
                n_iters=7, min_pts=20, min_range=1.0, convergence_tol=1e-4,
                convergence_stat_scale=1.0)
CFG_B = JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
                n_iters=4, min_pts=15, min_range=1.0)
TCFG_A = config_from_icet(dataclasses.asdict(CFG_A))
TCFG_B = config_from_icet(dataclasses.asdict(CFG_B))
#: the filtered solve of tests/test_torch_compiled_dnn.py (drive A) and of
#: tests/test_torch_compiled_keyframe.py (drive B)
DNN = dict(dnn_filter=True, dnn_start_iter=3, dnn_sample_pts=32)
KCFG = KeyframeConfig(spawn_distance=0.5, spawn_angle=0.15, delta_clamp=2.0)
BCFG = BlockMapConfig(n_blocks=3, block_capacity=1024, points_per_scan=400)
MCFG = MapConfig(capacity=2_500, points_per_scan=1_000)


def _a(method, **kw):
    return TCFG_A.replace(moment_method=method, **kw)


def _b(method, **kw):
    return TCFG_B.replace(moment_method=method, **kw)


@pytest.fixture(scope="module")
def scans():
    src = SyntheticTrajectorySource(n_frames=6, speed=0.2, yaw_rate=0.01,
                                    n_beams=48, n_azimuth=512)
    return np.stack([s for s, _ in src]).astype(np.float32)


@pytest.fixture(scope="module")
def drive():
    src = SyntheticTrajectorySource(n_frames=7, speed=0.3, yaw_rate=0.02,
                                    n_beams=32, n_azimuth=256)
    scans, poses = zip(*[(s.astype(np.float32), T) for s, T in src])
    return np.stack(scans), list(poses)


@pytest.fixture(scope="module")
def net():
    return load_pretrained(100)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_equal(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


def _tuples_equal(got, want, what):
    for name, a, b in zip(getattr(want, "_fields", range(len(want))), got, want):
        _assert_equal(a, b, f"{what}.{name}")


def _results_equal(got, want):
    for name in ("X", "pred_stds", "Q", "static_mask"):
        _assert_equal(getattr(got, name), getattr(want, name), name)
    _tuples_equal(got.diagnostics, want.diagnostics, "diagnostics")
    assert got.iterations == want.iterations


def _frames_equal(got, want, names=("X", "pred_stds", "T_world")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for name in names:
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
        assert (g.diverged, g.iterations) == (w.diverged, w.iterations)


def _spy(monkeypatch, module, names):
    calls = []
    for name in names:
        real = getattr(module, name)

        def wrapped(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(module, name, wrapped)
    return calls


# ---------------------------------------------------------------------------
# 1. Compiled against eager, bit for bit
# ---------------------------------------------------------------------------


@METHODS
@pytest.mark.parametrize("variant", ["early_exit", "moving_range"])
def test_prepare_and_register_jit_equal_eager(scans, method, variant):
    extra = ({} if variant == "early_exit" else
             dict(remove_moving=True, rm_start_iter=2, rm_residual_thresh=0.05,
                  range_sigma=0.02))
    cfg = _a(method, **extra)
    s1, s2 = _t(scans[0]), _t(scans[1])
    model = ts.prepare_reference(s1, cfg)
    _tuples_equal(ts.prepare_reference_jit(s1, cfg), model, "model")
    x0 = torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 0.005])
    got = ts.register_jit(model, s2, x0, cfg)
    _results_equal(got, ts.register(model, s2, x0, cfg))
    assert bool(got.static_mask.any()) and int(got.diagnostics.n_corr[-1]) > 20


@METHODS
def test_odometry_step_jit_equals_eager(scans, method):
    cfg = _a(method)
    m_e = ts.prepare_reference(_t(scans[0]), cfg)
    m_c = ts.prepare_reference_jit(_t(scans[0]), cfg)
    x = torch.zeros(6)
    for k in range(1, 4):
        r_e, m_e = ts.odometry_step(m_e, _t(scans[k]), x, cfg)
        r_c, m_c = ts.odometry_step_jit(m_c, _t(scans[k]), x, cfg)
        _results_equal(r_c, r_e)
        _tuples_equal(m_c, m_e, "model")
        x = r_e.X


@METHODS
def test_sequence_runner_equals_eager_chain(scans, monkeypatch, method):
    """``run_odometry_device`` takes ``odometry_sequence_jit`` (two blocks,
    the carry handed over) and equals its eager chain."""
    cfg = _a(method)
    odo = OdometryConfig(divergence_clamp=0.3)
    calls = _spy(monkeypatch, todo, ["odometry_sequence_jit"])
    got = todo.run_odometry_device(scans, cfg, odo, block=3, device="cpu")
    assert calls == ["odometry_sequence_jit"] * 2
    want = eager_chains.odometry_device(_t(scans), cfg, odo, block=3)
    _frames_equal(got, want, ("X", "pred_stds", "T_world", "pose"))


def test_fixed_mode_scatter_equals_eager(scans):
    """Fixed radial mode on the scatter route: a table of V + 1 = 20,385
    rows, past the kernel's shared-memory table (its global-atomics branch
    on the card)."""
    cfg = _a("pallas", radial_mode="fixed", n_shells=26)
    assert cfg.n_voxels + 1 > SHARED_ROWS and ts.moment_route(cfg) == "scatter"
    s1, s2 = _t(scans[0]), _t(scans[1])
    model = ts.prepare_reference(s1, cfg)
    _tuples_equal(ts.prepare_reference_jit(s1, cfg), model, "model")
    x0 = torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 0.005])
    _results_equal(ts.register_jit(model, s2, x0, cfg), ts.register(model, s2, x0, cfg))
    _results_equal(ts.register_pair_jit(s1, s2, x0, cfg), ts.register_pair_impl(s1, s2, x0, cfg))


@METHODS
def test_register_pair_jit_equals_impl(drive, method):
    scans, _ = drive
    cfg = _b(method)
    s1, s2 = _t(scans[0]), _t(scans[2])
    x0 = torch.tensor([0.5, 0, 0, 0, 0, 0.03])
    _results_equal(ts.register_pair_jit(s1, s2, x0, cfg), ts.register_pair_impl(s1, s2, x0, cfg))


@METHODS
def test_dnn_step_jit_equals_eager(scans, net, method):
    """``model_voxel_samples_jit`` and three chained ``odometry_step_dnn_jit``
    steps (kernels #4 and, on the scatter route, #3 in one set of graphs on
    the card)."""
    cfg = _a(method, **DNN)
    m_e = ts.prepare_reference(_t(scans[0]), cfg)
    s_e = tf.model_voxel_samples(m_e, _t(scans[0]), cfg)
    m_c = ts.prepare_reference_jit(_t(scans[0]), cfg)
    s_c = tf.model_voxel_samples_jit(m_c, _t(scans[0]), cfg)
    _tuples_equal(s_c, s_e, "samples")
    x = torch.zeros(6)
    for k in range(1, 4):
        prev, scan = _t(scans[k - 1]), _t(scans[k])
        r_e, m_e, s_e, f_e = tf.odometry_step_dnn(m_e, prev, s_e, scan, x, cfg, net)
        r_c, m_c, s_c, f_c = tf.odometry_step_dnn_jit(m_c, prev, s_c, scan, x, cfg, net,
                                                      return_filter=True)
        _results_equal(r_c, r_e)
        _tuples_equal(m_c, m_e, "model")
        _tuples_equal(s_c, s_e, "samples")
        _tuples_equal(f_c, f_e, "filter")
        x = r_e.X
    assert int(f_e.n_rejected) > 0


def _spawned(scan, cfg, seed=3):
    bm = tkf.blockmap_init(BCFG)
    u = torch.rand(BCFG.points_per_scan, generator=torch.Generator().manual_seed(seed))
    return tkf.keyframe_spawn(bm, _t(scan), torch.zeros(6), u, True, cfg, BCFG)


def _clone_bm(bm):
    return bm._replace(points=bm.points.clone(), valid=bm.valid.clone(), poses=bm.poses.clone())


def _bm_equal(got, want):
    for name in ("points", "valid", "poses"):
        _assert_equal(getattr(got, name), getattr(want, name), f"bm.{name}")
    assert (got.n_blocks, got.cursor) == (want.n_blocks, want.cursor)


def _kf_chain(step, scans, model, bm, cfg, dnn_args=(), net=None):
    gen = torch.Generator().manual_seed(2)
    x_rel, delta, h0 = torch.zeros(6), torch.zeros(6), torch.zeros(2)
    outs = []
    for k in range(1, 5):
        u = torch.rand(BCFG.points_per_scan, generator=gen)
        out = step(model, bm, _t(scans[k]), *dnn_args, x_rel, delta, u, h0, cfg, KCFG, BCFG,
                   *((net,) if net is not None else ()))
        res, x_rel, delta, _, _, health, bm = out
        h0 = tkf.update_health0(h0, health)
        outs.append(out)
    return outs


def _kf_steps_equal(got, want):
    for g, w in zip(got, want):
        _results_equal(g[0], w[0])
        for name, a, b in zip(("X_rel", "delta", "diverged", "spawn", "health"), g[1:6], w[1:6]):
            if isinstance(b, bool):
                assert a is b, name
            else:
                _assert_equal(a, b, name)
        _bm_equal(g[6], w[6])


@METHODS
@pytest.mark.parametrize("dnn", [False, True], ids=["plain", "dnn"])
def test_keyframe_step_jit_equals_eager(drive, net, method, dnn):
    scans, _ = drive
    cfg = _b(method, **DNN) if dnn else _b(method)
    model, bm = _spawned(scans[0], cfg)
    args = (cfg,)
    if dnn:
        step_e, step_c = tkf.keyframe_step_dnn, tkf.keyframe_step_dnn_jit
        extra = ((_t(scans[0]), tf.model_voxel_samples(model, _t(scans[0]), cfg)), net)
    else:
        step_e, step_c = tkf.keyframe_step, tkf.keyframe_step_jit
        extra = ((), None)
    want = _kf_chain(step_e, scans, model, _clone_bm(bm), *args, *extra)
    got = _kf_chain(step_c, scans, model, _clone_bm(bm), *args, *extra)
    _kf_steps_equal(got, want)


@METHODS
def test_keyframe_spawn_and_sequence_jit_equal_eager(drive, method):
    scans, _ = drive
    cfg = _b(method)
    model0, bm0 = _spawned(scans[0], cfg)
    world = torch.tensor([1.0, 0.5, 0.0, 0.0, 0.0, 0.3])
    u = torch.rand(BCFG.points_per_scan, generator=torch.Generator().manual_seed(5))
    m_w, bm_w = tkf.keyframe_spawn(_clone_bm(bm0), _t(scans[2]), world, u, False, cfg, BCFG)
    m_g, bm_g = tkf.keyframe_spawn_jit(_clone_bm(bm0), _t(scans[2]), world, u, False, cfg, BCFG)
    _tuples_equal(m_g, m_w, "model")
    _bm_equal(bm_g, bm_w)
    z6 = torch.zeros(6)
    gen_w, gen_g = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    (mw, bw, cw), ow = tkf.keyframe_sequence(_t(scans[1:5]), model0, _clone_bm(bm0),
                                             (z6, z6, z6, torch.zeros(2), z6), gen_w, cfg, KCFG,
                                             BCFG)
    (mg, bg, cg), og, iters = tkf.keyframe_sequence_jit(
        _t(scans[1:5]), model0, _clone_bm(bm0), (z6, z6, z6, gen_g, torch.zeros(2), z6), cfg,
        KCFG, BCFG, return_iterations=True)
    d2, stds, world6, div, x2, n_corr, is_kf, iters_w = ow
    names = ("delta", "delta_stds", "world6", "diverged", "x_rel", "is_keyframe", "n_corr")
    for name, a, b in zip(names, og, (d2, stds, world6, div, x2, is_kf, n_corr)):
        _assert_equal(a, b.to(a.dtype) if name == "is_keyframe" else b, name)
    assert [int(i) for i in iters] == [int(i) for i in iters_w]
    _tuples_equal(mg, mw, "model")
    _bm_equal(bg, bw)


def _ring_clone(state):
    return state._replace(points=state.points.clone(), valid=state.valid.clone(),
                          trail=state.trail.clone())


def _rings_equal(a, b):
    assert (a.write_ptr, a.trail_len) == (b.write_ptr, b.trail_len)
    for name in ("points", "valid", "trail"):
        _assert_equal(getattr(a, name), getattr(b, name), name)


@METHODS
def test_map_update_and_step_jit_equal_eager(drive, method):
    scans, _ = drive
    cfg = _b(method)
    model = ts.prepare_reference(_t(scans[0]), cfg)
    gen = torch.Generator().manual_seed(5)
    u = torch.rand(scans.shape[1], generator=gen)
    e = tmap.map_update(tmap.init_map(MCFG, trail_capacity=4, device="cpu"), _t(scans[0]),
                        torch.zeros(6), u, MCFG, cfg.min_range)
    c = tmap.map_update_jit(tmap.init_map(MCFG, trail_capacity=4, device="cpu"), _t(scans[0]),
                            torch.zeros(6), u, MCFG, cfg.min_range)
    _rings_equal(c, e)
    u = torch.rand(scans.shape[1], generator=gen)
    se = tmap.map_step(model, _ring_clone(e), _t(scans[1]), u, 0.9, cfg, MCFG)
    sc = tmap.map_step_jit(model, _ring_clone(c), _t(scans[1]), u, 0.9, cfg, MCFG)
    _results_equal(sc[0], se[0])
    _assert_equal(sc[1], se[1], "X")
    assert bool(sc[2]) == bool(se[2]) is False
    _rings_equal(sc[3], se[3])


def _x0_fn(poses):
    def x0(i, j):
        return np_pose_to_state(np.linalg.inv(poses[i]) @ poses[j]).astype(np.float32)
    return x0


@METHODS
def test_close_loops_equals_pair_by_pair(drive, monkeypatch, method):
    scans, poses = drive
    cfg = _b(method)
    cands = [(0, 2), (1, 3), (2, 4), (3, 5)]
    x0_fn = _x0_fn(poses)
    calls = _spy(monkeypatch, tp, ["register_pair_jit"])
    got = tp.close_loops(list(scans), cands, cfg, x0_fn, batch=3, device="cpu")
    assert calls == ["register_pair_jit"] * len(cands)
    want = eager_chains.close_loops(list(scans), cands, cfg, x0_fn, batch=3)
    assert len(got) == len(want) == len(cands)
    for (i, j, gx, gi), (k, m, wx, wi) in zip(got, want):
        assert (i, j) == (k, m) and np.array_equal(gx, wx) and np.array_equal(gi, wi)


# ---------------------------------------------------------------------------
# 2. Against the JAX package's jitted functions on the same route
# ---------------------------------------------------------------------------


def _close(t, j):
    np.testing.assert_allclose(t.X.numpy(), np.asarray(j.X), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.pred_stds.numpy(), np.asarray(j.pred_stds), rtol=1e-3)


@METHODS
def test_compiled_matches_jax(scans, method):
    jcfg = CFG_A.replace(moment_method=method)
    cfg = _a(method)
    jm = js.prepare_reference_jit(jnp.asarray(scans[0]), jcfg)
    model = voxel_model_from_numpy({k: np.asarray(v) for k, v in jm._asdict().items()})
    x0 = np.zeros(6, np.float32)
    _close(ts.register_jit(model, _t(scans[1]), _t(x0), cfg),
           js.register_jit(jm, jnp.asarray(scans[1]), jnp.asarray(x0), jcfg))
    j, jnext = js.odometry_step_jit(jm, jnp.asarray(scans[1]), jnp.asarray(x0), jcfg)
    t, tnext = ts.odometry_step_jit(model, _t(scans[1]), _t(x0), cfg)
    _close(t, j)
    for k in ("count", "valid"):
        np.testing.assert_array_equal(getattr(tnext, k).numpy(), np.asarray(getattr(jnext, k)))
    np.testing.assert_allclose(tnext.mean.numpy(), np.asarray(jnext.mean), rtol=0, atol=1e-5)
    (_, _, jT), (jX, jstds, jdiv, _) = jodo.odometry_sequence_jit(
        jnp.asarray(scans[1:4]), jm, jnp.zeros(6), jnp.eye(4), jcfg, 0.3, True, "previous")
    (_, _, tT), (X, stds, div, _) = todo.odometry_sequence_jit(
        _t(scans[1:4]), model, torch.zeros(6), torch.eye(4), cfg, 0.3, True, "previous")
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-4)
    np.testing.assert_allclose(stds.numpy(), np.asarray(jstds), rtol=1e-3)
    np.testing.assert_array_equal(div.numpy(), np.asarray(jdiv))
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# 3. The runners take the compiled steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", [None, "pallas", "onehot"],
                         ids=["default", "scatter", "onehot"])
@pytest.mark.parametrize("dnn", [False, True], ids=["plain", "dnn"])
def test_pipeline_takes_the_compiled_step(scans, net, monkeypatch, method, dnn):
    """The pipeline takes the compiled step on every route (``None``: the
    config's default ``moment_method``) and equals the eager chain."""
    cfg = TCFG_A if method is None else _a(method)
    cfg = cfg.replace(**DNN) if dnn else cfg
    monkeypatch.setitem(tf._PRETRAINED_CACHE, (32, "cpu"), net)
    step = "odometry_step_dnn_jit" if dnn else "odometry_step_jit"
    calls = _spy(monkeypatch, todo, [step])
    got = list(todo.OdometryPipeline(cfg, device="cpu").run(scans[:4]))
    assert calls == [step] * 3
    want = eager_chains.odometry(_t(scans[:4]), cfg, OdometryConfig(), net if dnn else None)
    _frames_equal(got, want)


@METHODS
@pytest.mark.parametrize("runner", ["keyframe", "keyframe_dnn", "device", "mapmaker"])
def test_mapping_runners_take_the_compiled_steps(drive, net, monkeypatch, method, runner):
    scans, _ = drive
    monkeypatch.setitem(tf._PRETRAINED_CACHE, (32, "cpu"), net)
    cfg = _b(method, **DNN) if runner == "keyframe_dnn" else _b(method)
    odo = OdometryConfig(divergence_clamp=0.9)
    if runner == "mapmaker":
        module, jit = tmap, ["map_step_jit"]

        def run():
            maker = tmap.MapMaker(cfg, MCFG, odo, device="cpu")
            return [f for f in (maker.step(s) for s in scans[:4]) if f is not None]

        def chain():
            return eager_chains.map_maker(_t(scans[:4]), cfg, MCFG, odo)[0]
    elif runner == "device":
        module, jit = tkf, ["keyframe_sequence_jit"]

        def run():
            return tkf.run_keyframe_device(scans[:5], cfg, KCFG, BCFG, block=2,
                                           device="cpu")[0]

        def chain():
            return eager_chains.keyframe_device(_t(scans[:5]), cfg, KCFG, BCFG, block=2)[0]
    else:
        module = tkf
        jit = ["keyframe_step_dnn_jit" if runner == "keyframe_dnn" else "keyframe_step_jit"]

        def run():
            return tkf.KeyframeOdometry(cfg, KCFG, BCFG, device="cpu").run(scans[:5])

        def chain():
            return eager_chains.keyframe_odometry(_t(scans[:5]), cfg, KCFG, BCFG,
                                                  net if runner == "keyframe_dnn" else None)[0]
    calls = _spy(monkeypatch, module, jit)
    got = run()
    assert calls and set(calls) == set(jit)
    want = chain()
    names = ("X", "pred_stds") if runner == "mapmaker" else ("X", "pred_stds", "T_world")
    for g, w in zip(got, want):
        for name in names:
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)
    assert len(got) == len(want)


def test_scatter_is_counted_in_graphs():
    from icet_tpu_torch.ops.moment_scatter import moment_scatter_sums

    assert moment_scatter_sums in graphs.COUNTED
    assert "moment_scatter_sums" in graphs.warmup_launches
