"""The port's compiled ring map (``mapping.map_update_jit``, ``map_step_jit``
and ``MapMaker`` on them) on the CPU, where its capture-safe stages run as
plain calls on the static buffers of ``icet_tpu_torch.graphs``.

1. The staged ring stage (the insert's rows from the device mirror of the
   ring cursor, the trail's row from the mirror of its length, the roll
   when full known on the host) equals the eager ``map_update`` and
   ``map_step`` bit for bit, through the ring's wrap (capacity 2,500, not a
   multiple of the 1,000 points a scan) and the trail's roll (capacity 4),
   and with the divergence guard tripped.
2. Against the JAX package's ``map_update`` and ``map_step_jit``, fed the
   JAX package's own uniforms, within tests/test_torch_mapping.py's
   tolerances: indices and flags exact, coordinates 1e-5 m (1e-4 m after a
   solve), X 1e-4, pred_stds 1e-3 relative.
3. ``MapMaker`` equals the eager functions chained with its semantics
   (``tests/eager_chains.py``) frame by frame (X, pred_stds, flags, the
   fill, the ring, the trail), and so does one that fails once and
   recovers; recovery keeps the ring's tensors.
4. The scatter and one-hot routes take the compiled step too, equal to
   the eager one bit for bit.

The solving cases use a 25x8 grid against 256-column sweeps (coprime: no
column on a bin edge, ROADMAP C1).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import mapping as jmap
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.config import MapConfig as JMapConfig
from icet_tpu.datasets.replay import SyntheticTrajectorySource
from icet_tpu.solver import prepare_reference_jit
from icet_tpu_torch import graphs
from icet_tpu_torch import mapping as tmap
from icet_tpu_torch.config import PROFILES, MapConfig, OdometryConfig
from icet_tpu_torch.convert import (
    config_from_icet,
    map_state_from_numpy,
    map_state_to_numpy,
    voxel_model_from_numpy,
)
from icet_tpu_torch.solver import prepare_reference
from tests import eager_chains

torch.set_num_threads(2)

CFG = JConfig(n_theta=25, n_phi=8, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=4, min_pts=15, min_range=1.0)
TCFG = config_from_icet(dataclasses.asdict(CFG))
MCFG = dict(capacity=2_500, points_per_scan=1_000)
TRAIL = 4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _clone(state):
    return state._replace(points=state.points.clone(), valid=state.valid.clone(),
                          trail=state.trail.clone())


def _assert_states_identical(a, b):
    assert (a.write_ptr, a.trail_len) == (b.write_ptr, b.trail_len)
    for name in ("points", "valid", "trail"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def _assert_matches_jax(tstate, jstate, atol=1e-5):
    got, want = map_state_to_numpy(tstate), _np(jstate)
    for name in ("write_ptr", "trail_len"):
        assert int(got[name]) == int(want[name]), name
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["points"], want["points"], rtol=0, atol=atol)
    np.testing.assert_allclose(got["trail"], want["trail"], rtol=0, atol=atol)


@pytest.fixture(scope="module")
def drive():
    src = SyntheticTrajectorySource(n_frames=7, speed=0.3, yaw_rate=0.02,
                                    n_beams=32, n_azimuth=256)
    return [s.astype(np.float32) for s, _ in src]


def _updates(n: int):
    """``n`` random scans and motions: one scan with fewer valid points than
    points_per_scan (its short-fall slots go invalid)."""
    rng = np.random.default_rng(1)
    short = np.zeros((2000, 3), np.float32)
    short[:300] = rng.normal(size=(300, 3)) * 5 + 20
    out = []
    for i in range(n):
        scan = short if i == 2 else (rng.normal(size=(2000, 3)) * 5 + 10).astype(np.float32)
        X = (rng.uniform(-0.1, 0.1, 6) * [5, 5, 1, 0.2, 0.2, 1]).astype(np.float32)
        out.append((scan, X, jax.random.PRNGKey(i)))
    return out


# ---------------------------------------------------------------------------
# 1. Staged against eager, bit for bit
# ---------------------------------------------------------------------------


def test_map_update_jit_equals_eager():
    """Six updates: the ring wraps (6 x 1,000 rows into 2,500) and the trail
    (capacity 4) fills at the fourth and rolls from the fifth."""
    mcfg = MapConfig(**MCFG)
    eager = tmap.init_map(mcfg, trail_capacity=TRAIL, device="cpu")
    staged = _clone(eager)
    rows = staged.points, staged.valid, staged.trail
    gen = torch.Generator().manual_seed(3)
    for scan, X, _ in _updates(6):
        u = torch.rand(scan.shape[0], generator=gen)
        eager = tmap.map_update(eager, _t(scan), _t(X), u, mcfg, 0.2)
        staged = tmap.map_update_jit(staged, _t(scan), _t(X), u, mcfg, 0.2)
        _assert_states_identical(staged, eager)
    # The ring is written in place (the donated state of the JAX package).
    assert all(a is b for a, b in zip(rows, (staged.points, staged.valid, staged.trail)))
    assert staged.trail_len == TRAIL and staged.write_ptr == 6_000 % 2_500


@pytest.mark.parametrize("clamp", [0.9, 1e-6], ids=["kept", "diverged"])
def test_map_step_jit_equals_eager(drive, clamp):
    mcfg = MapConfig(**MCFG)
    model = prepare_reference(_t(drive[0]), TCFG)
    u = torch.rand(drive[1].shape[0], generator=torch.Generator().manual_seed(5))
    start = tmap.map_update(tmap.init_map(mcfg, trail_capacity=TRAIL, device="cpu"),
                            _t(drive[0]), torch.zeros(6), u, mcfg, TCFG.min_range)
    e = tmap.map_step(model, _clone(start), _t(drive[1]), u, clamp, TCFG, mcfg)
    c = tmap.map_step_jit(model, _clone(start), _t(drive[1]), u, clamp, TCFG, mcfg)
    assert bool(c[2]) == bool(e[2]) == (clamp < 0.5)
    assert torch.equal(c[1], e[1]) and torch.equal(c[0].X, e[0].X)
    assert torch.equal(c[0].pred_stds, e[0].pred_stds) and c[0].iterations == e[0].iterations
    _assert_states_identical(c[3], e[3])
    assert all(torch.equal(a, b) for a, b in zip(c[4], e[4]))


# ---------------------------------------------------------------------------
# 2. Against the JAX package
# ---------------------------------------------------------------------------


def test_map_update_jit_matches_jax():
    jcfg, tcfg = JMapConfig(**MCFG), MapConfig(**MCFG)
    jstate = jmap.init_map(jcfg, trail_capacity=TRAIL)
    tstate = map_state_from_numpy(_np(jstate))
    for scan, X, key in _updates(6):
        u = np.asarray(jax.random.uniform(key, (scan.shape[0],)))
        jstate = jmap.map_update(jstate, jnp.asarray(scan), jnp.asarray(X), key, jcfg, 0.2)
        tstate = tmap.map_update_jit(tstate, _t(scan), _t(X), _t(u), tcfg, 0.2)
        _assert_matches_jax(tstate, jstate)


@pytest.mark.parametrize("clamp", [0.9, 1e-6], ids=["kept", "diverged"])
def test_map_step_jit_matches_jax(drive, clamp):
    jcfg, tcfg = JMapConfig(**MCFG), MapConfig(**MCFG)
    jmodel = prepare_reference_jit(jnp.asarray(drive[0]), CFG)
    tmodel = voxel_model_from_numpy({k: np.asarray(v) for k, v in jmodel._asdict().items()})
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (drive[1].shape[0],)))
    state = jmap.map_update(jmap.init_map(jcfg), jnp.asarray(drive[0]), jnp.zeros(6), key, jcfg,
                            1.0)
    start = _np(state)
    jres, jX, jdiv, jstate, jnext = jmap.map_step_jit(
        jmodel, state, jnp.asarray(drive[1]), key, jnp.float32(clamp), CFG, jcfg)
    tres, tX, tdiv, tstate, tnext = tmap.map_step_jit(
        tmodel, map_state_from_numpy(start), _t(drive[1]), _t(u), clamp, TCFG, tcfg)
    assert bool(tdiv) == bool(jdiv) == (clamp < 0.5)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tres.pred_stds.numpy(), np.asarray(jres.pred_stds), rtol=1e-3)
    _assert_matches_jax(tstate, jstate, atol=1e-4)
    np.testing.assert_array_equal(tnext.valid.numpy(), np.asarray(jnext.valid))
    np.testing.assert_allclose(tnext.mean.numpy(), np.asarray(jnext.mean), rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# 3. MapMaker
# ---------------------------------------------------------------------------


ODO = OdometryConfig(divergence_clamp=0.9)


def _maker(**kw):
    return tmap.MapMaker(TCFG, MapConfig(**MCFG), ODO, device="cpu", **kw)


def _chain(scans, cfg=TCFG, map_cfg=MapConfig(**MCFG), odo=ODO):
    """The eager functions chained with ``MapMaker``'s semantics:
    ``(frames, final state)``."""
    return eager_chains.map_maker(_t(np.stack(scans)), cfg, map_cfg, odo)


def _assert_frames_identical(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.index, g.diverged, g.n_map_points, g.iterations) == (
            w.index, w.diverged, w.n_map_points, w.iterations)
        assert g.iterations > 0
        assert np.array_equal(g.X, w.X) and np.array_equal(g.pred_stds, w.pred_stds)


def _run(maker, scans):
    return [f for f in (maker.step(s) for s in scans) if f is not None]


def test_mapmaker_compiled_equals_eager(drive, monkeypatch):
    calls = {"jit": 0, "eager": 0}
    for name, key in (("map_step_jit", "jit"), ("map_step", "eager")):
        real = getattr(tmap, name)

        def counted(*args, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(tmap, name, counted)
    compiled = _maker()
    got = _run(compiled, drive[:6])
    assert calls == {"jit": 5, "eager": 0}
    want, state = _chain(drive[:6])
    _assert_frames_identical(got, want)
    _assert_states_identical(compiled.state, state)
    assert got[-1].n_map_points == min(MCFG["capacity"], 1_000 * 6)
    np.testing.assert_array_equal(compiled.snail_trail(),
                                  state.trail[:state.trail_len].numpy())


def test_mapmaker_compiled_recovers(drive, monkeypatch):
    """One compiled step raises at frame 3: the runner restores the
    snapshot into its own ring (the graphs keep replaying it), refits the
    model and retries; with a snapshot every frame the run equals an
    unfailed one, and the eager chain too."""
    clean = _run(_maker(snapshot_every=1), drive)
    real = tmap.map_step_jit
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("simulated device failure")
        return real(*args, **kw)

    monkeypatch.setattr(tmap, "map_step_jit", flaky)
    maker = _maker(snapshot_every=1)
    ring = (maker.state.points, maker.state.valid, maker.state.trail)
    got = _run(maker, drive)
    monkeypatch.setattr(tmap, "map_step_jit", real)
    assert maker.recoveries == 1 and calls["n"] == len(drive)
    assert all(a is b for a, b in zip(ring, (maker.state.points, maker.state.valid,
                                             maker.state.trail)))
    _assert_frames_identical(got, clean)
    _assert_frames_identical(got, _chain(drive)[0])


# ---------------------------------------------------------------------------
# 4. The scatter and one-hot routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["pallas", "onehot"])
def test_scatter_and_onehot_routes_take_the_compiled_step(drive, monkeypatch, method):
    """The scatter and one-hot routes, once left to the eager step, are
    captured now: ``map_step_jit`` on them equals ``map_step`` bit for bit,
    and ``MapMaker`` takes the compiled step and equals the eager chain."""
    cfg = TCFG.replace(moment_method=method)
    mcfg = MapConfig(**MCFG)
    model = prepare_reference(_t(drive[0]), cfg)
    state = tmap.init_map(mcfg, device="cpu")
    u = torch.rand(drive[1].shape[0], generator=torch.Generator().manual_seed(5))
    c = tmap.map_step_jit(model, _clone(state), _t(drive[1]), u, 0.9, cfg, mcfg)
    e = tmap.map_step(model, _clone(state), _t(drive[1]), u, 0.9, cfg, mcfg)
    assert torch.equal(c[0].X, e[0].X) and torch.equal(c[0].pred_stds, e[0].pred_stds)
    assert c[0].iterations == e[0].iterations and bool(c[2]) == bool(e[2])
    _assert_states_identical(c[3], e[3])
    calls = []
    real = tmap.map_step_jit
    monkeypatch.setattr(tmap, "map_step_jit", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    maker = tmap.MapMaker(cfg, mcfg, ODO, device="cpu")
    frames = _run(maker, drive[:3])
    assert len(calls) == 2 and len(frames) == 2 and not any(f.diverged for f in frames)
    want, state = _chain(drive[:3], cfg, mcfg)
    _assert_frames_identical(frames, want)
    _assert_states_identical(maker.state, state)


def test_map_update_jit_uses_the_mapping_profiles_set():
    """The map stage reads no solver config: map_update_jit runs in the set
    of ``PROFILES["mapping"]`` at its min_range, the default MapMaker's."""
    mcfg = MapConfig(**MCFG)
    scan = torch.ones(2000, 3) * 5
    tmap.map_update_jit(tmap.init_map(mcfg, device="cpu"), scan, torch.zeros(6),
                        torch.rand(2000), mcfg, 0.2)
    fg = graphs.frame_graphs("cpu", 2000, PROFILES["mapping"].replace(min_range=0.2))
    assert fg.buffers.ring is not None and fg.buffers.ring.expect == (1_000, 1)


# ---------------------------------------------------------------------------
# Full size
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_mapmaker_compiled_equals_eager_full_size():
    """The mapping profile and the default 600,000-point ring on three
    64x1024 frames of the city drive (65,536 points each)."""
    from icet_tpu_torch.datasets.replay import CityDriveSource

    scans = [s.astype(np.float32) for s, _ in CityDriveSource(n_frames=3, speed=1.0,
                                                               n_beams=64, n_azimuth=1024)]
    odo = OdometryConfig(divergence_clamp=2.5)
    compiled = tmap.MapMaker(PROFILES["mapping"], MapConfig(), odo, device="cpu")
    want, state = _chain(scans, PROFILES["mapping"], MapConfig(), odo)
    _assert_frames_identical(_run(compiled, scans), want)
    _assert_states_identical(compiled.state, state)
