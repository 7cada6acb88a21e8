"""The port's DNN-filtered odometry against the JAX package's.

Both ``OdometryPipeline``s run the same numpy scans with the filter on and
the same bundled BiasNet weights (the s100 weights serve S = 32, put into
each package's process cache).  The JAX side's encoder runs as its fused
Pallas kernel in interpret mode, as in tests/test_torch_filters.py.  49
azimuth bins against a 512-column sweep keep every point off the bin
edges.  Per-frame X within 2e-3 (a bf16 rounding can move a voxel across
the filter's threshold; see tests/test_torch_filters.py), divergence flags
identical.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import icet_tpu.filters as jf
import icet_tpu.models.bias_net as jbn
from icet_tpu import odometry as jodo
from icet_tpu.config import ICETConfig as JConfig
from icet_tpu.config import OdometryConfig as JOdo
from icet_tpu.datasets.replay import CityDriveSource, SyntheticTrajectorySource
from icet_tpu_torch import filters as tf
from icet_tpu_torch import odometry as todo
from icet_tpu_torch.config import OdometryConfig
from icet_tpu_torch.convert import config_from_icet
from icet_tpu_torch.models.bias_net import load_pretrained

torch.set_num_threads(2)

CFG = JConfig(n_theta=49, n_phi=16, phi_min=math.pi / 3, phi_max=2 * math.pi / 3,
              n_iters=7, min_pts=20, min_range=1.0, convergence_tol=1e-4,
              convergence_stat_scale=1.0, dnn_filter=True, dnn_start_iter=4,
              dnn_sample_pts=32)


@pytest.fixture
def s100_weights(monkeypatch):
    """Both packages' pretrained caches hold the s100 weights for S = 32,
    and the JAX filter's encoder is its fused kernel in interpret mode."""
    monkeypatch.setitem(jf._PRETRAINED_CACHE, 32, jbn.load_pretrained(100))
    monkeypatch.setitem(tf._PRETRAINED_CACHE, (32, "cpu"), load_pretrained(100))
    plain = jbn.apply_bias_net
    monkeypatch.setattr(jbn, "apply_bias_net", lambda net, params, x, **kw: plain(
        net, params, x, fused=True, interpret=True))


def _drive(cfg, scans, odo):
    want = list(jodo.OdometryPipeline(cfg, JOdo(divergence_clamp=odo)).run(scans))
    pipe = todo.OdometryPipeline(config_from_icet(dataclasses.asdict(cfg)),
                                 OdometryConfig(divergence_clamp=odo), device="cpu")
    assert pipe._dnn is not None
    return list(pipe.run(scans)), want


@pytest.mark.parametrize("in_loop", [True, False], ids=["in_loop", "one_shot"])
def test_pipeline_matches_jax(s100_weights, in_loop):
    src = SyntheticTrajectorySource(n_frames=4, speed=0.2, yaw_rate=0.01,
                                    n_beams=48, n_azimuth=512)
    scans = [s for s, _ in src]
    got, want = _drive(CFG.replace(dnn_in_loop=in_loop), scans, 0.3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.index == w.index and g.diverged == w.diverged is False
        np.testing.assert_allclose(g.X, w.X, rtol=0, atol=2e-3)
        np.testing.assert_allclose(g.T_world, w.T_world, rtol=0, atol=5e-3)
        assert g.n_corr.shape == w.n_corr.shape
        # In-loop: the plain phase's iterations + every filtered one; one
        # shot: both phases may exit early, each after at least one.
        n_post = CFG.n_iters - CFG.dnn_start_iter
        assert (n_post + 1 if in_loop else 2) <= g.iterations <= CFG.n_iters


@pytest.mark.slow
def test_full_width_drive():
    """75x24 grid, S = 100, the first 4 frames of the city drive; the JAX
    side runs its CPU default, the flax apply, whose bf16 roundings differ
    from the fused path's within the same 2e-2 output bound."""
    cfg = JConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0,
                  dnn_filter=True)
    scans = [s for s, _ in CityDriveSource(n_frames=4, speed=1.0, n_beams=64,
                                           n_azimuth=1024)]
    got, want = _drive(cfg, scans, 2.5)
    for g, w in zip(got, want):
        assert g.diverged == w.diverged is False
        np.testing.assert_allclose(g.X, w.X, rtol=0, atol=2e-3)
    assert np.isfinite(np.stack([g.pred_stds for g in got])).all()


def _first(mask, k=8):
    return np.nonzero(mask)[0][:k].tolist()


@pytest.mark.slow
def test_full_width_frame1_filter_matches_eager_reference():
    """The DNN drive's frame 1 (75x24 grid, 65,536 points, S = 100) through
    its plain phase and its first filtered iteration's mask, in both
    packages on the CPU.

    Against the JAX package evaluated as its code is written (eagerly, the
    flax forward), the port's keep mask is equal and its shifts agree (the
    encoder's float32 sums in another order move a pooled code by a bf16
    ulp: dnn_shift within 6.3e-5 here, held to 5e-4).  The JAX package's
    jitted filter, which its OdometryPipeline runs, differs from its own
    eager one: XLA's CPU compiler evaluates the BiasNet's bf16 bias add in
    float32 and drops the bf16 rounding the code states, which moves the
    network's shifts by up to 8.3e-3 m and flips 4 voxels of this mask.
    That is the cause of the drives' ATE gap (ROADMAP C5); the bound found
    is held here."""
    import jax
    import jax.numpy as jnp

    from icet_tpu import solver as js
    from icet_tpu.ops.geometry import transform_points as jtp
    from icet_tpu_torch import solver as ts

    jcfg = JConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0,
                   dnn_filter=True)
    tcfg = config_from_icet(dataclasses.asdict(jcfg))
    s0, s1 = (np.asarray(s, np.float32) for s, _ in
              list(CityDriveSource(n_frames=24, speed=1.0, n_beams=64, n_azimuth=1024))[:2])
    n_pre = max(min(jcfg.dnn_start_iter, jcfg.n_iters - 1), 1)
    jnet, jparams = jf.pretrained_dnn(jcfg)
    tnet = tf.pretrained_dnn(tcfg, "cpu")
    jm = js.prepare_reference_jit(jnp.asarray(s0), jcfg)
    tm = ts.prepare_reference(torch.from_numpy(s0), tcfg)
    jsamp = jf.model_voxel_samples_jit(jm, jnp.asarray(s0), jcfg)
    tsamp = tf.model_voxel_samples(tm, torch.from_numpy(s0), tcfg)
    jpre = js.register(jm, jnp.asarray(s1), jnp.zeros(6), jcfg.replace(n_iters=n_pre),
                       want_static_mask=False)
    tpre = ts.register(tm, torch.from_numpy(s1), torch.zeros(6),
                       tcfg.replace(n_iters=n_pre, range_sigma=0.0), want_static_mask=False)
    np.testing.assert_allclose(tpre.X.numpy(), np.asarray(jpre.X), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tpre.diagnostics.n_corr.numpy(),
                                  np.asarray(jpre.diagnostics.n_corr))

    # Both filters at the reference's X: the same aligned scan.
    X = np.asarray(jpre.X)
    aligned = jtp(jnp.asarray(s1), jnp.asarray(X))

    def jax_filter(m, a, smp):
        return jf.dnn_reject_mask(jnet, jparams, m, jnp.asarray(s0), a, jcfg, samples1=smp)

    eager = jax_filter(jm, aligned, jsamp)
    jitted = jax.jit(jax_filter)(jm, aligned, jsamp)
    port = tf.dnn_reject_mask(tnet, tm, torch.from_numpy(s0),
                              torch.from_numpy(np.array(aligned)), tcfg, samples1=tsamp)
    ek, jk, pk = np.asarray(eager.keep), np.asarray(jitted.keep), port.keep.numpy()
    assert not (pk != ek).any(), f"port vs eager reference: voxels {_first(pk != ek)}"
    np.testing.assert_allclose(port.icet_shift.numpy(), np.asarray(eager.icet_shift),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.dnn_shift.numpy(), np.asarray(eager.dnn_shift),
                               rtol=0, atol=5e-4)
    assert int((jk != ek).sum()) <= 8, f"jitted vs eager: voxels {_first(jk != ek)}"
    assert np.abs(np.asarray(jitted.dnn_shift) - np.asarray(eager.dnn_shift)).max() < 2e-2


def test_bias_add_rounding_matches_eager_reference():
    """The cause of ROADMAP C5 on one encoder stage: the pre-LayerNorm
    activation ``bf16(bf16(h @ W) + b)``.  The port rounds it as the JAX
    package's code states and as its eager evaluation computes it (equal up
    to the float32 order of the 4-term product sums); the JAX package's
    jitted CPU program keeps the sum in float32, so most entries differ
    from its own eager result."""
    import jax
    import jax.numpy as jnp

    _, params = jf.pretrained_dnn(JConfig(dnn_filter=True))
    w, b = (np.asarray(a) for a in jbn._split_params(params)[0][:2])
    h = np.random.default_rng(0).normal(size=(4096, 4)).astype(np.float32)
    hb = jnp.asarray(h).astype(jnp.bfloat16)

    def pre_ln(h, w, b):
        a = jnp.dot(h, w.astype(jnp.bfloat16), preferred_element_type=jnp.float32)
        return (a.astype(jnp.bfloat16) + b.astype(jnp.bfloat16)).astype(jnp.float32)

    eager = np.asarray(pre_ln(hb, jnp.asarray(w), jnp.asarray(b)))
    jitted = np.asarray(jax.jit(pre_ln)(hb, jnp.asarray(w), jnp.asarray(b)))
    th = torch.from_numpy(h).to(torch.bfloat16).float()
    a = (th @ torch.from_numpy(w).to(torch.bfloat16).float()).to(torch.bfloat16)
    port = (a.float() + torch.from_numpy(b).to(torch.bfloat16).float()).to(torch.bfloat16)
    port = port.float().numpy()
    assert (port != eager).mean() < 1e-3
    assert (jitted != eager).mean() > 0.5
