"""The port's pose graph (``icet_tpu_torch/pose_graph.py``, the backbone's
plain version in ``ops/tridiag.py``) against ``icet_tpu/pose_graph.py`` on
the CPU.

The fixtures of ``tests/test_pose_graph.py`` are rebuilt here in numpy (a
circle of poses, noisy odometry factors, confident loop factors) and the
same arrays go to both packages.  Tolerances: residuals within 1e-5;
normal-equation blocks within 1e-4 of the largest entry; optimised states
within 2e-3, the JAX package's own dense-vs-sparse tolerance; the backbone
factor and apply within 1e-4 of each block's (or vector's) largest entry,
since block 0 carries the 1e8 gauge prior and the others are O(1e4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import pose_graph as jp
from icet_tpu_torch import pose_graph as tp
from icet_tpu_torch.keyframe import np_pose_matrix, np_pose_to_state
from icet_tpu_torch.ops import tridiag as td

torch.set_num_threads(2)


def _rel_state(a, b):
    return np_pose_to_state(np.linalg.inv(np_pose_matrix(a)) @ np_pose_matrix(b))


def _make_circle(K=12, radius=5.0):
    states = []
    for k in range(K):
        a = 2 * np.pi * k / K * 0.9
        t = np.array([radius * np.cos(a), radius * np.sin(a), 0.0])
        states.append(np.concatenate([t, [0.0, 0.0, -a]]).astype(np.float32))
    return np.stack(states)


def _noisy_graph(states_true, rng, t_noise=0.05, a_noise=0.005, loops=()):
    """Numpy arrays (idx_i, idx_j, meas, info)."""
    K = len(states_true)
    idx_i, idx_j, meas, info = [], [], [], []
    for k in range(K - 1):
        m = np.array(_rel_state(states_true[k], states_true[k + 1]))
        m[:3] += rng.normal(0, t_noise, 3)
        m[3:] += rng.normal(0, a_noise, 3)
        idx_i.append(k)
        idx_j.append(k + 1)
        meas.append(m)
        info.append(np.diag([1 / t_noise**2] * 3 + [1 / a_noise**2] * 3))
    for (i, j) in loops:
        idx_i.append(i)
        idx_j.append(j)
        meas.append(_rel_state(states_true[i], states_true[j]))
        info.append(np.diag([1e4] * 3 + [1e6] * 3))
    return (np.asarray(idx_i, np.int32), np.asarray(idx_j, np.int32),
            np.stack(meas).astype(np.float32), np.stack(info).astype(np.float32))


def _integrate(arrays, K):
    meas = arrays[2]
    T = np.eye(4)
    states = [np.zeros(6, np.float32)]
    for k in range(K - 1):
        T = T @ np_pose_matrix(meas[k])
        states.append(np_pose_to_state(T))
    return np.stack(states).astype(np.float32)


def _graphs(arrays):
    """The same factors as the JAX package's and the port's PoseGraph."""
    j = jp.PoseGraph(*(jnp.asarray(a) for a in arrays))
    t = tp.PoseGraph(*(torch.from_numpy(np.array(a)) for a in arrays)).to("cpu")
    return j, t


@pytest.fixture
def circle():
    rng = np.random.default_rng(42)  # the stream of tests/conftest.py's rng
    arrays = _noisy_graph(_make_circle(12), rng, loops=[(0, 11), (1, 10)])
    return arrays, _integrate(arrays, 12)


def test_factor_residual_and_blocks(circle):
    arrays, s0 = circle
    jg, tg = _graphs(arrays)
    st = torch.from_numpy(s0)
    residual = jax.jit(jp._factor_residual)
    for f in range(len(arrays[0])):
        i, j = arrays[0][f], arrays[1][f]
        want = np.asarray(residual(jnp.asarray(s0[i]), jnp.asarray(s0[j]),
                                   jnp.asarray(arrays[2][f])))
        got = tp._factor_residual(st[i], st[j], tg.meas[f]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jb, jr = jax.jit(jp._factor_blocks)(jnp.asarray(s0), jg)
    tb, tr = tp._factor_blocks(st, tg)
    assert tb.dtype == torch.float32 and tr.dtype == torch.float32
    jb, jr = np.asarray(jb), np.asarray(jr)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-4 * np.abs(jb).max())
    np.testing.assert_allclose(tr.numpy(), jr, rtol=0, atol=1e-4 * np.abs(jr).max())


def test_factor_residual_zero_on_truth():
    s = torch.from_numpy(_make_circle())
    for k in range(len(s) - 1):
        meas = torch.from_numpy(_rel_state(s[k].numpy(), s[k + 1].numpy()).astype(np.float32))
        np.testing.assert_allclose(tp._factor_residual(s[k], s[k + 1], meas).numpy(), 0.0,
                                   atol=1e-5)


def test_wrap_matches():
    a = np.linspace(-10, 10, 101).astype(np.float32)
    np.testing.assert_allclose(tp._wrap(torch.from_numpy(a)).numpy(),
                               np.asarray(jp._wrap(jnp.asarray(a))), rtol=0, atol=1e-6)


def test_dense_matches_jax_and_closes_the_loop(circle):
    arrays, s0 = circle
    jg, tg = _graphs(arrays)
    want = np.asarray(jp.optimize_poses(jnp.asarray(s0), jg, 10))
    got = tp.optimize_poses(s0, tg, 10, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[0], s0[0], atol=1e-3)  # gauge pinned
    s_true = _make_circle(12)
    T0 = np.linalg.inv(np_pose_matrix(s_true[0]))
    rel_true = np.stack([np_pose_to_state(T0 @ np_pose_matrix(s)) for s in s_true])
    err0 = np.linalg.norm(s0[:, :3] - rel_true[:, :3], axis=1)
    err1 = np.linalg.norm(got[:, :3] - rel_true[:, :3], axis=1)
    assert err1[-1] < err0[-1] * 0.35 and err1.mean() < err0.mean() * 0.85


def test_dense_recovers_exact_graph():
    rng = np.random.default_rng(1)
    arrays = _noisy_graph(_make_circle(8), rng, t_noise=1e-3, a_noise=1e-3)
    s0 = _integrate(arrays, 8)
    noisy0 = s0 + rng.normal(0, 0.05, s0.shape).astype(np.float32)
    noisy0[0] = s0[0]
    jg, tg = _graphs(arrays)
    want = np.asarray(jp.optimize_poses(jnp.asarray(noisy0), jg, 10))
    got = tp.optimize_poses(noisy0, tg, 10, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got, s0, atol=2e-3)


@pytest.mark.parametrize("precond,cg", [("tridiag", 120), ("jacobi", 120), ("tridiag", 5)])
@pytest.mark.parametrize("robust", [0.0, 3.5])
def test_sparse_matches_jax(circle, precond, cg, robust):
    arrays, s0 = circle
    jg, tg = _graphs(arrays)
    want = np.asarray(jp.optimize_poses_sparse(jnp.asarray(s0), jg, 10, cg,
                                               precond=precond, robust_delta=robust))
    got = tp.optimize_poses_sparse(s0, tg, 10, cg, precond=precond, robust_delta=robust,
                                   device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    if cg == 120 and robust == 0.0:
        dense = tp.optimize_poses(s0, tg, 10, device="cpu").numpy()
        np.testing.assert_allclose(got, dense, atol=2e-3)


def test_robust_kernel_resists_outlier_loop():
    rng = np.random.default_rng(2)
    arrays = _noisy_graph(_make_circle(16), rng, loops=[(0, 15), (2, 13)])
    s0 = _integrate(arrays, 16)
    bad = list(arrays)
    bad[2] = arrays[2].copy()
    bad[2][-1, :3] += np.array([2.0, -1.5, 0.5], np.float32)
    bad[2][-1, 3:] += np.array([0.2, -0.1, 0.15], np.float32)
    _, tg = _graphs(arrays)
    jb, tb = _graphs(bad)
    clean = tp.optimize_poses_sparse(s0, tg, 10, 60, device="cpu").numpy()
    l2 = tp.optimize_poses_sparse(s0, tb, 10, 60, device="cpu").numpy()
    robust = tp.optimize_poses_sparse(s0, tb, 10, 60, robust_delta=3.5, device="cpu").numpy()
    want = np.asarray(jp.optimize_poses_sparse(jnp.asarray(s0), jb, 10, 60, robust_delta=3.5))
    np.testing.assert_allclose(robust, want, rtol=0, atol=2e-3)
    err_l2 = np.linalg.norm(l2[:, :3] - clean[:, :3], axis=1).max()
    err_r = np.linalg.norm(robust[:, :3] - clean[:, :3], axis=1).max()
    assert err_l2 > 0.3 and err_r < 0.1 * err_l2, (err_l2, err_r)


def _backbone(K, rng, fallback_at=None):
    """Damped diagonal blocks and super-diagonal blocks of an SPD chain;
    each k of ``fallback_at`` (one k or a tuple) gets ``D_k = I`` and
    ``E_{k-1} = c I`` with ``c^2`` above the smallest eigenvalue of
    ``S_{k-1}`` (1e5 after the prior's block, else 100), which makes that
    block's Schur complement indefinite."""
    A = rng.normal(size=(K, 6, 6))
    D = (A @ A.transpose(0, 2, 1) + 20 * np.eye(6)).astype(np.float32)
    D[0] += 1e8 * np.eye(6, dtype=np.float32)
    E = (rng.normal(size=(K - 1, 6, 6)) * 2).astype(np.float32)
    for k in _as_tuple(fallback_at):
        D[k] = np.eye(6, dtype=np.float32)
        E[k - 1] = (1e5 if k == 1 else 100) * np.eye(6, dtype=np.float32)
    return D, E


def _as_tuple(fallback_at):
    if fallback_at is None:
        return ()
    return fallback_at if isinstance(fallback_at, tuple) else (fallback_at,)


def _rel_close(got, want, tol=1e-4):
    got = got.reshape(got.shape[0], -1)
    want = want.reshape(want.shape[0], -1)
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
    assert np.all(np.abs(got - want) <= tol * scale), np.max(np.abs(got - want) / scale)


_RING = td.CHUNK * td.STAGES


@pytest.mark.parametrize("K,fallback_at", [
    (1, None), (2, None), (7, None), (40, 5), (40, 39), (40, 1), (40, (20, 21)),
    (td.CHUNK - 1, None), (td.CHUNK, None), (td.CHUNK + 1, None),
    (_RING - 1, None), (_RING, None), (_RING + 1, None)])
def test_tridiag_plain_matches_jax(K, fallback_at):
    rng = np.random.default_rng(K)
    D, E = _backbone(K, rng, fallback_at)
    eye6 = jnp.eye(6, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        jS, jU = jp._tridiag_factor(jnp.asarray(D), jnp.asarray(E), eye6)
        r = rng.normal(size=(K, 6)).astype(np.float32)
        jy = jp._tridiag_apply(jS, jU, jnp.asarray(r))
    S, U = td.tridiag_factor(torch.from_numpy(D), torch.from_numpy(E))
    assert S.shape == (K, 6, 6) and U.shape == (K - 1, 6, 6)
    assert bool(torch.isfinite(S).all())
    _rel_close(S.numpy(), np.asarray(jS))
    if K > 1:
        _rel_close(U.numpy(), np.asarray(jU))
    for k in _as_tuple(fallback_at):
        # The indefinite block took block-Jacobi: inv(D_k), U = 0.
        np.testing.assert_allclose(S[k].numpy(), np.eye(6), atol=1e-6)
        assert bool((U[k - 1] == 0).all())
    y = td.tridiag_apply(S, U, torch.from_numpy(r))
    _rel_close(y.numpy()[None], np.asarray(jy)[None])


# A float64 and float32 model of the order in which csrc/tridiag_backbone.cu
# evaluates, which differs from the plain recurrence: the factor carries
# the Cholesky factor L_k of S_k in float64, one reciprocal square root a
# pivot, W = L_k^-1 E_k by forward substitution and S_{k+1} = D - W^T W;
# S_inv_k = L^-T L^-1 and U_k = L^-T W by substitutions, rounded to float32;
# a failed pivot or a non-finite float32 inverse takes D_k.  The apply sums
# each step's six products pairwise, in float32.


def _model_cholesky(A):
    a, ri, ok = A.copy(), np.zeros(6), True
    for j in range(6):
        s = a[j, j]
        ok = ok and s > 0
        ri[j] = 1 / np.sqrt(s) if s > 0 else np.nan
        a[j + 1:, j] = a[j + 1:, j] * ri[j]
        for i in range(j + 1, 6):
            for m in range(j + 1, i + 1):
                a[i, m] = a[i, m] - a[i, j] * a[m, j]
    return a, ri, ok


def _model_lower_solve(L, ri, x):
    x = x.copy()
    for i in range(6):
        t = x[i].copy()
        for m in range(i):
            t = t - L[i, m] * x[m]
        x[i] = t * ri[i]
    return x


def _model_upper_solve(L, ri, y):
    y = y.copy()
    for i in range(5, -1, -1):
        t = y[i].copy()
        for m in range(5, i, -1):
            t = t - L[m, i] * y[m]
        y[i] = t * ri[i]
    return y


def _model_factor(D, E):
    K = len(D)
    sym = [0.5 * (d.astype(np.float64) + d.astype(np.float64).T) for d in D]
    S_inv = np.zeros((K, 6, 6), np.float32)
    U = np.zeros((K - 1, 6, 6), np.float32)
    S_cur, u_prev = sym[0], None
    for k in range(K):
        L, ri, ok = _model_cholesky(S_cur)
        fallback = k > 0 and not ok
        if fallback:
            L, ri, _ = _model_cholesky(sym[k])
        inv = _model_upper_solve(L, ri, _model_lower_solve(L, ri, np.eye(6))).astype(np.float32)
        if k > 0 and not fallback and not np.isfinite(inv).all():
            fallback = True
            L, ri, _ = _model_cholesky(sym[k])
            inv = _model_upper_solve(L, ri, _model_lower_solve(L, ri, np.eye(6)))
        S_inv[k] = inv
        if k > 0:
            U[k - 1] = 0.0 if fallback else u_prev
        if k + 1 < K:
            W = _model_lower_solve(L, ri, E[k].astype(np.float64))
            t = W[0][:, None] * W[0][None, :]
            for m in range(1, 6):
                t = t + W[m][:, None] * W[m][None, :]
            S_cur = sym[k + 1] - t
            u_prev = _model_upper_solve(L, ri, W).astype(np.float32)
    return S_inv, U


def _model_apply(S_inv, U, r):
    def minus_sum6(b, p):
        return ((b - p[0]) - (p[1] + p[2])) - ((p[3] + p[4]) + p[5])

    K = len(r)
    z = np.zeros((K, 6), np.float32)
    z[0] = r[0]
    for k in range(1, K):
        z[k] = minus_sum6(r[k], U[k - 1] * z[k - 1][:, None])  # p[m][a] = U[m][a] z[m]
    q = S_inv * z[:, None, :]  # q[k][a][m] = S_inv[a][m] z[m]
    Sz = ((q[..., 0] + q[..., 1]) + (q[..., 2] + q[..., 3])) + (q[..., 4] + q[..., 5])
    y = np.zeros((K, 6), np.float32)
    y[K - 1] = Sz[K - 1]
    for k in range(K - 2, -1, -1):
        y[k] = minus_sum6(Sz[k], (U[k] * y[k + 1][None, :]).T)  # p[m][a] = U[a][m] y[m]
    return y


@pytest.mark.parametrize("K,fallback_at", [(2000, None), (2000, (1, 1000, 1001, 1999))])
def test_tridiag_kernel_order_matches_jax(K, fallback_at):
    rng = np.random.default_rng(K + len(_as_tuple(fallback_at)))
    D, E = _backbone(K, rng, fallback_at)
    r = rng.normal(size=(K, 6)).astype(np.float32)
    eye6 = jnp.eye(6, dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        jS, jU = jp._tridiag_factor(jnp.asarray(D), jnp.asarray(E), eye6)
        jy = jp._tridiag_apply(jS, jU, jnp.asarray(r))
    S, U = _model_factor(D, E)
    _rel_close(S, np.asarray(jS))
    _rel_close(U, np.asarray(jU))
    for k in _as_tuple(fallback_at):
        np.testing.assert_allclose(S[k], np.eye(6), atol=1e-6)
        assert (U[k - 1] == 0).all()
    y = _model_apply(S, U, r)
    _rel_close(y[None], np.asarray(jy)[None])


def test_tridiag_ring_constants_match_source():
    """CHUNK and STAGES, which the tests and chip_smoke.py place their edge
    cases by, are the kernel source's kChunk and kStages."""
    import re
    from pathlib import Path

    src = (Path(td.__file__).resolve().parents[1] / "csrc" / "tridiag_backbone.cu").read_text()
    assert int(re.search(r"constexpr int kChunk = (\d+);", src).group(1)) == td.CHUNK
    assert int(re.search(r"constexpr int kStages = (\d+);", src).group(1)) == td.STAGES


def test_tridiag_counts_only_kernel_launches():
    rng = np.random.default_rng(0)
    D, E = _backbone(5, rng)
    before = td.tridiag_factor.launches, td.tridiag_apply.launches
    S, U = td.tridiag_factor(torch.from_numpy(D), torch.from_numpy(E))
    td.tridiag_apply(S, U, torch.zeros(5, 6))
    assert (td.tridiag_factor.launches, td.tridiag_apply.launches) == before


def test_tridiag_wrapper_refusals():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no tridiagonal backbone kernel"):
        td.tridiag_factor(torch.empty(4, 6, 6, **meta), torch.empty(3, 6, 6, **meta))
    with pytest.raises(ValueError, match="shape"):
        td.tridiag_factor(torch.empty(4, 6, 6, **meta), torch.empty(4, 6, 6, **meta))
    with pytest.raises(TypeError, match="float32"):
        td.tridiag_apply(torch.empty(4, 6, 6, **meta), torch.empty(3, 6, 6, **meta),
                         torch.empty(4, 6, dtype=torch.float64, **meta))
    with pytest.raises(ValueError, match="out of the kernel's range"):
        td.tridiag_factor(torch.empty(0, 6, 6, **meta), torch.empty(0, 6, 6, **meta))


class _Frame:
    def __init__(self, X, T, stds, diverged=False):
        self.X = X
        self.T_world = T
        self.pred_stds = stds
        self.diverged = diverged


def test_graph_from_odometry_matches_jax():
    from icet_tpu_torch.odometry import OdometryFrame

    rng = np.random.default_rng(3)
    frames, T = [], np.eye(4)
    for k in range(5):
        X = np.concatenate([rng.normal(0, 1, 3), rng.normal(0, 0.02, 3)]).astype(np.float32)
        T = T @ np_pose_matrix(X)
        stds = np.abs(rng.normal(0, 0.01, 6)).astype(np.float32)
        stds[0] = 1e-6  # floored at 1e-4
        frames.append(OdometryFrame(
            index=k + 1, X=X, pred_stds=stds, T_world=T, pose=np_pose_to_state(T),
            twist=X * 10, diverged=k == 2, n_corr=np.zeros(1, np.int32), solve_ms=0.0))
    loops = [(0, 4, rng.normal(size=6).astype(np.float32),
              np.diag(rng.uniform(1, 10, 6)).astype(np.float32))]
    ts0, tg = tp.graph_from_odometry(frames, loops)
    js0, jg = jp.graph_from_odometry(
        [_Frame(f.X, f.T_world, f.pred_stds, f.diverged) for f in frames], loops)
    np.testing.assert_allclose(ts0, js0, rtol=0, atol=1e-5)
    for t, j in zip(tg, jg):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tg.idx_i.dtype == torch.int64 and tg.info.dtype == torch.float32


def test_graph_from_odometry_single_frame():
    X = np.array([1, 0, 0, 0, 0, 0], np.float32)
    states0, graph = tp.graph_from_odometry(
        [_Frame(X, np_pose_matrix(X), np.full(6, 0.01, np.float32))])
    assert states0.shape == (2, 6)
    np.testing.assert_allclose(states0[1], X, atol=1e-6)
    np.testing.assert_allclose(graph.info[0].numpy(), np.eye(6) * 1e4, rtol=1e-6)


@pytest.mark.parametrize("n,radius,min_gap,k", [(400, 3.0, 10, 1), (300, 4.0, 10, 3),
                                                (50, 100.0, 5, 2), (0, 3.0, 10, 1)])
def test_detect_loop_candidates_matches(n, radius, min_gap, k):
    pos = np.random.default_rng(n).normal(0, 12.0, (n, 3))
    got = tp.detect_loop_candidates(pos, radius, min_gap, k)
    assert got == jp.detect_loop_candidates(pos, radius, min_gap, k)
    brute = []
    for i in range(n):
        cand = sorted((np.linalg.norm(pos[i] - pos[j]), j) for j in range(i + min_gap, n)
                      if np.linalg.norm(pos[i] - pos[j]) < radius)
        brute.extend((i, j) for _, j in cand[:k])
    assert got == brute


def test_states_poses_roundtrip():
    s = np.random.default_rng(5).normal(0, 0.4, (5, 6)).astype(np.float32)
    poses = tp.states_to_poses(s)
    assert poses.shape == (5, 4, 4) and poses.dtype == np.float32
    np.testing.assert_allclose(poses, np.asarray(jp.states_to_poses(jnp.asarray(s))), atol=1e-6)
    np.testing.assert_allclose(tp.poses_to_states(poses), s, atol=1e-5)
    np.testing.assert_allclose(tp.poses_to_states(torch.from_numpy(poses)),
                               np.asarray(jp.poses_to_states(poses)), atol=1e-6)
