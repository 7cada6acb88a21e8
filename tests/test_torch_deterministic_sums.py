"""Sums in a fixed order: the pose graph's normals assembled from a factor
incidence (``icet_tpu_torch.pose_graph.Incidence``) instead of float
``index_add_`` / ``index_put_(accumulate=True)``, whose CUDA atomics add in
whatever order the hardware commits them; the plain moments route, whose
card path sums with the moment scatter kernel; and the scatter kernel's
part plan.

The assembly is held against ``icet_tpu.pose_graph`` on the same seeded
numpy inputs, on the CPU (the dense normals through its
``_build_normals``; the block-sparse normals and the off-diagonal product
through its formulas in ``_sparse_gn_step_inner``, written here with jnp),
at 1e-4 of each quantity's largest entry: the two packages' float32 factor
Jacobians differ at that level (tests/test_torch_pose_graph.py's
``test_factor_residual_and_blocks``).  It is also held against the
``index_add_`` formula it replaced, kept here as the yardstick, on the same
factor blocks: the two add the same pieces in orders that can differ only
by reassociation, so within 4 ulp of the pieces' absolute sum.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icet_tpu import pose_graph as jp
from icet_tpu_torch import pose_graph as tp
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.datasets.synthetic import simulate_scan
from icet_tpu_torch.keyframe import np_pose_matrix, np_pose_to_state
from icet_tpu_torch.ops import moment_scatter as tsc
from icet_tpu_torch.ops.fused_moments import fused_moment_sums_reference
from icet_tpu_torch.solver import _moment_sums, moment_route, prepare_reference

torch.set_num_threads(2)

#: reassociation bound against the index_add_ yardstick, in units of the
#: float32 epsilon times the pieces' absolute sum
ULPS = 4
EPS32 = float(np.finfo(np.float32).eps)
#: port against the JAX package: the factor blocks' own tolerance
JAX_RTOL = 1e-4


def _rel(a, b):
    return np_pose_to_state(np.linalg.inv(np_pose_matrix(a)) @ np_pose_matrix(b))


def _graph(kind: str):
    """``(states (K, 6), (idx_i, idx_j, meas, info))`` as numpy, from seed 5:
    a noisy circle of K poses, its odometry chain, and

    * ``loops``: three loop factors, one of them closing the ring;
    * ``repeated``: the factor (2, 3) three times and its reverse (3, 2);
    * ``isolated``: pose K-1 with no factor (the chain stops at K-2).
    """
    rng = np.random.default_rng(5)
    K = 9
    a = np.linspace(0, 1.6 * np.pi, K)
    truth = np.stack([4 * np.cos(a), 4 * np.sin(a), 0.1 * np.sin(3 * a), 0.01 * np.cos(a),
                      -0.02 * np.sin(a), -a], axis=1).astype(np.float32)
    states = (truth + rng.normal(0, [0.05] * 3 + [0.005] * 3, truth.shape)).astype(np.float32)
    last = K - 2 if kind == "isolated" else K - 1
    pairs = [(k, k + 1) for k in range(last)]
    pairs += {"loops": [(0, 8), (1, 6), (2, 7)],
              "repeated": [(2, 3), (2, 3), (3, 2), (0, 4)],
              "isolated": [(0, 5), (3, 7)]}[kind]
    meas, info = [], []
    for i, j in pairs:
        m = np.asarray(_rel(truth[i], truth[j]), np.float32)
        meas.append(m + rng.normal(0, [0.02] * 3 + [0.002] * 3).astype(np.float32))
        w = rng.uniform(0.5, 2.0, 6) * np.array([1e3] * 3 + [1e5] * 3)
        q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
        info.append((q * w) @ q.T)
    idx = np.asarray(pairs, np.int64)
    return states, (idx[:, 0].copy(), idx[:, 1].copy(), np.stack(meas).astype(np.float32),
                    np.stack(info).astype(np.float32))


def _both(kind):
    states, arrays = _graph(kind)
    jg = jp.PoseGraph(*(jnp.asarray(x) for x in arrays))
    tg = tp.PoseGraph(*(torch.from_numpy(x) for x in arrays)).to("cpu")
    return states, jg, tg


def _close(got, want, rtol=JAX_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rtol * np.abs(want).max())


def _within_ulps(got, want, magnitude):
    """|got - want| within ULPS float32 epsilons of the pieces' absolute sum."""
    err = (got - want).abs()
    assert bool((err <= ULPS * EPS32 * magnitude).all()), float(err.max())


def _old_sparse(states, graph, blocks, rhs):
    """The ``index_add_`` formulas the fixed-order sums replaced: gradient,
    diagonal blocks and the backbone's blocks (row K-1 dropped)."""
    K = states.shape[0]
    bi, bj = graph.idx_i, graph.idx_j
    b = states.new_zeros((K, 6)).index_add_(0, bi, rhs[:, 0]).index_add_(0, bj, rhs[:, 1])
    diag = states.new_zeros((K, 6, 6)).index_add_(0, bi, blocks[:, 0]).index_add_(
        0, bj, blocks[:, 3])
    consec = bj == bi + 1
    sent = torch.where(consec, bi, K - 1)
    E = states.new_zeros((K, 6, 6)).index_add_(
        0, sent, torch.where(consec[:, None, None], blocks[:, 1], 0.0))
    return b, diag, E


KINDS = ["loops", "repeated", "isolated"]


@pytest.mark.parametrize("kind", KINDS)
def test_dense_normals_match_jax(kind):
    states, jg, tg = _both(kind)
    st = torch.from_numpy(states)
    H, b = tp._build_normals(st, tg, 1e8, tp.incidence(tg, st.shape[0]))
    jH, jb = jax.jit(jp._build_normals, static_argnums=2)(jnp.asarray(states), jg, 1e8)
    _close(H.numpy(), jH)
    _close(b.numpy(), jb)


@pytest.mark.parametrize("kind", KINDS)
def test_dense_normals_against_index_put(kind):
    states, _, tg = _both(kind)
    st = torch.from_numpy(states)
    K = st.shape[0]
    H, b = tp._build_normals(st, tg, 1e8, tp.incidence(tg, K))
    blocks, rhs = tp._factor_blocks(st, tg)
    bi, bj = tg.idx_i, tg.idx_j
    old = st.new_zeros((K, K, 6, 6))
    mag = st.new_zeros((K, K, 6, 6))
    for m, (r, c) in enumerate(((bi, bi), (bi, bj), (bj, bi), (bj, bj))):
        old.index_put_((r, c), blocks[:, m], accumulate=True)
        mag.index_put_((r, c), blocks[:, m].abs(), accumulate=True)
    old[0, 0] += 1e8 * torch.eye(6)
    mag[0, 0] += 1e8 * torch.eye(6)
    old_b = st.new_zeros((K, 6)).index_add_(0, bi, rhs[:, 0]).index_add_(0, bj, rhs[:, 1])
    mag_b = st.new_zeros((K, 6)).index_add_(0, bi, rhs[:, 0].abs()).index_add_(
        0, bj, rhs[:, 1].abs())
    _within_ulps(H, old.permute(0, 2, 1, 3).reshape(6 * K, 6 * K),
                 mag.permute(0, 2, 1, 3).reshape(6 * K, 6 * K))
    _within_ulps(b, old_b.reshape(-1), mag_b.reshape(-1))


def _jax_sparse(states, jg, prior, damping):
    """The JAX package's block-sparse normals, as ``_sparse_gn_step_inner``
    forms them (icet_tpu/pose_graph.py:267-311)."""
    K = states.shape[0]
    eye6 = jnp.eye(6, dtype=states.dtype)
    blocks, rhs = jp._factor_blocks(states, jg)
    bi, bj = jg.idx_i, jg.idx_j
    b = jnp.zeros((K, 6), states.dtype).at[bi].add(rhs[:, 0]).at[bj].add(rhs[:, 1])
    diag = jnp.zeros((K, 6, 6), states.dtype).at[bi].add(blocks[:, 0]).at[bj].add(blocks[:, 3])
    diag = diag.at[0].add(prior * eye6)
    scale = damping * jnp.sum(jax.vmap(jnp.trace)(diag)) / (6 * K)
    consec = bj == bi + 1
    sent = jnp.where(consec, bi, K - 1)
    E = jnp.zeros((K - 1, 6, 6), states.dtype).at[sent].add(
        jnp.where(consec[:, None, None], blocks[:, 1], 0.0))
    return b, diag + scale * eye6, blocks[:, 1], blocks[:, 2], E


def _jax_offdiag(v, jg, off_ij, off_ji):
    bi, bj = jg.idx_i, jg.idx_j
    hi = jax.lax.Precision.HIGHEST
    off = jnp.zeros_like(v)
    off = off.at[bi].add(jnp.einsum("fab,fb->fa", off_ij, v[bj], precision=hi))
    return off.at[bj].add(jnp.einsum("fab,fb->fa", off_ji, v[bi], precision=hi))


@pytest.mark.parametrize("kind", KINDS)
def test_sparse_normals_match_jax(kind):
    states, jg, tg = _both(kind)
    st = torch.from_numpy(states)
    got = tp._sparse_normals(st, tg, 1e8, 1e-6, inc=tp.incidence(tg, st.shape[0]))
    want = jax.jit(_jax_sparse, static_argnums=(2, 3))(jnp.asarray(states), jg, 1e8, 1e-6)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("kind", KINDS)
def test_sparse_normals_against_index_add(kind):
    states, _, tg = _both(kind)
    st = torch.from_numpy(states)
    K = st.shape[0]
    blocks, rhs = tp._factor_blocks(st, tg)
    b, diag, E, _, _ = tp._sparse_local(st, tg, tp.incidence(tg, K), 0.0)
    old = _old_sparse(st, tg, blocks, rhs)
    mag = _old_sparse(st, tg, blocks.abs(), rhs.abs())
    for g, w, m in zip((b, diag, E), old, mag):
        _within_ulps(g, w, m)
    assert not bool(E[K - 1].any())


@pytest.mark.parametrize("kind", KINDS)
def test_offdiag_product_matches_jax_and_index_add(kind):
    states, jg, tg = _both(kind)
    st = torch.from_numpy(states)
    K = st.shape[0]
    rng = np.random.default_rng(11)
    v = rng.normal(size=(K, 6)).astype(np.float32)
    blocks, _ = tp._factor_blocks(st, tg)
    off_ij, off_ji = blocks[:, 1], blocks[:, 2]
    got = tp._offdiag(torch.from_numpy(v), tg, tp.incidence(tg, K), off_ij, off_ji)
    jb, _ = jax.jit(jp._factor_blocks)(jnp.asarray(states), jg)
    want = _jax_offdiag(jnp.asarray(v), jg, jb[:, 1], jb[:, 2])
    _close(got.numpy(), want)
    bi, bj = tg.idx_i, tg.idx_j
    vt = torch.from_numpy(v)
    pij = torch.einsum("fab,fb->fa", off_ij, vt[bj])
    pji = torch.einsum("fab,fb->fa", off_ji, vt[bi])
    old = torch.zeros_like(vt).index_add_(0, bi, pij).index_add_(0, bj, pji)
    mag = torch.zeros_like(vt).index_add_(0, bi, pij.abs()).index_add_(0, bj, pji.abs())
    _within_ulps(got, old, mag)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dense", [True, False])
def test_solves_match_jax(kind, dense):
    """The whole solve on each graph, against the JAX package's."""
    states, jg, tg = _both(kind)
    if dense:
        got = tp.optimize_poses(states, tg, 5, device="cpu")
        want = jp.optimize_poses(jnp.asarray(states), jg, 5)
    else:
        got = tp.optimize_poses_sparse(states, tg, 5, 30, device="cpu")
        want = jp.optimize_poses_sparse(jnp.asarray(states), jg, 5, 30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_incidence_layout(kind):
    """Every piece is named once, in factor order within a row; the pad
    fills the rest; a pose with no factor has only pads."""
    _, _, tg = _both(kind)
    K, F = 9, tg.idx_i.shape[0]
    inc = tp.incidence(tg, K)
    ends = inc.ends.numpy()
    named = np.sort(ends[ends < 2 * F])
    assert np.array_equal(named, np.arange(2 * F))
    for row in ends:
        real = row[row < 2 * F]
        assert np.array_equal(real, np.sort(real)) and (row[len(real):] == 2 * F).all()
    pairs = inc.pairs.numpy()
    assert np.array_equal(np.sort(pairs[pairs < 4 * F]), np.arange(4 * F))
    keys = inc.pair_r.numpy() * K + inc.pair_c.numpy()
    assert np.array_equal(keys, np.unique(keys))
    consec = np.flatnonzero(tg.idx_j.numpy() == tg.idx_i.numpy() + 1)
    chain = inc.chain.numpy()
    assert np.array_equal(np.sort(chain[chain < F]), consec)
    if kind == "isolated":
        assert (ends[K - 1] == 2 * F).all() and (chain[K - 1] == F).all()
        assert not ((inc.pair_r == K - 1) | (inc.pair_c == K - 1)).any()


@pytest.mark.parametrize("pads", [1, 3])
def test_padding_slot_adds_exactly_zero(pads):
    rng = np.random.default_rng(3)
    stack = torch.from_numpy(rng.normal(size=(7, 6, 6)).astype(np.float32) * 1e3)
    stack[2] = -0.0
    slots = torch.tensor([[k] + [7] * pads for k in range(7)])
    got = tp._gather_sum([stack], slots)
    assert torch.equal(got, stack)
    two = torch.tensor([[4, 1] + [7] * pads])
    assert torch.equal(tp._gather_sum([stack[:3], stack[3:]], two)[0], stack[4] + stack[1])


def _scan(seed: int, n_beams=16, n_azimuth=256):
    return simulate_scan(seed=seed, n_beams=n_beams, n_azimuth=n_azimuth).astype(np.float32)


@pytest.mark.parametrize("cfg", [
    ICETConfig(n_theta=25, n_phi=8, radial_mode="fixed", n_shells=20, moment_method="segsum"),
    ICETConfig(n_theta=25, n_phi=8, moment_method="segsum"),
    ICETConfig(n_theta=250, n_phi=24, moment_method="segsum"),
], ids=["fixed", "segsum", "large-adaptive"])
def test_plain_route_cpu_unchanged(cfg):
    """On the CPU the plain route is still ``fused_moment_sums_reference``
    (its ``index_add_``), bit for bit, and so is the fused route, which
    fixed radial mode and the large adaptive grid take at ``"auto"``."""
    assert moment_route(cfg) == "plain"
    auto = cfg.replace(moment_method="auto")
    assert moment_route(auto) == "fused"
    ref, pts = (torch.from_numpy(_scan(s)) for s in (1, 2))
    model = prepare_reference(ref, cfg)
    X = torch.tensor([0.3, -0.1, 0.02, 0.01, -0.005, 0.03])
    got = _moment_sums(pts, X, model.bounds, model.anchors, cfg)
    want = fused_moment_sums_reference(pts, X, model.bounds, model.anchors, cfg)
    assert torch.equal(got, want)
    assert torch.equal(_moment_sums(pts, X, model.bounds, model.anchors, auto), got)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025, 65_536, 131_072, 200_000])
@pytest.mark.parametrize("n_voxels", [1800, tsc.SHARED_ROWS - 1, 90_000])
def test_part_plan(n, n_voxels):
    """One part a block with a shared table; otherwise parts of at most
    SORT_POINTS points covering every point, one block's sort each; the
    scratch holds every part's rows, bitmap and prefixes, and a block's
    shared memory fits Hopper's."""
    blocks, per_block, shared = tsc.launch_plan(n, n_voxels, 132)
    chunk, parts, cap = tsc.part_plan(n, n_voxels, blocks, per_block, shared)
    assert chunk * parts >= n and cap >= 1 and cap <= n_voxels + 1
    if shared:
        assert parts == blocks and chunk == per_block
    else:
        assert 1 <= chunk <= tsc.SORT_POINTS and (parts - 1) * chunk < max(n, 1)
        assert cap >= min(chunk, n_voxels + 1)
    words = tsc.bitmap_words(n_voxels)
    assert tsc.scratch_words(parts, cap, n_voxels) == parts * (cap * 16 + 2 * words)
    assert tsc.shared_bytes(n_voxels, shared) <= tsc.MAX_SHARED_BYTES
