"""Pose-graph back end (``icet_tpu/pose_graph.py``): Gauss-Newton refinement
of a trajectory from relative-pose factors, and loop closure.

Factors are relative-pose measurements in the solver's convention (``p_i =
R(-angs) p_j + t`` for a measurement X_ij between poses i and j), weighted
by 6x6 information matrices: ``psd_pinv(res.Q)`` of a registration puts
ICET's own predicted covariance to work.  Every residual and Jacobian is
evaluated as one batch (``torch.func.vmap`` of ``jacfwd``), in float32.

* :func:`optimize_poses`: dense Gauss-Newton, the (6K, 6K) normals and
  their Cholesky (library calls, as the JAX package leaves them to XLA).
* :func:`optimize_poses_sparse`: block-sparse Gauss-Newton with
  preconditioned conjugate gradients, never densifying the normals.  The
  "tridiag" preconditioner solves the odometry backbone exactly with the
  CUDA kernels of ``ops/tridiag.py`` on the card; "jacobi" is one batched
  6x6 Cholesky.  Fixed iteration counts, no read back to the host inside.
* :func:`close_loops` verifies loop candidates by registration, in chunks
  of ``batch`` pairs.

Both solves are the JAX package's jitted programs as captured stages
(``icet_tpu_torch.graphs``): on CUDA the dense Gauss-Newton step, or the
sparse solve's assembly, one CG iteration and the update, are CUDA graphs
captured once per ``(device, K, F, cg_iters, precond, robust)`` and
replayed; on the CPU the stages run as plain calls on the same buffers.
They equal :func:`optimize_poses_eager` and
:func:`optimize_poses_sparse_eager`, the plain loops, bit for bit.
:func:`close_loops` registers each pair through
``solver.register_pair_jit`` where ``solver.compiled_route(cfg)`` holds.

* :func:`optimize_poses_sharded` and :func:`optimize_poses_sparse_sharded`
  shard the factors over a mesh's first axis (``icet_tpu_torch.parallel``).

Entry points run on CUDA unless given ``device="cpu"``; the sharded ones
run on their mesh's devices.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from icet_tpu_torch import graphs
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.device import as_points, resolve_device
from icet_tpu_torch.ops.geometry import _homogeneous_row, pose_matrix, pose_to_state
from icet_tpu_torch.ops.linalg import psd_pinv
from icet_tpu_torch.ops.tridiag import cholesky, tridiag_apply, tridiag_factor
from icet_tpu_torch.solver import (  # noqa: F401 (prepare_reference, register: re-exported)
    compiled_route,
    prepare_reference,
    register,
    register_pair_impl,
    register_pair_jit,
)


class PoseGraph(NamedTuple):
    #: (F,) int64 indices of the "from" pose of each factor
    idx_i: torch.Tensor
    #: (F,) int64 indices of the "to" pose
    idx_j: torch.Tensor
    #: (F, 6) measured relative states X_ij
    meas: torch.Tensor
    #: (F, 6, 6) information (inverse covariance) of each measurement
    info: torch.Tensor

    def to(self, device) -> "PoseGraph":
        """The graph on ``device``: indices int64, the rest float32."""
        return PoseGraph(
            idx_i=torch.as_tensor(self.idx_i).to(device=device, dtype=torch.int64),
            idx_j=torch.as_tensor(self.idx_j).to(device=device, dtype=torch.int64),
            meas=torch.as_tensor(self.meas).to(device=device, dtype=torch.float32),
            info=torch.as_tensor(self.info).to(device=device, dtype=torch.float32),
        )


def _inv_pose(T: torch.Tensor) -> torch.Tensor:
    """Rigid inverse ``[R^T | -R^T t]`` of a 4x4 pose."""
    R = T[:3, :3]
    t = T[:3, 3]
    top = torch.cat([R.T, -(R.T @ t)[:, None]], dim=1)
    return torch.cat([top, _homogeneous_row(T.dtype, T.device)], dim=0)


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def _factor_residual(x_i: torch.Tensor, x_j: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
    """6-DOF residual of one relative-pose factor: the state of ``T_i^-1
    T_j`` minus the measurement, angles wrapped to [-pi, pi)."""
    rel = _inv_pose(pose_matrix(x_i)) @ pose_matrix(x_j)
    r = pose_to_state(rel) - meas
    return torch.cat([r[:3], _wrap(r[3:])])


def _factor_blocks(states: torch.Tensor, graph: PoseGraph):
    """Per-factor normal-equation pieces, batched over the factors:
    ``blocks (F, 4, 6, 6)`` (the ii, ij, ji, jj blocks) and ``rhs (F, 2,
    6)`` (the i and j gradient pieces)."""

    def one(xi, xj, meas, info):
        r = _factor_residual(xi, xj, meas)
        # Forward mode promotes a tangent to float64 on a division by a
        # Python float; the products are taken in float32.
        Ji, Jj = (J.to(xi.dtype) for J in
                  torch.func.jacfwd(_factor_residual, argnums=(0, 1))(xi, xj, meas))
        WJi = info @ Ji
        WJj = info @ Jj
        blocks = torch.stack([Ji.T @ WJi, Ji.T @ WJj, Jj.T @ WJi, Jj.T @ WJj])
        Wr = info @ r
        rhs = torch.stack([Ji.T @ Wr, Jj.T @ Wr])
        return blocks, rhs

    return torch.func.vmap(one)(
        states[graph.idx_i], states[graph.idx_j], graph.meas, graph.info
    )


def _build_normals(states: torch.Tensor, graph: PoseGraph, prior_weight: float):
    """The dense (6K, 6K) Gauss-Newton normals and the (6K,) gradient, with
    the gauge prior pinning pose 0."""
    K = states.shape[0]
    blocks, rhs = _factor_blocks(states, graph)
    bi, bj = graph.idx_i, graph.idx_j
    H = states.new_zeros((K, K, 6, 6))
    H.index_put_((bi, bi), blocks[:, 0], accumulate=True)
    H.index_put_((bi, bj), blocks[:, 1], accumulate=True)
    H.index_put_((bj, bi), blocks[:, 2], accumulate=True)
    H.index_put_((bj, bj), blocks[:, 3], accumulate=True)
    b = states.new_zeros((K, 6)).index_add_(0, bi, rhs[:, 0]).index_add_(0, bj, rhs[:, 1])
    H[0, 0] += prior_weight * torch.eye(6, dtype=states.dtype, device=states.device)
    return H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K), b.reshape(6 * K)


def _on_device(states0, graph: PoseGraph, device):
    dev = resolve_device(device)
    states = torch.as_tensor(states0).to(device=dev, dtype=torch.float32)
    return states, graph.to(dev)


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """cuSOLVER for the Cholesky factorisations and solves inside, on CUDA
    (restored after): MAGMA's read the device on the host, which a CUDA
    graph cannot capture.  The default backend picks cuSOLVER for these
    calls; a caller's global ``preferred_linalg_library("magma")`` would
    otherwise make the dense solve's capture raise."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def _dense_step(states, graph: PoseGraph, damping, prior_weight) -> torch.Tensor:
    """One dense Gauss-Newton step: the normals, the damping, the Cholesky
    solve.  ``damping`` and ``prior_weight`` are floats or 0-dim tensors."""
    K = states.shape[0]
    H, b = _build_normals(states, graph, prior_weight)
    eye = torch.eye(6 * K, dtype=states.dtype, device=states.device)
    H = H + damping * torch.trace(H) / (6 * K) * eye
    dx = torch.cholesky_solve(-b[:, None], cholesky(H))[:, 0]
    return states + dx.reshape(K, 6)


def optimize_poses_eager(
    states0,
    graph: PoseGraph,
    n_iters: int = 10,
    damping: float = 1e-6,
    prior_weight: float = 1e8,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """:func:`optimize_poses` as a plain loop of :func:`_dense_step` calls
    (the plain version the compiled solve is held to)."""
    states, graph = _on_device(states0, graph, device)
    for _ in range(n_iters):
        states = _dense_step(states, graph, damping, prior_weight)
    return states


def _pose_set(states, graph: PoseGraph, cg_iters: int, precond: str, robust_delta: float,
              damping: float, prior_weight: float) -> graphs.PoseGraphs:
    """The graph set of this solve's shapes and options, with the states,
    the factors, ``damping`` and ``prior_weight`` copied into its buffers."""
    pg = graphs.pose_graphs(states.device, states.shape[0], graph.idx_i.shape[0], cg_iters,
                            precond, float(robust_delta))
    b = pg.buffers
    graphs.copy_in(b.states, states)
    for dst, t in zip(b.factors, graph):
        graphs.copy_in(dst, t)
    graphs.copy_in(b.damping, damping)
    graphs.copy_in(b.prior_weight, prior_weight)
    return pg


def _stage_dense(b) -> None:
    """One dense Gauss-Newton step of the states buffer, in place."""
    with _cusolver(b.states.device):
        b.states.copy_(_dense_step(b.states, PoseGraph(*b.factors), b.damping,
                                   b.prior_weight))


def optimize_poses(
    states0,
    graph: PoseGraph,
    n_iters: int = 10,
    damping: float = 1e-6,
    prior_weight: float = 1e8,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Dense Gauss-Newton refinement of ``(K, 6)`` pose states (numpy or a
    tensor) from relative factors, on ``device`` (CUDA unless told
    otherwise).  Returns the refined ``(K, 6)`` states; pose 0 is
    gauge-fixed by a prior of ``prior_weight``.

    The JAX package's jitted program as one captured graph a Gauss-Newton
    step, replayed ``n_iters`` times (on the CPU, plain calls on the same
    buffers); equal to :func:`optimize_poses_eager` bit for bit."""
    states, graph = _on_device(states0, graph, device)
    pg = _pose_set(states, graph, 0, "dense", 0.0, damping, prior_weight)
    for _ in range(n_iters):
        pg.run(("step",), _stage_dense)
    return graphs.clone_out(pg.buffers.states)


def _sparse_local(states, graph, robust_delta):
    """One factor set's share of the block-sparse normals: the gradient
    ``b (K, 6)``, the diagonal blocks ``(K, 6, 6)`` (no prior), the
    backbone's super-diagonal blocks ``(K, 6, 6)`` (row K-1 takes the
    non-consecutive factors and is dropped later) and each factor's
    off-diagonal blocks ``off_ij, off_ji (F, 6, 6)``."""
    K = states.shape[0]
    if robust_delta > 0.0:
        # Cauchy IRLS: factor weight 1 / (1 + chi2 / delta^2), from the
        # original information at the current states (a redescending
        # kernel: a grossly wrong loop factor is switched off).
        r = torch.func.vmap(_factor_residual)(
            states[graph.idx_i], states[graph.idx_j], graph.meas
        )
        chi2 = torch.einsum("fa,fab,fb->f", r, graph.info, r)
        w = 1.0 / (1.0 + chi2 / robust_delta**2)
        graph = graph._replace(info=graph.info * w[:, None, None])
    blocks, rhs = _factor_blocks(states, graph)
    bi, bj = graph.idx_i, graph.idx_j

    b = states.new_zeros((K, 6)).index_add_(0, bi, rhs[:, 0]).index_add_(0, bj, rhs[:, 1])
    diag = states.new_zeros((K, 6, 6)).index_add_(0, bi, blocks[:, 0]).index_add_(
        0, bj, blocks[:, 3])
    # Consecutive factors form the backbone; the others go to a dropped row.
    consec = bj == bi + 1
    sent = torch.where(consec, bi, K - 1)
    E = states.new_zeros((K, 6, 6)).index_add_(
        0, sent, torch.where(consec[:, None, None], blocks[:, 1], 0.0))
    return b, diag, E, blocks[:, 1], blocks[:, 2]


def _sparse_normals(states, graph, prior_weight, damping, robust_delta=0.0, axis=None):
    """The block-sparse normal equations at ``states``: the gradient ``b
    (K, 6)``, the damped diagonal blocks ``diag_d (K, 6, 6)``, the
    off-diagonal blocks of each factor ``off_ij, off_ji (F, 6, 6)`` and the
    backbone's super-diagonal blocks ``E (K-1, 6, 6)`` (the consecutive
    factors' ij blocks).

    Under a factor ``axis``, ``graph`` is the list of local factor shards:
    ``b``, the diagonal and ``E`` are summed over the axis in one ``(K,
    78)`` collective, and ``off_ij``, ``off_ji`` are lists over the shards."""
    K = states.shape[0]
    eye6 = torch.eye(6, dtype=states.dtype, device=states.device)
    if axis is None:
        b, diag, E, off_ij, off_ji = _sparse_local(states, graph, robust_delta)
    else:
        parts = [_sparse_local(states.to(g.meas.device), g, robust_delta) for g in graph]
        packed = axis.psum([torch.cat([p[0], p[1].reshape(K, 36), p[2].reshape(K, 36)], 1)
                            for p in parts])
        b, diag, E = (packed[:, :6], packed[:, 6:42].reshape(K, 6, 6).contiguous(),
                      packed[:, 42:].reshape(K, 6, 6))
        off_ij, off_ji = [p[3] for p in parts], [p[4] for p in parts]
    diag[0] += prior_weight * eye6
    # The dense path's damping scale: damping * trace(H) / (6K).
    scale = damping * torch.diagonal(diag, dim1=-2, dim2=-1).sum() / (6 * K)
    diag_d = diag + scale * eye6
    return b, diag_d.contiguous(), off_ij, off_ji, E[: K - 1].contiguous()


def _offdiag(v, graph, off_ij, off_ji):
    """One factor set's off-diagonal product ``H_off v``."""
    bi, bj = graph.idx_i, graph.idx_j
    off = torch.zeros_like(v)
    off.index_add_(0, bi, torch.einsum("fab,fb->fa", off_ij, v[bj]))
    off.index_add_(0, bj, torch.einsum("fab,fb->fa", off_ji, v[bi]))
    return off


#: the sparse solve's preconditioners
PRECONDITIONERS = ("tridiag", "jacobi")


def _sparse_system(states, graph, prior_weight, damping, precond_kind, robust_delta=0.0,
                   axis=None):
    """The block-sparse normals at ``states`` and the preconditioner's
    factor: ``(b, diag_d, off_ij, off_ji, factor)``, ``factor`` the
    backbone's ``(S_inv, U)`` ("tridiag": the odometry backbone solved
    exactly leaves CG only the loop couplings, tens of iterations instead
    of hundreds) or the diagonal blocks' Cholesky factors ``(L,)``
    ("jacobi")."""
    b, diag_d, off_ij, off_ji, E = _sparse_normals(states, graph, prior_weight, damping,
                                                   robust_delta, axis)
    if precond_kind == "tridiag":
        factor = tridiag_factor(diag_d, E)
    elif precond_kind == "jacobi":
        # Row-major, as the buffer a captured solve keeps it in: the
        # triangular solves round by the factor's memory layout.
        factor = (cholesky(diag_d).contiguous(),)
    else:
        raise ValueError(f"unknown preconditioner {precond_kind!r}")
    return b, diag_d, off_ij, off_ji, factor


def _make_matvec(graph, diag_d, off_ij, off_ji, axis=None):
    """``v -> H v`` applied factor by factor.  Under a factor ``axis``
    (``graph`` the local shards) the shards' off-diagonal products are
    summed in one ``(K, 6)`` collective."""
    if axis is None:
        def matvec(v):
            return torch.einsum("kab,kb->ka", diag_d, v) + _offdiag(v, graph, off_ij, off_ji)
    else:
        def matvec(v):
            off = axis.psum([_offdiag(v.to(g.meas.device), g, oij, oji)
                             for g, oij, oji in zip(graph, off_ij, off_ji)])
            return torch.einsum("kab,kb->ka", diag_d, v) + off
    return matvec


def _make_precond(precond_kind, factor):
    """``r -> M^-1 r`` of the preconditioner's factor."""
    if precond_kind == "tridiag":
        S_inv, U = factor

        def precond(r):
            return tridiag_apply(S_inv, U, r.contiguous())

    else:
        (chol,) = factor

        def precond(r):
            y = torch.linalg.solve_triangular(chol, r[..., None], upper=False)
            return torch.linalg.solve_triangular(chol.transpose(-1, -2), y, upper=True)[..., 0]

    return precond


def _cg_start(b, precond):
    """The CG state ``(x, r, p, rz)`` from x = 0 for ``H x = -b``."""
    r = -b
    z = precond(r)
    return torch.zeros_like(b), r, z, torch.sum(r * z)


def _cg_step(x, r, p, rz, matvec, precond):
    """One preconditioned CG iteration: the next ``(x, r, p, rz)``."""
    Hp = matvec(p)
    alpha = rz / torch.clamp(torch.sum(p * Hp), min=1e-30)
    x = x + alpha * p
    r = r - alpha * Hp
    z = precond(r)
    rz_new = torch.sum(r * z)
    beta = rz_new / torch.clamp(rz, min=1e-30)
    return x, r, z + beta * p, rz_new


def _sparse_gn_step(states, graph, prior_weight, damping, cg_iters,
                    precond_kind="tridiag", robust_delta=0.0, axis=None):
    """One Gauss-Newton step without densifying H: the system is applied
    factor by factor (block-sparse matvec) and solved by ``cg_iters``
    preconditioned CG iterations.  Returns the updated states.  Under a
    factor ``axis`` (``graph`` the local shards), each matvec sums the
    shards' off-diagonal products in one ``(K, 6)`` collective; the CG
    state and the backbone factor are replicated."""
    b, diag_d, off_ij, off_ji, factor = _sparse_system(states, graph, prior_weight, damping,
                                                       precond_kind, robust_delta, axis)
    matvec = _make_matvec(graph, diag_d, off_ij, off_ji, axis)
    precond = _make_precond(precond_kind, factor)
    x, r, p, rz = _cg_start(b, precond)
    for _ in range(cg_iters):
        x, r, p, rz = _cg_step(x, r, p, rz, matvec, precond)
    return states + x


def optimize_poses_sparse_eager(
    states0,
    graph: PoseGraph,
    n_iters: int = 10,
    cg_iters: int = 100,
    damping: float = 1e-6,
    prior_weight: float = 1e8,
    precond: str = "tridiag",
    robust_delta: float = 0.0,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """:func:`optimize_poses_sparse` as a plain loop of Gauss-Newton steps
    (the plain version the compiled solve is held to)."""
    states, graph = _on_device(states0, graph, device)
    for _ in range(n_iters):
        states = _sparse_gn_step(states, graph, prior_weight, damping, cg_iters,
                                 precond, robust_delta)
    return states


def _copy_all(dsts, srcs) -> None:
    for dst, t in zip(dsts, srcs):
        dst.copy_(t)


def _stage_assemble(b, precond_kind: str, robust_delta: float) -> None:
    """The normals at the states buffer, the preconditioner's factor and
    the CG start, into the buffers."""
    with _cusolver(b.states.device):
        rhs, diag_d, off_ij, off_ji, factor = _sparse_system(
            b.states, PoseGraph(*b.factors), b.prior_weight, b.damping, precond_kind,
            robust_delta)
    _copy_all((b.diag_d, b.off_ij, b.off_ji, *b.factor), (diag_d, off_ij, off_ji, *factor))
    _copy_all((b.x, b.r, b.p, b.rz), _cg_start(rhs, _make_precond(precond_kind, factor)))


def _stage_cg(b, precond_kind: str) -> None:
    """One CG iteration of the buffers' state."""
    matvec = _make_matvec(PoseGraph(*b.factors), b.diag_d, b.off_ij, b.off_ji)
    _copy_all((b.x, b.r, b.p, b.rz),
              _cg_step(b.x, b.r, b.p, b.rz, matvec, _make_precond(precond_kind, b.factor)))


def _stage_update(b) -> None:
    b.states.copy_(b.states + b.x)


def optimize_poses_sparse(
    states0,
    graph: PoseGraph,
    n_iters: int = 10,
    cg_iters: int = 100,
    damping: float = 1e-6,
    prior_weight: float = 1e8,
    precond: str = "tridiag",
    robust_delta: float = 0.0,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Block-sparse Gauss-Newton refinement with a PCG inner solver, on
    ``device`` (CUDA unless told otherwise): :func:`optimize_poses`'s
    result without the dense system.

    ``precond``: "tridiag" solves the odometry backbone exactly at each CG
    application (one factor launch a step and one apply launch a CG
    iteration on the card); "jacobi" is block-diagonal.  ``robust_delta >
    0`` reweights each factor by the Cauchy weight ``1 / (1 + chi2 /
    robust_delta**2)`` every step.

    The JAX package's jitted program as three captured graphs, replayed
    ``n_iters x (1 + cg_iters + 1)`` times: the assembly (normals, the
    backbone's factor, the CG start), one CG iteration and the update (on
    the CPU, plain calls on the same buffers); equal to
    :func:`optimize_poses_sparse_eager` bit for bit."""
    if precond not in PRECONDITIONERS:
        raise ValueError(f"unknown preconditioner {precond!r}")
    states, graph = _on_device(states0, graph, device)
    pg = _pose_set(states, graph, cg_iters, precond, robust_delta, damping, prior_weight)

    def assemble(b):
        _stage_assemble(b, precond, robust_delta)

    def cg(b):
        _stage_cg(b, precond)

    for _ in range(n_iters):
        pg.run(("assemble",), assemble)
        for _ in range(cg_iters):
            pg.run(("cg",), cg)
        pg.run(("update",), _stage_update)
    return graphs.clone_out(pg.buffers.states)


def _pad_factors(graph: PoseGraph, n_shards: int) -> PoseGraph:
    """Pad to a multiple of the shard count with zero-information factors
    (between pose 0 and itself)."""
    F = graph.idx_i.shape[0]
    pad = (-F) % n_shards
    if not pad:
        return graph
    g = graph.to("cpu")
    return PoseGraph(
        idx_i=torch.cat([g.idx_i, torch.zeros(pad, dtype=torch.int64)]),
        idx_j=torch.cat([g.idx_j, torch.zeros(pad, dtype=torch.int64)]),
        meas=torch.cat([g.meas, torch.zeros((pad, 6))]),
        info=torch.cat([g.info, torch.zeros((pad, 6, 6))]),
    )


def _factor_shards(graph: PoseGraph, axis) -> list:
    """The axis's local factor shards: ``graph`` padded to a multiple of
    ``axis.size`` and cut into that many contiguous pieces, each of this
    process's on its shard's device."""
    graph = _pad_factors(graph.to("cpu"), axis.size)
    f = graph.idx_i.shape[0] // axis.size
    return [PoseGraph(*(t[i * f:(i + 1) * f] for t in graph)).to(d)
            for i, d in zip(axis.index, axis.shard_devices)]


def optimize_poses_sharded(
    states0,
    graph: PoseGraph,
    mesh,
    n_iters: int = 10,
    damping: float = 1e-6,
    prior_weight: float = 1e8,
) -> torch.Tensor:
    """:func:`optimize_poses` with the factors sharded over the mesh's
    first axis (an in-process ``parallel.sharding.Mesh`` or a
    ``parallel.distributed.ProcessMesh``).  Each shard assembles its
    factors' dense normals; one sum of ``(H, b)`` over the axis a GN step
    gives the whole system, solved on the axis's first device (every
    process of a process mesh solves it).  The gauge prior is added once,
    after the sum."""
    axis = mesh.axis(mesh.axis_names[0])
    shards = _factor_shards(graph, axis)
    states = torch.as_tensor(states0).to(device=axis.device, dtype=torch.float32)
    K = states.shape[0]
    eye = torch.eye(6 * K, dtype=states.dtype, device=states.device)
    for _ in range(n_iters):
        parts = [_build_normals(states.to(g.meas.device), g, 0.0) for g in shards]
        Hb = axis.psum([torch.cat([H.reshape(-1), b]) for H, b in parts])
        H, b = Hb[: 36 * K * K].reshape(6 * K, 6 * K), Hb[36 * K * K:]
        H[:6, :6] += prior_weight * eye[:6, :6]
        H = H + damping * torch.trace(H) / (6 * K) * eye
        dx = torch.cholesky_solve(-b[:, None], cholesky(H))[:, 0]
        states = states + dx.reshape(K, 6)
    return states


def optimize_poses_sparse_sharded(
    states0,
    graph: PoseGraph,
    mesh,
    n_iters: int = 10,
    cg_iters: int = 50,
    damping: float = 1e-6,
    prior_weight: float = 1e8,
    robust_delta: float = 0.0,
) -> torch.Tensor:
    """:func:`optimize_poses_sparse` (the "tridiag" preconditioner) with the
    factors sharded over the mesh's first axis: one ``(K, 78)`` sum of the
    gradient, diagonal and backbone blocks a GN step and one ``(K, 6)`` sum
    a CG matvec.  The CG state and the backbone kernels run replicated, on
    the axis's first device."""
    axis = mesh.axis(mesh.axis_names[0])
    shards = _factor_shards(graph, axis)
    states = torch.as_tensor(states0).to(device=axis.device, dtype=torch.float32)
    for _ in range(n_iters):
        states = _sparse_gn_step(states, shards, prior_weight, damping, cg_iters,
                                 "tridiag", robust_delta, axis)
    return states


def states_to_poses(states) -> np.ndarray:
    """``(K, 6)`` states -> ``(K, 4, 4)`` float32 pose matrices (numpy)."""
    s = torch.as_tensor(np.asarray(_host(states), np.float32))
    return torch.func.vmap(pose_matrix)(s).numpy()


def poses_to_states(poses) -> np.ndarray:
    """``(K, 4, 4)`` pose matrices -> ``(K, 6)`` float32 states (numpy)."""
    return pose_to_state(torch.as_tensor(np.asarray(_host(poses), np.float32))).numpy()


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


# ---------------------------------------------------------------------------
# Graph construction from odometry + loop closures
# ---------------------------------------------------------------------------


def graph_from_odometry(frames, loop_factors=()) -> tuple[np.ndarray, PoseGraph]:
    """Initial states and a factor graph from an odometry run.

    ``frames``: the port's ``OdometryFrame`` records; consecutive factors
    take each frame's X and a diagonal information from its pred_stds
    (floored at 1e-4; at 1e3 on a diverged frame, whose X the guard zeroed).
    ``loop_factors``: ``(i, j, X_ij (6,), info (6, 6))``.  Returns ``(states0
    (K, 6) numpy, PoseGraph on the CPU)``; pose 0 is the first scan."""
    poses = [np.eye(4, dtype=np.float32)] + [f.T_world for f in frames]
    states0 = poses_to_states(np.stack(poses)).astype(np.float32)

    idx_i, idx_j, meas, info = [], [], [], []
    for k, f in enumerate(frames):
        idx_i.append(k)
        idx_j.append(k + 1)
        meas.append(f.X)
        stds = np.maximum(np.asarray(f.pred_stds), 1e-4)
        if getattr(f, "diverged", False):
            stds = np.maximum(stds, 1e3)
        info.append(np.diag(1.0 / stds**2))
    for (i, j, x_ij, w) in loop_factors:
        idx_i.append(i)
        idx_j.append(j)
        meas.append(np.asarray(x_ij))
        info.append(np.asarray(w))

    graph = PoseGraph(
        idx_i=torch.as_tensor(np.asarray(idx_i, np.int64)),
        idx_j=torch.as_tensor(np.asarray(idx_j, np.int64)),
        meas=torch.as_tensor(np.stack(meas).astype(np.float32)),
        info=torch.as_tensor(np.stack(info).astype(np.float32)),
    )
    return states0, graph


def detect_loop_candidates(
    positions: np.ndarray,
    radius: float = 3.0,
    min_gap: int = 10,
    k: int = 1,
) -> list[tuple[int, int]]:
    """Index pairs whose poses are near in space (``< radius``) but far in
    time (``j >= i + min_gap``): loop candidates to verify by registration.
    Up to ``k`` nearest candidates per ``i``, sorted by ``(i, distance)``.

    A vectorised spatial hash (numpy, a copy of the JAX package's): cells of
    side ``radius``, every pose's neighbours in the 3^d adjacent cells
    enumerated at once; O(n + P) for P pairs within the radius."""
    positions = np.asarray(positions, np.float64)
    n, d = positions.shape
    if n == 0:
        return []
    cells = np.floor(positions / radius).astype(np.int64)
    lo = cells.min(axis=0) - 1
    dims = (cells.max(axis=0) - lo + 3).astype(np.int64)  # room for +-1

    # Flatten integer cells to one sortable int64 key (row-major).
    key = cells[:, 0] - lo[0]
    for a in range(1, d):
        key = key * dims[a] + (cells[:, a] - lo[a])
    order = np.argsort(key, kind="stable")
    uniq, starts, counts = np.unique(key[order], return_index=True, return_counts=True)

    offsets = np.stack(
        np.meshgrid(*([np.arange(-1, 2)] * d), indexing="ij"), axis=-1
    ).reshape(-1, d).astype(np.int64)
    deltas = offsets[:, 0]
    for a in range(1, d):
        deltas = deltas * dims[a] + offsets[:, a]

    pair_i, pair_j = [], []
    for delta in deltas:
        nk = key + delta
        pos = np.searchsorted(uniq, nk)
        pos_c = np.minimum(pos, len(uniq) - 1)
        hit = uniq[pos_c] == nk
        cnt = np.where(hit, counts[pos_c], 0)
        total = int(cnt.sum())
        if total == 0:
            continue
        ii = np.repeat(np.arange(n), cnt)
        ends = np.cumsum(cnt)
        within = np.arange(total) - np.repeat(ends - cnt, cnt)
        jj = order[np.repeat(np.where(hit, starts[pos_c], 0), cnt) + within]
        keep = jj >= ii + min_gap  # far in time, i < j
        pair_i.append(ii[keep])
        pair_j.append(jj[keep])

    if not pair_i:
        return []
    ii = np.concatenate(pair_i)
    jj = np.concatenate(pair_j)
    if ii.size == 0:
        return []
    dist = np.linalg.norm(positions[ii] - positions[jj], axis=1)
    near = dist < radius
    ii, jj, dist = ii[near], jj[near], dist[near]
    if ii.size == 0:
        return []
    # Up to k nearest per i: sort by (i, dist), keep within-group rank < k.
    srt = np.lexsort((dist, ii))
    ii, jj = ii[srt], jj[srt]
    first = np.r_[True, ii[1:] != ii[:-1]]
    group_start = np.maximum.accumulate(np.where(first, np.arange(ii.size), 0))
    rank = np.arange(ii.size) - group_start
    sel = rank < k
    return list(zip(ii[sel].tolist(), jj[sel].tolist()))


#: a loop registration is kept when its last |dx| is at most this (m)
LOOP_DX_GATE = 0.05


def close_loops(
    scans,
    candidates: list,
    cfg: ICETConfig,
    x0_fn=None,
    batch: int = 16,
    device: str | torch.device | None = None,
) -> list:
    """Verify loop candidates ``(i, j)`` by registering scan j to scan i on
    ``device`` (CUDA unless told otherwise), warm-started at ``x0_fn(i, j)``
    (zero without it).  Returns the loop factors ``(i, j, X_ij, info)``
    (numpy) of the pairs whose last ``|dx|`` is finite and at most
    :data:`LOOP_DX_GATE`, with ``info = psd_pinv(Q)``.

    The pairs run in chunks of ``batch``, and each chunk's results are read
    back to the host once.  Where ``solver.compiled_route(cfg)`` holds each
    pair is ``solver.register_pair_jit`` without the static mask (captured
    graphs on CUDA, one set for every pair of one scan size and config),
    otherwise the eager ``register_pair_impl``.  The JAX package runs each
    chunk as one vmapped program; the port registers its pairs back to
    back.  The solve is unfiltered whatever ``cfg.dnn_filter`` says, as in
    the JAX package."""
    dev = resolve_device(device)
    if not candidates:
        return []
    pair = register_pair_jit if compiled_route(cfg) else register_pair_impl
    factors = []
    for k0 in range(0, len(candidates), batch):
        chunk = candidates[k0:k0 + batch]
        X, Q, dx = [], [], []
        for i, j in chunk:
            x0 = (np.zeros(6, np.float32) if x0_fn is None
                  else np.asarray(x0_fn(i, j), np.float32))
            res = pair(as_points(scans[i], dev), as_points(scans[j], dev),
                       torch.from_numpy(x0).to(dev), cfg, want_static_mask=False)
            X.append(res.X)
            Q.append(res.Q)
            dx.append(res.diagnostics.dx_norm[-1])
        B = len(chunk)
        host = torch.cat([torch.stack(X), psd_pinv(torch.stack(Q)).reshape(B, 36),
                          torch.stack(dx)[:, None]], 1).cpu().numpy()
        for b, (i, j) in enumerate(chunk):
            d = host[b, 42]
            if np.isfinite(d) and d <= LOOP_DX_GATE:
                factors.append((i, j, host[b, :6], host[b, 6:42].reshape(6, 6)))
    return factors
