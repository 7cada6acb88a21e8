"""Batched small symmetric eigensolvers (Jacobi), as in
``icet_tpu/ops/linalg.py``.

The schedules are the JAX package's, rotation for rotation: cyclic for odd
n, round-robin (n/2 disjoint rotations combined per round) for even n.  The
solver's axis masks read the eigenbasis columns, so another eigensolver
could order or sign axes differently on repeated eigenvalues.
"""

from __future__ import annotations

import functools

import torch


def small_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched tiny-matrix product as a broadcast multiply-reduce."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _jacobi_pairs(n: int):
    return [(p, q) for p in range(n - 1) for q in range(p + 1, n)]


def _round_robin_rounds(n: int):
    """n-1 rounds of n/2 disjoint pairs (circle method)."""
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append(
            [tuple(sorted((players[i], players[n - 1 - i]))) for i in range(n // 2)]
        )
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


def _sorted(A: torch.Tensor, V: torch.Tensor):
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.take_along_dim(w, order, dim=-1)
    V = torch.take_along_dim(V, order[..., None, :], dim=-1)
    return w, V


def eigh_small(A: torch.Tensor, sweeps: int = 8):
    """Eigendecomposition of batched small symmetric matrices ``(..., n, n)``.

    Returns ``(w, V)``: eigenvalues ascending ``(..., n)`` and orthonormal
    eigenvectors as COLUMNS of ``V``.
    """
    n = A.shape[-1]
    A = 0.5 * (A + torch.swapaxes(A, -1, -2))
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    if n % 2 == 0:
        return _eigh_parallel(A, V, n, sweeps)

    pairs = _jacobi_pairs(n)
    for _ in range(sweeps):
        for p, q in pairs:
            apq = A[..., p, q]
            app = A[..., p, p]
            aqq = A[..., q, q]
            ang = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c = torch.cos(ang)[..., None]
            s = torch.sin(ang)[..., None]
            row_p = c * A[..., p, :] - s * A[..., q, :]
            row_q = s * A[..., p, :] + c * A[..., q, :]
            A = A.clone()
            A[..., p, :] = row_p
            A[..., q, :] = row_q
            col_p = c * A[..., :, p] - s * A[..., :, q]
            col_q = s * A[..., :, p] + c * A[..., :, q]
            A[..., :, p] = col_p
            A[..., :, q] = col_q
            v_p = c * V[..., :, p] - s * V[..., :, q]
            v_q = s * V[..., :, p] + c * V[..., :, q]
            V = V.clone()
            V[..., :, p] = v_p
            V[..., :, q] = v_q
    return _sorted(A, V)


@functools.lru_cache(maxsize=None)
def _round_robin_plan(n: int, dtype: torch.dtype, device: torch.device):
    """Per round of :func:`_round_robin_rounds`: the rotation pairs' p and q,
    each index's pair, and the sign pattern of G, as tensors on ``device``.
    Built once per ``(n, dtype, device)``: each is a host-to-device copy,
    which a CUDA graph cannot capture."""
    plan = []
    for rnd in _round_robin_rounds(n):
        pair_of = [0] * n
        sign = [[0.0] * n for _ in range(n)]
        for k, (p, q) in enumerate(rnd):
            pair_of[p] = pair_of[q] = k
            sign[p][q] = 1.0
            sign[q][p] = -1.0
        plan.append((
            torch.tensor([p for p, _ in rnd], device=device),
            torch.tensor([q for _, q in rnd], device=device),
            torch.tensor(pair_of, device=device),
            torch.tensor(sign, dtype=dtype, device=device),
        ))
    return tuple(plan)


def _eigh_parallel(A, V, n, sweeps):
    """Round-robin Jacobi for even n: each round's n/2 disjoint rotations
    form ONE orthogonal matrix G, applied as ``G^T A G``."""
    dev, dt = A.device, A.dtype
    eye = torch.eye(n, dtype=dt, device=dev)
    plan = _round_robin_plan(n, dt, dev)
    for _ in range(sweeps):
        for p, q, pair_of, sign in plan:
            app = A[..., p, p]
            aqq = A[..., q, q]
            apq = A[..., p, q]
            ang = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c_row = torch.cos(ang)[..., pair_of]
            s_row = torch.sin(ang)[..., pair_of]
            G = eye * c_row[..., None, :] + sign * s_row[..., None, :]
            A = torch.swapaxes(G, -1, -2) @ A @ G
            V = V @ G
    return _sorted(A, V)


def eigh_small_warm(A: torch.Tensor, V0: torch.Tensor, sweeps: int = 3):
    """Jacobi from the prior eigenbasis ``V0``: a few polishing sweeps of
    ``V0^T A V0``."""
    A0 = torch.swapaxes(V0, -1, -2) @ A @ V0
    w, V1 = eigh_small(A0, sweeps)
    return w, V0 @ V1


def eigh_small_warm_safe(A: torch.Tensor, V0: torch.Tensor, rtol: float = 1e-5):
    """One warm sweep from ``V0``, and a second one where the first leaves
    off-diagonal mass above ``rtol * ||diag||``.  Both sweeps are computed
    and ``torch.where`` selects on the device flag (the JAX package's
    ``lax.cond``): the same values as the branch, and no host read."""
    A0 = torch.swapaxes(V0, -1, -2) @ A @ V0
    w1, V1 = eigh_small(A0, sweeps=1)
    R = torch.swapaxes(V1, -1, -2) @ A0 @ V1
    dg = torch.diagonal(R, dim1=-2, dim2=-1)
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    off = torch.linalg.norm(R - dg[..., None] * eye)
    converged = off <= rtol * torch.clamp(torch.linalg.norm(dg), min=1e-30)
    w2, V2 = eigh_small(R, sweeps=1)
    return (torch.where(converged, w1, w2),
            torch.where(converged, V0 @ V1, V0 @ (V1 @ V2)))


def inverse_where(w: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """``1 / w`` where ``ok``, 0 elsewhere (no division by the others)."""
    return torch.where(ok, 1.0 / torch.where(ok, w, torch.ones_like(w)),
                       torch.zeros_like(w))


def psd_pinv(A: torch.Tensor, rcond: float = 1e-7, sweeps: int = 8) -> torch.Tensor:
    """Pseudo-inverse of batched small symmetric PSD matrices: eigenvalues
    below ``rcond * max |w|`` (or 1e-12) are truncated to zero."""
    w, V = eigh_small(A, sweeps)
    wmax = torch.amax(torch.abs(w), dim=-1, keepdim=True)
    keep = torch.abs(w) > torch.clamp(rcond * wmax, min=1e-12)
    inv_w = inverse_where(w, keep)
    return small_matmul(V * inv_w[..., None, :], torch.swapaxes(V, -1, -2))
