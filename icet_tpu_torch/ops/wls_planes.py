"""Per-voxel weighted-least-squares assembly on planes: each 3x3 entry is
a (V,) tensor, as in ``icet_tpu/ops/wls_planes.py``.

  P = diag(l) U^T;  R = cov1/n1' + cov2/n2';  W = pinv(P R P^T)
  H = [-I | dR_k mu2];  Hz = P H;  HTWH = sum_v Hz^T W Hz;
  HTWdz = sum_v Hz^T W P (mu2 - mu1)
"""

from __future__ import annotations

import torch


def _rotate3(A, Vm, p, q):
    """One Jacobi rotation zeroing A[p][q] of a 3x3 plane matrix, in place
    on the lists ``A`` and ``Vm``."""
    ang = 0.5 * torch.atan2(2.0 * A[p][q], A[q][q] - A[p][p])
    c = torch.cos(ang)
    s = torch.sin(ang)
    rowp = [c * A[p][j] - s * A[q][j] for j in range(3)]
    rowq = [s * A[p][j] + c * A[q][j] for j in range(3)]
    A[p], A[q] = rowp, rowq
    for i in range(3):
        ap = c * A[i][p] - s * A[i][q]
        aq = s * A[i][p] + c * A[i][q]
        A[i][p], A[i][q] = ap, aq
        vp = c * Vm[i][p] - s * Vm[i][q]
        vq = s * Vm[i][p] + c * Vm[i][q]
        Vm[i][p], Vm[i][q] = vp, vq


def _sweep3(A, Vm):
    A = [row[:] for row in A]
    Vm = [row[:] for row in Vm]
    for p, q in ((0, 1), (0, 2), (1, 2)):
        _rotate3(A, Vm, p, q)
    return A, Vm


def _identity_planes(like):
    one = torch.ones_like(like)
    zero = torch.zeros_like(like)
    return [[one, zero, zero], [zero, one, zero], [zero, zero, one]]


def _pinv3_planes(R, rcond, sweeps=5):
    """Pseudo-inverse of symmetric 3x3s given as a 3x3 list of planes."""
    A = [[R[i][j] for j in range(3)] for i in range(3)]
    Vm = _identity_planes(A[0][0])
    for _ in range(sweeps):
        A, Vm = _sweep3(A, Vm)
    w = [A[0][0], A[1][1], A[2][2]]
    wmax = torch.maximum(torch.maximum(torch.abs(w[0]), torch.abs(w[1])), torch.abs(w[2]))
    thresh = torch.clamp(rcond * wmax, min=1e-12)
    iw = []
    for wk in w:
        safe = torch.where(torch.abs(wk) > 1e-30, wk, torch.ones_like(wk))
        iw.append(torch.where(torch.abs(wk) > thresh, 1.0 / safe, torch.zeros_like(wk)))
    return [[sum(Vm[i][k] * iw[k] * Vm[j][k] for k in range(3)) for j in range(3)]
            for i in range(3)]


_SYM6 = ((0, 3, 4), (3, 1, 5), (4, 5, 2))  # (i, j) -> packed cov6 column


def _sym_planes(cov):
    """(V, 3, 3), (V, 6) packed symmetric, or a 3x3 plane list -> planes."""
    if isinstance(cov, (list, tuple)):
        return cov
    if cov.ndim == 3:
        return [[cov[:, i, j] for j in range(3)] for i in range(3)]
    return [[cov[:, _SYM6[i][j]] for j in range(3)] for i in range(3)]


def _mat_planes(m):
    """(V, 3, 3) or a 3x3 plane list -> planes."""
    if isinstance(m, (list, tuple)):
        return m
    return [[m[:, i, j] for j in range(3)] for i in range(3)]


def _vec3_planes(v):
    """(V, 3) or a list of 3 planes -> planes."""
    if isinstance(v, (list, tuple)):
        return v
    return [v[:, j] for j in range(3)]


def _unconverged3(A, rtol):
    """Device flag: any voxel with off-diagonal mass above ``rtol * ||diag||``."""
    off = A[0][1] ** 2 + A[0][2] ** 2 + A[1][2] ** 2
    dg = A[0][0] ** 2 + A[1][1] ** 2 + A[2][2] ** 2
    return torch.any(off > (rtol * rtol) * torch.clamp(dg, min=1e-30))


def eigh3_planes(cov, sweeps=4, safeguard=True, rtol=1e-5, max_extra=2):
    """Symmetric 3x3 eigendecomposition of a (V, 3, 3) or (V, 6) batch.

    ``sweeps`` cyclic Jacobi sweeps, then (``safeguard``) up to
    ``max_extra`` more while any voxel keeps off-diagonal mass above
    ``rtol * ||diag||``: each extra sweep is computed and committed to
    every voxel only while that device flag holds, the JAX package's
    ``while_loop`` rule, with no host read.  Returns ``(eigvals (V, 3)
    ascending, eigvecs as columns (V, 3, 3))``.
    """
    A = _sym_planes(cov)
    A = [list(row) for row in A]
    Vm = _identity_planes(A[0][0])
    for _ in range(sweeps):
        A, Vm = _sweep3(A, Vm)
    if safeguard:
        for _ in range(max_extra):
            # Once the flag is False the state no longer changes, so it
            # stays False: the committed sweeps are the while_loop's.
            go = _unconverged3(A, rtol)
            A2, Vm2 = _sweep3(A, Vm)
            A = [[torch.where(go, a2, a) for a2, a in zip(r2, r)] for r2, r in zip(A2, A)]
            Vm = [[torch.where(go, v2, v) for v2, v in zip(r2, r)] for r2, r in zip(Vm2, Vm)]

    w = [A[0][0], A[1][1], A[2][2]]
    cols = [[Vm[i][k] for i in range(3)] for k in range(3)]  # cols[k] = evec k

    def cswap(a, b):
        swap = w[a] > w[b]
        w[a], w[b] = torch.where(swap, w[b], w[a]), torch.where(swap, w[a], w[b])
        for i in range(3):
            cols[a][i], cols[b][i] = (
                torch.where(swap, cols[b][i], cols[a][i]),
                torch.where(swap, cols[a][i], cols[b][i]),
            )

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)
    eigvals = torch.stack(w, dim=-1)
    basis = torch.stack(
        [torch.stack([cols[k][i] for k in range(3)], dim=-1) for i in range(3)],
        dim=-2,
    )
    return eigvals, basis


def residual_compact_planes(basis, lmask, mean1, mean2):
    """``diag(l) U^T (mu2 - mu1)`` -> (V, 3)."""
    B = _mat_planes(basis)
    L = _vec3_planes(lmask)
    M1 = _vec3_planes(mean1)
    M2 = _vec3_planes(mean2)
    res = [M2[j] - M1[j] for j in range(3)]
    out = [L[i] * sum(B[j][i] * res[j] for j in range(3)) for i in range(3)]
    return torch.stack(out, dim=-1)


def assemble_normal_equations(
    basis, lmask, cov1, count1, cov2, count2, mean1, mean2, dR, cm, rcond,
    extra_dz=None,
):
    """Plane-form WLS assembly: ``(HTWH (6, 6), HTWdz (6,), res_compact
    (V, 3))``, plus ``H^T W P extra_dz`` (6,) when ``extra_dz`` is given
    (the range-sensitivity right-hand side).  ``cm`` is the (V,) float
    correspondence mask; ``dR`` the (3, 3, 3) rotation derivative."""
    B = _mat_planes(basis)
    L = _vec3_planes(lmask)
    M1 = _vec3_planes(mean1)
    M2 = _vec3_planes(mean2)
    P = [[L[i] * B[j][i] for j in range(3)] for i in range(3)]
    n1 = torch.clamp(count1 - 1.0, min=1.0)
    n2 = torch.clamp(count2 - 1.0, min=1.0)
    c1p = _sym_planes(cov1)
    c2p = _sym_planes(cov2)
    R = [[c1p[i][j] / n1 + c2p[i][j] / n2 for j in range(3)] for i in range(3)]
    res = [M2[j] - M1[j] for j in range(3)]
    res_c = [sum(P[i][j] * res[j] for j in range(3)) for i in range(3)]

    T = [[sum(P[i][k] * R[k][j] for k in range(3)) for j in range(3)]
         for i in range(3)]
    Rp = [[sum(T[i][k] * P[j][k] for k in range(3)) for j in range(3)]
          for i in range(3)]
    W = _pinv3_planes(Rp, rcond)

    mu = M2
    Hrot = [[sum(dR[a, b, k] * mu[b] for b in range(3)) for k in range(3)]
            for a in range(3)]
    Hz = [
        [-P[i][c] for c in range(3)]
        + [sum(P[i][a] * Hrot[a][k] for a in range(3)) for k in range(3)]
        for i in range(3)
    ]
    WHz = [[sum(W[i][j] * Hz[j][c] for j in range(3)) for c in range(6)]
           for i in range(3)]
    Wdz = [sum(W[i][j] * res_c[j] for j in range(3)) for i in range(3)]

    entries = {}
    for c in range(6):
        for d in range(c, 6):
            entries[c, d] = torch.sum(cm * sum(Hz[i][c] * WHz[i][d] for i in range(3)))
    HTWH = torch.stack(
        [torch.stack([entries[min(c, d), max(c, d)] for d in range(6)])
         for c in range(6)]
    )
    HTWdz = torch.stack(
        [torch.sum(cm * sum(Hz[i][c] * Wdz[i] for i in range(3))) for c in range(6)]
    )
    res_compact = torch.stack(res_c, dim=-1)
    if extra_dz is None:
        return HTWH, HTWdz, res_compact
    G = _vec3_planes(extra_dz)
    g_c = [sum(P[i][j] * G[j] for j in range(3)) for i in range(3)]
    Wg = [sum(W[i][j] * g_c[j] for j in range(3)) for i in range(3)]
    HTWg = torch.stack(
        [torch.sum(cm * sum(Hz[i][c] * Wg[i] for i in range(3))) for c in range(6)]
    )
    return HTWH, HTWdz, res_compact, HTWg
