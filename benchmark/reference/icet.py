"""The plain reference of the benchmark's ICET configurations.

A frozen copy of the port's eager plain route (PyTorch only), cut to what
the configurations use: the adaptive spherical grid, radial clustering,
anchored moments, the endpoint axis test, the Gauss-Newton solve with its
statistical early exit, the world pose, and the MapMaker's ring update.
It imports nothing of the program, so a change to the program cannot move
it.  Two departures from the program, both deliberate:

* the anchored moment sums are taken as what they are, a matrix product
  (the one-hot matrix of the points' voxels times their features, as the
  JAX package's one-hot route takes them), accumulated in float64 and
  rounded once to float32, where the program's kernel sums in float32 in
  its own fixed order; everything after the sums is the same float32
  arithmetic in the same order;
* every matrix product goes through a :class:`Precision`, so the control
  can compute the same reference with TF32 operands (the card's tensor-core
  rounding of float32 products: ten mantissa bits).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

TWO_PI = 2.0 * math.pi
_BIG = torch.iinfo(torch.int64).max


class Precision:
    """How matrix products (``torch.matmul``, shapes as the program's) are
    computed: float32 (``tf32=False``, the configurations' precision) or
    with both operands rounded to TF32."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return torch.matmul(tf32_round(a), tf32_round(b))
        return torch.matmul(a, b)

    def segment_sums(self, vid: torch.Tensor, feats: torch.Tensor, rows: int,
                     chunk: int = 8192) -> torch.Tensor:
        """``onehot(vid)^T @ feats``, ``(rows, C)``: the products exact
        (operands in TF32 where ``tf32``), accumulated in float64, rounded
        once to float32."""
        f = (tf32_round(feats) if self.tf32 else feats).double()
        out = torch.zeros((rows, f.shape[1]), dtype=torch.float64, device=f.device)
        ids = torch.arange(rows, device=f.device)[:, None]
        for i in range(0, f.shape[0], chunk):
            out += (ids == vid[None, i:i + chunk]).double() @ f[i:i + chunk]
        return out.float()


FP32 = Precision(False)
TF32 = Precision(True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest even at TF32's ten mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class Grid(NamedTuple):
    """The fields of a configuration the solve reads."""

    n_theta: int
    n_phi: int
    phi_min: float
    phi_max: float
    min_pts: int
    cluster_gap: float
    cluster_buffer: float
    min_range: float
    min_outer_range: float
    n_iters: int
    convergence_tol: float
    convergence_stat_scale: float
    sigma_scale: float
    condition_cutoff: float
    pinv_rcond: float

    @property
    def n_voxels(self) -> int:
        return self.n_theta * self.n_phi


#: configuration values the reference does not implement, and the value it
#: requires for each
_REQUIRED = {"radial_mode": "adaptive", "suppression": "endpoint", "clip_fill": 0.0,
             "range_sigma": 0.0, "remove_moving": False, "dnn_filter": False}


def grid_of(config: dict) -> Grid:
    """The :class:`Grid` of a configuration file's fields; raises
    ValueError where the file asks for a path the reference lacks."""
    for key, want in _REQUIRED.items():
        if config.get(key, want) != want:
            raise ValueError(f"the reference implements only {key}={want!r}")
    return Grid(**{k: config[k] for k in Grid._fields})


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def cart_to_spherical(pts: torch.Tensor) -> torch.Tensor:
    pts = torch.nan_to_num(pts, nan=0.0, posinf=0.0, neginf=0.0)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.atan2(y, x)
    theta = torch.where(theta < 0.0, theta + TWO_PI, theta)
    pos = r > 0.0
    safe_r = torch.where(pos, r, torch.ones_like(r))
    phi = torch.acos(torch.clamp(z / safe_r, -1.0, 1.0))
    zero = torch.zeros_like(r)
    return torch.stack([r, torch.where(pos, theta, zero), torch.where(pos, phi, zero)], dim=-1)


def point_norm(pts: torch.Tensor) -> torch.Tensor:
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.sqrt(x * x + y * y + z * z)


def spherical_to_cart(rtp: torch.Tensor) -> torch.Tensor:
    r, theta, phi = rtp[..., 0], rtp[..., 1], rtp[..., 2]
    sp = torch.sin(phi)
    return torch.stack(
        [r * sp * torch.cos(theta), r * sp * torch.sin(theta), r * torch.cos(phi)], dim=-1)


def euler_R(angs: torch.Tensor) -> torch.Tensor:
    """Body-xyz Euler rotation ``(..., 3) -> (..., 3, 3)``."""
    phi, theta, psi = angs[..., 0], angs[..., 1], angs[..., 2]
    cf, sf = torch.cos(phi), torch.sin(phi)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(psi), torch.sin(psi)
    row0 = torch.stack([ct * cp, sp * cf + sf * st * cp, sf * sp - st * cf * cp], -1)
    row1 = torch.stack([-sp * ct, cf * cp - sf * st * sp, sf * cp + st * sp * cf], -1)
    row2 = torch.stack([st, -sf * ct, cf * ct], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotation_jacobian(angs: torch.Tensor) -> torch.Tensor:
    """``dR/d(angs)`` (3, 3, 3), ``out[..., k] = d euler_R / d angs[k]``."""
    phi, theta, psi = angs[0], angs[1], angs[2]
    cf, sf = torch.cos(phi), torch.sin(phi)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(psi), torch.sin(psi)
    z = torch.zeros_like(cf)
    d_phi = [
        [z, -sp * sf + cf * st * cp, cf * sp + st * sf * cp],
        [z, -sf * cp - cf * st * sp, cf * cp - st * sp * sf],
        [z, -cf * ct, -sf * ct],
    ]
    d_theta = [
        [-st * cp, sf * ct * cp, -ct * cf * cp],
        [sp * st, -sf * ct * sp, ct * sp * cf],
        [ct, sf * st, -cf * st],
    ]
    d_psi = [
        [-ct * sp, cp * cf - sf * st * sp, sf * cp + st * cf * sp],
        [-cp * ct, -cf * sp - sf * st * cp, -sf * sp + st * cp * cf],
        [z, z, z],
    ]
    return torch.stack(
        [torch.stack([torch.stack([d[i][j] for d in (d_phi, d_theta, d_psi)])
                      for j in range(3)]) for i in range(3)])


def transform_points(pts: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``p' = euler_R(-X[3:6]) p + X[:3]``, each component as
    ``((x r_i0 + y r_i1) + z r_i2) + t_i``."""
    rot = euler_R(-X[3:6])
    return pts[:, 0:1] * rot[:, 0] + pts[:, 1:2] * rot[:, 1] + pts[:, 2:3] * rot[:, 2] + X[:3]


def pose_matrix(X: torch.Tensor) -> torch.Tensor:
    """4x4 matrix of ``p' = R(-angs) p + t``."""
    top = torch.cat([euler_R(-X[3:6]), X[:3, None]], dim=1)
    row = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=X.dtype, device=X.device)
    return torch.cat([top, row], dim=0)


def compose_pose(T_world: torch.Tensor, X: torch.Tensor, p: Precision = FP32) -> torch.Tensor:
    return p.mm(T_world, pose_matrix(X))


# ---------------------------------------------------------------------------
# Grid, clustering, moments
# ---------------------------------------------------------------------------


def voxel_ids(rtp: torch.Tensor, g: Grid) -> torch.Tensor:
    r, theta, phi = rtp[..., 0], rtp[..., 1], rtp[..., 2]
    itheta = torch.clamp((theta / TWO_PI * g.n_theta).to(torch.int32), 0, g.n_theta - 1)
    fphi = (phi - g.phi_min) / (g.phi_max - g.phi_min) * g.n_phi
    iphi = torch.floor(fphi).to(torch.int32)
    in_band = (iphi >= 0) & (iphi < g.n_phi) & (r >= g.min_range)
    vid = iphi * g.n_theta + itheta
    return torch.where(in_band, vid, g.n_voxels).to(torch.int32)


def voxel_anchors(bounds: torch.Tensor, g: Grid) -> torch.Tensor:
    """Radial midpoint of the bounds on the bin's angular center, rounded
    to bfloat16 (sentinel row 0)."""
    ang = torch.arange(g.n_voxels, dtype=torch.int32, device=bounds.device)
    theta_c = ((ang % g.n_theta).to(torch.float32) + 0.5) / g.n_theta * TWO_PI
    phi_c = g.phi_min + ((ang // g.n_theta).to(torch.float32) + 0.5) / g.n_phi * (
        g.phi_max - g.phi_min)
    r_mid = 0.5 * (bounds[: g.n_voxels, 0] + bounds[: g.n_voxels, 1])
    anchors = spherical_to_cart(torch.stack([r_mid, theta_c, phi_c], dim=-1))
    anchors = torch.cat([anchors, anchors.new_zeros((1, 3))], dim=0)
    return anchors.to(torch.bfloat16).float()


def radial_cluster_bounds(vid, r, valid, g: Grid):
    """``(bounds (V+1, 2), found (V+1,))``: a voxel's cluster is its first
    run of at least ``min_pts`` points with radial gaps ``<= cluster_gap``,
    widened by ``cluster_buffer``."""
    n, nv, dev = r.shape[0], g.n_voxels, r.device
    vid = torch.where(valid, vid, nv).long()
    order = torch.argsort(r, stable=True)
    order = order[torch.argsort(vid[order], stable=True)]
    vid_s, r_s = vid[order], r[order]
    brk = torch.ones(n, dtype=torch.bool, device=dev)
    brk[1:] = (vid_s[1:] != vid_s[:-1]) | ((r_s[1:] - r_s[:-1]) > g.cluster_gap)
    run_id = torch.cumsum(brk.long(), 0) - 1
    run_len = torch.zeros(n, dtype=torch.long, device=dev).index_add_(
        0, run_id, torch.ones_like(run_id))
    idx = torch.arange(n, device=dev)
    q_start = brk & (run_len[run_id] >= g.min_pts) & (vid_s < nv)
    first = torch.full((nv + 1,), _BIG, dtype=torch.long, device=dev).scatter_reduce(
        0, vid_s, torch.where(q_start, idx, _BIG), reduce="amin")
    found = first < _BIG
    start = torch.where(found, first, 0)
    end = start + run_len[run_id[start]] - 1
    inner = torch.clamp(r_s[start] - g.cluster_buffer, min=0.0)
    outer = r_s[end] + g.cluster_buffer
    zero = torch.zeros_like(inner)
    bounds = torch.stack([torch.where(found, inner, zero), torch.where(found, outer, zero)], -1)
    return bounds, found


def membership(vid, r, valid, bounds, n_voxels: int) -> torch.Tensor:
    vid = torch.where(valid, vid, n_voxels).long()
    b = bounds[vid]
    return valid & (vid < n_voxels) & (r >= b[..., 0]) & (r <= b[..., 1])


def moment_sums(pts, X, bounds, anchors, g: Grid, p: Precision = FP32) -> torch.Tensor:
    """``(V+1, 16)`` anchored sums ``[1, g, g g^T (6)]`` of the points
    transformed by X that fall inside their voxel's bounds."""
    raw_ok = point_norm(pts) >= g.min_range
    p2 = transform_points(pts, X)
    rtp = cart_to_spherical(p2)
    vid = voxel_ids(rtp, g)
    member = membership(vid, rtp[..., 0], raw_ok, bounds, g.n_voxels)
    vid = torch.where(member, vid, g.n_voxels).long()
    d = p2 - anchors[vid]
    gx, gy, gz = d[:, 0], d[:, 1], d[:, 2]
    feats = torch.stack([torch.ones_like(gx), gx, gy, gz, gx * gx, gy * gy, gz * gz,
                         gx * gy, gx * gz, gy * gz], dim=-1)
    feats = torch.where(member[:, None], feats, torch.zeros_like(feats))
    sums = p.segment_sums(vid, feats, g.n_voxels + 1)
    return torch.cat([sums, sums.new_zeros((g.n_voxels + 1, 6))], dim=1)


def finalize(sums, anchors):
    """``(count, mean (V+1, 3), cov6 (V+1, 6))``; cov6 packed
    ``[xx, yy, zz, xy, xz, yz]``."""
    count = sums[:, 0]
    safe_n = torch.clamp(count, min=1.0)
    gbar = sums[:, 1:4] / safe_n[:, None]
    mean = anchors + gbar
    denom = torch.clamp(count - 1.0, min=1.0)
    gx, gy, gz = gbar[:, 0], gbar[:, 1], gbar[:, 2]
    pairs = ((4, gx * gx), (5, gy * gy), (6, gz * gz), (7, gx * gy), (8, gx * gz), (9, gy * gz))
    cov6 = torch.stack([(sums[:, i] - safe_n * g2) / denom for i, g2 in pairs], dim=-1)
    return count, mean, cov6


def cov6_to_matrix(cov6):
    xx, yy, zz, xy, xz, yz = (cov6[:, i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1),
                        torch.stack([xz, yz, zz], -1)], dim=-2)


# ---------------------------------------------------------------------------
# 3x3 plane math (each entry a (V,) tensor)
# ---------------------------------------------------------------------------


def _rotate3(A, Vm, p, q):
    ang = 0.5 * torch.atan2(2.0 * A[p][q], A[q][q] - A[p][p])
    c, s = torch.cos(ang), torch.sin(ang)
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
    one, zero = torch.ones_like(like), torch.zeros_like(like)
    return [[one, zero, zero], [zero, one, zero], [zero, zero, one]]


def _pinv3_planes(R, rcond, sweeps=5):
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


_SYM6 = ((0, 3, 4), (3, 1, 5), (4, 5, 2))


def _sym_planes(cov):
    if cov.ndim == 3:
        return [[cov[:, i, j] for j in range(3)] for i in range(3)]
    return [[cov[:, _SYM6[i][j]] for j in range(3)] for i in range(3)]


def eigh3_planes(cov6, sweeps=4, rtol=1e-5, max_extra=2):
    """``(eigvals (V, 3) ascending, eigvecs as columns (V, 3, 3))``:
    ``sweeps`` cyclic Jacobi sweeps, then up to ``max_extra`` more, each
    committed while any voxel keeps off-diagonal mass above ``rtol``."""
    A = [list(row) for row in _sym_planes(cov6)]
    Vm = _identity_planes(A[0][0])
    for _ in range(sweeps):
        A, Vm = _sweep3(A, Vm)
    for _ in range(max_extra):
        off = A[0][1] ** 2 + A[0][2] ** 2 + A[1][2] ** 2
        dg = A[0][0] ** 2 + A[1][1] ** 2 + A[2][2] ** 2
        go = torch.any(off > (rtol * rtol) * torch.clamp(dg, min=1e-30))
        A2, Vm2 = _sweep3(A, Vm)
        A = [[torch.where(go, a2, a) for a2, a in zip(r2, r)] for r2, r in zip(A2, A)]
        Vm = [[torch.where(go, v2, v) for v2, v in zip(r2, r)] for r2, r in zip(Vm2, Vm)]
    w = [A[0][0], A[1][1], A[2][2]]
    cols = [[Vm[i][k] for i in range(3)] for k in range(3)]

    def cswap(a, b):
        swap = w[a] > w[b]
        w[a], w[b] = torch.where(swap, w[b], w[a]), torch.where(swap, w[a], w[b])
        for i in range(3):
            cols[a][i], cols[b][i] = (torch.where(swap, cols[b][i], cols[a][i]),
                                      torch.where(swap, cols[a][i], cols[b][i]))

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)
    eigvals = torch.stack(w, dim=-1)
    basis = torch.stack([torch.stack([cols[k][i] for k in range(3)], dim=-1)
                         for i in range(3)], dim=-2)
    return eigvals, basis


def normal_equations(basis, lmask, cov1, count1, cov2, count2, mean1, mean2, dR, cm, rcond):
    """``(HTWH (6, 6), HTWdz (6,))`` of the plane-form WLS problem."""
    B = [[basis[:, i, j] for j in range(3)] for i in range(3)]
    L = [lmask[:, j] for j in range(3)]
    M1 = [mean1[:, j] for j in range(3)]
    M2 = [mean2[:, j] for j in range(3)]
    P = [[L[i] * B[j][i] for j in range(3)] for i in range(3)]
    n1 = torch.clamp(count1 - 1.0, min=1.0)
    n2 = torch.clamp(count2 - 1.0, min=1.0)
    c1p, c2p = _sym_planes(cov1), _sym_planes(cov2)
    R = [[c1p[i][j] / n1 + c2p[i][j] / n2 for j in range(3)] for i in range(3)]
    res = [M2[j] - M1[j] for j in range(3)]
    res_c = [sum(P[i][j] * res[j] for j in range(3)) for i in range(3)]
    T = [[sum(P[i][k] * R[k][j] for k in range(3)) for j in range(3)] for i in range(3)]
    Rp = [[sum(T[i][k] * P[j][k] for k in range(3)) for j in range(3)] for i in range(3)]
    W = _pinv3_planes(Rp, rcond)
    Hrot = [[sum(dR[a, b, k] * M2[b] for b in range(3)) for k in range(3)] for a in range(3)]
    Hz = [[-P[i][c] for c in range(3)]
          + [sum(P[i][a] * Hrot[a][k] for a in range(3)) for k in range(3)]
          for i in range(3)]
    WHz = [[sum(W[i][j] * Hz[j][c] for j in range(3)) for c in range(6)] for i in range(3)]
    Wdz = [sum(W[i][j] * res_c[j] for j in range(3)) for i in range(3)]
    entries = {}
    for c in range(6):
        for d in range(c, 6):
            entries[c, d] = torch.sum(cm * sum(Hz[i][c] * WHz[i][d] for i in range(3)))
    HTWH = torch.stack([torch.stack([entries[min(c, d), max(c, d)] for d in range(6)])
                        for c in range(6)])
    HTWdz = torch.stack([torch.sum(cm * sum(Hz[i][c] * Wdz[i] for i in range(3)))
                         for c in range(6)])
    return HTWH, HTWdz


# ---------------------------------------------------------------------------
# 6x6 Jacobi (round robin: n/2 disjoint rotations a round as one G)
# ---------------------------------------------------------------------------


def _round_robin_rounds(n: int):
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([tuple(sorted((players[i], players[n - 1 - i]))) for i in range(n // 2)])
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


@functools.lru_cache(maxsize=None)
def _plan(n: int, dtype: torch.dtype, device: torch.device):
    plan = []
    for rnd in _round_robin_rounds(n):
        pair_of = [0] * n
        sign = [[0.0] * n for _ in range(n)]
        for k, (p, q) in enumerate(rnd):
            pair_of[p] = pair_of[q] = k
            sign[p][q] = 1.0
            sign[q][p] = -1.0
        plan.append((torch.tensor([p for p, _ in rnd], device=device),
                     torch.tensor([q for _, q in rnd], device=device),
                     torch.tensor(pair_of, device=device),
                     torch.tensor(sign, dtype=dtype, device=device)))
    return tuple(plan)


def eigh6(A: torch.Tensor, sweeps: int = 8, p: Precision = FP32):
    """``(w ascending, V columns)`` of a symmetric 6x6."""
    n = A.shape[-1]
    A = 0.5 * (A + A.T)
    V = torch.eye(n, dtype=A.dtype, device=A.device)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    for _ in range(sweeps):
        for pp, qq, pair_of, sign in _plan(n, A.dtype, A.device):
            ang = 0.5 * torch.atan2(2.0 * A[pp, qq], A[qq, qq] - A[pp, pp])
            c_row = torch.cos(ang)[pair_of]
            s_row = torch.sin(ang)[pair_of]
            G = eye * c_row[None, :] + sign * s_row[None, :]
            A = p.mm(p.mm(G.T, A), G)
            V = p.mm(V, G)
    w = torch.diagonal(A)
    order = torch.argsort(w, stable=True)
    return w[order], V[:, order]


def eigh6_warm_safe(A, V0, rtol: float = 1e-5, p: Precision = FP32):
    """One warm sweep from ``V0``; a second where the first leaves
    off-diagonal mass above ``rtol * ||diag||``."""
    A0 = p.mm(p.mm(V0.T, A), V0)
    w1, V1 = eigh6(A0, sweeps=1, p=p)
    R = p.mm(p.mm(V1.T, A0), V1)
    dg = torch.diagonal(R)
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    off = torch.linalg.norm(R - dg[:, None] * eye)
    converged = off <= rtol * torch.clamp(torch.linalg.norm(dg), min=1e-30)
    w2, V2 = eigh6(R, sweeps=1, p=p)
    return (torch.where(converged, w1, w2),
            torch.where(converged, p.mm(V0, V1), p.mm(V0, p.mm(V1, V2))))


# ---------------------------------------------------------------------------
# The solve
# ---------------------------------------------------------------------------


class Model(NamedTuple):
    bounds: torch.Tensor
    anchors: torch.Tensor
    count: torch.Tensor
    mean: torch.Tensor
    cov: torch.Tensor
    basis: torch.Tensor
    lmask: torch.Tensor
    valid: torch.Tensor


class Solve(NamedTuple):
    X: torch.Tensor
    pred_stds: torch.Tensor
    iterations: int


def _axis_mask(mean, eigvals, basis, bounds, valid, g: Grid):
    """Keep eigen-axis k iff an endpoint ``mu +- s sqrt(lam_k) u_k`` lies in
    the voxel (same bin, within the radial bounds)."""
    sq = torch.sqrt(torch.clamp(eigvals, min=0.0))
    offsets = g.sigma_scale * sq[:, None, :] * basis
    ep = torch.movedim(torch.stack([mean[:, :, None] + offsets, mean[:, :, None] - offsets]),
                       2, 3)
    rtp = cart_to_spherical(ep)
    ep_vid = voxel_ids(rtp, g)
    own = torch.arange(mean.shape[0], dtype=torch.int32, device=mean.device)[None, :, None]
    b = bounds[None, :, None, :]
    inside = (ep_vid == own) & (rtp[..., 0] >= b[..., 0]) & (rtp[..., 0] <= b[..., 1])
    return torch.where(valid[:, None], (inside[0] | inside[1]).to(mean.dtype), 0.0)


def prepare(scan: torch.Tensor, g: Grid, p: Precision = FP32) -> Model:
    """The voxel model of one scan (X = 0)."""
    rtp = cart_to_spherical(scan)
    r = rtp[..., 0]
    bounds, found = radial_cluster_bounds(voxel_ids(rtp, g), r, r >= g.min_range, g)
    anchors = voxel_anchors(bounds, g)
    sums = moment_sums(scan, torch.zeros(6, dtype=scan.dtype, device=scan.device), bounds,
                       anchors, g, p)
    count, mean, cov6 = finalize(sums, anchors)
    valid = found & (count >= g.min_pts) & (bounds[:, 1] > g.min_outer_range)
    eigvals, basis = eigh3_planes(cov6)
    lmask = _axis_mask(mean, eigvals, basis, bounds, valid, g)
    return Model(bounds, anchors, count, mean, cov6_to_matrix(cov6), basis, lmask, valid)


def _inverse_where(w, ok):
    return torch.where(ok, 1.0 / torch.where(ok, w, torch.ones_like(w)), torch.zeros_like(w))


def _iteration(model: Model, scan, X, g: Grid, U2_warm, p: Precision):
    sums = moment_sums(scan, X.contiguous(), model.bounds, model.anchors, g, p)
    count2, mean2, cov2 = finalize(sums, model.anchors)
    corr = model.valid & (count2 >= g.min_pts)
    cm = corr.to(X.dtype)
    HTWH, HTWdz = normal_equations(model.basis, model.lmask, model.cov, model.count, cov2,
                                   count2, model.mean, mean2, rotation_jacobian(X[3:6]), cm,
                                   g.pinv_rcond)
    if U2_warm is None:
        w6, U2 = eigh6(HTWH, p=p)
    else:
        w6, U2 = eigh6_warm_safe(HTWH, U2_warm, p=p)
    keep = (torch.abs(w6[-1]) <= g.condition_cutoff * torch.abs(w6)) & (torch.abs(w6) > 1e-30)
    dx = p.mm(U2, _inverse_where(w6, keep) * p.mm(U2.T, HTWdz))
    return X + dx, w6, keep, U2, torch.linalg.norm(dx)


def _exit_threshold(w6, U2, g: Grid):
    t = torch.full((), g.convergence_tol, dtype=w6.dtype, device=w6.device)
    if g.convergence_stat_scale > 0.0:
        wmax = torch.amax(torch.abs(w6))
        inv = _inverse_where(w6, torch.abs(w6) > g.pinv_rcond * wmax)
        var = torch.sum(U2 * U2 * inv[None, :], dim=1)
        t = torch.maximum(t, g.convergence_stat_scale * torch.sqrt(torch.sum(torch.abs(var))))
    return t


def _pred_stds(w6, U2, keep, g: Grid, p: Precision):
    wmax = torch.amax(torch.abs(w6))
    inv_all = _inverse_where(w6, torch.abs(w6) > g.pinv_rcond * wmax)
    Q = p.mm(U2 * inv_all[None, :], U2.T)
    stds = torch.sqrt(torch.abs(torch.diagonal(Q)))
    return stds + p.mm(torch.abs(U2), (~keep).to(stds.dtype))


def register(model: Model, scan, x0, g: Grid, p: Precision = FP32) -> Solve:
    """Gauss-Newton from ``x0``: a cold 6x6 eigensystem, then warm ones; with
    an exit tolerance set, stop once ``|dx|`` falls below the threshold."""
    X, w6, keep, U2, dxn = _iteration(model, scan, x0, g, None, p)
    early = g.convergence_tol > 0.0 or g.convergence_stat_scale > 0.0
    thresh = _exit_threshold(w6, U2, g) if early else None
    it = 1
    while it < g.n_iters:
        if early and not bool(dxn >= thresh):
            break
        X, w6, keep, U2, dxn = _iteration(model, scan, X, g, U2, p)
        if early:
            thresh = _exit_threshold(w6, U2, g)
        it += 1
    return Solve(X, _pred_stds(w6, U2, keep, g, p), it)


def guard(X: torch.Tensor, clamp: float):
    """``(diverged, X or 0)``: any ``|X_i| > clamp`` zeroes the solution."""
    diverged = bool(torch.any(torch.abs(X) > clamp))
    return diverged, torch.zeros_like(X) if diverged else X


# ---------------------------------------------------------------------------
# The MapMaker's ring
# ---------------------------------------------------------------------------


def ring_update(points, valid, scan, X, u, capacity: int, per_scan: int, min_range: float,
                write_ptr: int, p: Precision = FP32):
    """The ring after one scan: the ring re-expressed in the new frame
    (``R^T (p - t)``), then ``per_scan`` rows of the scan with the smallest
    ``u + 2 * (|p| <= min_range)`` written at the cursor."""
    rot = euler_R(-X[3:6])
    pts = p.mm(points - X[:3], rot)
    ok = torch.sum(scan * scan, dim=-1) > (min_range * min_range)
    order = torch.argsort(u.to(scan) + (~ok).to(scan.dtype) * 2.0, stable=True)
    take = order[:per_scan]
    idx = (write_ptr + torch.arange(per_scan, device=scan.device)) % capacity
    pts[idx] = scan[take]
    valid = valid.clone()
    valid[idx] = ok[take]
    return pts, valid, (write_ptr + per_scan) % capacity
