"""Keyframe odometry and the keyframe block map (``icet_tpu/keyframe.py``).

Each scan registers against a held KEYFRAME's voxel model until the sensor
has moved too far from it (or the solve's health degrades); the prepare is
paid once a keyframe.  The per-frame DELTA is still derived and reported,
so a :class:`KeyframeFrame` honours :class:`~icet_tpu_torch.odometry.
OdometryFrame`'s ``X`` contract.  The map is a ring of keyframe BLOCKS: a
block's points are stored once, in its keyframe's own frame, and only the
(B, 6) block poses move when the trajectory is refined.

Differences from the JAX package, none of which changes a trajectory:

* the block map's ``n_blocks`` and ``cursor`` are host integers, and its
  point and validity tensors are updated in place (the JAX package donates
  them to its jitted steps);
* the eager functions read the spawn decision on the host once a frame;
  it gates the frame's map insert and the keyframe prepare.  Besides it,
  the eager solver reads ``|dx|`` on the host once an iteration, as in
  :mod:`icet_tpu_torch.solver`.  The compiled sequence runner decides on
  the device, as the JAX package's ``lax.cond`` does, and reads once a
  block; ``KeyframeOdometry`` decides on the host, as the JAX package's
  host loop does, from its step's one read;
* random draws come from a ``torch.Generator`` seeded from ``seed``, not
  from ``jax.random``: map CONTENTS differ between the packages (the JAX
  package's own sequence runner and host loop differ the same way).  The
  inserts take their uniforms as an argument, so a test can pass the JAX
  package's draws in;
* the moments kernel has no window, so ``windowed_overflow`` is 0 and the
  "auto" policy's ``ovf_spawn`` term never fires (as in the JAX package
  off the TPU);
* the keyframe step updates the block map in place (the JAX package
  donates it), so a failed step may leave it half-written: recovery
  restores the newest host snapshot, as the JAX package's does;
* :func:`shard_blockmap` splits the block axis into per-device chunks
  (:class:`BlockShards`) in place of a sharded array.

The compiled entry points :func:`keyframe_step_jit`,
:func:`keyframe_step_dnn_jit`, :func:`keyframe_spawn_jit` and
:func:`keyframe_sequence_jit` run the same frame as capture-safe stages
(``icet_tpu_torch.graphs``: CUDA graphs on the card, plain calls on the
CPU, which equal the eager functions bit for bit).  Their insert is gated
on the device (``enabled = ~spawn``, as in the JAX package) and reads the
active block's slot and cursor from a device mirror of the host's
``n_blocks`` and ``cursor``, so one graph serves every cursor.  The
frame's graphs stage the rows, the points and any block opening; a small
map-write graph a table set, keyed by the tables' addresses, writes them
into the map, so the frame's graphs depend on no map: a sharded map
(:class:`BlockShards`) has one map-write graph a chunk, each masked by
whether its chunk holds the active block.  A ``torch.Generator`` (or the
uniforms themselves) stands where the JAX functions take a PRNG key,
drawn on the device before the replay, in the eager order.
``KeyframeOdometry`` and :func:`run_keyframe_device` run on them; the eager
functions stay as the plain version the tests hold them to.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple

import numpy as np
import torch

from icet_tpu_torch import graphs
from icet_tpu_torch.config import BlockMapConfig, ICETConfig, KeyframeConfig
from icet_tpu_torch.device import as_points, resolve_device
from icet_tpu_torch.filters import (
    model_voxel_samples_jit,
    pretrained_dnn,
    register_with_dnn,
    solve_dnn,
)
from icet_tpu_torch.ops.geometry import (
    compose_states,
    euler_R,
    point_norm,
    relative_state,
    transform_points,
)
from icet_tpu_torch.solver import (
    IterationDiag,
    RegistrationResult,
    VoxelModel,
    _stage_prepare,
    compiled_graphs,
    moment_route,
    prepare_reference,
    register,
)

_log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Host pose math (numpy twins of ops/geometry.py, float64)
# ---------------------------------------------------------------------------


def _np_euler_R(angs: np.ndarray) -> np.ndarray:
    """numpy twin of ops/geometry.euler_R."""
    phi, theta, psi = angs
    cf, sf = np.cos(phi), np.sin(phi)
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(psi), np.sin(psi)
    return np.array(
        [
            [ct * cp, sp * cf + sf * st * cp, sf * sp - st * cf * cp],
            [-sp * ct, cf * cp - sf * st * sp, sf * cp + st * sp * cf],
            [st, -sf * ct, cf * ct],
        ]
    )


def np_pose_matrix(X: np.ndarray) -> np.ndarray:
    """numpy twin of ops/geometry.pose_matrix."""
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = _np_euler_R(-np.asarray(X[3:6], np.float64))
    T[:3, 3] = X[:3]
    return T


def np_pose_to_state(T: np.ndarray) -> np.ndarray:
    """numpy twin of ops/geometry.pose_to_state."""
    rot = T[:3, :3]
    r_sum = np.sqrt(
        (rot[0, 0] ** 2 + rot[1, 0] ** 2 + rot[2, 1] ** 2 + rot[2, 2] ** 2) / 2.0
    )
    phi = np.arctan2(-rot[2, 1], rot[2, 2])
    theta = np.arctan2(rot[2, 0], r_sum)
    psi = np.arctan2(-rot[1, 0], rot[0, 0])
    return np.concatenate([T[:3, 3], [-phi, -theta, -psi]])


# ---------------------------------------------------------------------------
# Keyframe block map
# ---------------------------------------------------------------------------


class BlockMap(NamedTuple):
    #: (B, P, 3) per-block points, in each block's OWN keyframe frame
    points: torch.Tensor
    #: (B, P) slot validity
    valid: torch.Tensor
    #: (B, 6) world pose state of each block's keyframe
    poses: torch.Tensor
    #: keyframes spawned ever (slot = (n - 1) % B; older blocks are evicted)
    n_blocks: int
    #: next free row in the active block
    cursor: int


def blockmap_init(bm_cfg: BlockMapConfig, device=None) -> BlockMap:
    B, P = bm_cfg.n_blocks, bm_cfg.block_capacity
    return BlockMap(
        points=torch.zeros((B, P, 3), dtype=torch.float32, device=device),
        valid=torch.zeros((B, P), dtype=torch.bool, device=device),
        poses=torch.zeros((B, 6), dtype=torch.float32, device=device),
        n_blocks=0,
        cursor=0,
    )


def _uniforms(gen: torch.Generator, k: int, device) -> torch.Tensor:
    """``k`` uniforms in [0, 1) from ``gen`` (the port's only random draw)."""
    return torch.rand(k, generator=gen, device=device)


class BlockShards:
    """A block-map table split along its block axis over devices
    (:func:`shard_blockmap`): chunk k holds blocks ``[k c, (k + 1) c)`` on
    its own device."""

    def __init__(self, chunks: list):
        self.chunks = list(chunks)
        self.per = self.chunks[0].shape[0]

    @property
    def shape(self) -> tuple:
        return (self.per * len(self.chunks),) + tuple(self.chunks[0].shape[1:])

    def block(self, slot: int) -> torch.Tensor:
        """Block ``slot`` (a view, on its owning device)."""
        k, i = divmod(slot, self.per)
        return self.chunks[k][i]

    def clone(self) -> "BlockShards":
        return BlockShards([c.clone() for c in self.chunks])


def whole_table(table) -> torch.Tensor:
    """A block-map table as one tensor (a sharded one gathered onto its
    first chunk's device)."""
    if isinstance(table, BlockShards):
        return torch.cat([c.to(table.chunks[0].device) for c in table.chunks])
    return table


def _row(table, slot: int) -> torch.Tensor:
    """Block ``slot`` of a block-map table, a view on its device."""
    return table.block(slot) if isinstance(table, BlockShards) else table[slot]


def shard_blockmap(bm: BlockMap, mesh, axis: str = "dp") -> BlockMap:
    """The map with its block axis split over the devices of ``mesh``'s
    ``axis`` (an in-process ``parallel.sharding.Mesh``).  Inserts and
    spawns touch one block, on the device that owns it;
    :func:`blockmap_world_points` gathers.  Raises ValueError where the
    block count does not divide.  A checkpoint restore or a recovery gives
    an unsharded map back."""
    devices = mesh.axis(axis).devices
    B = bm.points.shape[0]
    if B % len(devices):
        raise ValueError(f"{B} blocks do not divide over {len(devices)} devices")
    c = B // len(devices)

    def split(t):
        t = whole_table(t)
        return BlockShards([t[k * c:(k + 1) * c].to(d, copy=True) for k, d in enumerate(devices)])

    return bm._replace(points=split(bm.points), valid=split(bm.valid), poses=split(bm.poses))


def _blockmap_spawn(bm: BlockMap, pose_state: torch.Tensor) -> BlockMap:
    """Open a new (empty) active block anchored at ``pose_state``."""
    nb = bm.n_blocks + 1
    slot = (nb - 1) % bm.points.shape[0]
    _row(bm.valid, slot).fill_(False)
    pose = _row(bm.poses, slot)
    pose.copy_(pose_state.to(pose))
    return bm._replace(n_blocks=nb, cursor=0)


def _blockmap_insert(
    bm: BlockMap,
    scan: torch.Tensor,
    X_rel: torch.Tensor,
    u: torch.Tensor,
    bm_cfg: BlockMapConfig,
    min_range: float,
    enabled: bool = True,
) -> BlockMap:
    """Fold a range-gated stratified downsample of ``scan`` into the active
    block, in place (on the block's device).

    ``X_rel`` maps the scan's sensor frame into the active keyframe's frame.
    Sample k of K is scan row ``floor((k + u[k]) N / K)`` (``u``: K uniforms
    in [0, 1)); range-gated rows and rows past the block capacity are not
    written.  With no block open yet the points are dropped; with
    ``enabled`` False the insert is skipped and the cursor stays."""
    if not enabled:
        return bm
    B, P = bm.valid.shape
    n = scan.shape[0]
    K = bm_cfg.points_per_scan
    cursor = min(bm.cursor + K, P)
    k = min(K, P - bm.cursor)
    if bm.n_blocks == 0 or k <= 0:
        return bm._replace(cursor=cursor)
    local = transform_points(scan, X_rel)
    ok = torch.sum(scan * scan, dim=-1) > (min_range * min_range)
    ar = torch.arange(K, dtype=torch.float32, device=scan.device)
    take = torch.floor((ar + u.to(ar)) * (n / K)).to(torch.int64)
    take = torch.clamp(take, max=n - 1)[:k]
    new_ok = ok[take]
    slot = (bm.n_blocks - 1) % B
    rows = slice(bm.cursor, bm.cursor + k)
    pts, valid = _row(bm.points, slot), _row(bm.valid, slot)
    new_ok = new_ok.to(pts.device)
    pts[rows] = torch.where(new_ok[:, None], local[take].to(pts.device), pts[rows])
    valid[rows] |= new_ok
    return bm._replace(cursor=cursor)


def blockmap_world_points(bm: BlockMap) -> tuple[torch.Tensor, torch.Tensor]:
    """All map points in the world frame: ``((B*P, 3), (B*P,) validity)``
    (a sharded map gathered)."""
    points, valid, poses = (whole_table(t) for t in (bm.points, bm.valid, bm.poses))
    rot = euler_R(-poses[:, 3:6])  # (B, 3, 3)
    world = torch.einsum("bpi,bji->bpj", points, rot) + poses[:, None, :3]
    return world.reshape(-1, 3), valid.reshape(-1)


def blockmap_refresh_poses(bm: BlockMap, keyframe_states: np.ndarray) -> BlockMap:
    """Write refined keyframe poses back into the map (pose-graph feedback).

    ``keyframe_states`` is the FULL ``(n_spawned, 6)`` history of keyframe
    world states in spawn order; only the latest B (the resident blocks)
    are written."""
    B = bm.poses.shape[0]
    n = bm.n_blocks
    states = np.asarray(keyframe_states, np.float32)
    if states.shape[0] < n:
        raise ValueError(
            f"keyframe_states must cover all {n} spawned keyframes "
            f"(got {states.shape[0]}); resident blocks are indexed by their "
            "spawn order, so a trailing window is ambiguous"
        )
    poses = bm.poses.clone()
    for spawn_idx in range(max(0, n - B), n):
        _row(poses, spawn_idx % B).copy_(torch.from_numpy(states[spawn_idx]))
    return bm._replace(poses=poses)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def update_health0(health0: torch.Tensor, health: torch.Tensor) -> torch.Tensor:
    """Fold one solve's ``health = [n_corr, rms]`` into the keyframe baseline
    ``health0`` (all-zero right after a spawn): both latch from the
    keyframe's FIRST solve."""
    return torch.where(health0 == 0.0, health, health0)


def _predict(scan, x_prev_rel, delta_prev, cfg: ICETConfig):
    """The constant-velocity prediction ``x0`` and the scan pre-transformed
    by it (raw-invalid points zeroed BEFORE the pre-transform, so dropouts
    cannot resurrect at |t0|)."""
    x0 = compose_states(x_prev_rel, delta_prev)
    scan0 = torch.where(
        (point_norm(scan) >= cfg.min_range)[:, None],
        transform_points(scan, x0),
        torch.zeros((), dtype=scan.dtype, device=scan.device),
    )
    return x0, scan0


def _propagate(res, x0, x_prev_rel, delta_prev, health0, kf_cfg: KeyframeConfig):
    """After the solve: the solve's health, the exact covariance propagation
    to the composed state, the delta guard and the spawn policy.  Returns
    ``(res, X, delta, diverged, spawn, health)``, ``spawn`` a device bool."""
    rms = torch.sqrt(torch.sum(res.pred_stds**2))
    X_total = compose_states(res.X, x0)
    # Exact covariance propagation through the Jacobian of the composition
    # (forward mode promotes a tangent to float64 on a float-scalar
    # division; the product is taken in the solve's float32).
    J = torch.func.jacfwd(lambda d: compose_states(d, x0))(res.X).to(res.Q.dtype)
    Q = J @ res.Q @ J.T
    res = res._replace(X=X_total, Q=Q, pred_stds=torch.sqrt(torch.abs(torch.diagonal(Q))))

    delta = relative_state(x_prev_rel, res.X)
    diverged = torch.any(torch.abs(delta) > kf_cfg.delta_clamp)
    X = torch.where(diverged, x0, res.X)
    delta = torch.where(diverged, delta_prev, delta)

    n_corr = res.diagnostics.n_corr[-1].to(torch.float32)
    health = torch.stack([n_corr, rms])
    n_corr0, rms0 = health0[0], health0[1]
    spawn = (
        (torch.linalg.norm(X[:3]) > kf_cfg.spawn_distance)
        | (torch.amax(torch.abs(X[3:6])) > kf_cfg.spawn_angle)
        | (n_corr < kf_cfg.min_corr_fraction * n_corr0)
        | diverged
    )
    if kf_cfg.spawn == "auto":
        ovf = res.diagnostics.windowed_overflow[-1]
        spawn = spawn | ((rms0 > 0.0) & (rms > kf_cfg.stds_growth * rms0))
        spawn = spawn | (ovf > kf_cfg.ovf_spawn)
    return res, X, delta, diverged, spawn, health


def keyframe_step(
    model: VoxelModel,
    bm: BlockMap,
    scan: torch.Tensor,
    x_prev_rel: torch.Tensor,
    delta_prev: torch.Tensor,
    u: torch.Tensor,
    health0: torch.Tensor,
    cfg: ICETConfig,
    kf_cfg: KeyframeConfig,
    bm_cfg: BlockMapConfig,
    solve_fn=None,
):
    """One keyframe-odometry frame: constant-velocity prediction, the solve
    in the prediction frame, exact covariance propagation to the composed
    state, the delta guard, the spawn policy and the map insert (skipped on
    a spawn frame, whose scan seeds the new block instead).  ``health0`` is
    the latched ``[n_corr, rms]`` of the keyframe's first solve (zeros right
    after a spawn), ``u`` the insert's uniforms, and ``solve_fn(model,
    scan0)`` replaces the residual-frame registration (the DNN step).

    Returns ``(res, X_rel, delta, diverged, spawn, health, new_bm)``;
    ``spawn`` is a host bool (the one read of this step besides the
    solver's), the others tensors."""
    x0, scan0 = _predict(scan, x_prev_rel, delta_prev, cfg)
    if solve_fn is None:
        res = register(model, scan0, torch.zeros_like(x0), cfg, want_static_mask=False)
    else:
        res = solve_fn(model, scan0)
    res, X, delta, diverged, spawn, health = _propagate(res, x0, x_prev_rel, delta_prev,
                                                        health0, kf_cfg)
    spawn = bool(spawn)
    new_bm = _blockmap_insert(bm, scan, X, u, bm_cfg, cfg.min_range, enabled=not spawn)
    return res, X, delta, diverged, spawn, health, new_bm


def keyframe_step_dnn(
    model: VoxelModel,
    bm: BlockMap,
    scan: torch.Tensor,
    key_scan: torch.Tensor,
    key_samples: tuple,
    x_prev_rel: torch.Tensor,
    delta_prev: torch.Tensor,
    u: torch.Tensor,
    health0: torch.Tensor,
    cfg: ICETConfig,
    kf_cfg: KeyframeConfig,
    bm_cfg: BlockMapConfig,
    net,
):
    """DNN-filtered keyframe step: the residual-frame registration runs with
    the perspective-shift rejection, sampling the KEYFRAME's raw points
    (``key_scan``; ``key_samples`` its :func:`model_voxel_samples`, taken
    once at spawn)."""

    def solve_fn(m, scan0):
        res, _ = register_with_dnn(m, key_scan, scan0, torch.zeros(6, dtype=scan.dtype,
                                                                 device=scan.device),
                                   cfg, net, want_static_mask=False, samples1=key_samples)
        return res

    return keyframe_step(model, bm, scan, x_prev_rel, delta_prev, u, health0,
                         cfg, kf_cfg, bm_cfg, solve_fn=solve_fn)


def keyframe_spawn(
    bm: BlockMap,
    scan: torch.Tensor,
    world_state: torch.Tensor,
    u: torch.Tensor,
    seed_insert: bool,
    cfg: ICETConfig,
    bm_cfg: BlockMapConfig,
) -> tuple[VoxelModel, BlockMap]:
    """Spawn a keyframe: fit the scan's voxel model and open its map block,
    seeded with the scan itself when ``seed_insert``."""
    model = prepare_reference(scan, cfg)
    bm = _blockmap_spawn(bm, world_state)
    bm = _blockmap_insert(bm, scan, torch.zeros(6, dtype=torch.float32, device=scan.device),
                          u, bm_cfg, cfg.min_range, enabled=seed_insert)
    return model, bm


# ---------------------------------------------------------------------------
# Sequence runner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KeyframeFrame:
    """Per-frame output; duck-type compatible with odometry.OdometryFrame."""

    index: int
    #: consecutive frame-to-frame step (what the pose graph consumes)
    X: np.ndarray
    pred_stds: np.ndarray
    T_world: np.ndarray
    diverged: bool
    #: pose relative to the current keyframe (the actual solve output)
    X_rel: np.ndarray
    #: True when this frame became a new keyframe
    is_keyframe: bool
    n_corr: np.ndarray
    #: Gauss-Newton iterations the frame's solve executed (a port-only
    #: field, as on OdometryFrame)
    iterations: int = 0


def keyframe_sequence(frames, model, bm, carry, gen, cfg, kf_cfg, bm_cfg):
    """Run the ``(F, N, 3)`` frames on their device, chained as the JAX
    package's ``keyframe_sequence_jit`` chains them; results stay on the
    device.  ``carry = (x_rel, delta, world_key6, health0, prev_stds)``.
    Each frame draws the insert's and the spawn's uniforms at once, spawn
    or not (the JAX package splits its key three ways a frame).  Returns
    ``(model, bm, carry), outs`` with per-frame outs ``(delta, delta_stds,
    world6, diverged, x_rel, n_corr, is_keyframe, iterations)``, each
    stacked over the frames (the last two host values as tensors)."""
    x_rel, delta, world_key, h0, prev_stds = carry
    K = bm_cfg.points_per_scan
    outs = []
    for scan in frames:
        u = _uniforms(gen, 2 * K, scan.device)
        res, x2, d2, div, spawn, health, bm = keyframe_step(
            model, bm, scan, x_rel, delta, u[:K], h0, cfg, kf_cfg, bm_cfg)
        h0 = update_health0(h0, health)
        world2 = compose_states(world_key, x2)
        delta_stds = torch.sqrt(res.pred_stds**2 + prev_stds**2)
        if spawn:
            model, bm = keyframe_spawn(bm, scan, world2, u[K:], True, cfg, bm_cfg)
            x_rel, h0, world_key = torch.zeros_like(x2), torch.zeros_like(h0), world2
            prev_stds = torch.zeros_like(prev_stds)
        else:
            x_rel, prev_stds = x2, res.pred_stds
        delta = d2
        outs.append((d2, delta_stds, world2, div, x2, health[0].to(torch.int32), spawn,
                      res.iterations))
    stacked = tuple(torch.stack([o[i] for o in outs]) for i in range(6)) + tuple(
        torch.tensor([o[i] for o in outs]) for i in (6, 7))
    return (model, bm, (x_rel, delta, world_key, h0, prev_stds)), stacked


# ---------------------------------------------------------------------------
# Capture-safe stages and the compiled entry points
# ---------------------------------------------------------------------------


def _stage_insert(mb, scan, X_rel, min_range: float, enabled, u=None) -> None:
    """:func:`_blockmap_insert` staged on the device for the map-write
    stage: the active block's slot, cursor and whether one is open come
    from the mirror ``mb.at``, the uniforms from ``u`` (default ``mb.u``);
    ``enabled`` is a host or device bool.  Every one of the ``min(K, P)``
    candidate samples gets a row (rows past the capacity wrap onto rows
    below the cursor, so no two samples share a row), its point, and
    whether it is written; the cursor moves as the eager insert's does."""
    B, P, K = mb.shape
    n = scan.shape[0]
    kw = min(K, P)
    u = mb.u if u is None else u
    slot, cursor, active = mb.at[0], mb.at[1], mb.at[2]
    local = transform_points(scan, X_rel)
    ok = torch.sum(scan * scan, dim=-1) > (min_range * min_range)
    ar = torch.arange(K, dtype=torch.float32, device=scan.device)
    take = torch.floor((ar + u.to(ar)) * (n / K)).to(torch.int64)
    take = torch.clamp(take, max=n - 1)[:kw]
    rows = cursor + torch.arange(kw, device=scan.device)
    mb.idx.copy_(slot * P + torch.remainder(rows, P))
    mb.vals.copy_(local[take])
    mb.write.copy_(ok[take] & (rows < P) & (active > 0) & enabled)
    moved = torch.clamp(cursor + K, max=P)
    if isinstance(enabled, bool):
        cursor.copy_(moved if enabled else cursor)
    else:
        cursor.copy_(torch.where(enabled, moved, cursor))


def _stage_write(mb, base: int) -> None:
    """The frame's staged map work written into the attached tables
    ``mb.tables`` (a whole map's, or the chunk of a sharded one whose first
    block is ``base``): where ``mb.spawn`` holds, the block at the mirror's
    slot is opened (its validity cleared, its pose ``mb.pose``), then the
    staged insert's rows get the new point where a sample is written and
    keep the old one elsewhere, the eager spawn's and insert's values bit
    for bit.  A chunk that does not hold the slot is left as it was."""
    points, valid, poses = mb.tables
    c, P = valid.shape
    slot = mb.at[0:1] - base
    own = (slot >= 0) & (slot < c)
    loc = torch.clamp(slot, 0, c - 1)
    pts, ok = points.view(-1, 3), valid.view(-1)
    opening = own & mb.spawn
    block = loc * P + torch.arange(P, device=loc.device)
    ok.index_put_((block,), ok[block] & ~opening)
    poses.index_copy_(0, loc, torch.where(opening, mb.pose, poses.index_select(0, loc)))
    idx = torch.clamp(mb.idx - base * P, 0, c * P - 1)
    write = mb.write & own
    pts.index_put_((idx,), torch.where(write[:, None], mb.vals, pts[idx]))
    ok.index_put_((idx,), ok[idx] | write)


def _table_sets(bm: BlockMap) -> list:
    """``((points, valid, poses), first block)`` of each part of ``bm``'s
    tables: the whole map, or each chunk of a sharded one."""
    if not isinstance(bm.points, BlockShards):
        return [((bm.points, bm.valid, bm.poses), 0)]
    per = bm.points.per
    return [(t, k * per) for k, t in enumerate(zip(bm.points.chunks, bm.valid.chunks,
                                                   bm.poses.chunks))]


def _write_map(fg, bm: BlockMap) -> None:
    """Replay the map-write graph of each table set of ``bm`` (one graph a
    set, keyed by its addresses), after the frame's stages on the same
    stream.  A chunk on another device takes a copy of the staging there,
    device to device, and replays a graph of that device's set."""
    mb = fg.buffers.map
    for tables, base in _table_sets(bm):
        dev = tables[0].device
        wg = fg if dev == fg.device else graphs.frame_graphs(dev, fg.n, fg.cfg)
        wmb = wg.map_buffers(*mb.shape)
        if wmb is not mb:
            graphs.copy_in(wmb.staging, mb.staging)
        wmb.tables = tables
        wg.run(("kf_write", mb.shape, base, wmb.key()),
               lambda b, base=base: _stage_write(b.map, base))


def _stage_predict(b, cfg: ICETConfig) -> None:
    """The prediction from the carry into ``b.kf["x0"]``, the pre-transformed
    raw scan into the solve's scan buffer, and a zero start."""
    x0, scan0 = _predict(b.raw, b.kf["x_rel"], b.kf["delta"], cfg)
    b.kf["x0"].copy_(x0)
    b.scan.copy_(scan0)
    b.x0.zero_()


def _stage_post(b, cfg: ICETConfig, kf_cfg: KeyframeConfig, n_final: int) -> None:
    """:func:`_propagate` of the finished result into ``b.kf_out`` (with the
    iterations the solve executed), then the insert of the raw scan at the
    guarded pose staged, ``enabled = ~spawn``, opening no block."""
    r = b.result[(n_final, False)]
    res = RegistrationResult(X=r["X"], pred_stds=r["pred_stds"], Q=r["Q"],
                             diagnostics=IterationDiag(**{k: r[k] for k in IterationDiag._fields}),
                             static_mask=r["static_mask"], iterations=0)
    res, X, delta, diverged, spawn, health = _propagate(
        res, b.kf["x0"], b.kf["x_rel"], b.kf["delta"], b.kf["h0"], kf_cfg)
    out = b.kf_out
    for name, t in (("X_total", res.X), ("Q", res.Q), ("pred_stds", res.pred_stds), ("X", X),
                    ("delta", delta), ("diverged", diverged), ("spawn", spawn),
                    ("health", health), ("iterations", b.iters[0])):
        out[name].copy_(t)
    _stage_insert(b.map, b.raw, X, cfg.min_range, ~spawn)
    b.map.spawn.fill_(False)


def _stage_spawn(b, cfg: ICETConfig, seed_insert: bool, carry_model: bool) -> None:
    """:func:`keyframe_spawn` of the raw scan: the prepare, the new block
    (the mirror's next slot, opened at the pose ``b.kf["world"]``) and the
    seeded insert from the spawn's uniforms staged for the map-write stage;
    with ``carry_model`` the new model goes into the model buffer too."""
    _stage_prepare(b, cfg, "raw")
    mb = b.map
    mb.at[0].copy_(torch.remainder(mb.at[0] + mb.at[2], mb.shape[0]))
    mb.at[1].zero_()
    mb.at[2].fill_(1)
    mb.spawn.fill_(True)
    mb.pose.copy_(b.kf["world"])
    _stage_insert(mb, b.raw, torch.zeros(6, dtype=torch.float32, device=b.raw.device),
                  cfg.min_range, seed_insert, mb.su)
    if carry_model:
        b.model_buf.copy_(b.prepared_buf)


def _stage_glue(b) -> None:
    """The sequence runner's bookkeeping after a step: the health latch, the
    world pose, the delta's stds, the frame's row, and the carry (reset on
    a spawn), all on the device."""
    c, o = b.kf, b.kf_out
    spawn = o["spawn"]
    h0 = update_health0(c["h0"], o["health"])
    world2 = compose_states(c["world_key"], o["X"])
    delta_stds = torch.sqrt(o["pred_stds"] ** 2 + c["prev_stds"] ** 2)
    world_key = torch.where(spawn, world2, c["world_key"])
    zero6 = torch.zeros_like(world2)
    row = b.kf_row
    for name, t in (("delta", o["delta"]), ("delta_stds", delta_stds), ("world6", world2),
                    ("diverged", o["diverged"]), ("x_rel", o["X"]), ("is_keyframe", spawn),
                    ("n_corr", o["health"][0].to(torch.int32)), ("iterations", b.iters[0])):
        row[name].copy_(t)
    c["x_rel"].copy_(torch.where(spawn, zero6, o["X"]))
    c["h0"].copy_(torch.where(spawn, torch.zeros_like(h0), h0))
    c["world_key"].copy_(world_key)
    c["prev_stds"].copy_(torch.where(spawn, zero6, o["pred_stds"]))
    c["delta"].copy_(o["delta"])
    c["world"].copy_(world2)


def _spawn_flag(b) -> torch.Tensor:
    return b.kf_out["spawn"]


def _frame_schedule(fg, cfg: ICETConfig, kf_cfg: KeyframeConfig) -> list:
    """One frame of the sequence runner: the prediction, the solve, the
    propagation with the insert staged, the glue, and the spawn (the
    prepare, the new block, the seeded insert and the model hand-over)
    guarded by the device's spawn flag, a host read only where the guard
    runs on the host (``spawn_reads``)."""
    return ([lambda b: _stage_predict(b, cfg)] + fg.solve_schedule(False)
            + [lambda b: _stage_post(b, cfg, kf_cfg, cfg.n_iters), _stage_glue,
               graphs.If(_spawn_flag, lambda b: _stage_spawn(b, cfg, True, True),
                         reads="spawn_reads")])


def _map_state(bm: BlockMap) -> tuple[int, int, int]:
    """The mirror's host value ``(slot, cursor, active)`` of ``bm``."""
    B = bm.poses.shape[0]
    return ((bm.n_blocks - 1) % B if bm.n_blocks else 0, bm.cursor, int(bm.n_blocks > 0))


def _keyframe_graphs(scan, cfg: ICETConfig, bm: BlockMap, bm_cfg: BlockMapConfig):
    """The frame graphs of ``scan``'s device, size and ``cfg`` with the map
    staging of ``bm``'s shape, its mirror holding ``bm``'s slot and cursor
    (copied in only when it holds something else).  The staging is keyed
    by the map's shape alone, sharded or not: only the map-write graphs
    are keyed by a map's tables."""
    fg = compiled_graphs(scan, cfg)
    mb = fg.map_buffers(*bm.valid.shape, bm_cfg.points_per_scan)
    want = _map_state(bm)
    if mb.expect != want:
        graphs.copy_in(mb.at, torch.tensor(want, dtype=torch.int64))
        mb.expect = want
    return fg


def _load_uniforms(dst: torch.Tensor, u) -> None:
    """Uniforms into the staging buffer ``dst``: drawn in place from ``u``
    when it is a generator (one ``torch.rand``, as the eager runners draw
    them), else copied."""
    if isinstance(u, torch.Generator):
        torch.rand(dst.shape, generator=u, out=dst)
        graphs.host_ops["draws"] += 1
    else:
        graphs.copy_in(dst, u)


def _load_step(fg, model, scan, x_prev_rel, delta_prev, u, health0) -> None:
    b = fg.buffers
    fg.load(model=model, raw=scan)
    for name, t in (("x_rel", x_prev_rel), ("delta", delta_prev), ("h0", health0)):
        graphs.copy_in(b.kf[name], t)
    _load_uniforms(b.map.u, u)


def _post(fg, cfg, kf_cfg, bm, n_final) -> dict:
    """Replay the step's post stage and the map-write graphs (the insert,
    gated on the device), then read the step's packed outputs, the spawn
    flag among them, in one copy (the one host read of a step)."""
    fg.run(("kf_post", kf_cfg, fg.buffers.map.shape, n_final),
           lambda b: _stage_post(b, cfg, kf_cfg, n_final))
    _write_map(fg, bm)
    graphs.host_ops["spawn_reads"] += 1
    host = fg.buffers.kf_out_buf.to("cpu", copy=True)
    return {k: v.numpy() for k, v in graphs.KF_OUT_LAYOUT.views(host).items()}


def _advance(fg, bm: BlockMap, bm_cfg: BlockMapConfig, spawn: bool) -> BlockMap:
    """The host's map after a step's insert (skipped on a spawn frame)."""
    if not spawn:
        bm = bm._replace(cursor=min(bm.cursor + bm_cfg.points_per_scan, bm.valid.shape[1]))
    fg.buffers.map.expect = _map_state(bm)
    return bm


def _step_result(fg, bm, bm_cfg, n_final, host: dict, host_out: bool):
    spawn = bool(host["spawn"])
    out = graphs.KF_OUT_LAYOUT.views(graphs.clone_out(fg.buffers.kf_out_buf))
    res = fg.result(False, n_final)
    res = res._replace(X=out["X_total"], Q=out["Q"], pred_stds=out["pred_stds"])
    step = (res, out["X"], out["delta"], out["diverged"], spawn, out["health"],
            _advance(fg, bm, bm_cfg, spawn))
    return step + (host,) if host_out else step


def keyframe_step_jit(
    model: VoxelModel,
    bm: BlockMap,
    scan: torch.Tensor,
    x_prev_rel: torch.Tensor,
    delta_prev: torch.Tensor,
    u,
    health0: torch.Tensor,
    cfg: ICETConfig,
    kf_cfg: KeyframeConfig,
    bm_cfg: BlockMapConfig,
    *,
    host_out: bool = False,
):
    """:func:`keyframe_step` as captured graphs (the JAX package's
    ``keyframe_step_jit``; ``u`` a generator or the uniforms): the
    prediction, the solve, the propagation, the guard, the spawn flag and
    the insert, gated on the device and written by the map-write graphs.
    The step's outputs are read on the host once, in one copy, for the
    spawn flag; ``host_out`` appends them to the result (numpy arrays by
    ``graphs.KF_OUT_LAYOUT``'s names)."""
    fg = _keyframe_graphs(scan, cfg, bm, bm_cfg)
    _load_step(fg, model, scan, x_prev_rel, delta_prev, u, health0)
    fg.run(("kf_predict",), lambda b: _stage_predict(b, cfg))
    fg.solve(False)
    host = _post(fg, cfg, kf_cfg, bm, cfg.n_iters)
    return _step_result(fg, bm, bm_cfg, cfg.n_iters, host, host_out)


def keyframe_step_dnn_jit(
    model: VoxelModel,
    bm: BlockMap,
    scan: torch.Tensor,
    key_scan: torch.Tensor,
    key_samples: tuple,
    x_prev_rel: torch.Tensor,
    delta_prev: torch.Tensor,
    u,
    health0: torch.Tensor,
    cfg: ICETConfig,
    kf_cfg: KeyframeConfig,
    bm_cfg: BlockMapConfig,
    net,
    *,
    host_out: bool = False,
):
    """:func:`keyframe_step_dnn` as captured graphs (the JAX package's
    ``keyframe_step_dnn_jit``): the filtered solve of
    ``filters.solve_dnn`` with the keyframe as scan 1, given by its
    samples (``key_scan`` is not read, as in the eager step); one host read
    and ``host_out`` as :func:`keyframe_step_jit`."""
    del key_scan
    fg = _keyframe_graphs(scan, cfg, bm, bm_cfg)
    _load_step(fg, model, scan, x_prev_rel, delta_prev, u, health0)
    fg.load(samples=key_samples)
    fg.run(("kf_predict",), lambda b: _stage_predict(b, cfg))
    n_final = solve_dnn(fg, net, False)
    host = _post(fg, cfg, kf_cfg, bm, n_final)
    return _step_result(fg, bm, bm_cfg, n_final, host, host_out)


def _spawn(fg, cfg, bm: BlockMap, bm_cfg: BlockMapConfig, seed_insert: bool,
           carry_model: bool) -> BlockMap:
    """Replay the spawn graph (the new block at the mirror's next slot,
    ``n_blocks`` mod B as :func:`_blockmap_spawn`'s, its pose
    ``b.kf["world"]``) and the map-write graphs; the host's counters
    follow."""
    fg.run(("kf_spawn", seed_insert, carry_model, fg.buffers.map.shape),
           lambda b: _stage_spawn(b, cfg, seed_insert, carry_model))
    _write_map(fg, bm)
    bm = bm._replace(n_blocks=bm.n_blocks + 1,
                     cursor=min(bm_cfg.points_per_scan, bm.valid.shape[1]) if seed_insert else 0)
    fg.buffers.map.expect = _map_state(bm)
    return bm


def keyframe_spawn_jit(
    bm: BlockMap,
    scan: torch.Tensor,
    world_state: torch.Tensor,
    u,
    seed_insert: bool,
    cfg: ICETConfig,
    bm_cfg: BlockMapConfig,
) -> tuple[VoxelModel, BlockMap]:
    """:func:`keyframe_spawn` as a captured graph (the JAX package's
    ``keyframe_spawn_jit``; ``u`` a generator or the uniforms); the block's
    pose ``world_state`` is copied in, and nothing is read."""
    seed_insert = bool(seed_insert)
    fg = _keyframe_graphs(scan, cfg, bm, bm_cfg)
    fg.load(raw=scan)
    _load_uniforms(fg.buffers.map.su, u)
    graphs.copy_in(fg.buffers.kf["world"], world_state)
    bm = _spawn(fg, cfg, bm, bm_cfg, seed_insert, False)
    return fg.prepared(), bm


def _read_block(rows: torch.Tensor) -> torch.Tensor:
    """The sequence runner's one host read a block: its stacked rows and
    the map's mirror."""
    graphs.host_ops["block_reads"] += 1
    return rows.cpu()


def keyframe_sequence_jit(frames, model0, bm0, carry0, cfg, kf_cfg, bm_cfg,
                          return_iterations: bool = False):
    """The ``(F, N, 3)`` frames chained on the device as captured graphs
    (the JAX package's ``keyframe_sequence_jit``).  Each frame draws both
    sets of uniforms (the insert's, then the spawn's: the JAX package's
    three-way key split), copies its scan in and replays two graphs: the
    frame's schedule (:func:`_frame_schedule`; the spawn, kernel #1's
    prepare among it, in an IF node on the device's spawn flag) and the
    map-write graph of each table set of ``bm0``.  Nothing is read inside
    the block: the device mirror of the map's slot and cursor is the truth
    there, and the block's end reads it with the stacked outputs in one
    copy, from which the host's ``n_blocks`` (the old count plus the
    block's keyframes) and ``cursor`` follow.

    ``carry0 = (x_rel, delta, world_key6, gen, health0, prev_stds)``, a
    ``torch.Generator`` in the JAX key's place; returns ``(model, bm,
    carry), outs`` with per-frame outs ``(delta, delta_stds, world6,
    diverged, x_rel, is_keyframe, n_corr)`` stacked, as the JAX package's,
    on the host (the block-end read); with ``return_iterations`` a third
    element follows, the iterations each frame executed (an ``(F,)``
    int64 tensor).  The model and carry stay on the device."""
    if frames.ndim != 3 or frames.shape[0] == 0:
        raise ValueError(f"frames must be a non-empty (F, N, 3) block, got {tuple(frames.shape)}")
    x_rel, delta, world_key, gen, h0, prev_stds = carry0
    fg = _keyframe_graphs(frames[0], cfg, bm0, bm_cfg)
    b = fg.buffers
    mb = b.map
    fg.load(model=model0)
    fg.hold("model", None)  # a spawn hands its model over in the buffer
    for name, t in (("x_rel", x_rel), ("delta", delta), ("world_key", world_key), ("h0", h0),
                    ("prev_stds", prev_stds)):
        graphs.copy_in(b.kf[name], t)
    schedule = _frame_schedule(fg, cfg, kf_cfg)
    F = frames.shape[0]
    rows = torch.empty((F + 1, graphs.KF_ROW_LAYOUT.nbytes), dtype=torch.uint8, device=fg.device)
    for k in range(F):
        _load_uniforms(mb.draws, gen)
        fg.load(raw=frames[k])
        fg.run_schedule(("kf_frame", kf_cfg, mb.shape), schedule)
        _write_map(fg, bm0)
        graphs.copy_in(rows[k], b.kf_row_buf)
    graphs.copy_in(rows[F, :mb.at.nbytes].view(torch.int64), mb.at)
    host = _read_block(rows)
    out = graphs.KF_ROW_LAYOUT.stacked_views(host[:F])
    at = tuple(host[F, :mb.at.nbytes].view(torch.int64).tolist())
    bm = bm0._replace(n_blocks=bm0.n_blocks + int(out["is_keyframe"].sum()), cursor=at[1])
    if at != _map_state(bm):
        raise RuntimeError(f"the map mirror {at} disagrees with the block's keyframes "
                           f"({_map_state(bm)})")
    mb.expect = at
    c = graphs.KF_CARRY_LAYOUT.views(graphs.clone_out(b.kf_buf))
    carry = (c["x_rel"], c["delta"], c["world_key"], gen, c["h0"], c["prev_stds"])
    outs = tuple(out[name] for name, *_ in graphs.KF_ROW_LAYOUT.fields if name != "iterations")
    result = ((fg.model_copy(), bm, carry), outs)
    return result + (out["iterations"],) if return_iterations else result


def run_keyframe_device(
    scans,
    cfg: ICETConfig | None = None,
    kf_cfg: KeyframeConfig | None = None,
    bm_cfg: BlockMapConfig | None = None,
    block: int = 64,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> tuple[list[KeyframeFrame], BlockMap]:
    """Run a recorded ``(F, N, 3)`` sequence on ``device`` (CUDA unless told
    otherwise) in ``block``-frame uploads, chained on the device; results
    come back once per block.  Returns the same :class:`KeyframeFrame`
    records as :class:`KeyframeOdometry` and the final block map.  The
    seed spawn is :func:`keyframe_spawn_jit` and each block one
    :func:`keyframe_sequence_jit`, one host read a block.
    ``cfg.dnn_filter`` raises NotImplementedError: use
    :class:`KeyframeOdometry`, whose DNN step carries the keyframe's
    per-voxel samples."""
    cfg = cfg or ICETConfig()
    if cfg.dnn_filter:
        raise NotImplementedError(
            "run_keyframe_device does not support cfg.dnn_filter; use "
            "KeyframeOdometry (per-frame steps) for the DNN-filtered mode"
        )
    kf_cfg = kf_cfg or KeyframeConfig()
    bm_cfg = bm_cfg or BlockMapConfig()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scans = np.asarray(scans, np.float32)
    bm = blockmap_init(bm_cfg, dev)
    zero6 = torch.zeros(6, device=dev)
    model, bm = keyframe_spawn_jit(bm, as_points(scans[0], dev), zero6,
                                   _uniforms(gen, bm_cfg.points_per_scan, dev), True, cfg, bm_cfg)
    carry = (zero6, zero6, zero6, gen, torch.zeros(2, device=dev), zero6)
    frames: list[KeyframeFrame] = []
    for s in range(1, scans.shape[0], block):
        blk = torch.from_numpy(scans[s : s + block]).to(dev)
        (model, bm, carry), outs, iters = keyframe_sequence_jit(
            blk, model, bm, carry, cfg, kf_cfg, bm_cfg, return_iterations=True)
        d2, stds, world6, div, x2, is_kf, n_corr, iters = (o.numpy() for o in (*outs, iters))
        for j in range(d2.shape[0]):
            frames.append(KeyframeFrame(
                index=s + j,
                X=d2[j],
                pred_stds=stds[j],
                T_world=np_pose_matrix(world6[j]),
                diverged=bool(div[j]),
                X_rel=x2[j],
                is_keyframe=bool(is_kf[j]),
                n_corr=np.asarray(n_corr[j]),
                iterations=int(iters[j]),
            ))
    return frames, bm


# ---------------------------------------------------------------------------
# Host loop
# ---------------------------------------------------------------------------


class KeyframeOdometry:
    """Streaming keyframe odometry with an attached keyframe block map, on
    ``device`` (CUDA unless told otherwise).  Each frame runs one keyframe
    step (register + delta guard + map insert); keyframe frames add a
    prepare and a block spawn.  With ``cfg.dnn_filter`` every solve runs
    the perspective-shift rejection (the bundled bias network, loaded
    once), sampling the keyframe scan, whose samples are taken at spawn.

    The map sharded or not, each frame is one :func:`keyframe_step_jit` (or
    :func:`keyframe_step_dnn_jit`) and each keyframe one
    :func:`keyframe_spawn_jit` (and :func:`~icet_tpu_torch.filters.
    model_voxel_samples_jit`); they draw their uniforms from the runner's
    generator.  An unknown ``cfg.moment_method`` raises ValueError here,
    before any frame."""

    def __init__(
        self,
        cfg: ICETConfig | None = None,
        kf_cfg: KeyframeConfig | None = None,
        bm_cfg: BlockMapConfig | None = None,
        seed: int = 0,
        device: str | torch.device | None = None,
        snapshot_every: int = 10,
    ):
        self.cfg = cfg or ICETConfig()
        self.kf_cfg = kf_cfg or KeyframeConfig()
        self.bm_cfg = bm_cfg or BlockMapConfig()
        self.device = resolve_device(device)
        self._seed = seed
        #: host-snapshot cadence for recovery: a failed step may leave the
        #: block map half-written, so recovery restores the newest snapshot
        #: (a :func:`~icet_tpu_torch.utils.checkpoint.keyframe_state`, taken
        #: every ``snapshot_every`` frames); inserts since it are lost.
        self.snapshot_every = snapshot_every
        self._dnn = pretrained_dnn(self.cfg, self.device) if self.cfg.dnn_filter else None
        moment_route(self.cfg)
        self.reset()

    def reset(self) -> None:
        dev = self.device
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(self._seed)
        self._model = None
        self._key_scan = None
        self._key_samples = None
        self.blockmap = blockmap_init(self.bm_cfg, dev)
        self._T_key = np.eye(4)
        self._x_rel = torch.zeros(6, device=dev)
        self._delta = torch.zeros(6, device=dev)
        self._stds_rel = np.zeros(6, np.float32)
        self._health0: torch.Tensor | None = None
        self._index = 0
        self.keyframe_states: list[np.ndarray] = []
        self.keyframe_indices: list[int] = []
        #: world pose at which the next seed spawn opens (identity for a
        #: fresh run; a restore or a recovery sets it)
        self._resume_T = np.eye(4)
        #: whether the next spawn seeds its block with its scan (a restore
        #: with ``replay_overlap`` clears it for one spawn)
        self._resume_seed_insert = True
        self._snapshot: dict | None = None
        #: the newest completed world pose (recovery spawns there)
        self._T_world_host = np.eye(4)
        self.recoveries = 0

    def _spawn(self, scan_dev: torch.Tensor, T_world: np.ndarray) -> None:
        state = np_pose_to_state(T_world).astype(np.float32)
        self._model, self.blockmap = keyframe_spawn_jit(
            self.blockmap, scan_dev, torch.from_numpy(state).to(self.device), self._gen,
            self._resume_seed_insert, self.cfg, self.bm_cfg,
        )
        self._resume_seed_insert = True
        self._T_key = T_world
        if self._dnn is not None:
            self._key_scan = scan_dev
            self._key_samples = model_voxel_samples_jit(self._model, scan_dev, self.cfg)
        self._x_rel = torch.zeros(6, device=self.device)
        # Right after a spawn x_prev_rel is exactly zero, so the previous
        # solve's stds are zero too.
        self._stds_rel = np.zeros(6, np.float32)
        self._health0 = None  # latched by the first solve against this keyframe
        self.keyframe_states.append(state)
        self.keyframe_indices.append(self._index)

    def step(self, scan) -> KeyframeFrame | None:
        """Feed one scan; returns None for the very first frame.

        Survives a failed step: on any exception but a TypeError or a
        ValueError the pipeline probes the device, restores the newest
        host snapshot (every ``snapshot_every`` frames; the generator state
        included) and retries; the retried frame spawns a keyframe at the
        newest completed pose (and returns None), inserts since the
        snapshot are lost, odometry goes on.  ``recoveries`` counts these.
        On CUDA this covers failures that leave the context usable; after
        a sticky error the probe finds no device or the retry raises."""
        try:
            frame = self._step_device(scan)
        except (TypeError, ValueError):
            raise
        except Exception:
            _log.warning("frame %d failed; recovering", self._index, exc_info=True)
            self._recover()
            frame = self._step_device(scan)
        if self._index % self.snapshot_every == 0:
            from icet_tpu_torch.utils.checkpoint import keyframe_state

            self._snapshot = keyframe_state(self)
        return frame

    def _recover(self) -> None:
        from icet_tpu_torch.parallel.elastic import probe_devices

        if not probe_devices([self.device]):
            raise RuntimeError(f"device {self.device} does not answer")
        self.recoveries += 1
        # The failed frame may have left a capture or its buffers half-done.
        graphs.clear(self.device)
        idx, rec, T_last = self._index, self.recoveries, self._T_world_host
        if self._snapshot is None:
            self.reset()
        else:
            from icet_tpu_torch.utils.checkpoint import restore_keyframe

            restore_keyframe(self, self._snapshot)
        self._index, self.recoveries = idx, rec
        self._T_world_host = T_last
        # Spawn at the newest completed pose, not the snapshot's: block
        # poses describe themselves, so a newer keyframe fits an older map.
        self._resume_T = T_last

    def _step_device(self, scan) -> KeyframeFrame | None:
        scan_dev = as_points(scan, self.device)
        if self._model is None:
            self._spawn(scan_dev, self._resume_T)
            self._index += 1
            return None

        health0 = (self._health0 if self._health0 is not None
                   else torch.zeros(2, device=self.device))  # fresh keyframe: tests off
        # The step reads its outputs once and hands them over.
        if self._dnn is not None:
            step = keyframe_step_dnn_jit(
                self._model, self.blockmap, scan_dev, self._key_scan, self._key_samples,
                self._x_rel, self._delta, self._gen, health0,
                self.cfg, self.kf_cfg, self.bm_cfg, self._dnn, host_out=True,
            )
        else:
            step = keyframe_step_jit(
                self._model, self.blockmap, scan_dev, self._x_rel, self._delta,
                self._gen, health0, self.cfg, self.kf_cfg, self.bm_cfg, host_out=True,
            )
        _, x_rel, delta, _, spawn, health, self.blockmap, host = step
        self._health0 = update_health0(health0, health)
        self._x_rel = x_rel
        self._delta = delta
        X_rel, delta_np, cur_stds = host["X"], host["delta"], host["pred_stds"]
        T_world = self._T_key @ np_pose_matrix(X_rel)
        self._T_world_host = T_world

        # The reported X is the consecutive-frame DELTA (the difference of
        # two keyframe-relative solves), so its stds bound the delta's:
        # sqrt(cur^2 + prev^2), exact right after a spawn.
        delta_stds = np.sqrt(cur_stds**2 + self._stds_rel**2)
        if spawn:
            self._spawn(scan_dev, T_world)  # zeroes _stds_rel
        else:
            self._stds_rel = cur_stds

        frame = KeyframeFrame(
            index=self._index,
            X=delta_np,
            pred_stds=delta_stds,
            T_world=T_world,
            diverged=bool(host["diverged"]),
            X_rel=X_rel,
            is_keyframe=spawn,
            n_corr=np.asarray(host["health"][0]).astype(np.int32),
            iterations=int(host["iterations"]),
        )
        self._index += 1
        return frame

    def run(self, scans) -> list[KeyframeFrame]:
        out = []
        for scan in scans:
            f = self.step(scan)
            if f is not None:
                out.append(f)
        return out

    def map_points(self) -> np.ndarray:
        """Current map in the world frame as (M, 3) numpy."""
        pts, ok = blockmap_world_points(self.blockmap)
        return pts[ok].cpu().numpy()


__all__ = [
    "BlockMap",
    "BlockShards",
    "KeyframeFrame",
    "KeyframeOdometry",
    "blockmap_init",
    "blockmap_refresh_poses",
    "blockmap_world_points",
    "keyframe_sequence",
    "keyframe_sequence_jit",
    "keyframe_spawn",
    "keyframe_spawn_jit",
    "keyframe_step",
    "keyframe_step_dnn",
    "keyframe_step_dnn_jit",
    "keyframe_step_jit",
    "np_pose_matrix",
    "np_pose_to_state",
    "run_keyframe_device",
    "shard_blockmap",
    "update_health0",
    "whole_table",
]
