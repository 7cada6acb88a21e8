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
* the spawn decision is read on the host once a frame (the JAX sequence
  runner decides inside a ``lax.cond``); it gates the frame's map insert
  and the keyframe prepare.  Besides it, the solver reads ``|dx|`` on the
  host once an iteration, as in :mod:`icet_tpu_torch.solver`;
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
"""

from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple

import numpy as np
import torch

from icet_tpu_torch.config import BlockMapConfig, ICETConfig, KeyframeConfig
from icet_tpu_torch.device import as_points, resolve_device
from icet_tpu_torch.filters import model_voxel_samples, pretrained_dnn, register_with_dnn
from icet_tpu_torch.ops.geometry import (
    compose_states,
    euler_R,
    point_norm,
    relative_state,
    transform_points,
)
from icet_tpu_torch.solver import VoxelModel, prepare_reference, register

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
    x0 = compose_states(x_prev_rel, delta_prev)
    # Raw-invalid points are zeroed BEFORE the pre-transform, so dropouts
    # cannot resurrect at |t0|.
    scan0 = torch.where(
        (point_norm(scan) >= cfg.min_range)[:, None],
        transform_points(scan, x0),
        torch.zeros((), dtype=scan.dtype, device=scan.device),
    )
    if solve_fn is None:
        res = register(model, scan0, torch.zeros_like(x0), cfg, want_static_mask=False)
    else:
        res = solve_fn(model, scan0)
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
    Returns ``(model, bm, carry), outs`` with per-frame outs ``(delta,
    delta_stds, world6, diverged, x_rel, n_corr, is_keyframe, iterations)``,
    each stacked over the frames (the last two host values as tensors)."""
    x_rel, delta, world_key, h0, prev_stds = carry
    K = bm_cfg.points_per_scan
    outs = []
    for scan in frames:
        u = _uniforms(gen, K, scan.device)
        res, x2, d2, div, spawn, health, bm = keyframe_step(
            model, bm, scan, x_rel, delta, u, h0, cfg, kf_cfg, bm_cfg)
        h0 = update_health0(h0, health)
        world2 = compose_states(world_key, x2)
        delta_stds = torch.sqrt(res.pred_stds**2 + prev_stds**2)
        if spawn:
            model, bm = keyframe_spawn(bm, scan, world2, _uniforms(gen, K, scan.device),
                                       True, cfg, bm_cfg)
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
    records as :class:`KeyframeOdometry` and the final block map.
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
    model, bm = keyframe_spawn(bm, as_points(scans[0], dev), zero6,
                               _uniforms(gen, bm_cfg.points_per_scan, dev), True, cfg, bm_cfg)
    carry = (zero6, zero6, zero6, torch.zeros(2, device=dev), zero6)
    frames: list[KeyframeFrame] = []
    for s in range(1, scans.shape[0], block):
        blk = torch.from_numpy(scans[s : s + block]).to(dev)
        (model, bm, carry), outs = keyframe_sequence(blk, model, bm, carry, gen,
                                                     cfg, kf_cfg, bm_cfg)
        d2, stds, world6, div, x2, n_corr, is_kf, iters = (o.cpu().numpy() for o in outs)
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
    once), sampling the keyframe scan, whose samples are taken at spawn."""

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

    def _uniforms(self) -> torch.Tensor:
        return _uniforms(self._gen, self.bm_cfg.points_per_scan, self.device)

    def _spawn(self, scan_dev: torch.Tensor, T_world: np.ndarray) -> None:
        state = np_pose_to_state(T_world).astype(np.float32)
        self._model, self.blockmap = keyframe_spawn(
            self.blockmap, scan_dev, torch.from_numpy(state).to(self.device),
            self._uniforms(), self._resume_seed_insert, self.cfg, self.bm_cfg,
        )
        self._resume_seed_insert = True
        self._T_key = T_world
        if self._dnn is not None:
            self._key_scan = scan_dev
            self._key_samples = model_voxel_samples(self._model, scan_dev, self.cfg)
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
        if self._dnn is not None:
            step = keyframe_step_dnn(
                self._model, self.blockmap, scan_dev, self._key_scan, self._key_samples,
                self._x_rel, self._delta, self._uniforms(), health0,
                self.cfg, self.kf_cfg, self.bm_cfg, self._dnn,
            )
        else:
            step = keyframe_step(
                self._model, self.blockmap, scan_dev, self._x_rel, self._delta,
                self._uniforms(), health0, self.cfg, self.kf_cfg, self.bm_cfg,
            )
        res, x_rel, delta, diverged, spawn, health, self.blockmap = step
        self._health0 = update_health0(health0, health)
        self._x_rel = x_rel
        self._delta = delta
        host = torch.cat([x_rel, delta, res.pred_stds, diverged[None].float(),
                          health[:1]]).cpu().numpy()
        X_rel, delta_np, cur_stds = host[0:6], host[6:12], host[12:18]
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
            diverged=bool(host[18]),
            X_rel=X_rel,
            is_keyframe=spawn,
            n_corr=np.asarray(host[19]).astype(np.int32),
            iterations=res.iterations,
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
    "keyframe_spawn",
    "keyframe_step",
    "keyframe_step_dnn",
    "np_pose_matrix",
    "np_pose_to_state",
    "run_keyframe_device",
    "shard_blockmap",
    "update_health0",
    "whole_table",
]
