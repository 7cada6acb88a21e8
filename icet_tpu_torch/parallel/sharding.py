"""Batched, point-sharded registration on a mesh of devices in one process
(``icet_tpu/parallel/sharding.py``).

A :class:`Mesh` is a ``(dp, sp)`` grid of ``torch.device``s:

* ``dp``: independent scan PAIRS, split over the mesh's rows;
* ``sp``: the POINTS of each scan, split over a row's devices.  Each
  device runs the moments pass over its point shard (kernel #1 on the
  card), and the ``(V+1, 16)`` sums are added on the row's first device,
  once a prepare and once a Gauss-Newton iteration: the counterpart of the
  JAX package's ``lax.psum(sums, "sp")``.  The radial clustering routes
  each point to the device owning its voxel range.  All per-voxel math
  (eigensystems, the 6x6 solve) runs once, on the row's first device.

Devices may repeat, so one card (or the CPU, in the tests) stands in for
several, as the JAX package's tests use 8 virtual CPU devices.  The shard
axis object, :class:`DeviceAxis`, is what the solver takes as ``axis``;
the multi-process mesh (:mod:`icet_tpu_torch.parallel.distributed`)
supplies its own, so the shard math is written once, in the solver.

:func:`make_sharded_register` (the JAX package's ``jax.jit(shard_map(...))``)
runs each pair as one captured schedule (:func:`sharded_pair` over a
``graphs.ShardedGraphs`` set a mesh row): the clustering's bucket count,
the prepare in two branches (an if/else of IF nodes on the summed
overflow, the JAX package's ``lax.cond``), the Gauss-Newton iterations
(the early exit on the device, as the unsharded compiled solve) and the
finish.  The stages are the solver's shard math, split at the axis's
collectives; on the CPU they run as plain calls, the guards read on the
host, and equal :func:`make_sharded_register_eager` (``register_pair_impl``
with the axis, pair by pair) bit for bit.  A row of distinct devices (a
card and the CPU) runs its parts as separate graphs with the guards read
on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icet_tpu_torch import graphs, solver
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.device import resolve_device
from icet_tpu_torch.ops.clustering import (
    ClusterResult,
    cluster_buckets,
    cluster_plan,
    cluster_points,
    cluster_table,
    clusters_of_points,
    clusters_of_tables,
)
from icet_tpu_torch.ops.geometry import cart_to_spherical
from icet_tpu_torch.ops.grid import voxel_anchors, voxel_ids
from icet_tpu_torch.solver import (
    IterationDiag,
    RegistrationResult,
    exit_schedule,
    finish_result,
    fixed_clusters,
    iteration_from_sums,
    model_from_sums,
    register_pair_impl,
    static_mask_of,
)


class DeviceAxis:
    """One axis of an in-process mesh, as the solver's shard ``axis``.

    This process holds every shard of the axis: local data is a list with
    one tensor per device of ``devices``, in order (``index`` is
    ``(0, ..., size - 1)``).  Results of ``psum`` and ``all_gather`` lie on
    ``device``, the axis's first device; ``all_to_all`` returns each
    shard's part on its own device.  ``collectives`` and ``bytes`` count
    the calls and one shard's payload in bytes."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        self.size = len(self.devices)
        self.index = tuple(range(self.size))
        self.device = self.devices[0]
        self.shard_devices = self.devices
        self.collectives = 0
        self.bytes = 0

    def _count(self, t: torch.Tensor) -> None:
        self.collectives += 1
        self.bytes += t.numel() * t.element_size()

    def psum(self, xs: list) -> torch.Tensor:
        """The sum of the shards' tensors, added in shard order."""
        self._count(xs[0])
        out = xs[0].to(self.device)
        for x in xs[1:]:
            out = out + x.to(self.device)
        return out

    def all_to_all(self, xs: list) -> list:
        """Shard i's ``xs[i][j]`` goes to shard j: shard j receives
        ``stack([xs[i][j] for i])``.  Each ``xs[i]`` has ``size`` rows."""
        self._count(xs[0])
        return [torch.stack([x[j].to(d) for x in xs]) for j, d in enumerate(self.devices)]

    def all_gather(self, xs: list) -> torch.Tensor:
        """The shards' tensors concatenated along dim 0, in shard order."""
        self._count(xs[0])
        return torch.cat([x.to(self.device) for x in xs])


class Mesh:
    """A ``(dp, sp)`` grid of devices; ``devices[r, c]`` is row r's c-th."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis(self, name: str, row: int = 0) -> DeviceAxis:
        """Row ``row``'s shard axis for ``"sp"``; the mesh's first column
        for ``"dp"``."""
        if name == "sp":
            return DeviceAxis(self.devices[row])
        if name == "dp":
            return DeviceAxis(self.devices[:, 0])
        raise ValueError(f"no mesh axis {name!r}")


def _local_devices() -> list:
    resolve_device(None)  # raises without CUDA
    return [torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]


def registration_mesh(dp: int = 1, sp: int | None = None, devices=None) -> Mesh:
    """Build a ``(dp, sp)`` mesh of ``devices`` (row-major; repeats
    allowed).  Defaults: every local CUDA device, all on ``sp``."""
    devices = list(devices) if devices is not None else _local_devices()
    if sp is None:
        sp = len(devices) // dp
    if dp * sp != len(devices):
        raise ValueError(f"a ({dp}, {sp}) mesh needs {dp * sp} devices, got {len(devices)}")
    grid = np.empty(dp * sp, dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return Mesh(grid.reshape(dp, sp))


class ShardedBatch(NamedTuple):
    #: ``[row][col]`` point shards ``(B/dp, N/sp, 3)`` on ``devices[row, col]``
    scans1: list
    scans2: list
    #: ``[row]`` initial states ``(B/dp, 6)`` on the row's first device
    x0s: list


def _f32(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} {n} does not divide by the mesh axis size {parts}")
    return n // parts


def shard_scan_batch(scans1, scans2, x0s, mesh: Mesh) -> ShardedBatch:
    """Place a ``(B, N, 3)`` batch of pairs and ``(B, 6)`` initial states
    on ``mesh``: pairs over ``dp``, points over ``sp``.  Raises ValueError
    where B or N does not divide."""
    dp, sp = mesh.devices.shape
    s1, s2, x0 = (_f32(a) for a in (scans1, scans2, x0s))
    b = _split(s1.shape[0], dp, "batch")
    n = _split(s1.shape[1], sp, "points")

    def cut(s, r):
        return [s[r * b:(r + 1) * b, c * n:(c + 1) * n].contiguous().to(mesh.devices[r, c])
                for c in range(sp)]

    return ShardedBatch(
        scans1=[cut(s1, r) for r in range(dp)],
        scans2=[cut(s2, r) for r in range(dp)],
        x0s=[x0[r * b:(r + 1) * b].to(mesh.devices[r, 0]) for r in range(dp)],
    )


def stack_results(results: list, device) -> RegistrationResult:
    """Per-pair results stacked along a leading batch axis on ``device``
    (``iterations`` as a ``(B,)`` int64 tensor: on ``device`` where the
    pairs' counts are device counts, else on the CPU)."""

    def stack(get):
        return torch.stack([get(r).to(device) for r in results])

    return RegistrationResult(
        X=stack(lambda r: r.X),
        pred_stds=stack(lambda r: r.pred_stds),
        Q=stack(lambda r: r.Q),
        diagnostics=IterationDiag(*(stack(lambda r, k=k: r.diagnostics[k])
                                    for k in range(len(IterationDiag._fields)))),
        static_mask=stack(lambda r: r.static_mask),
        iterations=(stack(lambda r: r.iterations)
                    if isinstance(results[0].iterations, torch.Tensor)
                    else torch.tensor([r.iterations for r in results], dtype=torch.int64)),
    )


# ---------------------------------------------------------------------------
# The compiled sharded step
# ---------------------------------------------------------------------------
#
# Each stage is a list of steps over a row's buffers (graphs.ShardedBuffers):
# "shard" steps read and write one shard's buffers on its device, "rep"
# steps the replicated buffers on the axis device, and "join" steps move
# data between them through the axis (``sg.axis``, bound for each pair).
# Python-level branches depend on the config alone.


def _moments_steps(sg, cfg: ICETConfig, scan: str) -> list:
    """Every shard's moments pass of scan ``scan`` at its ``X``, then the
    sum over the axis into ``rep.sums``."""

    def sums(sh):
        sh.sums.copy_(solver._moment_sums(getattr(sh, scan), sh.X, sh.bounds, sh.anchors, cfg))

    def total(b):
        b.rep.sums.copy_(sg.axis.psum([sh.sums for sh in b.shards]))

    return [("shard", sums), ("join", total)]


def _x_to_shards(src: str):
    def join(b):
        for sh in b.shards:
            sh.X.copy_(getattr(b.rep, src))
    return ("join", join)


def _count_steps(sg, cfg: ICETConfig) -> list:
    """The distributed clustering's buckets on every shard and their summed
    overflow, left as a flag in ``rep.overflow``."""
    vps, cap = cluster_plan(sg.n, cfg.n_voxels, sg.shards)

    def bucket(sh):
        rtp = cart_to_spherical(sh.scan1)
        r = rtp[..., 0]
        vid, ok = voxel_ids(rtp, cfg), r >= cfg.min_range
        sends, overflow = cluster_buckets(vid, r, ok, cfg.n_voxels, sg.shards, vps, cap)
        sh.sends.copy_(sends)
        sh.overflow.copy_(overflow)
        sh.points.copy_(cluster_points(vid, r, ok, cfg.n_voxels))

    def total(b):
        torch.gt(sg.axis.psum([sh.overflow for sh in b.shards]), 0, out=b.rep.overflow)

    return [("shard", bucket), ("join", total)]


def _cluster_steps(sg, cfg: ICETConfig, branch: str) -> list:
    """Scan 1's clusters and anchors into ``rep.model`` by ``branch``
    (``"gather"``: the whole cloud gathered; ``"sharded"``: the buckets
    exchanged and each shard's voxels clustered where they live;
    ``"fixed"``: fixed radial mode's shells)."""
    vps, _ = cluster_plan(sg.n, cfg.n_voxels, sg.shards)
    args = (cfg.min_pts, cfg.cluster_gap, cfg.cluster_buffer)

    def keep(rep, cl):
        rep.model.bounds.copy_(cl.bounds)
        rep.found.copy_(cl.found)
        rep.model.anchors.copy_(voxel_anchors(cl.bounds, cfg))

    if branch == "gather":
        def gather(b):
            b.rep.points.copy_(sg.axis.all_gather([sh.points for sh in b.shards]))
        steps = [("join", gather),
                 ("rep", lambda rep: keep(rep, clusters_of_points(rep.points, cfg.n_voxels,
                                                                  *args)))]
    elif branch == "sharded":
        def exchange(b):
            for sh, recv in zip(b.shards, sg.axis.all_to_all([sh.sends for sh in b.shards])):
                sh.recv.copy_(recv)

        def table(sh):
            sh.table.copy_(cluster_table(sh.recv, sg.axis.index[sh.local], vps, *args))

        def tables(b):
            b.rep.tables.copy_(sg.axis.all_gather([sh.table for sh in b.shards]))

        steps = [("join", exchange), ("shard", table), ("join", tables),
                 ("rep", lambda rep: keep(rep, clusters_of_tables(rep.tables, cfg.n_voxels)))]
    else:
        steps = [("rep", lambda rep: keep(rep, fixed_clusters(cfg, rep.X.device)))]
    return steps


def _model_steps(sg, cfg: ICETConfig) -> list:
    """The rest of scan 1's model from its clusters: the bounds and anchors
    to the shards, the moments at X = 0 and the replicated finalize."""

    def to_shards(b):
        for sh in b.shards:
            sh.bounds.copy_(b.rep.model.bounds)
            sh.anchors.copy_(b.rep.model.anchors)
            sh.X.zero_()

    def finalize(rep):
        m = rep.model
        model = model_from_sums(rep.sums, ClusterResult(m.bounds, rep.found), m.anchors, cfg)
        for dst, src in zip(m, model):
            dst.copy_(src)

    return [("join", to_shards), *_moments_steps(sg, cfg, "scan1"), ("rep", finalize)]


def _iteration_steps(sg, cfg: ICETConfig, it: int, first: bool) -> list:
    """Gauss-Newton iteration ``it`` of scan 2: from ``rep.x0`` with the cold
    6x6 eigendecomposition (``first``), else from ``rep.X`` and ``rep.U2``."""
    src = "x0" if first else "X"

    def math(rep):
        if first:
            rep.it.zero_()
            rep.iters.zero_()
        out = iteration_from_sums(rep.model, rep.sums, getattr(rep, src), it, cfg, None,
                                  None if first else rep.U2)
        solver._commit(rep, cfg, *out[:6])

    return [_x_to_shards(src), *_moments_steps(sg, cfg, "scan2"), ("rep", math)]


def _finish_steps(sg, cfg: ICETConfig) -> list:
    """The finish (``solver._stage_finish`` over the shards): the range
    sensitivity's moments pass where ``range_sigma > 0``, the predicted
    covariance and diagnostics, and each shard's slice of the static mask
    gathered in shard order."""
    n_it = cfg.n_iters
    steps = []
    if cfg.range_sigma > 0.0:
        steps += [_x_to_shards("X"), *_moments_steps(sg, cfg, "scan2")]

    def math(rep):
        sens = None
        if cfg.range_sigma > 0.0:
            sens = iteration_from_sums(rep.model, rep.sums, rep.X, n_it - 1, cfg, None, rep.U2,
                                       want_range_sens=True)
        finish_result(rep, cfg, True, sens)

    def to_shards(b):
        for sh in b.shards:
            sh.X.copy_(b.rep.X)
            sh.corr.copy_(b.rep.corr)

    def mask(sh):
        sh.mask.copy_(static_mask_of(sh.scan2, sh.X, sh.bounds, sh.corr, cfg))

    def gather(b):
        dev = b.rep.X.device
        b.rep.result[(n_it, True)]["static_mask"].copy_(
            torch.cat([sh.mask.to(dev) for sh in b.shards]))

    return steps + [("rep", math), ("join", to_shards), ("shard", mask), ("join", gather)]


def _rep_overflow(b) -> torch.Tensor:
    return b.rep.overflow


def _rep_go(b) -> torch.Tensor:
    return b.rep.go


def pair_schedule(sg, cfg: ICETConfig) -> list:
    """One pair's schedule (``graphs.ShardedGraphs.run_schedule``): the
    bucket count and the clustering's two branches on the summed overflow
    (``"gather"`` where a bucket overflowed, else ``"sharded"``; fixed
    radial mode has one), the rest of the prepare, iteration 0, the
    iterations below ``min_it``, each later one guarded by ``go``, the
    finish."""
    if cfg.radial_mode == "fixed":
        entries = [_cluster_steps(sg, cfg, "fixed")]
    else:
        entries = [_count_steps(sg, cfg),
                   graphs.If(_rep_overflow, _cluster_steps(sg, cfg, "gather"),
                             _cluster_steps(sg, cfg, "sharded"), "overflow_reads")]
    early, min_it = exit_schedule(cfg)
    entries += [_model_steps(sg, cfg), _iteration_steps(sg, cfg, 0, True)]
    for it in range(1, cfg.n_iters):
        steps = _iteration_steps(sg, cfg, it, False)
        entries.append(graphs.If(_rep_go, steps) if early and it >= min_it else steps)
    return entries + [_finish_steps(sg, cfg)]


def sharded_pair(sg, axis, scans1: list, scans2: list, x0: torch.Tensor) -> RegistrationResult:
    """``register_pair_impl(scans1, scans2, x0, cfg, axis)`` (the local
    shards of one pair) through the row's graph set ``sg``: the inputs
    copied into its buffers, the pair's schedule (:func:`pair_schedule`;
    one graph where the row is one device), the result (with its static
    mask; ``iterations`` a 0-d device count) one copy of its packed buffer
    on the axis device."""
    cfg = sg.cfg
    sg.bind(axis)
    b = sg.buffers
    for sh, s1, s2 in zip(b.shards, scans1, scans2):
        graphs.copy_in(sh.scan1, s1)
        graphs.copy_in(sh.scan2, s2)
    graphs.copy_in(b.rep.x0, x0)
    sg.run_schedule(("pair",), pair_schedule(sg, cfg))
    return graphs.packed_result(b.rep, (cfg.n_iters, True))


class ShardedRegister:
    """The compiled sharded step :func:`make_sharded_register` returns:
    ``step(scans1, scans2, x0s)``.  It holds a graph set a mesh row
    (``sets``, keyed by the row's devices and its points a shard), made at
    first use; :meth:`clear` drops them."""

    def __init__(self, cfg: ICETConfig, mesh: Mesh):
        self.cfg, self.mesh = cfg, mesh
        self.sets: dict = {}
        #: each row's axis, made once (a set's collectives counts go to it)
        self.axes = [mesh.axis("sp", r) for r in range(mesh.devices.shape[0])]

    def row_graphs(self, row: int, n: int):
        devices = tuple(self.mesh.devices[row])
        key = (devices, n)
        sg = self.sets.get(key)
        if sg is None:
            sg = self.sets[key] = graphs.ShardedGraphs(devices, n, self.cfg, len(devices))
        return sg

    def clear(self) -> None:
        self.sets.clear()

    def __call__(self, scans1, scans2, x0s) -> RegistrationResult:
        batch = _batch(scans1, scans2, x0s, self.mesh)
        results = []
        for r, axis in enumerate(self.axes):
            sg = self.row_graphs(r, batch.scans1[r][0].shape[1])
            for b in range(batch.x0s[r].shape[0]):
                results.append(sharded_pair(sg, axis, [s[b] for s in batch.scans1[r]],
                                            [s[b] for s in batch.scans2[r]], batch.x0s[r][b]))
        return stack_results(results, self.mesh.devices[0, 0])


def _batch(scans1, scans2, x0s, mesh: Mesh) -> ShardedBatch:
    if isinstance(x0s, list):
        return ShardedBatch(scans1, scans2, x0s)
    return shard_scan_batch(scans1, scans2, x0s, mesh)


def make_sharded_register(cfg: ICETConfig, mesh: Mesh) -> ShardedRegister:
    """A batched, point-sharded registration step over ``mesh``, compiled.

    Returns ``step(scans1, scans2, x0s) -> RegistrationResult``: ``(B, N,
    3)`` scans and ``(B, 6)`` initial states (numpy or tensors), or the
    three parts of a :class:`ShardedBatch` (``step(*shard_scan_batch(...))``);
    B must divide by ``dp`` and N by ``sp``.  Outputs
    have a leading B axis on the mesh's first device; ``static_mask`` is
    ``(B, N)``.  Rows run one after another; within a row, each pair's
    stages replay back to back (:func:`sharded_pair`), each prepare and
    iteration launching the moments pass once on every shard.  Equal to
    :func:`make_sharded_register_eager`'s step bit for bit on the CPU."""
    return ShardedRegister(cfg, mesh)


def make_sharded_register_eager(cfg: ICETConfig, mesh: Mesh):
    """:func:`make_sharded_register`'s step on the eager functions
    (``register_pair_impl`` with the row's axis, pair by pair): the plain
    version the compiled step is held to."""

    def step(scans1, scans2, x0s) -> RegistrationResult:
        batch = _batch(scans1, scans2, x0s, mesh)
        results = []
        for r in range(mesh.devices.shape[0]):
            axis = mesh.axis("sp", r)
            for b in range(batch.x0s[r].shape[0]):
                results.append(register_pair_impl(
                    [s[b] for s in batch.scans1[r]], [s[b] for s in batch.scans2[r]],
                    batch.x0s[r][b], cfg, axis=axis))
        return stack_results(results, mesh.devices[0, 0])

    return step


__all__ = [
    "DeviceAxis",
    "Mesh",
    "ShardedBatch",
    "ShardedRegister",
    "make_sharded_register",
    "make_sharded_register_eager",
    "registration_mesh",
    "shard_scan_batch",
    "sharded_pair",
    "stack_results",
]
