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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.device import resolve_device
from icet_tpu_torch.solver import IterationDiag, RegistrationResult, register_pair_impl


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
    (``iterations`` as a ``(B,)`` int64 tensor)."""

    def stack(get):
        return torch.stack([get(r).to(device) for r in results])

    return RegistrationResult(
        X=stack(lambda r: r.X),
        pred_stds=stack(lambda r: r.pred_stds),
        Q=stack(lambda r: r.Q),
        diagnostics=IterationDiag(*(stack(lambda r, k=k: r.diagnostics[k])
                                    for k in range(len(IterationDiag._fields)))),
        static_mask=stack(lambda r: r.static_mask),
        iterations=torch.tensor([r.iterations for r in results], dtype=torch.int64),
    )


def make_sharded_register(cfg: ICETConfig, mesh: Mesh):
    """A batched, point-sharded registration step over ``mesh``.

    Returns ``step(scans1, scans2, x0s) -> RegistrationResult``: ``(B, N,
    3)`` scans and ``(B, 6)`` initial states (numpy or tensors), or the
    three parts of a :class:`ShardedBatch` (``step(*shard_scan_batch(...))``);
    B must divide by ``dp`` and N by ``sp``.  Outputs
    have a leading B axis on the mesh's first device; ``static_mask`` is
    ``(B, N)``.  Rows run one after another; within a row, each pair's
    prepare and iterations launch the moments pass once on every shard."""

    def step(scans1, scans2, x0s) -> RegistrationResult:
        if isinstance(x0s, list):
            batch = ShardedBatch(scans1, scans2, x0s)
        else:
            batch = shard_scan_batch(scans1, scans2, x0s, mesh)
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
    "make_sharded_register",
    "registration_mesh",
    "shard_scan_batch",
    "stack_results",
]
