"""Multi-process (multi-controller) registration over ``torch.distributed``
(``icet_tpu/parallel/distributed.py``).

One process per device: every process runs this same program, joined by
:func:`init_distributed` (NCCL on the card, gloo on the CPU).  A global
``(dp, sp)`` mesh spans the processes in rank order: ``dp`` spans rows of
processes, which register their own frames, and the ``sp`` ranks of a row
pass the same local frames and each takes its slice of the points.  The
``(V+1, 16)`` moment sums go through ``dist.all_reduce`` on the row's
process group (``dist.new_group``), once a prepare and once a Gauss-Newton
iteration; the solver's shard math is the one it runs in-process
(:mod:`icet_tpu_torch.parallel.sharding`), given :class:`GroupAxis` as its
``axis``.

The step is compiled (the in-process mesh's ``sharding.sharded_pair``
schedule over a ``graphs.ShardedGraphs`` set on this process's device,
the NCCL collectives inside the graph, inside its IF nodes too, each
warmed up once before its capture) on an NCCL group, and on no other
backend; so are ``pose_graph.optimize_poses_sharded`` and
``optimize_poses_sparse_sharded`` over the mesh's first axis.  A gloo group stages
CUDA tensors through the host (:class:`GroupAxis`), which no graph can
hold: there, as on any backend but NCCL, the step takes the eager
functions, decided from the group's backend before any launch.

Several ranks on one card: NCCL refuses two ranks on the same GPU, so such
a run takes ``backend="gloo"`` on CUDA tensors (every collective is
staged through the host).  The moments kernel is a cooperative launch with
one block per SM; two processes time-slice the card, so each launch stays
legal.  Under MPS, processes share the SMs at once and a cooperative
launch sized for the whole card could be refused; this module does not
support MPS.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from icet_tpu_torch import graphs
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.device import resolve_device
from icet_tpu_torch.parallel.sharding import sharded_pair, stack_results
from icet_tpu_torch.solver import register_pair_impl


class GroupAxis:
    """One mesh axis over a process group, as the solver's shard ``axis``.

    This process holds one shard of the axis: local data is a one-element
    list, and ``index`` is ``(position of this rank in the group,)``.
    Results lie on ``device``.  With gloo, CUDA tensors are staged through
    the host.  ``collectives`` and ``bytes`` count the calls and this
    rank's payload in bytes."""

    def __init__(self, group, ranks: list, device: torch.device, backend: str):
        self.group = group
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.index = (self.ranks.index(dist.get_rank()),)
        self.device = device
        self.shard_devices = (device,)
        self._host = backend == "gloo"
        self.collectives = 0
        self.bytes = 0

    def _send(self, xs: list) -> torch.Tensor:
        (x,) = xs
        self.collectives += 1
        self.bytes += x.numel() * x.element_size()
        x = x.detach().contiguous()
        return x.to("cpu", copy=True) if self._host else x.clone()

    def psum(self, xs: list) -> torch.Tensor:
        t = self._send(xs)
        dist.all_reduce(t, group=self.group)
        return t.to(self.device)

    def all_to_all(self, xs: list) -> list:
        t = self._send(xs)
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return [out.to(self.device)]

    def all_gather(self, xs: list) -> torch.Tensor:
        t = self._send(xs)
        outs = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(outs, t, group=self.group)
        return torch.cat(outs).to(self.device)


#: the device :func:`init_distributed` chose for this process (the process
#: group is process-wide state, and so is its device)
_joined: dict = {}


def _process_device(device=None, rank: int | None = None) -> torch.device:
    """``device``, or CUDA device ``LOCAL_RANK`` (else the rank) modulo the
    local device count; raises without CUDA."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    init_method: str | None = None,
    backend: str | None = None,
    device: str | torch.device | None = None,
    timeout_s: float = 600.0,
) -> torch.device:
    """Join this process into a process group; returns its device.

    ``coordinator_address`` ``"host:port"`` becomes ``tcp://host:port``;
    ``init_method`` (e.g. ``file:///path``) takes its place; with neither,
    ``env://`` reads ``MASTER_ADDR``, ``RANK`` and ``WORLD_SIZE``.  The
    device is CUDA unless told otherwise (see :func:`_process_device`);
    the backend follows it (NCCL on CUDA, gloo on the CPU) unless named.
    A collective that waits longer than ``timeout_s`` fails."""
    dev = _process_device(device, process_id)
    if init_method is None:
        init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method,
        world_size=num_processes if num_processes is not None else -1,
        rank=process_id if process_id is not None else -1,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _joined["device"] = dev
    return dev


class ProcessMesh:
    """The global ``(dp, sp)`` mesh of processes: rank ``row * sp + col``.

    Every process builds the same groups in the same order (the row groups,
    then the column groups), as ``dist.new_group`` requires.  ``compiled``:
    whether the registration step runs as captured graphs (on NCCL only);
    the graph sets of this process's row are kept here, one a ``(points a
    shard, cfg)``."""

    axis_names = ("dp", "sp")

    def __init__(self, dp: int, sp: int, device: torch.device):
        self.shape = {"dp": dp, "sp": sp}
        self.device = device
        self.rank = dist.get_rank()
        self.row, self.col = divmod(self.rank, sp)
        backend = dist.get_backend()
        self.compiled = backend == "nccl"
        self._sets: dict = {}
        rows = [[r * sp + c for c in range(sp)] for r in range(dp)]
        cols = [[r * sp + c for r in range(dp)] for c in range(sp)]
        for ranks in rows + cols:
            group = dist.new_group(ranks)
            if self.rank in ranks:
                axis = GroupAxis(group, ranks, device, backend)
                if ranks is rows[self.row]:
                    self._sp = axis
                else:
                    self._dp = axis

    def axis(self, name: str) -> GroupAxis:
        """This process's row (``"sp"``) or column (``"dp"``) axis."""
        if name == "sp":
            return self._sp
        if name == "dp":
            return self._dp
        raise ValueError(f"no mesh axis {name!r}")

    def row_graphs(self, n: int, cfg: ICETConfig):
        """The graph set of this process's shard of ``n`` points (made at
        first use)."""
        sg = self._sets.get((n, cfg))
        if sg is None:
            sg = self._sets[(n, cfg)] = graphs.ShardedGraphs((self.device,), n, cfg,
                                                             self.shape["sp"])
        return sg


def global_registration_mesh(sp: int | None = None, device=None) -> ProcessMesh:
    """Global ``(dp, sp)`` mesh over every process of the group.

    ``sp`` defaults to ``LOCAL_WORLD_SIZE`` (the processes of one host,
    as torchrun sets it), else the world size; ``dp`` is the world size
    over ``sp``.  ``device`` is this process's: by default the one
    :func:`init_distributed` chose."""
    world = dist.get_world_size()
    if sp is None:
        sp = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % sp:
        raise ValueError(f"sp={sp} must divide the world size {world}")
    if device is None:
        device = _joined.get("device")
    return ProcessMesh(world // sp, sp, _process_device(device, dist.get_rank()))


def global_scan_batch(scans1_local, scans2_local, x0s_local, mesh: ProcessMesh):
    """This process's share of its row's frames: the ``(B_local, N/sp,
    3)`` point slice ``col`` of both scans and the ``(B_local, 6)``
    initial states, on its device.  Every rank of a row passes the same
    frames.  Raises ValueError where N does not divide by ``sp``."""
    s1 = np.asarray(scans1_local, np.float32)
    s2 = np.asarray(scans2_local, np.float32)
    sp = mesh.shape["sp"]
    if s1.shape[1] % sp:
        raise ValueError(f"points {s1.shape[1]} do not divide by the mesh axis size {sp}")
    n = s1.shape[1] // sp
    cut = slice(mesh.col * n, (mesh.col + 1) * n)
    return (
        torch.from_numpy(np.ascontiguousarray(s1[:, cut])).to(mesh.device),
        torch.from_numpy(np.ascontiguousarray(s2[:, cut])).to(mesh.device),
        torch.from_numpy(np.asarray(x0s_local, np.float32)).to(mesh.device),
    )


def local_numpy(arr) -> np.ndarray:
    """This process's rows of a result as numpy (the port's results hold
    only this process's rows already)."""
    return arr.detach().cpu().numpy()


def run_distributed_registration(
    scans1_local, scans2_local, x0s_local, cfg: ICETConfig, mesh: ProcessMesh | None = None
):
    """Register this process's row of frames on the global mesh.

    Returns ``(result, local_slice)``: ``result`` holds the row's
    ``B_local`` pairs (outputs with a leading batch axis on this process's
    device; ``static_mask`` covers this rank's point slice), and
    ``local_slice`` says which rows of the global batch they are.  Every
    rank of a row takes the same number of iterations: the exit decision
    reads the all-reduced values only.  On NCCL each pair runs the compiled
    step (``mesh.compiled``); on gloo (or any other backend) the eager
    ``register_pair_impl``."""
    if mesh is None:
        mesh = global_registration_mesh()
    s1, s2, x0 = global_scan_batch(scans1_local, scans2_local, x0s_local, mesh)
    axis = mesh.axis("sp")
    if mesh.compiled:
        sg = mesh.row_graphs(s1.shape[1], cfg)
        pairs = [sharded_pair(sg, axis, [s1[b]], [s2[b]], x0[b]) for b in range(s1.shape[0])]
    else:
        pairs = [register_pair_impl([s1[b]], [s2[b]], x0[b], cfg, axis=axis)
                 for b in range(s1.shape[0])]
    res = stack_results(pairs, mesh.device)
    b_local = s1.shape[0]
    return res, slice(mesh.row * b_local, (mesh.row + 1) * b_local)


__all__ = [
    "GroupAxis",
    "ProcessMesh",
    "global_registration_mesh",
    "global_scan_batch",
    "init_distributed",
    "local_numpy",
    "run_distributed_registration",
]
