"""CUDA-graph capture and replay behind the compiled entry points
(``solver.prepare_reference_jit``, ``register_jit``, ``odometry_step_jit``,
``odometry.odometry_sequence_jit``; ``filters.model_voxel_samples_jit``,
``odometry_step_dnn_jit``, ``register_pair_with_dnn``; and
``keyframe.keyframe_step_jit``, ``keyframe_step_dnn_jit``,
``keyframe_spawn_jit``, ``keyframe_sequence_jit``; ``solver.register_pair_jit``
and ``pose_graph.close_loops``; ``mapping.map_update_jit``,
``map_step_jit``; ``pose_graph.optimize_poses`` and
``optimize_poses_sparse``, ``optimize_poses_sharded`` and
``optimize_poses_sparse_sharded``; ``parallel.sharding.make_sharded_register``
and the process mesh's step; ``models.bias_net.train_step``).

The JAX package compiles each of them once per static shape and config.
Here a frame runs as a few CUDA graphs, captured once per ``(device, N,
cfg)`` (:func:`frame_graphs`) and replayed afterwards:

* ``prepare``: the voxel model of the scan buffer;
* ``solve``: one registration, unrolled (see "Early exit" below):
  Gauss-Newton iteration 0 (the cold 6x6 eigendecomposition), the warm
  iterations, each with its global index (the moving-object schedule),
  and the finish (the predicted covariance, the diagnostics and, for
  ``register_jit``, the static mask, packed into one result buffer);
* for the sequence runner, ``seed`` and ``glue``: the warm start, the
  divergence guard, the world pose and the hand-over of the model;
* with the DNN filter (``filters``): ``dnn``, the filtered solve as one
  graph (its phases' schedules, each of its derived config, with the
  ``filter`` stage between them: the reject mask at the current X,
  kernels #1 and #4, each pass a :class:`Span` ``dnn_filter`` of the
  frame log), ``samples`` and the frame's ``handover``;
* for the keyframe path (``keyframe``): ``kf_predict``, ``kf_post`` (the
  covariance propagation, the delta guard, the spawn flag and the map
  insert staged under the device flag ``~spawn``), ``kf_spawn``, and the
  map-write stage, keyed by the map's addresses (the staged block opening
  and insert written into a map's tables, one graph a table set); the
  sequence runner's frame is one schedule, ``kf_predict``, the solve,
  ``kf_post``, the glue and the spawn in an IF node on the spawn flag;
* for the ring map (``mapping``): ``map_update`` and ``map_step`` (the
  divergence guard, the re-expression of the ring and the trail, the
  downsample and the insert at the device mirror of the ring's cursor),
  keyed by the ring's addresses and the trail's roll-when-full branch.

The pose graph's solves have sets of their own (:func:`pose_graphs`, one
a ``(device, K, F, cg_iters, precond, robust)``, :class:`PoseGraphs`):
``assemble`` (the block-sparse normals, the backbone's factor and the CG
start), ``cg`` (one CG iteration, replayed ``cg_iters`` times) and
``update``; the dense solve's one Gauss-Newton step.  A solve is a few
small graphs replayed many times, never one unrolled graph: it runs once
a drive, and capturing its hundreds of CG iterations would cost the host
about what running them eagerly does.

A mesh row of the sharded step has a set of its own
(:class:`ShardedGraphs`, a :class:`RowGraphs`: a pair is one schedule of
the bucket count of the distributed clustering, the prepare in two
branches, an if/else on the summed overflow, the iterations and the
finish, each a list of steps split at the axis's collectives), and so has
a sharded pose-graph solve (:class:`ShardedPoseGraphs`, one a ``(axis, K,
F a shard, cg_iters, precond, robust, damping, prior)``: the dense step,
or the assembly, a CG iteration and the update, split likewise).  A
training step is one graph of its own set
(:class:`TrainGraphs`), held with its optimizer (dropped with it), one a
device and batch shape.

The stages themselves are plain functions of the buffers (``solver``'s
``_stage_*``, ``odometry``'s ``_stage_seed``/``_stage_glue``,
``mapping``'s ``_stage_map``, ``pose_graph``'s ``_stage_*`` and the
sharded solves' steps).

Early exit: a registration is one graph (:meth:`FrameGraphs.solve`), its
iterations unrolled up to the static cap ``n_iters``: iteration 0, the
iterations below ``min_it`` unconditionally, each later one inside an IF
conditional node on the device flag ``go`` (``|dx| >= threshold`` of the
iteration before), then the finish.  Once an iteration clears ``go`` every
later IF skips, as the JAX package's ``lax.while_loop`` stops; the host
reads nothing inside a frame.  A schedule (a list of stages and
:class:`If` entries) is built once and run by one of two executors: on
CUDA it is captured with the IF nodes (an :class:`If` with an ``orelse``
becomes two IF nodes, on the predicate and on its negation, computed
before either body); on the CPU, and on a split row of the sharded step,
the stages run as plain calls (or per-part graphs) and a guard is a host
read of the flag, counted in :data:`host_ops` (``flag_reads``,
``overflow_reads``), skipped where the flag is known false since nothing
ran after its last read.

Buffers: every graph reads and writes :class:`FrameBuffers`, allocated
outside capture (the keyframe map's staging among them,
:class:`MapBuffers`, and the block-map or ring tables attached to it for
the stages that write them); the graphs' intermediates come from one
private memory pool a set.  No graph leaves an output in the pool, so the graphs
of a set may replay in any order (one at a time: they share the pool and
the buffers).  Results come back as views of one clone of a packed
buffer, so no returned tensor is overwritten by a later call.

Carried inputs: a model or scan-1 samples that the set's own graphs left
in its buffers (the DNN frame's ``handover``) are not copied in again when
the caller passes those very objects back unchanged
(:meth:`FrameGraphs.load` compares identity and version counters).

Weight images: the encoder kernel reads its weights as one image, cached
per weight set in ``ops/bias_encoder.py``; a set keeps a reference to
every image its graphs were captured with (:meth:`FrameGraphs.pin`), so an
image evicted from that cache stays alive while a graph reads it.

Warm-up: before its capture each graph's stage runs once on a scratch set
of buffers, on the capture stream, which builds and loads the kernels and
makes the kernels' shared-memory opt-ins and the cuBLAS and cuSOLVER
handles; every body of a schedule is warmed up, guarded or not (both
branches of an if/else).
Those launches are real; the wrappers count them and
:data:`warmup_launches` records them.  The capture launches nothing: each
graph records how many launches of each counted wrapper (and, on a sharded
row, collectives and bytes of its axis) it holds.  Which counts are exact,
and when: a replay adds at once the counts of its unconditional stages.
A guarded body adds one to its own slot of a device tally each time it
runs; :func:`settle` reads every tally (one host read a device) and adds
each body's counts times the runs since the last read.  So the counts are
exact after :func:`settle`, and lag by the guarded bodies run since
otherwise; :func:`clear` drops unsettled tallies.  A failed capture
raises, and the set is dropped from the cache: no compiled solve falls
back to host reads.

On CPU tensors the stages run as plain calls on the same buffers.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import functools
import math
import time
import weakref
from typing import Callable, NamedTuple

import torch

from icet_tpu_torch import _build
from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.ops.bias_encoder import bias_encoder_pool, cached_image
from icet_tpu_torch.ops.clustering import cluster_plan
from icet_tpu_torch.ops.fused_moments import fused_moment_sums
from icet_tpu_torch.ops.gn_assembly import gn_assembly
from icet_tpu_torch.ops.gn_eigh6 import gn_eigh6
from icet_tpu_torch.ops.model_fit import model_fit
from icet_tpu_torch.ops.moment_scatter import moment_scatter_sums
from icet_tpu_torch.ops.tridiag import tridiag_apply, tridiag_factor
from icet_tpu_torch.solver import (
    IterationDiag,
    RegistrationResult,
    VoxelModel,
    _stage_finish,
    _stage_first,
    _stage_prepare,
    _stage_warm,
    exit_schedule,
)
from icet_tpu_torch.utils.profiling import frame_log as _flog
from icet_tpu_torch.utils.profiling import graph_events as _flog_events
from icet_tpu_torch.utils.profiling import record_in_capture

#: the kernel wrappers whose launches a graph records and its replays count
COUNTED = (fused_moment_sums, bias_encoder_pool, tridiag_factor, tridiag_apply,
           moment_scatter_sums, gn_assembly, gn_eigh6, model_fit)
#: launches of each counted wrapper made by warm-ups before a capture
warmup_launches = {f.__name__: 0 for f in COUNTED}
#: host operations of the compiled path: graph replays, exit-flag reads,
#: keyframe spawn-flag reads (a keyframe step's one read of its outputs,
#: or a guard run on the host), the sharded prepare's clustering-overflow
#: reads (only where a guard runs on the host), the keyframe sequence
#: runner's one read a block, device copies of inputs in and of packed
#: results out, draws of the keyframe uniforms; graphs captured, and reads
#: of the guarded bodies' tallies (:func:`settle`).  The runners' own reads
#: are counted in the frame log (``utils.profiling.frame_log``), not here.
host_ops = {"replays": 0, "flag_reads": 0, "spawn_reads": 0, "overflow_reads": 0,
            "block_reads": 0, "copies": 0, "draws": 0, "captures": 0, "tally_reads": 0}

#: what the CUDA captures cost on the host: graphs captured (a guarded
#: body is a graph of its own, cloned into its IF node), seconds warming up
#: and capturing, and seconds instantiating
capture_stats = {"graphs": 0, "capture_s": 0.0, "instantiate_s": 0.0}

_sync_debug_mode = None


@contextlib.contextmanager
def sync_debug(mode):
    """Captures made inside run under ``torch.cuda.set_sync_debug_mode(mode)``
    (``"error"``: a hidden host synchronisation raises instead of passing).
    Not the warm-ups: they make the caches that keep syncs out of capture."""
    global _sync_debug_mode
    prev, _sync_debug_mode = _sync_debug_mode, mode
    try:
        yield
    finally:
        _sync_debug_mode = prev


@contextlib.contextmanager
def _debug_mode():
    if _sync_debug_mode is None:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(_sync_debug_mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@functools.lru_cache(maxsize=None)
def _cond_lib() -> ctypes.CDLL:
    """``csrc/graph_cond.cu``: the IF node."""
    lib = _build.load("graph_cond")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.icet_graph_add_if.argtypes = [p, p, p]
    lib.icet_graph_add_if.restype = i
    lib.icet_cuda_error_string.argtypes = [i]
    lib.icet_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(err: int, what: str) -> None:
    if err != 0:
        msg = _cond_lib().icet_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def _add_if(flag: torch.Tensor, body) -> None:
    """At the current stream's capture position, an IF node on the device
    bool ``flag`` whose body is a clone of the captured graph ``body``."""
    stream = torch.cuda.current_stream(flag.device).cuda_stream
    _check_cuda(_cond_lib().icet_graph_add_if(stream, flag.data_ptr(), body.raw_cuda_graph()),
                "adding an IF node")


#: ``CUgraphNodeType`` names, by value
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
              "event_record", "ext_semas_signal", "ext_semas_wait", "mem_alloc", "mem_free",
              "batch_memop", "conditional")


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    p = ctypes.c_void_p
    lib.cuGraphGetNodes.argtypes = [p, ctypes.POINTER(p), ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [p, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphChildGraphNodeGetGraph.argtypes = [p, ctypes.POINTER(p)]
    return lib


def _walk(graph: int, counts: dict) -> None:
    drv = _libcuda()
    n = ctypes.c_size_t(0)
    err = drv.cuGraphGetNodes(graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if not err and n.value:
        err = drv.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed ({err})")
    for node in nodes:
        t = ctypes.c_int(0)
        if drv.cuGraphNodeGetType(node, ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        name = NODE_TYPES[t.value] if t.value < len(NODE_TYPES) else str(t.value)
        counts[name] = counts.get(name, 0) + 1
        if name == "graph":
            sub = ctypes.c_void_p(0)
            if drv.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(sub)):
                raise RuntimeError("cuGraphChildGraphNodeGetGraph failed")
            _walk(sub.value, counts)


def node_types(graph) -> dict:
    """The node types of a kept captured graph (``keep_graph=True``) and
    its child graphs, by name (through libcuda); an IF node counts
    once, its body not."""
    counts: dict = {}
    _walk(graph.raw_cuda_graph(), counts)
    return counts


def graph_nodes(gs: GraphSet) -> dict:
    """The node types of every captured schedule of ``gs``: its graphs'
    and, once each, its guarded bodies'."""
    counts: dict = {}
    for entry in gs._graphs.values():
        for g in (entry.graph, *entry.bodies):
            for name, k in node_types(g).items():
                counts[name] = counts.get(name, 0) + k
    return counts


class Layout:
    """Named tensors packed into one byte buffer, each at a 256-byte
    aligned offset, so that one device copy moves them all."""

    ALIGN = 256

    def __init__(self, fields):
        self.fields = []
        off = 0
        for name, shape, dtype in fields:
            nbytes = math.prod(shape) * dtype.itemsize
            self.fields.append((name, tuple(shape), dtype, off, nbytes))
            off += -(-nbytes // self.ALIGN) * self.ALIGN
        self.nbytes = max(off, self.ALIGN)

    def empty(self, device) -> torch.Tensor:
        return torch.zeros(self.nbytes, dtype=torch.uint8, device=device)

    def views(self, buf: torch.Tensor) -> dict:
        return {name: buf[off:off + n].view(dtype).view(shape)
                for name, shape, dtype, off, n in self.fields}

    def stacked_views(self, rows: torch.Tensor) -> dict:
        """Views of ``(F, nbytes)`` stacked buffers, each ``(F, *shape)``."""
        return {name: rows[:, off:off + n].view(dtype).reshape((rows.shape[0],) + shape)
                for name, shape, dtype, off, n in self.fields}

    def buffer(self, view: torch.Tensor) -> torch.Tensor:
        """The byte buffer (a new tensor on its storage) that ``view``, a
        field of a buffer in this layout, lies in."""
        storage = view.untyped_storage()
        if storage.nbytes() != self.nbytes:
            raise ValueError("the tensor is not a field of a buffer in this layout")
        return torch.empty(0, dtype=torch.uint8, device=view.device).set_(storage)

    def source(self, tensors: dict) -> torch.Tensor | None:
        """The byte buffer ``tensors`` are views of in this layout (a new
        tensor on its storage), else None."""
        first = next(iter(tensors.values()))
        storage = first.untyped_storage()
        if storage.nbytes() != self.nbytes:
            return None
        base = storage.data_ptr()
        for name, shape, dtype, off, _ in self.fields:
            t = tensors[name]
            if (t.untyped_storage().data_ptr() != base or t.dtype != dtype
                    or tuple(t.shape) != shape or t.data_ptr() - base != off
                    or not t.is_contiguous()):
                return None
        return torch.empty(0, dtype=torch.uint8, device=first.device).set_(storage)


def model_layout(n_voxels: int) -> Layout:
    v1 = n_voxels + 1
    f32 = torch.float32
    return Layout([("bounds", (v1, 2), f32), ("anchors", (v1, 3), f32), ("count", (v1,), f32),
                   ("mean", (v1, 3), f32), ("cov", (v1, 3, 3), f32),
                   ("basis", (v1, 3, 3), f32), ("lmask", (v1, 3), f32),
                   ("valid", (v1,), torch.bool)])


_DIAG_DTYPES = (torch.int32, torch.float32, torch.float32, torch.int32, torch.int32,
                torch.int32)


def result_layout(n: int, n_iters: int, static_mask: bool) -> Layout:
    f32 = torch.float32
    diags = [(name, (n_iters,), dt) for name, dt in zip(IterationDiag._fields, _DIAG_DTYPES)]
    return Layout([("X", (6,), f32), ("pred_stds", (6,), f32), ("Q", (6, 6), f32), *diags,
                   ("static_mask", (n if static_mask else 0,), torch.bool),
                   ("iterations", (), torch.int64)])


def samples_layout(cfg: ICETConfig) -> Layout:
    """Lean per-voxel samples ``(V+1, S, 3)`` bf16 and their clipped counts."""
    v1 = cfg.n_voxels + 1
    return Layout([("samples", (v1, cfg.dnn_sample_pts, 3), torch.bfloat16),
                   ("counts", (v1,), torch.int32)])


def filter_layout(n_voxels: int, passes: int) -> Layout:
    """A filtered solve's DNN filter: its last pass (the keep mask, both
    shifts, ``n_rejected``) and the keep mask and both shifts of each of
    its ``passes`` passes."""
    v1 = n_voxels + 1
    return Layout([("keep", (v1,), torch.bool), ("dnn_shift", (v1, 3), torch.float32),
                   ("icet_shift", (v1, 3), torch.float32), ("n_rejected", (), torch.int32),
                   ("keeps", (passes, v1), torch.bool),
                   ("dnn_shifts", (passes, v1, 3), torch.float32),
                   ("icet_shifts", (passes, v1, 3), torch.float32)])


def dnn_phases(cfg: ICETConfig) -> tuple[int, int]:
    """``(n_pre, n_post)``: the filtered solve's plain and filtered
    iterations (``filters.register_with_dnn``)."""
    n_pre = max(min(cfg.dnn_start_iter, cfg.n_iters - 1), 1)
    return n_pre, cfg.n_iters - n_pre


def dnn_passes(cfg: ICETConfig) -> int:
    """Filter passes of one filtered solve: one a filtered iteration in the
    loop (``dnn_in_loop``), else one."""
    if cfg.n_iters >= 2 and cfg.dnn_in_loop:
        return dnn_phases(cfg)[1]
    return 1


def result_iters(cfg: ICETConfig) -> tuple[int, ...]:
    """The ``n_iters`` of every register call a frame of ``cfg`` finishes:
    its own, and the DNN-filtered solve's last phase's (1 in-loop, n_post
    one-shot)."""
    its = {cfg.n_iters, 1}
    if cfg.n_iters >= 2:
        its.add(dnn_phases(cfg)[1])
    return tuple(sorted(its))


#: one frame of the sequence runner: its guarded X, pred_stds, world pose,
#: divergence flag and the iterations its solve executed
ROW_LAYOUT = Layout([("X", (6,), torch.float32), ("pred_stds", (6,), torch.float32),
                     ("T_world", (4, 4), torch.float32), ("diverged", (), torch.bool),
                     ("iterations", (), torch.int64)])

_F32 = torch.float32
#: the keyframe runner's carry: pose relative to the keyframe, last delta,
#: keyframe world pose, latched health, last stds; the spawn's world pose
#: and the step's prediction
KF_CARRY_LAYOUT = Layout([("x_rel", (6,), _F32), ("delta", (6,), _F32),
                          ("world_key", (6,), _F32), ("h0", (2,), _F32),
                          ("prev_stds", (6,), _F32), ("world", (6,), _F32), ("x0", (6,), _F32)])
#: one keyframe step's outputs besides its registration result, and the
#: iterations its solve executed (read on the host in one copy)
KF_OUT_LAYOUT = Layout([("X_total", (6,), _F32), ("Q", (6, 6), _F32), ("pred_stds", (6,), _F32),
                        ("X", (6,), _F32), ("delta", (6,), _F32), ("diverged", (), torch.bool),
                        ("spawn", (), torch.bool), ("health", (2,), _F32),
                        ("iterations", (), torch.int64)])
#: one frame of the keyframe sequence runner, in the JAX package's order,
#: and the iterations its solve executed (a port-only column)
KF_ROW_LAYOUT = Layout([("delta", (6,), _F32), ("delta_stds", (6,), _F32),
                        ("world6", (6,), _F32), ("diverged", (), torch.bool),
                        ("x_rel", (6,), _F32), ("is_keyframe", (), torch.bool),
                        ("n_corr", (), torch.int32), ("iterations", (), torch.int64)])


def map_staging_layout(p: int, k: int) -> Layout:
    """What a keyframe frame stages for the map-write stage of a ``P``-row
    block map and ``K`` samples a scan: the insert's flat row indices,
    points and write mask, the device mirror ``at = [slot, cursor,
    active]``, whether the frame opens the block at ``at``'s slot, and that
    block's pose."""
    kw = min(k, p)
    return Layout([("idx", (kw,), torch.int64), ("vals", (kw, 3), _F32),
                   ("write", (kw,), torch.bool), ("at", (3,), torch.int64),
                   ("spawn", (), torch.bool), ("pose", (6,), _F32)])


class MapBuffers:
    """The keyframe map staging for a ``(B, P)`` block map and ``K``
    samples a scan: ``draws``, a frame's uniforms (the insert's ``u``, then
    the spawn's ``su``); the staging of :func:`map_staging_layout`, one
    packed buffer (``staging``; ``at`` the device mirror of the host's
    ``(n_blocks, cursor)``, ``expect`` the host value it holds, None when
    unknown); and ``tables``, the ``(points, valid, poses)`` the map-write
    stage writes (a map's own tables or one chunk of a sharded map's,
    attached before each replay; a twin's own zeros for the warm-ups)."""

    def __init__(self, b: int, p: int, k: int, device):
        self.shape = (b, p, k)
        self.draws = torch.zeros(2 * k, dtype=torch.float32, device=device)
        self.u, self.su = self.draws[:k], self.draws[k:]
        layout = map_staging_layout(p, k)
        self.staging = layout.empty(device)
        v = layout.views(self.staging)
        self.idx, self.vals, self.write = v["idx"], v["vals"], v["write"]
        self.at, self.spawn, self.pose = v["at"], v["spawn"], v["pose"]
        self.expect = None
        self.tables = None
        self._own: dict = {}

    def key(self) -> tuple:
        """The attached tables' addresses and shapes (the map-write graph
        that writes them is keyed by them)."""
        return tuple((t.data_ptr(), tuple(t.shape)) for t in self.tables)

    def twin_of(self, tables) -> None:
        """Attach zero tables of ``tables``' shapes (the warm-ups' own,
        made once a shape)."""
        if tables is None:
            self.tables = None
            return
        shapes = tuple((tuple(t.shape), t.dtype) for t in tables)
        if shapes not in self._own:
            self._own[shapes] = tuple(torch.zeros_like(t) for t in tables)
        self.tables = self._own[shapes]


#: one ring-map frame's outputs, read on the host in one copy: the guarded
#: X, pred_stds, the divergence flag, the ring's fill and the iterations
#: the frame's solve executed
MAP_OUT_LAYOUT = Layout([("X", (6,), _F32), ("pred_stds", (6,), _F32),
                         ("diverged", (), torch.bool), ("n_valid", (), torch.int64),
                         ("iterations", (), torch.int64)])


class RingBuffers:
    """The ring map stage's staging for a ``(capacity, trail capacity, K)``
    ring and an N-point scan: the uniforms, the X of a standalone update,
    the device mirror ``at = [write_ptr, trail_len]`` of the host's
    counters (``expect``: the host value it holds, None when unknown), the
    frame's packed outputs, and ``ring``: the ``(points, valid, trail)``
    the stage writes in place (a runner's own ring, attached before each
    replay; a twin's own zeros for the warm-ups)."""

    def __init__(self, cap: int, tcap: int, k: int, n: int, device, twin: bool = False):
        self.shape = (cap, tcap, k)
        self.u = torch.zeros(n, dtype=torch.float32, device=device)
        self.X = torch.zeros(6, dtype=torch.float32, device=device)
        self.at = torch.zeros(2, dtype=torch.int64, device=device)
        self.out_buf = MAP_OUT_LAYOUT.empty(device)
        self.out = MAP_OUT_LAYOUT.views(self.out_buf)
        self.expect = None
        self.ring = None
        if twin:
            self.ring = (torch.zeros((cap, 3), dtype=torch.float32, device=device),
                         torch.zeros(cap, dtype=torch.bool, device=device),
                         torch.zeros((tcap, 3), dtype=torch.float32, device=device))

    def key(self) -> tuple:
        """The attached ring's addresses (a graph that writes it is keyed by them)."""
        return tuple(t.data_ptr() for t in self.ring)


class FrameBuffers:
    """The static buffers of one frame: inputs, the Gauss-Newton state, the
    diagnostics columns, the packed results and the sequence runner's
    carry; the DNN filter's scan-1 samples, the new scan's samples and the
    filter pass; the keyframe path's raw scan, carry and outputs.
    ``model`` and ``prepared`` are views of packed buffers."""

    def __init__(self, device: torch.device, n: int, cfg: ICETConfig):
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        def packed(layout):
            buf = layout.empty(device)
            return buf, layout.views(buf)

        self.n_iters = cfg.n_iters
        self.model_layout = model_layout(cfg.n_voxels)
        self.scan = z(n, 3)
        self.x0 = z(6)
        self.model_buf = self.model_layout.empty(device)
        self.model = VoxelModel(**self.model_layout.views(self.model_buf))
        self.prepared_buf = self.model_layout.empty(device)
        self.prepared = self.model_layout.views(self.prepared_buf)
        self.X, self.w6, self.U2 = z(6), z(6), z(6, 6)
        self.keep = z(6, dtype=torch.bool)
        self.corr = z(cfg.n_voxels + 1, dtype=torch.bool)
        #: the next diagnostics row (an iteration count on the device)
        self.it = z(1, dtype=torch.int64)
        #: the iterations of the current registration, all its phases
        self.iters = z(1, dtype=torch.int64)
        #: the exit flag ``|dx| >= threshold`` of the last iteration
        self.go = z(dtype=torch.bool)
        self.diag = tuple(z(cfg.n_iters, dtype=dt) for dt in _DIAG_DTYPES[:5])
        #: packed results by ``(n_iters of the finished call, static mask)``
        self.result_layout = {(k, m): result_layout(n, k, m)
                              for k in result_iters(cfg) for m in (False, True)}
        self.result_buf = {key: lay.empty(device) for key, lay in self.result_layout.items()}
        self.result = {key: self.result_layout[key].views(buf)
                       for key, buf in self.result_buf.items()}
        self.xprev, self.xprev2, self.T = z(6), z(6), z(4, 4)
        self.row_buf, self.row = packed(ROW_LAYOUT)
        self.samples_layout = samples_layout(cfg)
        self.samples1_buf, self.samples1 = packed(self.samples_layout)
        self.samples_next_buf, self.samples_next = packed(self.samples_layout)
        self.filt_layout = filter_layout(cfg.n_voxels, dnn_passes(cfg))
        self.filt_buf, self.filt = packed(self.filt_layout)
        self.raw = z(n, 3)
        self.kf_buf, self.kf = packed(KF_CARRY_LAYOUT)
        self.kf_out_buf, self.kf_out = packed(KF_OUT_LAYOUT)
        self.kf_row_buf, self.kf_row = packed(KF_ROW_LAYOUT)
        #: the keyframe insert's staging (:meth:`FrameGraphs.map_buffers`)
        self.map: MapBuffers | None = None
        #: the ring map stage's staging (:meth:`FrameGraphs.ring_buffers`)
        self.ring: RingBuffers | None = None


def _versions(obj) -> tuple:
    if isinstance(obj, torch.Tensor):
        return (obj._version,)
    return tuple(t._version for t in obj)


class If(NamedTuple):
    """A guarded entry of a schedule: ``body(buffers)`` runs where the 0-d
    bool ``pred(buffers)`` holds and, with ``orelse``, ``orelse(buffers)``
    where it does not.  ``reads`` names the :data:`host_ops` count a host
    read of the predicate adds to (the CPU and split-row executors)."""

    pred: Callable
    body: Callable
    orelse: Callable | None = None
    reads: str = "flag_reads"


class Span(NamedTuple):
    """A stage of a schedule that the frame log times apart, ``name``:
    on the CPU a host span around ``fn(buffers)``; on CUDA two timing
    events recorded inside the graph around the stage's work
    (:func:`~icet_tpu_torch.utils.profiling.graph_events`), whose device
    milliseconds each logged replay adds to the frame's value ``name``.
    Not inside a guarded body: an IF node's body holds no event."""

    name: str
    fn: Callable

    def __call__(self, b) -> None:
        span = _flog.begin(self.name)
        self.fn(b)
        _flog.end(span)


def _go(b) -> torch.Tensor:
    return b.go


def run_on_host(b, schedule, call) -> None:
    """Run ``schedule`` with its guards read on the host: ``call(key, fn)``
    runs an entry (``key``: its position, and the branch for a guarded
    one).  A guard already read false is skipped unread while nothing ran
    after its read, as the eager loop stops at the first false flag."""
    known_false = set()
    for k, e in enumerate(schedule):
        if not isinstance(e, If):
            call((k,), e)
            known_false.clear()
            continue
        if e.orelse is None and e.pred in known_false:
            continue
        host_ops[e.reads] += 1
        if bool(e.pred(b)):
            call((k, True), e.body)
            known_false.clear()
        elif e.orelse is not None:
            call((k, False), e.orelse)
            known_false.clear()
        else:
            known_false.add(e.pred)


class _Captured(NamedTuple):
    """A captured schedule: its graph, the counts its unconditional stages
    add a replay, the device tally of its guarded bodies (one slot a body,
    None without one) with each body's counts and the tally's value at the
    last :func:`settle`, the bodies' own graphs (kept: an IF node holds
    a clone, which may still refer to what a body's graph owns), and the
    timed :class:`Span` stages as ``(name, start event, end event)``."""

    graph: object
    counts: tuple
    tally: torch.Tensor | None
    body_counts: list
    seen: list
    bodies: list
    spans: list


#: graph sets whose guarded bodies may have run since the last settle
_TALLIED: weakref.WeakSet = weakref.WeakSet()


class GraphSet:
    """Graphs captured over one set of static buffers (``self.buffers``),
    with one private memory pool and one capture stream on CUDA; a
    subclass makes the scratch buffers its warm-ups run on."""

    #: ``torch.cuda.graph``'s ``capture_error_mode``
    capture_mode = "global"

    def __init__(self, device: torch.device):
        self.device = device
        self._graphs: dict = {}
        self._scratch = None
        if device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)

    def scratch(self):
        """The buffers of the warm-ups (made at first use)."""
        raise NotImplementedError

    def counters(self) -> list:
        """``(object, attribute)`` of every count a stage adds to on the host:
        each counted wrapper's launches (a subclass adds its own).  A graph
        records what its capture added, and each replay adds it again."""
        return [(w, "launches") for w in COUNTED]

    def run(self, key, stage) -> None:
        """Run ``stage(buffers)``: on CUDA replay its graph (``key`` names
        it; captured at first use), on the CPU call it."""
        self.run_schedule(key, [stage])

    def run_schedule(self, key, schedule: list) -> None:
        """Run a schedule of stages, :class:`If` and :class:`Span` entries:
        on CUDA replay its one graph (``key`` names it; captured at first
        use, the guards as IF nodes, the spans' timing events as nodes),
        on the CPU call its stages with the guards read on the host."""
        if self.device.type != "cuda":
            span = _flog.begin(key[0]) if _flog.active else -1
            run_on_host(self.buffers, schedule, lambda _, fn: fn(self.buffers))
            _flog.end(span)
            return
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(schedule)
        span = _flog.begin(key[0], timed=True) if _flog.active else -1
        entry.graph.replay()
        if entry.spans:
            _flog.add_device(entry.spans)
        _flog.end(span)
        host_ops["replays"] += 1
        for (obj, attr), k in zip(self.counters(), entry.counts):
            setattr(obj, attr, getattr(obj, attr) + k)
        if entry.tally is not None:
            _TALLIED.add(self)

    def settle(self) -> None:
        """Add the counts of the guarded bodies run since the last settle
        (one host read of this set's tallies)."""
        entries = [e for e in self._graphs.values() if e.tally is not None]
        if not entries:
            return
        values = torch.cat([e.tally for e in entries]).tolist()
        host_ops["tally_reads"] += 1
        counters = self.counters()
        for e in entries:
            for slot, counts in enumerate(e.body_counts):
                runs = values[slot] - e.seen[slot]
                e.seen[slot] = values[slot]
                for (obj, attr), k in zip(counters, counts):
                    setattr(obj, attr, getattr(obj, attr) + k * runs)
            values = values[len(e.body_counts):]

    def _capture(self, schedule: list) -> _Captured:
        """Warm every body up on the scratch buffers, capture each guarded
        body as a graph of its own, then the schedule, each guard an IF node
        (an if/else two, on the predicate and on its negation, both computed
        before either body runs), each :class:`Span` between two timing
        events recorded in the graph."""
        scratch = self.scratch()
        counters = self.counters()

        def read():
            return tuple(getattr(obj, attr) for obj, attr in counters)

        def since(start):
            return tuple(v - k for v, k in zip(read(), start))

        guarded = [(e, fn) for e in schedule if isinstance(e, If)
                   for fn in (e.body, e.orelse) if fn is not None]
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            before = read()
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                # Every body, guarded or not: as if each guard held.
                for e in schedule:
                    for fn in ((e.body, e.orelse) if isinstance(e, If) else
                               (e.fn if isinstance(e, Span) else e,)):
                        if fn is not None:
                            fn(scratch)
            torch.cuda.current_stream().wait_stream(self._stream)
            warm = read()
            for w, a, b in zip(COUNTED, before, warm):
                warmup_launches[w.__name__] += b - a
            tally = (torch.zeros(len(guarded), dtype=torch.int64, device=self.device)
                     if guarded else None)
            negated = {id(e): torch.zeros((), dtype=torch.bool, device=self.device)
                       for e, _ in guarded if e.orelse is not None}
            body_counts, bodies = [], []
            spans = [e for e in schedule if isinstance(e, Span)]
            events = _flog_events(self.device, len(spans)) if spans else []
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                for slot, (_, fn) in enumerate(guarded):
                    body = torch.cuda.CUDAGraph(keep_graph=True)
                    torch.cuda.synchronize(self.device)
                    with torch.cuda.stream(self._stream):
                        body.capture_begin(pool=self._pool, capture_error_mode=self.capture_mode)
                        try:
                            with _debug_mode():
                                start = read()
                                tally[slot:slot + 1].add_(1)
                                fn(self.buffers)
                                body_counts.append(since(start))
                        finally:
                            body.capture_end()
                    bodies.append(body)
                with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                      capture_error_mode=self.capture_mode):
                    with _debug_mode():
                        slot, timed_spans = 0, iter(events)
                        for e in schedule:
                            if isinstance(e, Span):
                                start, end = next(timed_spans)
                                record_in_capture(start, self._stream.cuda_stream)
                                e.fn(self.buffers)
                                record_in_capture(end, self._stream.cuda_stream)
                                continue
                            if not isinstance(e, If):
                                e(self.buffers)
                                continue
                            pred = e.pred(self.buffers)
                            flags = [pred]
                            if e.orelse is not None:
                                flags.append(torch.logical_not(pred, out=negated[id(e)]))
                            for flag in flags:
                                _add_if(flag, bodies[slot])
                                slot += 1
                t1 = time.perf_counter()
                graph.instantiate()
                t2 = time.perf_counter()
            except BaseException:
                _forget(self)
                raise
            finally:
                total = since(warm)
                for (obj, attr), k in zip(counters, warm):
                    setattr(obj, attr, k)
        host_ops["captures"] += 1
        capture_stats["graphs"] += 1 + len(bodies)
        capture_stats["capture_s"] += t1 - t0
        capture_stats["instantiate_s"] += t2 - t1
        counts = tuple(t - sum(c[i] for c in body_counts) for i, t in enumerate(total))
        return _Captured(graph, counts, tally, body_counts, [0] * len(body_counts), bodies,
                         [(e.name, *ev) for e, ev in zip(spans, events)])


def settle() -> None:
    """Add to the counts every guarded body run since the last settle (one
    host read of the tallies a graph set); after it the counts are exact."""
    for gs in list(_TALLIED):
        gs.settle()
    _TALLIED.clear()


class FrameGraphs(GraphSet):
    """The graphs of one ``(device, N, cfg)`` and their buffers."""

    def __init__(self, device: torch.device, n: int, cfg: ICETConfig):
        super().__init__(device)
        self.n, self.cfg = n, cfg
        self.buffers = FrameBuffers(device, n, cfg)
        #: carried inputs the buffers hold: name -> (object, its versions)
        self._held: dict = {}
        #: (net, weight image) of every image a graph of this set reads
        self.pinned: list = []
        self._maps: dict = {}
        self._rings: dict = {}

    def scratch(self) -> FrameBuffers:
        if self._scratch is None:
            self._scratch = FrameBuffers(self.device, self.n, self.cfg)
        if self.buffers.map is not None:
            twin = self._scratch.map = self._maps[self.buffers.map.shape][1]
            twin.twin_of(self.buffers.map.tables)
        if self.buffers.ring is not None:
            self._scratch.ring = self._rings[self.buffers.ring.shape][1]
        return self._scratch

    # -- stages ---------------------------------------------------------

    def pin(self, net) -> None:
        """Keep ``net`` and the encoder's weight image of it alive with this
        set: a graph replays the image's address, and the image cache of
        ``ops/bias_encoder.py`` may evict it."""
        img = cached_image(net.encoder_weights())
        if not any(i is img for _, i in self.pinned):
            self.pinned.append((net, img))

    def map_buffers(self, b: int, p: int, k: int) -> MapBuffers:
        """The map staging of a ``(B, P)`` map and ``K`` samples (made at
        first use, with a twin for the warm-ups), now the one the stages
        see.  Only the map-write stage writes a map's own tables, those
        attached to it."""
        key = (b, p, k)
        if key not in self._maps:
            self._maps[key] = (MapBuffers(b, p, k, self.device), MapBuffers(b, p, k, self.device))
        self.buffers.map = self._maps[key][0]
        return self.buffers.map

    def ring_buffers(self, ring, k: int) -> RingBuffers:
        """The ring map stage's staging for ``ring = (points, valid, trail)``
        and ``k`` points a scan (made at first use per shape, with a twin
        that carries its own ring for the warm-ups), ``ring`` attached, now
        the one the stages see."""
        key = (ring[0].shape[0], ring[2].shape[0], k)
        if key not in self._rings:
            self._rings[key] = tuple(RingBuffers(*key, self.n, self.device, twin)
                                     for twin in (False, True))
        rb = self.buffers.ring = self._rings[key][0]
        rb.ring = tuple(ring)
        return rb

    # -- inputs and results ---------------------------------------------

    def holds(self, name: str, obj) -> bool:
        """Whether the buffer ``name`` holds ``obj`` (the very object, at
        the versions it had when it went in)."""
        held = self._held.get(name)
        return held is not None and held[0] is obj and held[1] == _versions(obj)

    def hold(self, name: str, obj) -> None:
        """Record that the buffer ``name`` now holds ``obj`` (None: unknown)."""
        if obj is None:
            self._held.pop(name, None)
        else:
            self._held[name] = (obj, _versions(obj))

    def load(self, scan=None, x0=None, model: VoxelModel | None = None, samples=None,
             raw=None) -> None:
        """Copy the inputs given into the static buffers: a model or samples
        packed in this set's layout by one copy, and none where the buffer
        already holds them (the buffer itself, or the object it holds)."""
        b = self.buffers
        span = _flog.begin("load")
        if scan is not None:
            copy_in(b.scan, scan)
        if x0 is not None:
            copy_in(b.x0, x0)
        if raw is not None:
            copy_in(b.raw, raw)
        if model is not None and not self.holds("model", model):
            src = b.model_layout.source(model._asdict())
            if src is None:
                for dst, t in zip(b.model, model):
                    copy_in(dst, t)
            elif src.data_ptr() != b.model_buf.data_ptr():
                copy_in(b.model_buf, src)
            self.hold("model", model)
        if samples is not None and not self.holds("samples", samples):
            src = b.samples_layout.source(dict(zip(("samples", "counts"), samples)))
            if src is None:
                copy_in(b.samples1["samples"], samples[0])
                copy_in(b.samples1["counts"], samples[1])
            elif src.data_ptr() != b.samples1_buf.data_ptr():
                copy_in(b.samples1_buf, src)
            self.hold("samples", samples)
        _flog.end(span)

    def solve_schedule(self, want_static_mask: bool, cfg: ICETConfig | None = None,
                       it_offset: int = 0, masked: bool = False, start: str = "x0",
                       finish: bool = True) -> list:
        """The schedule of one registration (the eager ``register``) of the
        loaded scan against the loaded model: from ``b.x0`` or, with
        ``start="X"``, from the last phase's X; ``cfg`` is this call's
        config (a phase's, derived from the set's), ``it_offset`` its first
        global iteration, ``masked`` whether the filter's keep mask gates
        it; without ``finish`` only X comes out.  Iteration 0, the
        iterations below ``min_it``, then each later one guarded by ``go``,
        each with its own global index."""
        cfg = cfg or self.cfg
        early, min_it = exit_schedule(cfg, it_offset)
        entries = [lambda b: _stage_first(b, cfg, it_offset, masked, start)]
        for it in range(1, cfg.n_iters):
            def warm(b, g=it + it_offset):
                _stage_warm(b, cfg, g, masked)
            entries.append(If(_go, warm) if early and it >= min_it else warm)
        if finish:
            entries.append(lambda b: _stage_finish(b, cfg, want_static_mask, it_offset, masked))
        return entries

    def solve(self, want_static_mask: bool, cfg: ICETConfig | None = None, it_offset: int = 0,
              masked: bool = False, start: str = "x0", finish: bool = True) -> None:
        """Run :meth:`solve_schedule` as one graph: the iterations it
        executes, all phases of the registration, are counted on the device
        (``b.iters``, in the finished result's ``iterations``)."""
        cfg = cfg or self.cfg
        self.run_schedule(("solve", cfg, want_static_mask, it_offset, masked, start, finish),
                          self.solve_schedule(want_static_mask, cfg, it_offset, masked, start,
                                              finish))

    def run_prepare(self, src: str = "scan") -> None:
        self.run(("prepare", src), lambda b: _stage_prepare(b, self.cfg, src))

    def result(self, want_static_mask: bool, n_iters: int | None = None) -> RegistrationResult:
        """The finished result of ``(n_iters, want_static_mask)`` (one copy)."""
        return packed_result(self.buffers, (n_iters or self.cfg.n_iters, want_static_mask))

    def prepared(self) -> VoxelModel:
        b = self.buffers
        return VoxelModel(**b.model_layout.views(clone_out(b.prepared_buf)))

    def model_copy(self) -> VoxelModel:
        b = self.buffers
        return VoxelModel(**b.model_layout.views(clone_out(b.model_buf)))


def packed_result(b: FrameBuffers, key: tuple) -> RegistrationResult:
    """The result buffer ``key = (n_iters, static mask)`` of ``b`` as a
    :class:`RegistrationResult` of views of one copy (``iterations`` a 0-d
    device count)."""
    v = b.result_layout[key].views(clone_out(b.result_buf[key]))
    diag = IterationDiag(**{k: v[k] for k in IterationDiag._fields})
    return RegistrationResult(X=v["X"], pred_stds=v["pred_stds"], Q=v["Q"], diagnostics=diag,
                              static_mask=v["static_mask"], iterations=v["iterations"])


def copy_in(dst: torch.Tensor, src) -> None:
    """Copy ``src`` into the static buffer ``dst`` (one device copy)."""
    dst.copy_(torch.as_tensor(src))
    host_ops["copies"] += 1


def clone_out(t: torch.Tensor) -> torch.Tensor:
    """A copy of a static buffer that no later replay overwrites."""
    host_ops["copies"] += 1
    return t.clone()


_CACHE: dict = {}


def _canonical(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def frame_graphs(device, n: int, cfg: ICETConfig) -> FrameGraphs:
    """The graph set of ``(device, N, cfg)``, made at first use."""
    key = (_canonical(device), n, cfg)
    fg = _CACHE.get(key)
    if fg is None:
        fg = _CACHE[key] = FrameGraphs(key[0], n, cfg)
    return fg


def _incidence_buffers(owner, inc) -> bool:
    """Copy a factor graph's incidence (``pose_graph.Incidence``) into
    ``owner.incidence``, made anew where its shapes differ (then True: the
    graphs captured over the old buffers are stale)."""
    fresh = [tuple(t.shape) for t in owner.incidence] != [tuple(t.shape) for t in inc]
    if fresh:
        owner.incidence = tuple(torch.empty(t.shape, dtype=t.dtype, device=owner.states.device)
                                for t in inc)
    for dst, t in zip(owner.incidence, inc):
        copy_in(dst, t)
    return fresh


def _incidence_twin(dst, src) -> None:
    """A scratch twin's copy of ``src``'s incidence (valid indices for the
    warm-ups)."""
    dst.incidence = tuple(t.clone() for t in src.incidence)


class PoseBuffers:
    """The static buffers of one pose-graph solve of K poses and F factors:
    the states, the factors ``(idx_i, idx_j, meas, info)``, their incidence
    (the order of every sum of the normals; its shapes depend on the
    graph, so :meth:`PoseGraphs.attach_incidence` makes it), ``damping`` and
    ``prior_weight``; for the block-sparse solve (``precond`` "tridiag" or
    "jacobi"; "dense" is the dense solve) also the damped diagonal blocks,
    the factors' off-diagonal blocks, the preconditioner's factor (the
    backbone's ``(S_inv, U)`` or the block Cholesky factors) and the CG
    state ``x, r, p, rz``."""

    def __init__(self, device: torch.device, k: int, f: int, precond: str):
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.states = z(k, 6)
        self.factors = (z(f, dtype=torch.int64), z(f, dtype=torch.int64), z(f, 6), z(f, 6, 6))
        self.incidence = ()
        self.damping, self.prior_weight = z(), z()
        if precond != "dense":
            self.diag_d, self.off_ij, self.off_ji = z(k, 6, 6), z(f, 6, 6), z(f, 6, 6)
            self.factor = ((z(k, 6, 6), z(k - 1, 6, 6)) if precond == "tridiag"
                           else (z(k, 6, 6),))
            self.x, self.r, self.p, self.rz = z(k, 6), z(k, 6), z(k, 6), z()


class PoseGraphs(GraphSet):
    """The graphs of one pose-graph solve's ``(device, K, F, cg_iters,
    precond, robust)`` and their buffers."""

    def __init__(self, device: torch.device, k: int, f: int, precond: str):
        super().__init__(device)
        self.shape = (k, f, precond)
        self.buffers = PoseBuffers(device, k, f, precond)

    def scratch(self) -> PoseBuffers:
        if self._scratch is None:
            self._scratch = PoseBuffers(self.device, *self.shape)
            _incidence_twin(self._scratch, self.buffers)
        return self._scratch

    def attach_incidence(self, inc) -> None:
        """Copy the solve's factor incidence into the buffers; a graph of
        other incidence shapes drops the graphs captured over the old
        buffers (they are captured anew at their next run)."""
        if _incidence_buffers(self.buffers, inc):
            self._graphs.clear()
            self._scratch = None


def pose_graphs(device, k: int, f: int, cg_iters: int, precond: str,
                robust: float) -> PoseGraphs:
    """The graph set of a pose-graph solve, made at first use."""
    key = (_canonical(device), k, f, cg_iters, precond, robust)
    pg = _CACHE.get(key)
    if pg is None:
        pg = _CACHE[key] = PoseGraphs(key[0], k, f, precond)
    return pg


class ShardBuffers:
    """One point shard's static buffers on its device, for the compiled
    sharded step: both scans' shard, the replicated state it reads (X,
    bounds, anchors, correspondences), its moment sums, static-mask slice
    and the distributed clustering's buckets, the points it sends to the
    gather, the buckets it received and its table of owned voxels."""

    def __init__(self, device: torch.device, local: int, n: int, cfg: ICETConfig,
                 shards: int):
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        v1 = cfg.n_voxels + 1
        vps, cap = cluster_plan(n, cfg.n_voxels, shards)
        #: the shard's position in the local list (its axis index is the axis's)
        self.local = local
        self.scan1, self.scan2 = z(n, 3), z(n, 3)
        self.X, self.bounds, self.anchors = z(6), z(v1, 2), z(v1, 3)
        self.corr = z(v1, dtype=torch.bool)
        self.sums = z(v1, 16)
        self.mask = z(n, dtype=torch.bool)
        self.sends, self.recv = (z(shards, cap, 2, dtype=torch.int32) for _ in range(2))
        self.overflow = z(dtype=torch.int64)
        self.points = z(n, 2, dtype=torch.int32)
        self.table = z(vps, 3)


class RowBuffers(FrameBuffers):
    """A sharded pair's replicated buffers on the axis device: a frame's
    (the model, the Gauss-Newton state, the diagnostics, the results over
    all ``sp`` shards' points) and the summed moments, the clustering's
    overflow flag, gathered points and tables, and the clusters found."""

    def __init__(self, device: torch.device, n: int, cfg: ICETConfig, shards: int):
        super().__init__(device, n * shards, cfg)
        v1 = cfg.n_voxels + 1
        vps, _ = cluster_plan(n, cfg.n_voxels, shards)
        self.sums = torch.zeros((v1, 16), dtype=torch.float32, device=device)
        self.overflow = torch.zeros((), dtype=torch.bool, device=device)
        self.points = torch.zeros((n * shards, 2), dtype=torch.int32, device=device)
        self.tables = torch.zeros((vps * shards, 3), dtype=torch.float32, device=device)
        self.found = torch.zeros(v1, dtype=torch.bool, device=device)


class ShardedBuffers:
    """The static buffers of one mesh row: a :class:`ShardBuffers` a local
    shard (``shards``) and the replicated :class:`RowBuffers` (``rep``) on
    the first local shard's device, the axis's."""

    def __init__(self, devices, n: int, cfg: ICETConfig, shards: int):
        self.shards = [ShardBuffers(d, i, n, cfg, shards) for i, d in enumerate(devices)]
        self.rep = RowBuffers(devices[0], n, cfg, shards)


def _run_steps(b: ShardedBuffers, steps) -> None:
    for kind, fn in steps:
        if kind == "shard":
            for sh in b.shards:
                fn(sh)
        elif kind == "rep":
            fn(b.rep)
        else:
            fn(b)


class _PartGraphs(GraphSet):
    """The graphs of one part of a split row: one shard's, on its device,
    or the replicated part's, on the axis device."""

    def __init__(self, device: torch.device, buffers, scratch):
        super().__init__(device)
        self.buffers = buffers
        self._make_scratch = scratch

    def scratch(self):
        return self._make_scratch()


class RowGraphs(GraphSet):
    """The graphs of one mesh row's sharded work: the row's local shard
    ``devices`` (one a local shard), the replicated math on the first of
    them (the axis's device), over buffers ``make(devices)`` with a list
    ``shards`` (one a local shard) and a replicated ``rep``.

    A stage is a list of steps ``(kind, fn)``: ``"shard"`` runs
    ``fn(shard buffers)`` on every local shard, ``"rep"`` runs ``fn(rep
    buffers)``, ``"join"`` runs ``fn(all buffers)`` (the axis's collectives
    and the copies between shards and ``rep``).  A schedule is a list of
    stages and :class:`If` entries over stages (:meth:`run_schedule`).
    Where every device is one device (repeats of one card; a process's one
    shard) the whole schedule is one graph, its guards IF nodes: the
    shards' work and the axis's collectives are device operations on one
    stream.  Where the row holds distinct devices (``split``) no capture
    spans two devices: each shard step is a graph a shard on its own
    device (a plain call on a CPU shard), each replicated step a graph on
    the axis's device, the joins run between the replays, and every guard
    is a host read of its flag (``flag_reads``, ``overflow_reads``): an IF
    node cannot hold the CPU part's steps.

    ``axis`` is bound by :meth:`bind` before each run; the collectives a
    graph captured are added to the bound axis's counts at each replay
    (a guarded body's at :func:`settle`, which a new binding runs first).
    Captures run in ``thread_local`` mode: a process group's watchdog
    thread queries its events while a capture is open."""

    capture_mode = "thread_local"

    def __init__(self, devices, make):
        self.devices = tuple(_canonical(d) for d in devices)
        super().__init__(self.devices[0])
        self._make = make
        self.split = len(set(self.devices)) > 1
        self.buffers = make(self.devices)
        self.axis = None
        if self.split:
            self._parts = [_PartGraphs(d, sh, lambda i=i: self.scratch().shards[i])
                           for i, (d, sh) in enumerate(zip(self.devices, self.buffers.shards))]
            self._rep = _PartGraphs(self.device, self.buffers.rep, lambda: self.scratch().rep)

    def scratch(self):
        if self._scratch is None:
            self._scratch = self._make(self.devices)
        return self._scratch

    def counters(self) -> list:
        return super().counters() + [(self.axis, "collectives"), (self.axis, "bytes")]

    def bind(self, axis) -> None:
        """The axis of the next run (the guarded bodies' counts settled
        onto the one bound before, where it changes)."""
        if axis is not self.axis:
            if self in _TALLIED:
                self.settle()
            self.axis = axis

    def run_schedule(self, key, schedule: list) -> None:
        """Run a schedule whose entries are stages (lists of steps) or
        :class:`If` entries over stages; ``key`` names its graphs."""
        if not self.split:
            def stage(steps):
                return lambda b: _run_steps(b, steps)
            super().run_schedule(key, [
                If(e.pred, stage(e.body), e.orelse and stage(e.orelse), e.reads)
                if isinstance(e, If) else stage(e) for e in schedule])
            return
        run_on_host(self.buffers, schedule, lambda k, steps: self._split_stage((key, k), steps))

    def _split_stage(self, key, steps) -> None:
        for k, (kind, fn) in enumerate(steps):
            if kind == "shard":
                for part in self._parts:
                    part.run((key, k), fn)
            elif kind == "rep":
                self._rep.run((key, k), fn)
            else:
                fn(self.buffers)


class ShardedGraphs(RowGraphs):
    """The graphs of one mesh row's compiled sharded registration step
    (:class:`RowGraphs` over :class:`ShardedBuffers`): ``n`` points a
    shard, ``shards`` shards on the axis; a pair is one schedule
    (``parallel.sharding.pair_schedule``)."""

    def __init__(self, devices, n: int, cfg: ICETConfig, shards: int):
        self.n, self.cfg, self.shards = n, cfg, shards
        super().__init__(devices, lambda devs: ShardedBuffers(devs, n, cfg, shards))


class PoseShardBuffers:
    """One factor shard's static buffers on its device, for a sharded
    pose-graph solve of K poses: the states it reads, its ``F`` factors
    ``(idx_i, idx_j, meas, info)``, their incidence and, for the
    block-sparse solve, its
    share of the normals packed ``(K, 78)`` (gradient, diagonal and
    backbone blocks), its factors' off-diagonal blocks, the CG direction
    it reads and its off-diagonal product; for the dense solve its
    ``(H, b)`` flattened."""

    def __init__(self, device: torch.device, local: int, k: int, f: int, precond: str):
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.local = local
        self.states = z(k, 6)
        self.factors = (z(f, dtype=torch.int64), z(f, dtype=torch.int64), z(f, 6), z(f, 6, 6))
        self.incidence = ()
        if precond == "dense":
            self.Hb = z(36 * k * k + 6 * k)
        else:
            self.packed, self.off_ij, self.off_ji = z(k, 78), z(f, 6, 6), z(f, 6, 6)
            self.v, self.off = z(k, 6), z(k, 6)


class PoseRepBuffers:
    """A sharded pose-graph solve's replicated buffers on the axis device:
    the states and, for the block-sparse solve, the summed normals, the
    damped diagonal blocks, the backbone's factor ``(S_inv, U)``, the CG
    state ``x, r, p, rz`` and the summed off-diagonal product; for the
    dense solve the summed ``(H, b)``."""

    def __init__(self, device: torch.device, k: int, precond: str):
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.states = z(k, 6)
        if precond == "dense":
            self.Hb = z(36 * k * k + 6 * k)
        else:
            self.packed, self.diag_d = z(k, 78), z(k, 6, 6)
            self.factor = (z(k, 6, 6), z(k - 1, 6, 6))
            self.x, self.r, self.p, self.rz, self.off = z(k, 6), z(k, 6), z(k, 6), z(), z(k, 6)


class ShardedPoseBuffers:
    def __init__(self, devices, k: int, f: int, precond: str):
        self.shards = [PoseShardBuffers(d, i, k, f, precond) for i, d in enumerate(devices)]
        self.rep = PoseRepBuffers(devices[0], k, precond)


class ShardedPoseGraphs(RowGraphs):
    """The graphs of one sharded pose-graph solve (:class:`RowGraphs` over
    :class:`ShardedPoseBuffers`): K poses, ``f`` factors a shard, the
    dense solve (``precond="dense"``) or the block-sparse one
    (``"tridiag"``).  As :class:`PoseGraphs`, a solve is a few stages
    replayed many times: the dense Gauss-Newton step, or the assembly, one
    CG iteration and the update."""

    def __init__(self, devices, k: int, f: int, precond: str):
        super().__init__(devices, lambda devs: ShardedPoseBuffers(devs, k, f, precond))

    def scratch(self):
        if self._scratch is None:
            for dst, src in zip(super().scratch().shards, self.buffers.shards):
                _incidence_twin(dst, src)
        return self._scratch

    def attach_incidence(self, incs: list) -> None:
        """Copy each local shard's factor incidence into its buffers; new
        shapes drop the graphs captured over the old buffers."""
        fresh = [_incidence_buffers(sh, inc) for sh, inc in zip(self.buffers.shards, incs)]
        if any(fresh):
            self._graphs.clear()
            self._scratch = None
            if self.split:
                for part in (*self._parts, self._rep):
                    part._graphs.clear()


def sharded_pose_graphs(axis, k: int, f: int, cg_iters: int, precond: str, robust: float,
                        damping: float, prior_weight: float) -> ShardedPoseGraphs:
    """The graph set of a sharded pose-graph solve over ``axis`` (its
    local shard devices and, over a process group, the group), made at
    first use."""
    devices = tuple(_canonical(d) for d in axis.shard_devices)
    key = (_canonical(axis.device), "sharded_pose", devices, getattr(axis, "group", None), k, f,
           cg_iters, precond, robust, damping, prior_weight)
    pg = _CACHE.get(key)
    if pg is None:
        pg = _CACHE[key] = ShardedPoseGraphs(devices, k, f, precond)
    return pg


class TrainBuffers:
    """One training step's static buffers: the module and the optimizer's
    parameters and ``(step, exp_avg, exp_avg_sq)`` slots (the caller's own
    tensors, or a scratch twin's), the batch, the Adam constants (``(-lr,
    b1, b2, eps, 1 - b1, 1 - b2)``) and the loss."""

    def __init__(self, model, params, slots, x_shape, y_shape, device):
        self.model, self.params, self.slots = model, params, slots
        self.x = torch.zeros(x_shape, dtype=torch.float32, device=device)
        self.y = torch.zeros(y_shape, dtype=torch.float32, device=device)
        self.hyper = torch.zeros(6, dtype=torch.float32, device=device)
        self.loss = torch.zeros((), dtype=torch.float32, device=device)


class TrainGraphs(GraphSet):
    """The training step's graph for one module, optimizer state and batch
    shape.  Its warm-up runs on a scratch twin: a copy of the module and
    zeroed slots, so the caller's parameters and optimizer state move only
    when the graph replays.  The Adam constants are a buffer, so the graph
    serves any learning rate."""

    def __init__(self, device: torch.device, model, params, slots, x_shape, y_shape):
        super().__init__(device)
        self.buffers = TrainBuffers(model, params, slots, x_shape, y_shape, device)
        #: the constants the buffer holds
        self._hyper = None

    def over(self, model, params, slots) -> bool:
        """Whether the set's buffers are ``model`` and these very tensors."""
        b = self.buffers
        return (b.model is model and len(b.params) == len(params)
                and all(a is t for a, t in zip(b.params, params))
                and all(a is t for sa, st in zip(b.slots, slots) for a, t in zip(sa, st)))

    def scratch(self) -> TrainBuffers:
        if self._scratch is None:
            b = self.buffers
            model = copy.deepcopy(b.model)
            names = {id(p): n for n, p in b.model.named_parameters()}
            twin = dict(model.named_parameters())
            params = [twin[names[id(p)]] for p in b.params]
            slots = [tuple(torch.zeros_like(t) for t in slot) for slot in b.slots]
            self._scratch = TrainBuffers(model, params, slots, b.x.shape, b.y.shape,
                                         self.device)
        self._scratch.hyper.copy_(self.buffers.hyper)
        return self._scratch

    def load(self, inputs, targets, hyper: tuple) -> None:
        """Copy the batch in, and the Adam constants where they changed."""
        copy_in(self.buffers.x, inputs)
        copy_in(self.buffers.y, targets)
        if hyper != self._hyper:
            copy_in(self.buffers.hyper, torch.tensor(hyper, dtype=torch.float32))
            self._hyper = hyper


#: the training sets of each optimizer (``{optimizer: {(device, x shape, y
#: shape): TrainGraphs}}``), dropped with the optimizer
_TRAIN: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def train_graphs(opt, model, params, slots, x_shape, y_shape) -> TrainGraphs:
    """The training set of the optimizer ``opt`` for ``model``, its
    ``params`` and ``slots`` and a batch of ``x_shape``/``y_shape`` (made at
    first use).  It lives as long as ``opt``: one a device and batch shape,
    replaced when the module or the tensors it was captured over are no
    longer these (a ``load_state_dict``, a new module)."""
    sets = _TRAIN.setdefault(opt, {})
    key = (_canonical(params[0].device), tuple(x_shape), tuple(y_shape))
    tg = sets.get(key)
    if tg is None or not tg.over(model, params, slots):
        tg = sets[key] = TrainGraphs(key[0], model, params, slots, x_shape, y_shape)
    return tg


def _forget(gs: GraphSet) -> None:
    """Drop ``gs`` from the caches."""
    for key in [k for k, v in _CACHE.items() if v is gs]:
        del _CACHE[key]
    for sets in list(_TRAIN.values()):
        for key in [k for k, v in sets.items() if v is gs]:
            del sets[key]


def clear(device=None) -> None:
    """Drop the cached graph sets, frame, pose-graph and training sets alike
    (of ``device`` only, if given); the next call captures anew."""
    dev = None if device is None else _canonical(device)
    for key in [k for k in _CACHE if dev is None or k[0] == dev]:
        del _CACHE[key]
    for sets in list(_TRAIN.values()):
        for key in [k for k in sets if dev is None or k[0] == dev]:
            del sets[key]


__all__ = ["COUNTED", "MAP_OUT_LAYOUT", "NODE_TYPES", "FrameBuffers", "FrameGraphs", "GraphSet",
           "If", "Layout", "MapBuffers", "PoseBuffers", "PoseGraphs", "RingBuffers", "RowBuffers",
           "PoseRepBuffers", "PoseShardBuffers", "RowGraphs", "ShardBuffers", "ShardedBuffers",
           "ShardedGraphs", "ShardedPoseBuffers", "ShardedPoseGraphs", "Span", "TrainBuffers",
           "TrainGraphs", "capture_stats", "clear", "clone_out", "copy_in", "dnn_passes",
           "dnn_phases", "frame_graphs", "graph_nodes", "host_ops", "node_types", "packed_result",
           "pose_graphs", "result_iters", "run_on_host", "settle", "sharded_pose_graphs",
           "sync_debug", "train_graphs", "warmup_launches"]
