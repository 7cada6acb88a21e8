"""CUDA-graph capture and replay behind the compiled entry points
(``solver.prepare_reference_jit``, ``register_jit``, ``odometry_step_jit``
and ``odometry.odometry_sequence_jit``).

The JAX package compiles each of them once per static shape and config.
Here a frame runs as a few CUDA graphs, captured once per ``(device, N,
cfg)`` (:func:`frame_graphs`) and replayed afterwards:

* ``prepare``: the voxel model of the scan buffer;
* ``first``: Gauss-Newton iteration 0 (the cold 6x6 eigendecomposition);
* ``warm``: one warm iteration (a second graph where the moving-object
  schedule switches on inside the solve);
* ``finish``: the predicted covariance, the diagnostics and, for
  ``register_jit``, the static mask, packed into one result buffer;
* for the sequence runner, ``seed`` and ``glue``: the warm start, the
  divergence guard, the world pose and the hand-over of the model.

The stages themselves are plain functions of the buffers (``solver``'s
``_stage_*``, ``odometry``'s ``_stage_seed``/``_stage_glue``).

Early exit: each iteration's graph leaves the flag ``|dx| >= threshold``
on the device, and the host reads it once an iteration past ``min_it``,
as the eager solver reads ``|dx|``, then replays the warm graph again or
the finish.  A frame therefore executes the eager solve's iterations.

Buffers: every graph reads and writes :class:`FrameBuffers`, allocated
outside capture; the graphs' intermediates come from one private memory
pool a set.  No graph leaves an output in the pool, so the graphs of a set
may replay in any order (one at a time: they share the pool and the
buffers).  Results come back as views of one clone of a packed buffer, so
no returned tensor is overwritten by a later call.

Warm-up: before its capture each graph's stage runs once on a scratch set
of buffers, on the capture stream, which builds and loads the kernels and
makes the fused kernel's shared-memory opt-in and the cuBLAS handles.
Those launches are real; the wrappers count them and
:data:`warmup_launches` records them.  The capture launches nothing: each
graph records how many launches of each counted wrapper it holds, and each
replay adds them to the wrapper's count.  A failed capture raises, and
the set is dropped from the cache.

On CPU tensors the stages run as plain calls on the same buffers.
"""

from __future__ import annotations

import contextlib
import math

import torch

from icet_tpu_torch.config import ICETConfig
from icet_tpu_torch.ops.fused_moments import fused_moment_sums
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

#: the kernel wrappers whose launches a graph records and its replays count
COUNTED = (fused_moment_sums,)
#: launches of each counted wrapper made by warm-ups before a capture
warmup_launches = {f.__name__: 0 for f in COUNTED}
#: host operations of the compiled path: graph replays, exit-flag reads, and
#: device copies of inputs in and of packed results out; and graphs captured
host_ops = {"replays": 0, "flag_reads": 0, "copies": 0, "captures": 0}

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
                   ("static_mask", (n if static_mask else 0,), torch.bool)])


#: one frame of the sequence runner: its guarded X, pred_stds, world pose
#: and divergence flag
ROW_LAYOUT = Layout([("X", (6,), torch.float32), ("pred_stds", (6,), torch.float32),
                     ("T_world", (4, 4), torch.float32), ("diverged", (), torch.bool)])


class FrameBuffers:
    """The static buffers of one frame: inputs, the Gauss-Newton state, the
    diagnostics columns, the packed results and the sequence runner's
    carry.  ``model`` and ``prepared`` are views of packed buffers."""

    def __init__(self, device: torch.device, n: int, cfg: ICETConfig):
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

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
        #: the exit flag ``|dx| >= threshold`` of the last iteration
        self.go = z(dtype=torch.bool)
        self.diag = tuple(z(cfg.n_iters, dtype=dt) for dt in _DIAG_DTYPES[:5])
        self.result_layout = {m: result_layout(n, cfg.n_iters, m) for m in (False, True)}
        self.result_buf = {m: lay.empty(device) for m, lay in self.result_layout.items()}
        self.result = {m: self.result_layout[m].views(buf) for m, buf in self.result_buf.items()}
        self.xprev, self.xprev2, self.T = z(6), z(6), z(4, 4)
        self.row_buf = ROW_LAYOUT.empty(device)
        self.row = ROW_LAYOUT.views(self.row_buf)


class FrameGraphs:
    """The graphs of one ``(device, N, cfg)`` and their buffers."""

    def __init__(self, device: torch.device, n: int, cfg: ICETConfig):
        self.device, self.n, self.cfg = device, n, cfg
        self.buffers = FrameBuffers(device, n, cfg)
        self._graphs: dict = {}
        self._scratch = None
        if device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)

    # -- stages ---------------------------------------------------------

    def run(self, key, stage) -> None:
        """Run ``stage(buffers)``: on CUDA replay its graph (``key`` names
        it; captured at first use), on the CPU call it."""
        if self.device.type != "cuda":
            stage(self.buffers)
            return
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(stage)
        graph, counts = entry
        graph.replay()
        host_ops["replays"] += 1
        for wrapper, k in zip(COUNTED, counts):
            wrapper.launches += k

    def _capture(self, stage):
        if self._scratch is None:
            self._scratch = FrameBuffers(self.device, self.n, self.cfg)
        with torch.cuda.device(self.device):
            before = tuple(w.launches for w in COUNTED)
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                stage(self._scratch)
            torch.cuda.current_stream().wait_stream(self._stream)
            warm = tuple(w.launches for w in COUNTED)
            for w, a, b in zip(COUNTED, before, warm):
                warmup_launches[w.__name__] += b - a
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
                    with _debug_mode():
                        stage(self.buffers)
            except BaseException:
                for key in [k for k, fg in _CACHE.items() if fg is self]:
                    del _CACHE[key]
                raise
            finally:
                counts = tuple(w.launches - k for w, k in zip(COUNTED, warm))
                for w, k in zip(COUNTED, warm):
                    w.launches = k
        host_ops["captures"] += 1
        return graph, counts

    # -- inputs and results ---------------------------------------------

    def load(self, scan=None, x0=None, model: VoxelModel | None = None) -> None:
        """Copy the inputs given into the static buffers (a model packed in
        this set's layout by one copy, and none where it is the buffer)."""
        b = self.buffers
        if scan is not None:
            copy_in(b.scan, scan)
        if x0 is not None:
            copy_in(b.x0, x0)
        if model is not None:
            src = b.model_layout.source(model._asdict())
            if src is None:
                for dst, t in zip(b.model, model):
                    copy_in(dst, t)
            elif src.data_ptr() != b.model_buf.data_ptr():
                copy_in(b.model_buf, src)

    def solve(self, want_static_mask: bool) -> int:
        """One registration of the loaded scan against the loaded model from
        the loaded x0; returns the iterations it executed."""
        cfg = self.cfg
        early, min_it = exit_schedule(cfg)
        self.run(("first",), lambda b: _stage_first(b, cfg))
        it = 1
        while it < cfg.n_iters:
            if early and it >= min_it:
                host_ops["flag_reads"] += 1
                if not bool(self.buffers.go):
                    break
            rm = cfg.remove_moving and it >= cfg.rm_start_iter
            self.run(("warm", rm), lambda b, it=it: _stage_warm(b, cfg, it))
            it += 1
        self.run(("finish", want_static_mask),
                 lambda b: _stage_finish(b, cfg, want_static_mask))
        return it

    def run_prepare(self) -> None:
        self.run(("prepare",), lambda b: _stage_prepare(b, self.cfg))

    def result(self, want_static_mask: bool, iterations: int) -> RegistrationResult:
        b = self.buffers
        v = b.result_layout[want_static_mask].views(clone_out(b.result_buf[want_static_mask]))
        diag = IterationDiag(**{k: v[k] for k in IterationDiag._fields})
        return RegistrationResult(X=v["X"], pred_stds=v["pred_stds"], Q=v["Q"],
                                  diagnostics=diag, static_mask=v["static_mask"],
                                  iterations=iterations)

    def prepared(self) -> VoxelModel:
        b = self.buffers
        return VoxelModel(**b.model_layout.views(clone_out(b.prepared_buf)))

    def model_copy(self) -> VoxelModel:
        b = self.buffers
        return VoxelModel(**b.model_layout.views(clone_out(b.model_buf)))


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


def clear(device=None) -> None:
    """Drop the cached graph sets (of ``device`` only, if given); the next
    call captures anew."""
    dev = None if device is None else _canonical(device)
    for key in [k for k in _CACHE if dev is None or k[0] == dev]:
        del _CACHE[key]


__all__ = ["COUNTED", "FrameBuffers", "FrameGraphs", "Layout", "clear", "clone_out", "copy_in",
           "frame_graphs", "host_ops", "sync_debug", "warmup_launches"]
