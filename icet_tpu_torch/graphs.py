"""CUDA-graph capture and replay behind the compiled entry points
(``solver.prepare_reference_jit``, ``register_jit``, ``odometry_step_jit``,
``odometry.odometry_sequence_jit``; ``filters.model_voxel_samples_jit``,
``odometry_step_dnn_jit``, ``register_pair_with_dnn``; and
``keyframe.keyframe_step_jit``, ``keyframe_step_dnn_jit``,
``keyframe_spawn_jit``, ``keyframe_sequence_jit``).

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
  divergence guard, the world pose and the hand-over of the model;
* with the DNN filter (``filters``): ``filter`` (the reject mask at the
  current X, kernels #1 and #4), the solve's phases as ``first``/``warm``/
  ``finish`` graphs of their derived configs, keyed inside the one set of
  the base config, ``samples`` and the frame's ``handover``;
* for the keyframe path (``keyframe``): ``kf_predict``, ``kf_post`` (the
  covariance propagation, the delta guard, the spawn flag and the map
  insert staged under the device flag ``~spawn``), ``kf_spawn`` and, in
  the sequence runner, ``kf_glue``.

The stages themselves are plain functions of the buffers (``solver``'s
``_stage_*``, ``odometry``'s ``_stage_seed``/``_stage_glue``).

Early exit: each iteration's graph leaves the flag ``|dx| >= threshold``
on the device, and the host reads it once an iteration past ``min_it``,
as the eager solver reads ``|dx|``, then replays the warm graph again or
the finish.  A frame therefore executes the eager solve's iterations.

Buffers: every graph reads and writes :class:`FrameBuffers`, allocated
outside capture (the keyframe insert's staging among them,
:class:`MapBuffers`: a block map's own tables are written by the host,
outside any graph); the graphs' intermediates come from one private
memory pool a set.  No graph leaves an output in the pool, so the graphs
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
makes the kernels' shared-memory opt-ins and the cuBLAS handles.
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
from icet_tpu_torch.ops.bias_encoder import bias_encoder_pool, cached_image
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
COUNTED = (fused_moment_sums, bias_encoder_pool)
#: launches of each counted wrapper made by warm-ups before a capture
warmup_launches = {f.__name__: 0 for f in COUNTED}
#: host operations of the compiled path: graph replays, exit-flag reads,
#: keyframe spawn-flag reads, device copies of inputs in and of packed
#: results out, draws of the insert's uniforms, the device operations that
#: write a staged insert or a spawn into a block map; and graphs captured
host_ops = {"replays": 0, "flag_reads": 0, "spawn_reads": 0, "copies": 0, "draws": 0,
            "map_writes": 0, "captures": 0}

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


def samples_layout(cfg: ICETConfig) -> Layout:
    """Lean per-voxel samples ``(V+1, S, 3)`` bf16 and their clipped counts."""
    v1 = cfg.n_voxels + 1
    return Layout([("samples", (v1, cfg.dnn_sample_pts, 3), torch.bfloat16),
                   ("counts", (v1,), torch.int32)])


def filter_layout(n_voxels: int) -> Layout:
    """One DNN filter pass: the keep mask, both shifts and ``n_rejected``."""
    v1 = n_voxels + 1
    return Layout([("keep", (v1,), torch.bool), ("dnn_shift", (v1, 3), torch.float32),
                   ("icet_shift", (v1, 3), torch.float32), ("n_rejected", (), torch.int32)])


def dnn_phases(cfg: ICETConfig) -> tuple[int, int]:
    """``(n_pre, n_post)``: the filtered solve's plain and filtered
    iterations (``filters.register_with_dnn``)."""
    n_pre = max(min(cfg.dnn_start_iter, cfg.n_iters - 1), 1)
    return n_pre, cfg.n_iters - n_pre


def result_iters(cfg: ICETConfig) -> tuple[int, ...]:
    """The ``n_iters`` of every register call a frame of ``cfg`` finishes:
    its own, and the DNN-filtered solve's last phase's (1 in-loop, n_post
    one-shot)."""
    its = {cfg.n_iters, 1}
    if cfg.n_iters >= 2:
        its.add(dnn_phases(cfg)[1])
    return tuple(sorted(its))


#: one frame of the sequence runner: its guarded X, pred_stds, world pose
#: and divergence flag
ROW_LAYOUT = Layout([("X", (6,), torch.float32), ("pred_stds", (6,), torch.float32),
                     ("T_world", (4, 4), torch.float32), ("diverged", (), torch.bool)])

_F32 = torch.float32
#: the keyframe runner's carry: pose relative to the keyframe, last delta,
#: keyframe world pose, latched health, last stds; the spawn's world pose
#: and the step's prediction
KF_CARRY_LAYOUT = Layout([("x_rel", (6,), _F32), ("delta", (6,), _F32),
                          ("world_key", (6,), _F32), ("h0", (2,), _F32),
                          ("prev_stds", (6,), _F32), ("world", (6,), _F32), ("x0", (6,), _F32)])
#: one keyframe step's outputs besides its registration result
KF_OUT_LAYOUT = Layout([("X_total", (6,), _F32), ("Q", (6, 6), _F32), ("pred_stds", (6,), _F32),
                        ("X", (6,), _F32), ("delta", (6,), _F32), ("diverged", (), torch.bool),
                        ("spawn", (), torch.bool), ("health", (2,), _F32)])
#: one frame of the keyframe sequence runner, in the JAX package's order
KF_ROW_LAYOUT = Layout([("delta", (6,), _F32), ("delta_stds", (6,), _F32),
                        ("world6", (6,), _F32), ("diverged", (), torch.bool),
                        ("x_rel", (6,), _F32), ("is_keyframe", (), torch.bool),
                        ("n_corr", (), torch.int32)])


class MapBuffers:
    """The keyframe insert's staging for a ``(B, P)`` block map and ``K``
    samples a scan: the uniforms, the device mirror ``at = [slot, cursor,
    active]`` of the host's ``(n_blocks, cursor)`` (``expect``: the host
    value it holds, None when unknown), and the staged insert (flat row
    indices, points and write mask) that the host applies to the map."""

    def __init__(self, b: int, p: int, k: int, device):
        self.shape = (b, p, k)
        kw = min(k, p)
        self.u = torch.zeros(k, dtype=torch.float32, device=device)
        self.at = torch.zeros(3, dtype=torch.int64, device=device)
        self.idx = torch.zeros(kw, dtype=torch.int64, device=device)
        self.vals = torch.zeros(kw, 3, dtype=torch.float32, device=device)
        self.write = torch.zeros(kw, dtype=torch.bool, device=device)
        self.expect = None


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
        self.filt_layout = filter_layout(cfg.n_voxels)
        self.filt_buf, self.filt = packed(self.filt_layout)
        self.raw = z(n, 3)
        self.kf_buf, self.kf = packed(KF_CARRY_LAYOUT)
        self.kf_out_buf, self.kf_out = packed(KF_OUT_LAYOUT)
        self.kf_row_buf, self.kf_row = packed(KF_ROW_LAYOUT)
        #: the keyframe insert's staging (:meth:`FrameGraphs.map_buffers`)
        self.map: MapBuffers | None = None


def _versions(obj) -> tuple:
    if isinstance(obj, torch.Tensor):
        return (obj._version,)
    return tuple(t._version for t in obj)


class FrameGraphs:
    """The graphs of one ``(device, N, cfg)`` and their buffers."""

    def __init__(self, device: torch.device, n: int, cfg: ICETConfig):
        self.device, self.n, self.cfg = device, n, cfg
        self.buffers = FrameBuffers(device, n, cfg)
        self._graphs: dict = {}
        self._scratch = None
        #: carried inputs the buffers hold: name -> (object, its versions)
        self._held: dict = {}
        #: (net, weight image) of every image a graph of this set reads
        self.pinned: list = []
        self._maps: dict = {}
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
        if self.buffers.map is not None:
            self._scratch.map = self._maps[self.buffers.map.shape][1]
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

    def pin(self, net) -> None:
        """Keep ``net`` and the encoder's weight image of it alive with this
        set: a graph replays the image's address, and the image cache of
        ``ops/bias_encoder.py`` may evict it."""
        img = cached_image(net.encoder_weights())
        if not any(i is img for _, i in self.pinned):
            self.pinned.append((net, img))

    def map_buffers(self, b: int, p: int, k: int) -> MapBuffers:
        """The insert staging of a ``(B, P)`` map and ``K`` samples (made at
        first use, with a twin for the warm-ups), now the one the stages
        see.  No graph reads or writes a map's own tables."""
        key = (b, p, k)
        if key not in self._maps:
            self._maps[key] = (MapBuffers(b, p, k, self.device), MapBuffers(b, p, k, self.device))
        self.buffers.map = self._maps[key][0]
        return self.buffers.map

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

    def solve(self, want_static_mask: bool, cfg: ICETConfig | None = None, it_offset: int = 0,
              masked: bool = False, start: str = "x0", finish: bool = True) -> int:
        """One registration (the eager ``register``) of the loaded scan
        against the loaded model: from ``b.x0`` or, with ``start="X"``, from
        the last phase's X; ``cfg`` is this call's config (a phase's, derived
        from the set's), ``it_offset`` its first global iteration, ``masked``
        whether the filter's keep mask gates it; without ``finish`` only X
        comes out.  Returns the iterations it executed."""
        cfg = cfg or self.cfg
        early, min_it = exit_schedule(cfg, it_offset)

        def rm(it):
            return cfg.remove_moving and it >= cfg.rm_start_iter

        self.run(("first", cfg, rm(it_offset), masked, start),
                 lambda b: _stage_first(b, cfg, it_offset, masked, start))
        it = 1
        while it < cfg.n_iters:
            if early and it >= min_it:
                host_ops["flag_reads"] += 1
                if not bool(self.buffers.go):
                    break
            self.run(("warm", cfg, rm(it + it_offset), masked),
                     lambda b, g=it + it_offset: _stage_warm(b, cfg, g, masked))
            it += 1
        if finish:
            self.run(("finish", cfg, want_static_mask, rm(it_offset + cfg.n_iters - 1), masked),
                     lambda b: _stage_finish(b, cfg, want_static_mask, it_offset, masked))
        return it

    def run_prepare(self, src: str = "scan") -> None:
        self.run(("prepare", src), lambda b: _stage_prepare(b, self.cfg, src))

    def result(self, iterations: int, want_static_mask: bool,
               n_iters: int | None = None) -> RegistrationResult:
        """The finished result of ``(n_iters, want_static_mask)`` (one copy)."""
        b = self.buffers
        key = (n_iters or self.cfg.n_iters, want_static_mask)
        v = b.result_layout[key].views(clone_out(b.result_buf[key]))
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


__all__ = ["COUNTED", "FrameBuffers", "FrameGraphs", "Layout", "MapBuffers", "clear",
           "clone_out", "copy_in", "dnn_phases", "frame_graphs", "host_ops", "result_iters",
           "sync_debug", "warmup_launches"]
