#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``icet_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA source of the port, compiled by nvcc in parallel,
   with each kernel's registers, shared memory and spills (-Xptxas -v);
3. kernels vs plain versions on the card:
   a. fused moments on a 65,536-point 64x1024 city-drive frame with its
      75x24 (V = 1,800) voxel model, at three transforms, in shuffled point
      order, and with NaN and zero rows; then 65,536 points in one voxel
      (the worst contention), no member at all, N = 1 and N = 65,537 (a
      ragged last block); each with its run-to-run difference;
   b. the BiasNet encoder on the drive's real filter input (1,801 voxels x
      200 points, frames 0 -> 1), on a 37-voxel batch and at P in {1, 63,
      64, 65, 200} x B in {1, 37, 1,801}: codes within one bf16 ulp on
      >= 99.5% of entries, outputs within 2e-2, tiles 8/16/32 bitwise
      equal;
   c. the moment scatter against ``index_add_`` at V = 1,800 (shared
      table) and in fixed radial mode at V = 90,000 (global atomics); then
      shuffled ids, 65,536 points in one voxel, every id on the sentinel,
      N = 1, N = 65,537 and out-of-range ids (dropped) at V = 1,800, and
      out-of-range ids at V = 90,000; counts exact, each with its
      run-to-run difference; one device operation a call and no host
      synchronisation in both branches;
4. sequence odometry: the 24-frame drive through ``run_odometry_device``
   (the compiled runner, ``odometry_sequence_jit``), fused-moments
   launches counted with the warm-ups before each graph's capture;
5. DNN-filtered odometry: the same drive through ``OdometryPipeline`` with
   the filter on (the compiled ``odometry_step_dnn_jit``); encoder and
   fused-moments launches counted with the warm-ups, ATE gated, the eager
   pipeline's ATE beside it;
6. pallas moments: the first 8 frames at ``moment_method="pallas"``,
   scatter launches counted;
7. fixed radial mode: one registration on the card against the CPU path;
8. windowed moments (kernel #2) against its plain version at block 512,
   window 256: beam-major at X = 0 (and, with no overflow, against kernel
   #1) and at a 1 m step, shuffled (overflow > 0), fixed radial mode at
   V = 90,000; then block 64 (more point blocks than SMs), windows 128
   and 512, a ragged N, one voxel and no member, overflow and counts
   exact; one device operation a call and no host synchronisation in both
   radial modes; then its own path, one windowed pass a frame of the drive
   at the sequence drive's solutions, launches counted;
9. keyframe odometry: the drive through ``run_keyframe_device`` and
   ``KeyframeOdometry`` at bench.py's keyframe config (both compiled);
   keyframe indices of the two equal, fused-moments launches counted with
   the warm-ups, the block map's fill, ATE gated at the JAX package's CPU
   figure plus 0.5 cm, the eager host loop's beside it;
10. DNN-filtered keyframe odometry: ``KeyframeOdometry`` with the filter
    (compiled); encoder and fused-moments launches counted with the
    warm-ups, ATE gated likewise, the eager run's beside it;
11. MapMaker at ``PROFILES["mapping"]`` on the compiled route
    (``map_step_jit``; its graphs captured under
    ``set_sync_debug_mode("error")``) against the eager route frame by
    frame (X within 1e-6 m, flags, fill and counters equal; bit-identical
    or not, and the rings): launches counted with the warm-ups, ring fill
    exact, trajectory ATE gated likewise;
12. ScanMatcher: 6 frames, statuses and aligned clouds;
13. times: CUDA-event times (one round after a warm-up) of the eager
    odometry, DNN, keyframe, DNN keyframe and pallas-moments frames; for each kernel, its plain version and, where one exists, the
    one PyTorch call that computes the same function, the device time a
    call by torch.profiler (what the JSON line reports) and the CUDA-event
    time over back-to-back calls; the encoder's LayerNorm-epilogue floor;
14. a grid above the fused kernel's shared-memory table (150x48, V =
    7,200): one registration through the plain route, the fused kernel not
    launched, X equal to the CPU path's;
15. BiasNet training at ``train_bias_net_mixed``'s published size (batch
    256, S = 100, 6 raycast pairs), cut to TRAIN_STEPS steps: every loss
    finite, the last ten below the first ten, ms a step; the JAX test's
    40-step patch case (last loss below 0.7x the first); the trained net
    saved, loaded by ``load_pretrained`` and served through the encoder
    kernel within phase 3b's gates, its forward equal to the training
    module's; the bundled s100 net's MAE below 0.12 through the kernel;
16. the backbone kernels (factor and apply) against their plain versions
    on the 10,000-pose graph of tests/test_pose_graph.py and its first
    1,000 poses, and on the synthetic chains of ``backbone_cases`` (K = 1,
    2, 3, the edges of the kernels' ring stage and ring, forced fallbacks
    at k = 1, at two consecutive k across a stage edge and at k = K - 1,
    inputs one float into their buffers), one launch a call, one device
    operation a call; then
    ``optimize_poses_sparse`` on that graph, compiled (its graphs captured
    under ``set_sync_debug_mode("error")``) and eager in turns, launches
    counted through the replays (10 + 260, the warm-ups beside them), the
    states against the eager loop's, the mean position error at most half
    the initial one; the kernels' times at K = 10,000 and 1,000 beside the
    chain floor, and their registers;
17. the loop-closure drive through ``icet_tpu_torch.examples.eval_citydrive.run``
    (tests/test_citydrive.py's block at 64x1024, 250 frames): odometry, loop
    candidates, ``close_loops``, ``optimize_poses_sparse(..., 10, 50,
    robust_delta=3.5)``, all compiled; launches counted, at least 30 loops,
    the refined ATE below the odometry ATE and within ATE_SLACK_M of the
    JAX package's CPU figure; the loop factors of the first 16 candidates
    against the eager route's;
18. the in-process mesh (``parallel.sharding``) on repeats of the card at
    (dp, sp) in SHARD_SHAPES, 4 pairs of the drive: each pair against the
    unsharded ``register_pair`` at the JAX package's sharding tolerances,
    fused launches sp x (prepares + iterations); the distributed
    clustering on 4 shards bit-identical to the replicated one at capacity
    2.0 and 0.02, beam-major and shuffled; ms a pair per shape; the
    keyframe drive with its block map over two repeats of the card
    (``shard_blockmap``) against the unsharded map;
19. ``run_distributed_registration`` as spawned processes (this script
    with ``--worker``), each joined with a timeout: two over gloo at
    (1, 2) and at (2, 1), one over NCCL at (1, 1); results against the
    unsharded solve and phase 18's at the same shape, equal iterations on
    the ranks of a row, launches counted; ms, collectives and bytes a pair;
20. the elastic runner on four repeats of the card, prefer_dp 2: one step
    raises and one probe entry fails, the runner rebuilds to (1, 3),
    results within the tolerances; a blocking probe returns within its
    1 s timeout;
21. recovery: ``OdometryPipeline`` (plain, through ``odometry_step_jit``,
    and DNN, through ``odometry_step_dnn_jit``), ``KeyframeOdometry``
    (through ``keyframe_step_jit``) and ``MapMaker`` (through
    ``map_step_jit``) on the drive with one
    step raising a RuntimeError at frame FAIL_AT: one recovery (the
    compiled pipelines' graphs captured anew; the MapMaker's kept, its
    ring restored in place), the frames against a clean run within a
    bound from two clean runs (the keyframe runner re-seeds a keyframe
    there, as the JAX package's does), ATE and ms a recovery (the eager
    route's beside it); then a
    resume of the odometry and keyframe runners from a mid-drive
    checkpoint;
22. KITTI evaluation at KITTI scale: the 24-frame city drive at 64x2048
    (131,072 rays a sweep) written as a KITTI sequence with a non-identity
    ``calib.txt``, through ``eval_kitti.run`` with the native prefetch
    queue: plain (TUM files and the HTML map written), ``--keyframe``,
    ``--dnn`` and ``--refine --strict-real``; launches of #1, #4 and the
    backbone counted (every mode through the compiled pipelines, graph
    replays counted, warm-ups added; --keyframe and --dnn once more on the
    eager route, their times beside), ATE gated at the JAX package's CPU figure
    (tools/kitti_eval_ate_cpu.py) plus 0.5 cm, the TUM files read back,
    ms a frame by CUDA events and the StageTimer split;
23. replay and prefetch: the sequence's first 8 scans as .bin and .npy;
    ``NativeReplaySource`` and ``KittiOdometrySource(prefetch=True)``
    bit-identical to the numpy readers; ``eval_odometry.run`` through
    ``ReplaySource``, launches counted;
24. ``eval_citydrive.run`` on a 16-frame drive: stepped, ``--chained`` and a
    ``--state --chunk`` run stopped and resumed once, the chained and
    resumed trajectories within phase 21's bound of the stepped one;
25. leftovers: a registration at ``moment_method="onehot"`` against the CPU
    path and the fused route; ``device_time_ms`` of kernel #1 within 25%
    of phase 13's CUDA-event measurement, taken again in turns beside it;
    ``trace()`` (in a fresh process) writing a Chrome trace that names the
    fused-moments kernel; phase 22's HTML map;
26. the compiled entry points: the sequence drive's graphs captured
    under ``torch.cuda.set_sync_debug_mode("error")``; ``odometry_step_jit``
    against the eager ``odometry_step`` on every frame (same model and
    seed: iterations equal, X within 1e-6 m, pred_stds within 1e-6
    relative, prepared models equal; bit-identical or not, and what
    differs); ``run_odometry_device`` and ``OdometryPipeline`` against the
    eager chain (ATE gated and within 1e-4 cm of it, kernel #1's launches
    equal, no warm-up); phase 22's compiled eval_kitti; frame times
    compiled and eager in turns at 64x1024 and 64x2048 (CUDA events), host
    operations a frame, device operations and idle share (torch.profiler);
27. the compiled DNN and keyframe paths: the graphs of ``OdometryPipeline``
    (DNN), ``KeyframeOdometry`` (plain and DNN) and ``run_keyframe_device``
    captured under ``set_sync_debug_mode("error")``, each drive against the
    eager route (ATE gated and within 1e-4 cm of it, iterations and
    keyframes equal, kernel #1's and #4's launches equal to the eager
    drive's plus the warm-ups), ``run_keyframe_device``'s keyframes equal to
    ``KeyframeOdometry``'s; ``odometry_step_dnn_jit``, ``keyframe_step_jit``
    and ``keyframe_step_dnn_jit`` (and ``keyframe_spawn_jit``,
    ``model_voxel_samples_jit``) against the eager functions on every frame
    (same model, seed and uniforms: iterations equal, X within 1e-6 m,
    pred_stds within 1e-6 relative, keep masks, ``n_rejected``, spawn flags,
    keyframe models and samples equal, block maps equal up to 1e-5 m in
    their points; bit-identical or not, and what differs); phase 22's
    compiled eval_kitti --dnn and --keyframe; the DNN, keyframe and DNN
    keyframe frames compiled and eager in turns at 64x1024 and 64x2048
    (CUDA events), host operations a frame, device operations and idle
    share (torch.profiler); then the HD-mapping back end compiled and eager
    in turns: the MapMaker frame, a loop pair (phase 17's first 16
    candidates) and phase 17's K = 250 solve; the dense solve of that graph
    captured under a global ``preferred_linalg_library("magma")``.

It prints, before the last line, one JSON object with the kernels' numbers
and, as the last line, ``{"ok": true, "device": {...}}``.  It imports
nothing of JAX or of ``icet_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 flop/s,
#: dense bf16 tensor-core flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
#: float64 outside the tensor cores (NVIDIA's H100 SXM data sheet)
PEAK_FP64_PER_S = 34e12
PEAK_BF16_PER_S = 989e12
#: kernel vs plain: float32 sums of up to a few thousand terms taken in two
#: different orders (shared-memory atomics vs index_add_)
RTOL, ATOL = 1e-4, 1e-3
#: points within this angle of a bin edge may bin differently when the
#: kernel and PyTorch's CUDA ops round theta/phi differently by an ulp
EDGE_RAD = 1e-5
#: at most this share of points may be that close to an edge
EDGE_CAP = 1e-3
#: trajectory accuracy bound on the drive (the JAX package reaches 1.083 cm
#: on it on the CPU)
ATE_MAX_M = 0.03
#: the JAX package's ATE on the DNN-filtered drive on the CPU, 0.5965 cm
#: (tools/dnn_drive_ate_cpu.py); the card's run may be 0.5 cm worse at most
DNN_ATE_REF_M = 0.005965255391115008
DNN_ATE_MAX_M = DNN_ATE_REF_M + 0.005
#: encoder kernel vs plain: codes within one bf16 ulp on this share of
#: entries, outputs (after the float32 head) within this bound
CODE_RTOL, CODE_SHARE, OUT_ATOL = 2.0**-7, 0.995, 2e-2
#: frames of the pallas-moments drive, and its ATE bound
PALLAS_FRAMES = 8
#: the JAX package's figures on the keyframe, DNN-keyframe and MapMaker
#: drives on the CPU (tools/keyframe_drive_ate_cpu.py, ATE in m); the card's
#: runs may be 0.5 cm worse at most
KF_ATE_REF_M = 0.005915265637431167
KF_INDICES_REF = [0, 4, 8, 12, 16, 19, 23]
DNN_KF_ATE_REF_M = 0.0013262779695870182
DNN_KF_INDICES_REF = [0, 4, 7, 11, 15, 18, 22]
MAP_ATE_REF_M = 0.010803162501453203
ATE_SLACK_M = 0.005
#: the windowed kernel's block and window (the TPU kernel's defaults)
WIN_BLOCK, WIN_WINDOW = 512, 256
#: frames of the ScanMatcher phase
MATCHER_FRAMES = 6
#: training steps of phase 15 (train_bias_net_mixed publishes 1,200), and
#: the steps timed after it
TRAIN_STEPS, TIMED_STEPS = 100, 25
#: the JAX package's losses on phase 15's two cases on the CPU
#: (tools/train_losses_cpu.py; other random draws than the card's):
#: (mean of the first ten, mean of the last ten) of the mixed case at
#: TRAIN_STEPS steps, and (first, last) of the 40-step patch case
MIXED_LOSS_REF = (0.3767514184117317, 0.09481397680938244)
PATCH_LOSS_REF = (0.6877281069755554, 0.1153113842010498)
#: backbone kernels vs plain: error relative to each block's (or
#: vector's) largest entry, float32 recurrences summed in another order
TRI_RTOL = 1e-4
#: poses of phase 16's graph (tests/test_pose_graph.py:162)
RING_POSES = 10_000
#: the JAX package's loop-closure drive on the CPU
#: (tools/loop_closure_ate_cpu.py): odometry ATE, loops, refined ATE (m)
LC_ODO_ATE_REF_M = 0.052732875553655995
LC_LOOPS_REF = 94
LC_ATE_REF_M = 0.037278022472340286
#: the loop-closure drive (tests/test_citydrive.py's block at full width)
LC_DRIVE = dict(n_frames=250, speed=1.0, rect=(-24, 24, -19, 19), n_beams=64, n_azimuth=1024)
#: frames of phase 26-27's profiled chains (prepare, then PROFILE_FRAMES - 1
#: steps)
PROFILE_FRAMES = 4
#: frames of phase 27's timed chains at 64x2048 (the eager DNN frame there
#: takes ~0.2 s), and at 64x1024 (the DNN, keyframe and MapMaker frames;
#: the eager MapMaker frame takes ~0.35 s)
KF_TIMED_FRAMES = 8
TIMED_FRAMES = 12
#: the Hopper FP32 pipe's latency between dependent instructions (cycles) and the H100
#: SXM's boost clock, for the backbone's chain-latency floor
FMA_LATENCY_CYCLES, BOOST_HZ = 4, 1.98e9


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def zero_warmups() -> None:
    """Zero the compiled path's record of warm-up launches (each graph's
    stage runs once eagerly before its capture; those launches of kernel #1
    are real and counted, so the gates below add them)."""
    from icet_tpu_torch import graphs

    for k in graphs.warmup_launches:
        graphs.warmup_launches[k] = 0


def warmups(kernel: str = "fused_moment_sums") -> int:
    """A kernel's warm-up launches since :func:`zero_warmups` (kernel #1's,
    or ``"bias_encoder_pool"`` for kernel #4's)."""
    from icet_tpu_torch import graphs

    return graphs.warmup_launches[kernel]


def eager(runner):
    """``runner`` (an ``OdometryPipeline``, ``KeyframeOdometry`` or
    ``MapMaker``) on the eager functions: its frames are the plain version
    the compiled route is held to."""
    runner._compiled = False
    return runner


@contextlib.contextmanager
def spy(module, name):
    """``with spy(module, name) as calls``: ``module.name`` records each
    call's ``(args, kwargs)`` in ``calls.args`` and its result in
    ``calls.results``; restored on exit."""
    real = getattr(module, name)
    calls = types.SimpleNamespace(args=[], results=[])

    def wrapped(*args, **kw):
        calls.args.append((args, kw))
        calls.results.append(real(*args, **kw))
        return calls.results[-1]

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` is ``value`` inside, restored on exit."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def device_profile(fn, reps: int) -> dict[str, tuple[float, float]]:
    """``{device operation: (ms a call, recorded a call)}`` over ``reps``
    calls of ``fn``, by torch.profiler: kernels, memsets, copies.  The
    profiler can miss an operation's record now and then (on the H100, 12
    of 20 encoder launches recorded in one run), and a missed record would
    read as a shorter call.  So an operation's ms a call is its mean
    recorded duration times the whole number of times a call runs it,
    ``ceil(recorded / reps)``; with every record there, that is the summed
    duration over ``reps``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, seen = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name] = us.get(e.name, 0.0) + e.time_range.end - e.time_range.start
            seen[e.name] = seen.get(e.name, 0) + 1
    return {name: (us[name] / seen[name] * -(-seen[name] // reps) / 1e3, seen[name] / reps)
            for name in us}


def device_ms(fn, reps: int) -> float:
    """Device time a call (:func:`device_profile`, summed over the device
    operations).  Unlike a CUDA-event time over back-to-back calls, it
    leaves out the gaps where the device waits for the host to launch the
    next call."""
    ops = device_profile(fn, reps)
    check(bool(ops), "the profiler recorded no device time")
    for name, (_, k) in ops.items():
        if k != round(k):
            print(f"profiler: {k:g} records a call of {name[:60]}: some were missed")
    return sum(ms for ms, _ in ops.values())


def kernel_times(fn, reps: int) -> tuple[float, float]:
    """(device ms a call, CUDA-event ms a call over back-to-back calls)."""
    return device_ms(fn, reps), median_ms(fn, reps)


def bound(nbytes: float, nops: float, peak_ops: float):
    """(bound ms, "bytes" or "operations") from the card's published peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, nops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def trajectory_ate(frames, gt) -> float:
    return pose_ate([f.T_world for f in frames], gt)


def pose_ate(poses, gt) -> float:
    """RMS translation error of ``[I] + poses`` against the drive's poses
    relative to its first frame."""
    est = [np.eye(4)] + [np.asarray(T, np.float64) for T in poses]
    ref = [np.linalg.inv(gt[0]) @ T for T in gt[: len(est)]]
    err = [np.linalg.norm(e[:3, 3] - r[:3, 3]) for e, r in zip(est, ref)]
    return float(np.sqrt(np.mean(np.square(err))))


def edge_points(pts, X, cfg) -> int:
    """Points past the raw range gate whose transformed theta or phi lies
    within EDGE_RAD of a bin edge (where an ulp of difference can move them
    to the next voxel); theta == 0 exactly (y == 0, x > 0) is not an edge
    case, as every atan2 returns 0 there."""
    from icet_tpu_torch.ops.geometry import (
        cart_to_spherical,
        point_norm,
        transform_points,
    )

    rtp = cart_to_spherical(transform_points(pts, X)).double()
    w_t = 2 * np.pi / cfg.n_theta
    w_p = (cfg.phi_max - cfg.phi_min) / cfg.n_phi
    ft = rtp[:, 1] / w_t
    fp = (rtp[:, 2] - cfg.phi_min) / w_p
    on_theta = ((ft - torch.round(ft)).abs() * w_t < EDGE_RAD) & (rtp[:, 1] > 0)
    on_phi = (fp - torch.round(fp)).abs() * w_p < EDGE_RAD
    return int(((on_theta | on_phi) & (point_norm(pts) >= cfg.min_range)).sum())


def compare(name, pts, X, model, cfg, report):
    """Fused moments kernel vs plain on one input; returns the max |error|
    over rows whose counts agree."""
    from icet_tpu_torch.ops.fused_moments import (
        fused_moment_sums,
        fused_moment_sums_reference,
    )

    got = fused_moment_sums(pts, X, model.bounds, model.anchors, cfg)
    again = fused_moment_sums(pts, X, model.bounds, model.anchors, cfg)
    want = fused_moment_sums_reference(pts, X, model.bounds, model.anchors, cfg)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel sums")
    check(bool((got[:, 10:] == 0).all()), f"{name}: columns 10-15 not zero")
    check(bool((got[-1] == 0).all()), f"{name}: sentinel row not zero")
    edges = edge_points(pts, X, cfg)
    check(edges <= EDGE_CAP * pts.shape[0],
          f"{name}: {edges} points within {EDGE_RAD} rad of a bin edge")
    dcount = (got[:, 0] - want[:, 0]).abs()
    check(float(dcount.sum()) <= 2 * edges,
          f"{name}: counts differ by {float(dcount.sum())} with {edges} edge points")
    same = dcount == 0
    err = (got[same, :10] - want[same, :10]).abs()
    tol = ATOL + RTOL * want[same, :10].abs()
    check(bool((err <= tol).all()),
          f"{name}: features differ by up to {float(err.max())}")
    run_to_run = float((got - again).abs().max())
    report.append(
        f"{name}: members {int(want[:, 0].sum())}, edge points {edges}, "
        f"count diffs {int(dcount.sum())}, max |err| {float(err.max()):.3e}, "
        f"run-to-run max |diff| {run_to_run:.3e}"
    )
    return float(err.max()), got


def windowed_compare(name, pts, X, bounds, anchors, cfg, report, block=WIN_BLOCK,
                     window=WIN_WINDOW, exact=False):
    """Windowed moments kernel vs plain on one input; returns (max |error|
    over rows whose counts agree, kernel sums, kernel overflow).  With
    ``exact``, overflow and counts must match exactly, with no slack for the
    points near a bin edge."""
    from icet_tpu_torch.ops.fused_moments import (
        fused_moment_sums_windowed,
        fused_moment_sums_windowed_reference,
    )

    got, ovf = fused_moment_sums_windowed(pts, X, bounds, anchors, cfg, block, window)
    again, _ = fused_moment_sums_windowed(pts, X, bounds, anchors, cfg, block, window)
    want, want_ovf = fused_moment_sums_windowed_reference(pts, X, bounds, anchors, cfg,
                                                          block, window)
    torch.cuda.synchronize()
    ovf, want_ovf = int(ovf), int(want_ovf)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite windowed sums")
    check(bool((got[:, 10:] == 0).all()), f"{name}: columns 10-15 not zero")
    check(bool((got[-1] == 0).all()), f"{name}: sentinel row not zero")
    edges = edge_points(pts, X, cfg)
    check(edges <= EDGE_CAP * pts.shape[0],
          f"{name}: {edges} points within {EDGE_RAD} rad of a bin edge")
    slack = 0 if exact else edges
    check(abs(ovf - want_ovf) <= slack,
          f"{name}: overflow {ovf} vs plain {want_ovf} with {edges} edge points")
    dcount = (got[:, 0] - want[:, 0]).abs()
    check(float(dcount.sum()) <= 2 * slack,
          f"{name}: counts differ by {float(dcount.sum())} with {edges} edge points")
    same = dcount == 0
    err = (got[same, :10] - want[same, :10]).abs()
    tol = ATOL + RTOL * want[same, :10].abs()
    check(bool((err <= tol).all()), f"{name}: features differ by up to {float(err.max())}")
    report.append(
        f"{name}: N={pts.shape[0]} V={cfg.n_voxels} block {block} window {window}, in-window "
        f"members {int(want[:, 0].sum())}, overflow {ovf} (plain {want_ovf}), edge points "
        f"{edges}, count diffs {int(dcount.sum())}, max |err| {float(err.max()):.3e}, "
        f"run-to-run max |diff| {float((got - again).abs().max()):.3e}"
    )
    return float(err.max()), got, ovf


def check_one_launch(what: str, fn, wrapper, kernel: str, report, reps: int = 10,
                     records_required: bool = True) -> None:
    """``fn`` runs ``kernel`` and no other device operation (no memset, no
    copy, no second kernel), at most once a call, with any host
    synchronisation an error (``torch.cuda.set_sync_debug_mode``), and
    ``wrapper``'s launch counter rises by one a call.  The profiler can
    miss a record (:func:`device_profile`), so fewer than one recorded a
    call is reported, not failed; with ``records_required`` False, none
    recorded at all is reported too (the backbone's long launches, of
    which the profiler recorded about one in ten on the H100), and every
    operation it does record must still be ``kernel``."""

    def strict():
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    before = wrapper.launches
    prof = device_profile(strict, reps)
    launched = wrapper.launches - before
    ops = sum(k for _, k in prof.values())
    others = sorted(name for name in prof if kernel not in name)
    check(not others and (0 < ops or not records_required) and ops <= 1
          and launched == reps + 1,
          f"{what}: {ops} device operations a call, others than {kernel}: {others}, "
          f"{launched} launches counted in {reps + 1} calls")
    report.append(f"{what}: only {kernel} on the device ({ops:g} recorded a call), "
                  f"{launched} launches counted in {reps + 1} calls, no host synchronisation")


def filter_input(model, samples1, scan2, X, cfg):
    """The encoder input the DNN filter builds for ``scan2`` aligned by X
    against ``model`` (icet_tpu_torch.filters.dnn_reject_mask, first
    refinement step)."""
    from icet_tpu_torch.filters import _unpack_fill_samples, model_voxel_samples
    from icet_tpu_torch.models.bias_net import pack_voxel_samples
    from icet_tpu_torch.ops.geometry import transform_points
    from icet_tpu_torch.solver import _moment_sums

    aligned = transform_points(scan2, X)
    s2, _ = model_voxel_samples(model, aligned, cfg)
    sums2 = _moment_sums(aligned, torch.zeros_like(X), model.bounds, model.anchors, cfg)
    n2 = torch.clamp(sums2[:, 0].to(torch.int32), 0, cfg.dnn_sample_pts)
    s1, n1 = samples1
    return pack_voxel_samples(_unpack_fill_samples(s1, n1),
                              _unpack_fill_samples(s2, n2)).contiguous()


def encoder_compare(name, net, x, report) -> float:
    """Encoder kernel vs plain on one input; returns the codes' max |error|."""
    from icet_tpu_torch.models.bias_net import apply_bias_net
    from icet_tpu_torch.ops.bias_encoder import bias_encoder_pool, encoder_pool_reference

    w = net.encoder_weights()
    tiles = {t: bias_encoder_pool(x, w, tile=t) for t in (8, 16, 32)}
    want = encoder_pool_reference(x, w)
    out = apply_bias_net(net, x)
    torch.cuda.synchronize()
    got = tiles[16]
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite encoder codes")
    for t in (8, 32):
        check(torch.equal(tiles[t], got), f"{name}: tile {t} codes differ from tile 16")
    close = float(((got - want).abs() <= CODE_RTOL * want.abs()).float().mean())
    check(close >= CODE_SHARE, f"{name}: only {close:.5f} of codes within one bf16 ulp")
    heads = net.head_weights()
    g = want
    for hw, hb in heads[:-1]:
        g = torch.relu(g @ hw + hb)
    out_want = g @ heads[-1][0] + heads[-1][1]
    out_err = float((out - out_want).abs().max())
    check(out_err <= OUT_ATOL, f"{name}: outputs differ by {out_err}")
    err = float((got - want).abs().max())
    report.append(f"{name} {tuple(x.shape)}: codes within one bf16 ulp {close:.5f}, "
                  f"codes max |err| {err:.3e}, outputs max |err| {out_err:.3e}, "
                  f"tiles 8/16/32 bitwise equal")
    return err


def scatter_inputs(pts, X, bounds, anchors, cfg):
    """(vid int32, feats (N, 16)) as ``moment_method="pallas"`` builds them."""
    from icet_tpu_torch.ops.clustering import membership
    from icet_tpu_torch.ops.geometry import cart_to_spherical, point_norm, transform_points
    from icet_tpu_torch.ops.grid import voxel_ids
    from icet_tpu_torch.ops.moments import _point_features

    raw_ok = point_norm(pts) >= cfg.min_range
    p2 = transform_points(pts, X)
    rtp = cart_to_spherical(p2)
    vid = voxel_ids(rtp, cfg)
    member = membership(vid, rtp[..., 0], raw_ok, bounds, cfg.n_voxels)
    vid = torch.where(member, vid, cfg.n_voxels).to(torch.int32)
    feats = _point_features(p2 - anchors[vid.long()], member).contiguous()
    return vid, feats


def scatter_compare(name, vid, feats, n_voxels, report) -> float:
    """Moment scatter kernel vs plain on one input, twice (the run-to-run
    difference); counts exact.  Returns the max |error|."""
    from icet_tpu_torch.ops.moment_scatter import moment_scatter_reference, moment_scatter_sums

    got = moment_scatter_sums(vid, feats, n_voxels)
    again = moment_scatter_sums(vid, feats, n_voxels)
    want = moment_scatter_reference(vid, feats, n_voxels)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite scatter sums")
    check(torch.equal(got[:, 0], want[:, 0]), f"{name}: scatter counts differ")
    err = (got - want).abs()
    check(bool((err <= ATOL + RTOL * want.abs()).all()),
          f"{name}: scatter sums differ by up to {float(err.max())}")
    report.append(f"{name}: N={vid.shape[0]} V={n_voxels}, count {int(want[:, 0].sum())}, "
                  f"counts exact, max |err| {float(err.max()):.3e}, run-to-run max |diff| "
                  f"{float((got - again).abs().max()):.3e}")
    return float(err.max())


def scatter_edge_cases(vid, feats, n_voxels, rng):
    """Phase 3c's edge inputs from the drive's (vid, feats): {name: (vid,
    feats)}.  Where every row lands in one row, the features are dyadic
    (multiples of 1/16 below 4, a count column of ones), so every sum is
    exact in float32 whatever the order of addition."""
    n, dev = vid.shape[0], vid.device
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    dyadic = torch.from_numpy(rng.integers(-63, 64, size=(n, 16)) / 16.0).float().to(dev)
    dyadic[:, 0] = 1.0
    bad = vid.clone()
    rows = torch.from_numpy(rng.permutation(n)[:5 * 1000]).to(dev).reshape(5, 1000)
    v_pad = -(-(n_voxels + 1) // 128) * 128
    for k, v in enumerate((-1, n_voxels + 1, v_pad + 5, 2**31 - 1, -2**31)):
        bad[rows[k]] = v
    single = int(torch.nonzero(feats[:, 0])[0])
    return {
        "shuffled ids": (vid[perm].contiguous(), feats[perm].contiguous()),
        "one voxel, N=65536": (torch.full_like(vid, 37), dyadic),
        "all on the sentinel": (torch.full_like(vid, n_voxels), dyadic),
        "N=1": (vid[single:single + 1].contiguous(), feats[single:single + 1].contiguous()),
        "N=65537": (torch.cat([vid, vid[single:single + 1]]).contiguous(),
                    torch.cat([feats, feats[single:single + 1]]).contiguous()),
        "out-of-range ids": (bad, feats),
    }


def ptxas_usage(logs: dict) -> dict:
    """Each kernel's registers, shared memory and spills from the build's
    ``-Xptxas -v`` logs: ``{kernel: "N registers, ..."}``."""
    out = {}
    for log in logs.values():
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and kernel:
                out[kernel] = f"spill stores {m.group(2)} B, spill loads {m.group(3)} B"
            m = re.search(r"Used (\d+) registers(.*)", line)
            if m and kernel:
                out[kernel] = f"{m.group(1)} registers{m.group(2)}; " + out.get(kernel, "")
    return out


def one_voxel_case(cfg, dev, n, rng):
    """``n`` points in one voxel (a 0.5 m cube at 20 m range, on a 1/16 m
    lattice) with bounds that admit every range and that voxel's anchor at
    the cube's centre: at X = 0 every offset, square and product is a short
    dyadic number and every sum of them is exact in float32, so kernel and
    plain version agree whatever their order of addition."""
    it, ip = 10, 12
    theta = (it + 0.5) * 2 * np.pi / cfg.n_theta
    phi = cfg.phi_min + (ip + 0.5) * (cfg.phi_max - cfg.phi_min) / cfg.n_phi
    c = np.round(20.0 * np.array([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                                  np.cos(phi)]) * 16) / 16
    pts = (c + rng.integers(-4, 5, size=(n, 3)) / 16.0).astype(np.float32)
    bounds = torch.zeros((cfg.n_voxels + 1, 2), device=dev)
    bounds[:, 1] = 1000.0
    anchors = torch.zeros((cfg.n_voxels + 1, 3), device=dev)
    anchors[ip * cfg.n_theta + it] = torch.from_numpy(c.astype(np.float32)).to(dev)
    return torch.from_numpy(pts).to(dev), types.SimpleNamespace(bounds=bounds, anchors=anchors)


def rel_states(a, b) -> np.ndarray:
    """States of ``T(a_k)^-1 T(b_k)`` for stacked (N, 6) states, float64."""
    from icet_tpu_torch.keyframe import np_pose_matrix, np_pose_to_state

    return np.stack([np_pose_to_state(np.linalg.inv(np_pose_matrix(x)) @ np_pose_matrix(y))
                     for x, y in zip(a, b)])


def ring_graph(K: int):
    """tests/test_pose_graph.py:162-220's graph: 10 laps of a 50 m circle in
    K poses, odometry factors with 2 cm / 0.002 rad noise (numpy seed 3) and
    a loop factor every 100 poses to the next lap.  Returns (initial states
    chained from the odometry, PoseGraph on the CPU, true states relative
    to pose 0)."""
    from icet_tpu_torch.keyframe import np_pose_matrix, np_pose_to_state
    from icet_tpu_torch.pose_graph import PoseGraph

    a = np.linspace(0, 20 * np.pi, K)
    t = np.stack([50 * np.cos(a), 50 * np.sin(a), np.zeros(K)], axis=1)
    s_true = np.concatenate([t, np.zeros((K, 2)), -a[:, None]], axis=1).astype(np.float32)
    rng = np.random.default_rng(3)
    t_noise, a_noise = 0.02, 0.002
    meas_odo = rel_states(s_true[:-1], s_true[1:])
    meas_odo[:, :3] += rng.normal(0, t_noise, (K - 1, 3))
    meas_odo[:, 3:] += rng.normal(0, a_noise, (K - 1, 3))
    info_odo = np.broadcast_to(np.diag([1 / t_noise**2] * 3 + [1 / a_noise**2] * 3),
                               (K - 1, 6, 6))
    li = np.arange(0, K - 1000, 100)
    meas_loop = rel_states(s_true[li], s_true[li + 1000])
    info_loop = np.broadcast_to(np.diag([1e4] * 3 + [1e6] * 3), (len(li), 6, 6))
    graph = PoseGraph(
        idx_i=torch.from_numpy(np.concatenate([np.arange(K - 1), li]).astype(np.int64)),
        idx_j=torch.from_numpy(np.concatenate([np.arange(1, K), li + 1000]).astype(np.int64)),
        meas=torch.from_numpy(np.concatenate([meas_odo, meas_loop]).astype(np.float32)),
        info=torch.from_numpy(np.concatenate([info_odo, info_loop]).astype(np.float32)),
    )
    T, states0 = np.eye(4), [np.zeros(6)]
    for m in meas_odo:
        T = T @ np_pose_matrix(m)
        states0.append(np_pose_to_state(T))
    rel_true = rel_states(np.broadcast_to(s_true[0], s_true.shape), s_true)
    return np.stack(states0).astype(np.float32), graph, rel_true


def backbone_cases() -> list:
    """Phase 16's synthetic chains, (K, blocks forced to the fallback, offset
    of the inputs in floats): K = 1, 2, 3; the edges of a ring stage and of
    the whole ring of the kernels (``tridiag.CHUNK`` steps a stage,
    ``tridiag.STAGES`` stages); 1,000 poses; fallbacks at k = 1, at two
    consecutive k across a stage edge and at k = K - 1; and inputs one float
    into their buffers, which the kernels' bulk copies cannot take."""
    from icet_tpu_torch.ops.tridiag import CHUNK, STAGES

    ring = CHUNK * STAGES
    edges = [(K, (), 0) for K in (1, 2, 3, CHUNK - 1, CHUNK, CHUNK + 1, ring - 1, ring, ring + 1)]
    return edges + [(3 * CHUNK + 1, (1, CHUNK, CHUNK + 1, 3 * CHUNK), 0),
                    (1000, (1, 500, 501, 999), 0), (3 * CHUNK + 1, (CHUNK,), 1)]


def on_device(x: np.ndarray, dev, offset: int = 0) -> torch.Tensor:
    """``x`` as a contiguous float32 tensor on ``dev`` that starts ``offset``
    floats into its buffer."""
    flat = torch.empty(x.size + offset, dtype=torch.float32, device=dev)
    t = flat[offset:].view(x.shape)
    t.copy_(torch.from_numpy(np.ascontiguousarray(x, np.float32)))
    return t


def backbone_chain(K: int, seed: int, fallback_at=()):
    """A random SPD block chain as tools/check_tridiag_kernel.py builds it:
    diagonal blocks ``A A^T + 20 I``, block 0 with the 1e8 gauge prior,
    super-diagonal blocks of scale 2, and r (K, 6).  Each k in
    ``fallback_at`` gets ``D_k = I`` and ``E_{k-1} = c I`` with ``c^2`` above
    the smallest eigenvalue of ``S_{k-1}`` (1e5 after the prior's block,
    else 100), which makes the Schur complement ``I - c^2 S_{k-1}^{-1}``
    indefinite: the block takes the block-Jacobi fallback."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(K, 6, 6))
    D = (A @ A.transpose(0, 2, 1) + 20 * np.eye(6)).astype(np.float32)
    D[0] += 1e8 * np.eye(6, dtype=np.float32)
    E = (rng.normal(size=(K - 1, 6, 6)) * 2).astype(np.float32)
    for k in fallback_at:
        D[k] = np.eye(6, dtype=np.float32)
        E[k - 1] = (1e5 if k == 1 else 100) * np.eye(6, dtype=np.float32)
    r = rng.normal(size=(K, 6)).astype(np.float32)
    return D, E, r


def block_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| of each block (first axis) over that block's
    largest |want|, maxed over the blocks."""
    if want.numel() == 0:
        return 0.0
    g, w = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    scale = torch.clamp(w.abs().amax(dim=1), min=1e-30)
    return float(((g - w).abs().amax(dim=1) / scale).max())


# ---------------------------------------------------------------------------
# Phases 18-21: sharded, multi-process and elastic registration, recovery
# ---------------------------------------------------------------------------

#: mesh shapes of phase 18 (repeats of the one card); phase 19 runs (1, 2)
#: and (2, 1) as processes and (1, 1) as one NCCL process
SHARD_SHAPES = [(1, 1), (1, 2), (2, 1), (1, 4), (2, 2)]
#: pairs of the drive that phases 18-20 register
SHARD_PAIRS = 4
#: the JAX package's sharding tolerances (tests/test_parallel.py:56-75)
SHARD_X_ATOL, SHARD_STD_RTOL, SHARD_STD_ATOL, SHARD_FLIPS = 5e-4, 0.05, 1e-5, 5
#: a spawned process's limit (start, CUDA and group set-up, two passes)
WORKER_TIMEOUT_S = 150
#: phase 19's cases: (name, processes, sp, backend, mesh shape)
PROCESS_CASES = [("gloo_1x2", 2, 2, "gloo", (1, 2)), ("gloo_2x1", 2, 1, "gloo", (2, 1)),
                 ("nccl_1x1", 1, 1, "nccl", (1, 1))]
#: the frame whose step raises in phase 21 (the step's 3rd call)
FAIL_AT = 3
#: phase 21: a recovered run may differ from a clean one by this many
#: times two clean runs' largest |dX| (kernel #1's float atomics vary
#: between runs), and by at least this floor (m)
RECOVERY_SPREAD, RECOVERY_FLOOR_M = 10.0, 1e-5
#: phase 21, keyframe runner: after the re-seed the frames solve against
#: another keyframe than the clean run's; their steps may differ by this (m)
KF_DELTA_ATOL_M = 0.01


def shard_gate(what: str, X, stds, mask, ref, cut=slice(None)) -> float:
    """Hold one pair's sharded result (numpy) against the unsharded one
    (``mask`` covers the points ``cut``); returns max |dX|."""
    rX, rs, rm = (t.cpu().numpy() for t in (ref.X, ref.pred_stds, ref.static_mask[cut]))
    dX = float(np.abs(X - rX).max())
    check(dX <= SHARD_X_ATOL, f"{what}: X differs by {dX:.3e} from the unsharded solve")
    bad = np.abs(stds - rs) > SHARD_STD_ATOL + SHARD_STD_RTOL * np.abs(rs)
    check(not bad.any(), f"{what}: pred_stds {stds} vs unsharded {rs}")
    flips = int((mask != rm).sum())
    check(flips <= SHARD_FLIPS, f"{what}: {flips} static-mask flips")
    return dX


def wall_ms(fn, rounds: int = 3) -> float:
    """Median host-clock ms of ``fn`` (ended by a synchronise) over
    ``rounds``, after one untimed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_sharded(s1, s2, x0s, cfg, dev, card):
    """Phase 18: the in-process mesh on repeats of the one card."""
    from icet_tpu_torch.ops.clustering import (
        distributed_radial_cluster_bounds,
        radial_cluster_bounds,
    )
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums
    from icet_tpu_torch.ops.geometry import cart_to_spherical
    from icet_tpu_torch.ops.grid import voxel_ids
    from icet_tpu_torch.parallel.sharding import (
        DeviceAxis,
        make_sharded_register,
        registration_mesh,
        shard_scan_batch,
    )
    from icet_tpu_torch.solver import register_pair

    B = s1.shape[0]
    ref = [register_pair(s1[b], s2[b], x0s[b], cfg, device=dev) for b in range(B)]
    ref_ms = wall_ms(lambda: [register_pair(s1[b], s2[b], x0s[b], cfg, device=dev)
                              for b in range(B)], rounds=5) / B
    results = {}
    for dp, sp in SHARD_SHAPES:
        mesh = registration_mesh(dp, sp, [dev] * (dp * sp))
        step = make_sharded_register(cfg, mesh)
        batch = shard_scan_batch(s1, s2, x0s, mesh)
        torch.cuda.synchronize()
        fused_moment_sums.launches = 0
        res = step(*batch)
        torch.cuda.synchronize()
        launches = fused_moment_sums.launches
        iters = res.iterations.tolist()
        want = sp * sum(1 + it for it in iters)
        check(launches == want, f"sharded ({dp}, {sp}): fused launches {launches} != sp x "
              f"(prepares + iterations) = {want}")
        host = {k: getattr(res, k).cpu().numpy() for k in ("X", "pred_stds", "static_mask")}
        dX = max(shard_gate(f"sharded ({dp}, {sp}) pair {b}", host["X"][b], host["pred_stds"][b],
                            host["static_mask"][b], ref[b]) for b in range(B))
        ms = wall_ms(lambda: step(*batch), rounds=5) / B
        results[(dp, sp)] = dict(host, iterations=iters, ms=ms)
        print(f"sharded register ({dp}, {sp}) on {dp * sp} x {dev}: {ms:.2f} ms a pair ({card}), "
              f"iterations {iters}, fused launches {launches} = {sp} x {sum(1 + it for it in iters)}, "
              f"max |dX| vs unsharded {dX:.3e}")
    print(f"unsharded register_pair: {ref_ms:.2f} ms a pair ({card}), iterations "
          f"{[r.iterations for r in ref]}")

    # The distributed clustering on the card: the first scan on 2 and 4
    # shards.  Its points crowd the middle beam rows, whose voxel ids one or
    # two shards own, so most cases overflow their buckets and take the
    # gather; shuffled on 2 shards at capacity 2.0 they fit.
    scan = torch.from_numpy(s1[0]).to(dev)
    rtp = cart_to_spherical(scan)
    vid, r = voxel_ids(rtp, cfg), rtp[..., 0]
    ok = r >= cfg.min_range
    perm = torch.from_numpy(np.random.default_rng(1).permutation(r.shape[0])).to(dev)
    args = (cfg.n_voxels, cfg.min_pts, cfg.cluster_gap, cfg.cluster_buffer)
    golden = radial_cluster_bounds(vid, r, ok, *args)
    paths = []
    for order, (v, rr, o) in {"beam-major": (vid, r, ok),
                              "shuffled": (vid[perm], r[perm], ok[perm])}.items():
        for shards in (2, 4):
            for cf in (2.0, 0.02):
                axis = DeviceAxis([dev] * shards)
                n = rr.shape[0] // shards
                cut = [slice(i * n, (i + 1) * n) for i in range(shards)]
                got = distributed_radial_cluster_bounds(
                    [v[c] for c in cut], [rr[c] for c in cut], [o[c] for c in cut], *args, axis,
                    capacity_factor=cf)
                check(torch.equal(got.bounds, golden.bounds)
                      and torch.equal(got.found, golden.found),
                      f"distributed clustering ({order}, {shards} shards, capacity {cf}) is not "
                      "bit-identical")
                path = "sharded" if axis.collectives == 3 else "gather"
                paths.append(f"{order} {shards}x {cf}: {path}")
    check(any(p.endswith("sharded") for p in paths), "the sharded clustering path was not taken")
    print(f"distributed clustering bit-identical to the replicated one ({'; '.join(paths)})")
    return ref, results


def phase_sharded_blockmap(scans, cfg, kf_cfg, bm_cfg, dev) -> None:
    """Phase 18's block map: the keyframe drive with the map's block axis
    over two repeats of the card, against the unsharded map."""
    from icet_tpu_torch.keyframe import KeyframeOdometry, shard_blockmap, whole_table
    from icet_tpu_torch.parallel.sharding import registration_mesh

    plain = KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev)
    sharded = KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev)
    sharded.blockmap = shard_blockmap(sharded.blockmap, registration_mesh(2, 1, [dev] * 2))
    a, b = plain.run(scans), sharded.run(scans)
    check(plain.keyframe_indices == sharded.keyframe_indices,
          f"sharded block map: keyframes {sharded.keyframe_indices} vs {plain.keyframe_indices}")
    dT = max(float(np.abs(f.T_world - g.T_world).max()) for f, g in zip(a, b))
    check(dT <= 1e-4, f"sharded block map: poses differ by {dT:.3e}")
    pts = [whole_table(bm.points)[whole_table(bm.valid)] for bm in (plain.blockmap,
                                                                  sharded.blockmap)]
    check(pts[0].shape == pts[1].shape, f"sharded block map: {pts[1].shape[0]} points, "
          f"unsharded {pts[0].shape[0]}")
    dP = float((pts[0] - pts[1].to(pts[0].device)).abs().max())
    check(dP <= 1e-3, f"sharded block map: points differ by {dP:.3e}")
    print(f"sharded block map over 2 x {dev}: {len(b)} keyframe frames, keyframes "
          f"{sharded.keyframe_indices}, {pts[1].shape[0]} points; max |dT| {dT:.3e}, max |dp| "
          f"{dP:.3e} vs the unsharded map")


def trace_worker(spec: dict) -> int:
    """A spawned process of phase 25: ``TRACE_LAUNCHES`` launches of kernel
    #1 on the saved inputs inside ``utils.profiling.trace``; writes the
    Chrome trace's kernel event names to ``spec["out"]``."""
    sys.path.insert(0, ROOT)
    from icet_tpu_torch.config import ICETConfig
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums
    from icet_tpu_torch.utils.profiling import trace

    cfg = ICETConfig(**spec["cfg"])
    with np.load(spec["data"]) as z:
        pts, X, bounds, anchors = (torch.from_numpy(z[k]).cuda()
                                   for k in ("pts", "X", "bounds", "anchors"))
    fused_moment_sums(pts, X, bounds, anchors, cfg)  # build and load outside the trace
    torch.cuda.synchronize()
    with trace(spec["dir"]) as path:
        for _ in range(TRACE_LAUNCHES):
            fused_moment_sums(pts, X, bounds, anchors, cfg)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    with open(spec["out"], "w") as f:
        json.dump({"kernels": kernels, "events": len(events),
                   "bytes": os.path.getsize(path)}, f)
    return 0


def worker(spec: dict) -> int:
    """A spawned process of phase 19 (one rank of a process-group mesh) or,
    with ``kind`` "trace", of phase 25."""
    if spec.get("kind") == "trace":
        return trace_worker(spec)
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from icet_tpu_torch.config import ICETConfig
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums
    from icet_tpu_torch.parallel.distributed import (
        global_registration_mesh,
        init_distributed,
        run_distributed_registration,
    )

    init_distributed(num_processes=spec["world"], process_id=spec["rank"],
                     init_method=f"file://{spec['store']}", backend=spec["backend"],
                     device=spec["device"], timeout_s=WORKER_TIMEOUT_S)
    cfg = ICETConfig(**spec["cfg"])
    mesh = global_registration_mesh(sp=spec["sp"])
    data = np.load(spec["data"])
    b_local = data["s1"].shape[0] // mesh.shape["dp"]
    rows = slice(mesh.row * b_local, (mesh.row + 1) * b_local)
    args = (data["s1"][rows], data["s2"][rows], data["x0"][rows], cfg, mesh)
    run_distributed_registration(*args)  # first pass: group and kernel set-up
    torch.cuda.synchronize()
    dist.barrier()
    axis = mesh.axis("sp")
    c0, b0 = axis.collectives, axis.bytes
    fused_moment_sums.launches = 0
    res, local = run_distributed_registration(*args)
    torch.cuda.synchronize()
    launches, collectives, nbytes = fused_moment_sums.launches, axis.collectives, axis.bytes
    times = []
    for _ in range(3):
        dist.barrier()
        t0 = time.perf_counter()
        run_distributed_registration(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / b_local)
    np.savez(spec["out"], X=res.X.cpu().numpy(), pred_stds=res.pred_stds.cpu().numpy(),
             static_mask=res.static_mask.cpu().numpy(), iterations=res.iterations.numpy(),
             start=local.start, row=mesh.row, col=mesh.col, ms=float(np.median(times)),
             launches=launches, collectives=collectives - c0, bytes=nbytes - b0)
    dist.destroy_process_group()
    return 0


def spawn_case(tmp: str, name: str, world: int, sp: int, backend: str, cfg, dev) -> list:
    """Run one phase-19 case as ``world`` processes; each is joined with a
    timeout and killed after it.  Returns each rank's results."""
    import dataclasses

    procs = []
    for rank in range(world):
        spec = dict(rank=rank, world=world, sp=sp, backend=backend, cfg=dataclasses.asdict(cfg),
                    device=str(dev),
                    store=os.path.join(tmp, f"{name}.store"), data=os.path.join(tmp, "pairs.npz"),
                    out=os.path.join(tmp, f"{name}.{rank}.npz"))
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker",
                                        json.dumps(spec)], cwd=ROOT, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), spec))
    outs = []
    try:
        for p, _ in procs:
            try:
                outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                outs.append(None)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    got = []
    for (p, spec), out in zip(procs, outs):
        check(out is not None, f"{name}: rank {spec['rank']} did not end in {WORKER_TIMEOUT_S} s")
        check(p.returncode == 0, f"{name}: rank {spec['rank']} failed:\n{(out or '')[-3000:]}")
        with np.load(spec["out"]) as z:
            got.append({k: z[k] for k in z.files})
    return got


def phase_processes(s1, s2, x0s, cfg, dev, ref, sharded, card):
    """Phase 19: ``run_distributed_registration`` as processes on the card."""
    import tempfile

    n = s1.shape[1]
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "pairs.npz"), s1=s1, s2=s2, x0=x0s)
        for name, world, sp, backend, shape in PROCESS_CASES:
            t0 = time.perf_counter()
            ranks = spawn_case(tmp, name, world, sp, backend, cfg, dev)
            wall = time.perf_counter() - t0
            same = sharded[shape]
            for g in ranks:
                start, col, nl = int(g["start"]), int(g["col"]), n // sp
                b_local = g["X"].shape[0]
                # One shard a rank: one launch a prepare and an iteration.
                want = sum(1 + int(it) for it in g["iterations"])
                check(int(g["launches"]) == want, f"{name}: rank launches {int(g['launches'])} != "
                      f"prepares + iterations {want}")
                for k in range(b_local):
                    b = start + k
                    shard_gate(f"{name} pair {b}", g["X"][k], g["pred_stds"][k],
                               g["static_mask"][k], ref[b], slice(col * nl, (col + 1) * nl))
                    dX = float(np.abs(g["X"][k] - same["X"][b]).max())
                    check(dX <= SHARD_X_ATOL, f"{name} pair {b}: X differs by {dX:.3e} from "
                          f"phase 18's {shape}")
            rows = {}
            for g in ranks:
                rows.setdefault(int(g["row"]), []).append(g["iterations"].tolist())
            for row, its in rows.items():
                check(all(i == its[0] for i in its), f"{name}: row {row} iterations differ {its}")
            per = [(float(g["ms"]), int(g["collectives"]) / g["X"].shape[0],
                    int(g["bytes"]) / g["X"].shape[0]) for g in ranks]
            print(f"processes {name} (mesh {shape}, {world} process(es) on one card): ms a pair "
                  f"{[round(p[0], 2) for p in per]} ({card}), collectives a pair "
                  f"{[p[1] for p in per]}, bytes a pair {[int(p[2]) for p in per]}, iterations "
                  f"{sorted(rows.items())}, launches a rank {[int(g['launches']) for g in ranks]}, "
                  f"{wall:.1f} s with start-up")


def phase_elastic(s1, s2, x0s, cfg, dev, ref, card):
    """Phase 20: the elastic runner on four repeats of the card."""
    import threading

    import icet_tpu_torch.parallel.elastic as elastic

    runner = elastic.ElasticRegistrationRunner(cfg, prefer_dp=2, devices=[dev] * 4)
    check(runner.shape == (2, 2), f"elastic runner shape {runner.shape}")
    armed = {"step": True, "probe": 0}
    lock = threading.Lock()
    real_step, real_probe = runner._step, elastic.probe_devices

    def failing_step(*args):
        if armed["step"]:
            armed["step"] = False
            raise RuntimeError("simulated device failure")
        return real_step(*args)

    def one_entry_fails(d):
        with lock:
            armed["probe"] += 1
            k = armed["probe"]
        if k == 1:
            raise RuntimeError("simulated probe failure")
        return elastic._default_probe_op(d)

    runner._step = failing_step
    elastic.probe_devices = lambda devs=None, timeout_s=60.0, _op=None: real_probe(
        devs, timeout_s, _op=one_entry_fails)
    try:
        t0 = time.perf_counter()
        res = runner.run(s1, s2, x0s)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        elastic.probe_devices = real_probe
    check(runner.rebuilds == 1 and runner.shape == (1, 3),
          f"elastic: {runner.rebuilds} rebuilds, shape {runner.shape}")
    # The runner padded the points to a multiple of sp = 3 with zeros.
    dX = max(shard_gate(f"elastic pair {b}", res.X[b], res.pred_stds[b],
                        res.static_mask[b][: s1.shape[1]], ref[b]) for b in range(s1.shape[0]))
    release = threading.Event()

    def blocking(d):
        release.wait()
        return True

    t0 = time.perf_counter()
    healthy = elastic.probe_devices([dev] * 4, timeout_s=1.0, _op=blocking)
    blocked_s = time.perf_counter() - t0
    release.set()
    check(healthy == [] and blocked_s < 2.0, f"blocking probe: {healthy} after {blocked_s:.2f} s")
    t0 = time.perf_counter()
    check(len(elastic.probe_devices([dev] * 4)) == 4, "the real probe lost a device")
    probe_ms = (time.perf_counter() - t0) * 1e3
    print(f"elastic: (2, 2) -> (1, 3) after one failed step and one failed probe entry, "
          f"{runner.rebuilds} rebuild, {s1.shape[0]} pairs in {run_s:.2f} s with the rebuild "
          f"({card}), max |dX| vs unsharded {dX:.3e}; blocking probe returned {healthy} in "
          f"{blocked_s:.2f} s (timeout 1 s); a 4-device probe {probe_ms:.2f} ms")


def phase_recovery(scans, gt, cfg, dcfg, kf_cfg, bm_cfg, mcfg, map_cfg, odo, dev, card,
                   earlier: dict):
    """Phase 21: one step of each runner raises at frame FAIL_AT; recovery
    and retry, then a resume from a mid-drive checkpoint.  ``earlier``
    holds clean runs of the same runners from phases 5, 9 and 11."""
    import tempfile

    import icet_tpu_torch.keyframe as kf_mod
    import icet_tpu_torch.mapping as map_mod
    import icet_tpu_torch.odometry as odo_mod
    from icet_tpu_torch import graphs
    from icet_tpu_torch.keyframe import np_pose_matrix
    from icet_tpu_torch.utils.checkpoint import (
        keyframe_state,
        load_checkpoint,
        odometry_state,
        restore_keyframe,
        restore_odometry,
        save_checkpoint,
    )

    def indexed_ate(frames, poses=None) -> float:
        poses = poses or [f.T_world for f in frames]
        ref = [np.linalg.inv(gt[0]) @ gt[f.index] for f in frames]
        err = [np.linalg.norm(np.asarray(T)[:3, 3] - R[:3, 3]) for T, R in zip(poses, ref)]
        return float(np.sqrt(np.mean(np.square(err))))

    def composed(frames):
        T, out = np.eye(4), []
        for f in frames:
            T = T @ np_pose_matrix(f.X)
            out.append(T)
        return out

    runners = {
        "odometry": (lambda: odo_mod.OdometryPipeline(cfg, odo, device=dev), odo_mod,
                     "odometry_step_jit"),
        "dnn_odometry": (lambda: odo_mod.OdometryPipeline(dcfg, odo, device=dev), odo_mod,
                         "odometry_step_dnn_jit"),
        "keyframe": (lambda: kf_mod.KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev), kf_mod,
                     "keyframe_step_jit"),
        "mapmaker": (lambda: map_mod.MapMaker(mcfg, map_cfg, odo, device=dev), map_mod,
                     "map_step_jit"),
    }

    def drive(make, module=None, name=None):
        real = getattr(module, name) if module else None
        calls = {"n": 0}

        def flaky(*args, **kw):
            calls["n"] += 1
            if calls["n"] == FAIL_AT:
                raise RuntimeError("simulated device failure")
            return real(*args, **kw)

        if module:
            setattr(module, name, flaky)
        try:
            runner = make()
            frames = [f for f in (runner.step(s) for s in scans) if f is not None]
        finally:
            if module:
                setattr(module, name, real)
        torch.cuda.synchronize()
        return runner, frames

    def max_dx(a, b) -> float:
        return float(max(np.abs(np.asarray(f.X) - np.asarray(g.X)).max() for f, g in zip(a, b)))

    def maker_ring(maker) -> tuple:
        return tuple(getattr(maker.state, k).data_ptr() for k in ("points", "valid", "trail"))

    clean_runs = {}
    for what, (make, module, name) in runners.items():
        c1 = earlier[what] if what in earlier else drive(make)[1]
        _, c2 = drive(make)
        clean_runs[what] = c1
        spread = max_dx(c1, c2)
        bound_m = max(RECOVERY_SPREAD * spread, RECOVERY_FLOOR_M)
        captures = graphs.host_ops["captures"]
        ring_before, make_run = [], make
        if what == "mapmaker":
            def make_run(make=make):
                runner = make()
                ring_before.append(maker_ring(runner))
                return runner
        runner, frames = drive(make_run, module, name)
        check(runner.recoveries == 1, f"{what}: {runner.recoveries} recoveries")
        captures = graphs.host_ops["captures"] - captures
        if what != "mapmaker":
            # The failure reached the compiled step; recovery dropped the
            # graphs, and the retried frame captured them anew.
            check(captures > 0, f"{what}: no graph captured after the recovery")
            print(f"recovery {what}: {captures} graphs captured anew after the recovery")
        else:
            # The failure reached the compiled step; recovery restored the
            # snapshot into the runner's own ring, so the retried frame
            # replays the graphs captured before it.
            check(maker_ring(runner) == ring_before[0],
                  "mapmaker: recovery replaced the ring's tensors")
            print(f"recovery mapmaker: the ring kept its tensors; {captures} graphs captured "
                  f"in the whole drive (its ring's two map graphs at most)")
        if what == "keyframe":
            # The retried frame re-seeds a keyframe (it returns no frame);
            # the frames after it solve against that keyframe.
            check(len(frames) == len(c1) - 1, f"{what}: {len(frames)} frames")
            before = frames[: FAIL_AT - 1]
            check(max_dx(before, c1) <= bound_m, f"{what}: frames before the failure moved")
            after = {f.index: f for f in frames[FAIL_AT - 1:]}
            d_after = max(float(np.abs(after[f.index].X - f.X).max()) for f in c1
                          if f.index in after)
            check(d_after <= KF_DELTA_ATOL_M, f"{what}: steps after the re-seed differ by "
                  f"{d_after:.3e} m from the clean run's")
            dx, ate, ate_clean = d_after, indexed_ate(frames), indexed_ate(c1)
        else:
            check(len(frames) == len(c1), f"{what}: {len(frames)} frames, clean {len(c1)}")
            dx = max_dx(frames, c1)
            check(dx <= bound_m, f"{what}: recovered run differs by {dx:.3e} m, bound "
                  f"{bound_m:.3e} m (two clean runs: {spread:.3e} m)")
            poses = composed(frames) if what == "mapmaker" else None
            ate = indexed_ate(frames, poses)
            ate_clean = indexed_ate(c1, composed(c1) if what == "mapmaker" else None)
        recoveries = runner.recoveries
        rec_ms = wall_ms(runner._recover)
        plain = eager(make())
        for s in scans[:3]:
            plain.step(s)
        eager_ms = f"; eager route {wall_ms(plain._recover):.2f} ms"
        print(f"recovery {what}: recoveries {recoveries}, {len(frames)} frames, "
              f"max |dX| vs clean {dx:.3e} m (two clean runs {spread:.3e} m, bound "
              f"{bound_m:.3e} m), ATE {ate * 100:.4f} cm (clean {ate_clean * 100:.4f} cm), "
              f"{rec_ms:.2f} ms a recovery{eager_ms} ({card})")

    # Resume from a mid-drive checkpoint, on the checkpointed frame itself
    # (its re-seed advances the frame index by one, as in the JAX package).
    mid = len(scans) // 2
    with tempfile.TemporaryDirectory() as tmp:
        pipe = odo_mod.OdometryPipeline(cfg, odo, device=dev)
        for s in scans[: mid + 1]:
            pipe.step(s)
        save_checkpoint(os.path.join(tmp, "odo"), odometry_state(pipe))
        resumed = odo_mod.OdometryPipeline(cfg, odo, device=dev)
        restore_odometry(resumed, load_checkpoint(os.path.join(tmp, "odo")))
        frames = [f for f in (resumed.step(s) for s in scans[mid:]) if f is not None]
        clean = clean_runs["odometry"][mid:]
        check([f.index - 1 for f in frames] == [f.index for f in clean], "odometry resume: indices")
        d_odo = max_dx(frames, clean)
        t_odo = max(float(np.abs(f.T_world - g.T_world).max()) for f, g in zip(frames, clean))
        check(d_odo <= 1e-4 and t_odo <= 1e-3, f"odometry resume: X {d_odo:.3e}, T {t_odo:.3e}")
        ko = kf_mod.KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev)
        for s in scans[: mid + 1]:
            ko.step(s)
        save_checkpoint(os.path.join(tmp, "kf"), keyframe_state(ko))
        kr = kf_mod.KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev)
        restore_keyframe(kr, load_checkpoint(os.path.join(tmp, "kf")), replay_overlap=True)
        kframes = [f for f in (kr.step(s) for s in scans[mid:]) if f is not None]
        kclean = {f.index: f for f in clean_runs["keyframe"]}
        d_kf = max(float(np.abs(f.X - kclean[f.index - 1].X).max()) for f in kframes)
        check(len(kframes) == len(scans) - mid - 1 and d_kf <= KF_DELTA_ATOL_M,
              f"keyframe resume: {len(kframes)} frames, steps differ by {d_kf:.3e} m")
    print(f"resume at frame {mid}: {len(frames)} odometry frames within {d_odo:.3e} m (X) and "
          f"{t_odo:.3e} (T_world) of the clean run; {len(kframes)} keyframe steps within "
          f"{d_kf:.3e} m")


# ---------------------------------------------------------------------------
# Phases 22-25: the user entry points, replay and prefetch, the leftovers
# ---------------------------------------------------------------------------

#: phase 22's sequence: make_kitti_sequence's arguments, the 24-frame city
#: drive at 64x2048 (131,072 rays a sweep, an HDL-64E's ~0.18 deg azimuth
#: step) with a non-identity calib.txt (tools/kitti_eval_ate_cpu.py FIXTURE)
KITTI_FIXTURE = ["--frames", "24", "--speed", "1.0", "--beams", "64", "--azimuth", "2048",
                 "--calib"]
#: the JAX package's eval_kitti ATE on that sequence on the CPU, in cm as
#: its summary rounds them (tools/kitti_eval_ate_cpu.py); the card's runs
#: may be 0.5 cm worse at most
KITTI_ATE_REF_CM = {"plain": 5.1, "keyframe": 0.93, "dnn": 5.49}
#: phase 23: scans of the replay directory
REPLAY_FRAMES = 8
#: phase 24's short drive (no loop candidates at this length)
CD_SHORT = ["--frames", "16", "--beams", "64", "--azimuth", "1024"]
#: phase 24: a resumed or chained run's positions against the stepped
#: run's (phase 21's T_world bound, m)
RESUME_T_ATOL_M = 1e-3
#: phase 25: X of the onehot registration against the CPU path and the
#: fused route (tests/test_torch_solver.py's early-exit tolerance)
ONEHOT_X_ATOL = 1e-4
#: phase 25: device_time_ms of kernel #1 against phase 13's CUDA events,
#: each taken this many times in alternating turns (their medians compared)
DEVICE_TIME_RTOL, DEVICE_TIME_TURNS = 0.25, 5
#: phase 25: launches of kernel #1 inside trace()
TRACE_LAUNCHES = 50


def tum_positions(path: str) -> np.ndarray:
    rows = np.loadtxt(path)
    check(rows.ndim == 2 and rows.shape[1] == 8 and bool(np.isfinite(rows).all()),
          f"{path}: not a finite TUM trajectory")
    return rows[:, 1:4]


def phase_kitti(tmp: str, dev, card) -> dict:
    """Phase 22: ``eval_kitti.run`` at KITTI scale on the card, plain (with
    --out), --keyframe, --dnn, and --refine --strict-real; launches of
    kernels #1, #4 and the backbone counted, ATE gated."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.config import ICETConfig
    from icet_tpu_torch.datasets.kitti import load_calib_tr
    from icet_tpu_torch.examples import eval_kitti, make_kitti_sequence
    from icet_tpu_torch.ops.bias_encoder import bias_encoder_pool
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums
    from icet_tpu_torch.ops.tridiag import tridiag_apply, tridiag_factor

    t0 = time.perf_counter()
    seq = make_kitti_sequence.run(make_kitti_sequence.build_parser().parse_args(
        ["--out", os.path.join(tmp, "seq"), *KITTI_FIXTURE]))["dir"]
    data_s = time.perf_counter() - t0
    tr = load_calib_tr(os.path.join(seq, "calib.txt"))
    check(tr is not None and not np.allclose(tr, np.eye(4)), "calib.txt Tr is the identity")
    n_scans = int(KITTI_FIXTURE[1])
    base = ["--sequence", seq, "--poses", os.path.join(seq, "poses.txt"), "--clamp", "2.5",
            "--device", dev.type, "--prefetch", "on"]
    out_prefix = os.path.join(tmp, "kitti")

    def run(extra):
        torch.cuda.synchronize()
        fused_moment_sums.launches = bias_encoder_pool.launches = 0
        tridiag_factor.launches = tridiag_apply.launches = 0
        zero_warmups()
        replays = graphs.host_ops["replays"]
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        s = eval_kitti.run(eval_kitti.build_parser().parse_args(base + extra))
        ev1.record()
        torch.cuda.synchronize()
        launches = dict(fused=fused_moment_sums.launches, encoder=bias_encoder_pool.launches,
                        factor=tridiag_factor.launches, apply=tridiag_apply.launches,
                        warmups=warmups(), encoder_warmups=warmups("bias_encoder_pool"),
                        factor_warmups=warmups("tridiag_factor"),
                        apply_warmups=warmups("tridiag_apply"),
                        replays=graphs.host_ops["replays"] - replays)
        check(s["frames"] == n_scans - 1, f"eval_kitti {extra}: {s['frames']} frames")
        check(s["divergences"] == 0, f"eval_kitti {extra}: {s['divergences']} divergences")
        return s, launches, ev0.elapsed_time(ev1) / s["frames"]

    runs = {}
    dcfg = ICETConfig(dnn_filter=True)
    n_post = dcfg.n_iters - max(min(dcfg.dnn_start_iter, dcfg.n_iters - 1), 1)
    for mode, extra in (("plain", ["--out", out_prefix]), ("keyframe", ["--keyframe"]),
                        ("dnn", ["--dnn"]), ("refine", ["--refine", "--strict-real"])):
        s, lc, ms = run(extra)
        runs[mode] = (s, lc, ms)
        n = s["frames"]
        if mode == "keyframe":
            want = s["iterations"] + len(s["keyframes"]) + lc["warmups"]
            what = (f"{s['iterations']} iterations + {len(s['keyframes'])} keyframe prepares + "
                    f"{lc['warmups']} warm-ups before capture")
        elif mode == "dnn":
            want = s["iterations"] + n * n_post + n_scans + lc["warmups"]
            what = (f"{s['iterations']} iterations + {n * n_post} filter passes + {n_scans} "
                    f"prepares + {lc['warmups']} warm-ups before capture")
            want_enc = n * n_post * dcfg.dnn_refine_steps + lc["encoder_warmups"]
            check(lc["encoder"] == want_enc,
                  f"eval_kitti --dnn: encoder launches {lc['encoder']} != "
                  f"{n * n_post * dcfg.dnn_refine_steps} filtered iterations + "
                  f"{lc['encoder_warmups']} warm-ups")
        else:
            # --refine: 24 frames hold no loop candidate 100 frames apart,
            # so close_loops registers nothing
            check(s.get("loop_candidates", 0) == 0, f"eval_kitti {mode}: loop candidates")
            want = s["iterations"] + n_scans + lc["warmups"]
            what = (f"{s['iterations']} iterations + {n_scans} prepares + {lc['warmups']} "
                    "warm-ups before capture")
        check(lc["fused"] == want, f"eval_kitti {mode}: fused launches {lc['fused']} != {what}")
        # every mode steps through the compiled pipelines
        check(lc["replays"] > 0, f"eval_kitti {mode}: {lc['replays']} graph replays")
        if mode in KITTI_ATE_REF_CM:
            ref = KITTI_ATE_REF_CM[mode]
            check(s["ate_odometry_cm"] <= ref + ATE_SLACK_M * 100,
                  f"eval_kitti {mode}: ATE {s['ate_odometry_cm']} cm above {ref} + "
                  f"{ATE_SLACK_M * 100} cm")
        print(f"eval_kitti {mode} at 64x2048 (N = 131,072, sequence written in {data_s:.1f} "
              f"s): {n} frames, ATE {s['ate_odometry_cm']} cm (JAX package on the CPU: "
              f"{KITTI_ATE_REF_CM.get(mode, 'n/a')} cm), RPE {s['rpe_t_cm']} cm / "
              f"{s['rpe_r_deg']} deg, {s['iterations']} iterations, launches {lc} ({what}), "
              f"{ms:.3f} ms a frame by CUDA events ({card})"
              + (f", keyframes {s['keyframes']}" if mode == "keyframe" else ""))
    # The eager route of the modes this PR put on graphs, beside them.
    import icet_tpu_torch.keyframe as kf_mod
    import icet_tpu_torch.odometry as odo_mod

    routes = (odo_mod.compiled_route, kf_mod.compiled_route)
    odo_mod.compiled_route = kf_mod.compiled_route = lambda c: False
    try:
        for mode in ("keyframe", "dnn"):
            s, lc, ms = run([f"--{mode}"])
            check(lc["replays"] == 0, f"eval_kitti --{mode}, eager route: {lc['replays']} replays")
            print(f"eval_kitti {mode} at 64x2048, eager route: ATE {s['ate_odometry_cm']} cm, "
                  f"{s['iterations']} iterations, launches of #1 {lc['fused']}, of #4 "
                  f"{lc['encoder']}, {ms:.3f} ms a frame by CUDA events ({card}; compiled: "
                  f"{runs[mode][2]:.3f})")
    finally:
        odo_mod.compiled_route, kf_mod.compiled_route = routes
    s, lc, _ = runs["refine"]
    # The compiled solve: its graphs' replays, and the warm-ups before its
    # captures beside them.
    tri = (lc["factor"] - lc["factor_warmups"], lc["apply"] - lc["apply_warmups"])
    check(tri == (10, 10 * 51), f"eval_kitti --refine: factor/apply launches "
          f"{(lc['factor'], lc['apply'])} less warm-ups {(lc['factor_warmups'], lc['apply_warmups'])}")
    check(np.isfinite(s["ate_refined_cm"]), "eval_kitti --refine: refined ATE not finite")
    print(f"eval_kitti --refine --strict-real: {s['loop_factors']} loop factors, refined ATE "
          f"{s['ate_refined_cm']} cm (odometry {s['ate_odometry_cm']} cm), factor/apply "
          f"launches {(lc['factor'], lc['apply'])} = {tri} + warm-ups "
          f"{(lc['factor_warmups'], lc['apply_warmups'])}")
    # The TUM files read back: the odometry trajectory scores the same ATE.
    est, gt_pos = tum_positions(out_prefix + ".odo.tum"), tum_positions(out_prefix + ".gt.tum")
    check(est.shape == gt_pos.shape == (n_scans, 3), f"TUM files hold {est.shape} poses")
    ate_tum = float(np.sqrt(np.mean(np.sum((est - gt_pos) ** 2, axis=1)))) * 100
    plain = runs["plain"][0]
    check(abs(ate_tum - plain["ate_odometry_cm"]) <= 0.01,
          f"TUM files score {ate_tum:.4f} cm, the run {plain['ate_odometry_cm']} cm")
    stages = {k: {m: round(v[m], 3) for m in ("n", "mean_ms", "p50_ms", "p95_ms")}
              for k, v in {**plain["stages"], "refine": s["stages"]["refine"]}.items()}
    print(f"eval_kitti StageTimer ({card}): {json.dumps(stages)}")
    return {"seq": seq, "map_html": out_prefix + ".map.html", "runs": runs}


def phase_replay(seq: str, dev, card) -> None:
    """Phase 23: the first REPLAY_FRAMES scans of phase 22's sequence as
    .bin and .npy; the native queue and the prefetched KITTI source bit
    for bit against the numpy readers; eval_odometry through ReplaySource."""
    import shutil
    import tempfile

    from icet_tpu_torch.datasets.kitti import KittiOdometrySource, load_poses
    from icet_tpu_torch.datasets.loaders import load_kitti_bin, load_npy
    from icet_tpu_torch.examples import eval_odometry
    from icet_tpu_torch.native import NativeReplaySource
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums

    vel = os.path.join(seq, "velodyne")
    bins = sorted(os.listdir(vel))[:REPLAY_FRAMES]
    with tempfile.TemporaryDirectory() as tmp:
        bdir, ndir = os.path.join(tmp, "bin"), os.path.join(tmp, "npy")
        os.makedirs(bdir)
        os.makedirs(ndir)
        for b in bins:
            shutil.copy(os.path.join(vel, b), bdir)
            raw = np.fromfile(os.path.join(vel, b), np.float32).reshape(-1, 4)[:, :3]
            np.save(os.path.join(ndir, b.replace(".bin", ".npy")), raw)
        t0 = time.perf_counter()
        nat_bin = list(NativeReplaySource(bdir, max_points=131072))
        nat_npy = list(NativeReplaySource(ndir, max_points=131072))
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        np_bin = [load_kitti_bin(os.path.join(bdir, b), 131072) for b in bins]
        np_npy = [load_npy(os.path.join(ndir, b.replace(".bin", ".npy")), 131072) for b in bins]
        np_s = time.perf_counter() - t0
        check(len(nat_bin) == len(nat_npy) == REPLAY_FRAMES, "native replay: frame count")
        for a, b in zip(nat_bin + nat_npy, np_bin + np_npy):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  "native replay: a scan differs from the numpy reader's")
        kw = dict(poses_file=os.path.join(seq, "poses.txt"), end=REPLAY_FRAMES)
        pre = list(KittiOdometrySource(seq, prefetch=True, **kw))
        plain = list(KittiOdometrySource(seq, prefetch=False, **kw))
        check(len(pre) == len(plain) == REPLAY_FRAMES, "KITTI source: frame count")
        for (sa, Ta), (sb, Tb) in zip(pre, plain):
            check(np.array_equal(sa, sb) and np.array_equal(Ta, Tb),
                  "KittiOdometrySource(prefetch=True) differs from the numpy reader")
        print(f"replay ({REPLAY_FRAMES} scans of 131,072 points): native queue .bin and .npy "
              f"bit-identical to the numpy readers ({nat_s:.2f} s vs {np_s:.2f} s on the host), "
              f"KittiOdometrySource(prefetch=True) bit-identical to prefetch=False")
        # Velodyne-frame ground truth for eval_odometry (it reads no calib).
        poses = os.path.join(tmp, "poses.txt")
        tr = np.loadtxt(os.path.join(seq, "calib.txt"), usecols=range(1, 13)).reshape(3, 4)
        T_tr = np.eye(4)
        T_tr[:3] = tr
        velo = load_poses(os.path.join(seq, "poses.txt"))[:REPLAY_FRAMES] @ T_tr
        np.savetxt(poses, velo[:, :3, :].reshape(-1, 12), fmt="%.9e")
        torch.cuda.synchronize()
        fused_moment_sums.launches = 0
        zero_warmups()
        s = eval_odometry.run(eval_odometry.build_parser().parse_args(
            ["--scans", ndir, "--poses", poses, "--device", dev.type]))
        torch.cuda.synchronize()
        check(s["frames"] == REPLAY_FRAMES - 1 and s["divergences"] == 0,
              f"eval_odometry: {s}")
        check(fused_moment_sums.launches == s["iterations"] + REPLAY_FRAMES + warmups(),
              f"eval_odometry: fused launches {fused_moment_sums.launches} != "
              f"{s['iterations']} iterations + {REPLAY_FRAMES} prepares + {warmups()} "
              "warm-ups before capture")
        print(f"eval_odometry through ReplaySource: {s['frames']} frames, ATE {s['ate_cm']} cm, "
              f"RPE {s['rpe_t_cm']} cm, fused launches {fused_moment_sums.launches}, mean "
              f"solve {s['mean_solve_ms']} ms ({card})")


def phase_citydrive_entry(tmp: str, dev, card) -> None:
    """Phase 24: eval_citydrive.run on a short drive: stepped, --chained
    and a --state --chunk run stopped and resumed once; the chained and
    resumed trajectories against the stepped one."""
    from icet_tpu_torch.examples import eval_citydrive
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums

    def run(extra):
        torch.cuda.synchronize()
        fused_moment_sums.launches = 0
        zero_warmups()
        t0 = time.perf_counter()
        s = eval_citydrive.run(eval_citydrive.build_parser().parse_args(
            CD_SHORT + ["--device", dev.type] + extra))
        torch.cuda.synchronize()
        return s, fused_moment_sums.launches - warmups(), time.perf_counter() - t0

    n = int(CD_SHORT[1])
    stepped, f_step, t_step = run(["--out", os.path.join(tmp, "cd_step")])
    chained, f_chain, t_chain = run(["--chained", "--out", os.path.join(tmp, "cd_chain")])
    state = os.path.join(tmp, "cd_state", "drive")
    first, _, t_first = run(["--state", state, "--chunk", str(n // 2)])
    check(first.get("chunk_done") and first["next_k"] == n // 2,
          f"eval_citydrive --chunk: {first}")
    resumed, f_res, t_res = run(["--state", state, "--chunk", str(n // 2),
                                 "--out", os.path.join(tmp, "cd_res")])
    for name, s, f in (("stepped", stepped, f_step), ("chained", chained, f_chain)):
        check(s["frames"] == n - 1 and s["divergences"] == 0, f"eval_citydrive {name}: {s}")
        check(f == s["iterations"] + n, f"eval_citydrive {name}: fused launches {f} "
              f"(less the warm-ups before capture) != {s['iterations']} iterations + {n} "
              "prepares")
    check(resumed["frames"] == n - 1, f"eval_citydrive resumed: {resumed}")
    ref = tum_positions(os.path.join(tmp, "cd_step.odo.tum"))
    d_chain = float(np.abs(tum_positions(os.path.join(tmp, "cd_chain.odo.tum")) - ref).max())
    d_res = float(np.abs(tum_positions(os.path.join(tmp, "cd_res.odo.tum")) - ref).max())
    check(d_chain <= RESUME_T_ATOL_M and d_res <= RESUME_T_ATOL_M,
          f"eval_citydrive: chained {d_chain:.3e} m, resumed {d_res:.3e} m from the stepped run")
    print(f"eval_citydrive short drive ({n} frames of 64x1024): stepped ATE "
          f"{stepped['ate_odometry_cm']} cm in {t_step:.1f} s, chained "
          f"{chained['ate_odometry_cm']} cm in {t_chain:.1f} s (max |dp| {d_chain:.3e} m), "
          f"--chunk {n // 2} + resume {resumed['ate_odometry_cm']} cm in {t_first:.1f} + "
          f"{t_res:.1f} s (max |dp| {d_res:.3e} m, {f_res} fused launches after the resume); "
          f"stepped StageTimer ({card}): "
          f"{json.dumps({k: round(v['mean_ms'], 3) for k, v in stepped['stages'].items()})} "
          "ms mean")


def phase_leftovers(kitti: dict, scans, cfg, dev, card, fused_ev: float, timed) -> None:
    """Phase 25: a registration at moment_method="onehot"; device_time_ms of
    kernel #1 against phase 13; trace(); phase 22's HTML map."""
    import tempfile

    from icet_tpu_torch.ops.fused_moments import fused_moment_sums
    from icet_tpu_torch.solver import moment_route, register_pair
    from icet_tpu_torch.utils.profiling import device_time_ms

    ocfg = cfg.replace(moment_method="onehot")
    check(moment_route(ocfg) == "onehot", f"onehot route: {moment_route(ocfg)}")
    x0 = np.array([0.9, 0.05, 0.0, 0.0, 0.0, 0.0], np.float32)
    torch.cuda.synchronize()
    before = fused_moment_sums.launches
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    card_res = register_pair(scans[0], scans[1], x0, ocfg, device=dev)
    ev1.record()
    torch.cuda.synchronize()
    onehot_fused = fused_moment_sums.launches - before
    onehot_ms = ev0.elapsed_time(ev1)
    cpu_res = register_pair(scans[0], scans[1], x0, ocfg, device="cpu")
    fused_res = register_pair(scans[0], scans[1], x0, cfg, device=dev)
    oX, cX, fX = (r.X.cpu().numpy() for r in (card_res, cpu_res, fused_res))
    d_cpu, d_fused = float(np.abs(oX - cX).max()), float(np.abs(oX - fX).max())
    check(onehot_fused == 0, f"onehot registration launched kernel #1 {onehot_fused} times")
    check(bool(np.isfinite(oX).all()) and d_cpu <= ONEHOT_X_ATOL and d_fused <= ONEHOT_X_ATOL,
          f"onehot X {oX}: {d_cpu:.3e} from the CPU path, {d_fused:.3e} from the fused route")
    print(f"onehot registration (N = {scans.shape[1]}, V = {cfg.n_voxels}, block "
          f"{cfg.moment_block}): {card_res.iterations} iterations in {onehot_ms:.2f} ms "
          f"(CUDA events, {card}), max |X - CPU| {d_cpu:.3e}, max |X - fused| {d_fused:.3e}")

    # device_time_ms against phase 13's measurement (median_ms: CUDA events
    # over 100 back-to-back calls, median of 5), taken again here in
    # alternating turns: back-to-back calls of #1 are bound by the wrapper's
    # host time (~0.04-0.06 ms against the kernel's ~0.011), which drifts
    # with the host's load (0.058 in phase 13 against 0.038 in phase 25 of
    # one run; 0.044 and 0.062 in consecutive calls of another).
    pts, X, bounds, anchors = timed

    def fused():
        return fused_moment_sums(pts, X, bounds, anchors, cfg)

    evs, dts = [], []
    for turn in range(2 * DEVICE_TIME_TURNS):
        if turn % 4 in (0, 3):
            evs.append(median_ms(fused, reps=100))
        else:
            dts.append(device_time_ms(lambda p, x, b, a: fused_moment_sums(p, x, b, a, cfg),
                                      pts, X, bounds, anchors, inner=100, trials=5))
    dt, ev_here = float(np.median(dts)), float(np.median(evs))
    check(abs(dt - ev_here) <= DEVICE_TIME_RTOL * ev_here,
          f"device_time_ms {np.round(dts, 5).tolist()} ms vs phase 13's CUDA-event "
          f"measurement in turns {np.round(evs, 5).tolist()} ms (phase 13 read {fused_ev:.5f})")
    # trace() in a fresh process, as a user calls it: in this process, after
    # the earlier phases' many profiler sessions, a trace of 20 launches
    # recorded no kernel event on an H100, while a fresh process recorded
    # every launch.
    import dataclasses

    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "in.npz"), pts=pts.cpu().numpy(), X=X.cpu().numpy(),
                 bounds=bounds.cpu().numpy(), anchors=anchors.cpu().numpy())
        spec = dict(kind="trace", cfg=dataclasses.asdict(cfg), data=os.path.join(tmp, "in.npz"),
                    dir=os.path.join(tmp, "trace"), out=os.path.join(tmp, "trace.json"))
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                            json.dumps(spec)], cwd=ROOT, capture_output=True, text=True,
                           timeout=WORKER_TIMEOUT_S)
        check(r.returncode == 0, f"trace worker failed:\n{(r.stdout + r.stderr)[-3000:]}")
        with open(spec["out"]) as f:
            traced = json.load(f)
    recorded = sum("fused_moments_kernel" in n for n in traced["kernels"])
    trace_kb = traced["bytes"] / 1024
    check(recorded > 0, f"trace(): the Chrome trace names no fused_moments_kernel "
          f"({traced['events']} events, kernels {sorted(set(traced['kernels']))[:5]})")
    html = kitti["map_html"]
    check(os.path.exists(html) and os.path.getsize(html) > 100_000,
          f"{html}: the HTML map is missing or nearly empty")
    with open(html) as f:
        text = f.read()
    start = text.index("const SCENE = ") + len("const SCENE = ")
    scene = json.loads(text[start:text.index(";\n", start)])
    layers = [(L["label"], L["n"]) for L in scene["layers"]]
    check(layers[0][0] == "map" and layers[0][1] > 100_000 and layers[1][0] == "trail",
          f"HTML map layers {layers}")
    print(f"device_time_ms(fused_moment_sums) median {dt:.5f} ms of "
          f"{np.round(dts, 5).tolist()} vs phase 13's CUDA-event measurement in turns, median "
          f"{ev_here:.5f} of {np.round(evs, 5).tolist()} (phase 13 read {fused_ev:.5f}; "
          f"{card}); trace() in a fresh process: {trace_kb:.0f} KB Chrome "
          f"trace, {recorded} of {TRACE_LAUNCHES} launches of fused_moments_kernel recorded; "
          f"eval_kitti's HTML map {os.path.getsize(html) / 1e6:.1f} MB, layers {layers}")


def eager_drive(drive, cfg, odo):
    """The sequence drive chained through the eager ``odometry_step`` with
    ``run_odometry_device``'s semantics (one block): ``(world poses,
    iterations)``."""
    from icet_tpu_torch.odometry import warm_start_seed
    from icet_tpu_torch.ops.geometry import compose_pose
    from icet_tpu_torch.solver import odometry_step, prepare_reference

    dev = drive.device
    model = prepare_reference(drive[0], cfg)
    x = torch.zeros(6, device=dev)
    T = torch.eye(4, device=dev)
    xprev = xprev2 = x
    poses, iters = [], []
    for k in range(1, drive.shape[0]):
        seed = (warm_start_seed(xprev, xprev2, odo.warm_start_mode) if odo.warm_start
                else torch.zeros_like(xprev))
        res, model = odometry_step(model, drive[k], seed, cfg)
        diverged = torch.any(torch.abs(res.X) > odo.divergence_clamp)
        X = torch.where(diverged, torch.zeros_like(res.X), res.X)
        T = compose_pose(T, X)
        xprev2 = torch.where(diverged, X, xprev)
        xprev = X
        poses.append(T)
        iters.append(res.iterations)
    return [p.cpu().numpy() for p in poses], iters


def phase_compiled(scans, gt, cfg, odo, dev, card, kitti: dict) -> None:
    """Phase 26: the compiled entry points.  Capture under
    ``set_sync_debug_mode("error")``; ``odometry_step_jit`` against the
    eager ``odometry_step`` on every frame of the drive; the drive through
    ``run_odometry_device`` and ``OdometryPipeline`` against the eager chain;
    phase 22's compiled eval_kitti; frame times compiled and eager in turns
    at both sizes, with host operations, device operations and idle share."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.config import ICETConfig
    from icet_tpu_torch.datasets.kitti import KittiOdometrySource
    from icet_tpu_torch.odometry import OdometryPipeline, run_odometry_device
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums
    from icet_tpu_torch.solver import (
        odometry_step,
        odometry_step_jit,
        prepare_reference,
        prepare_reference_jit,
    )

    drive = torch.from_numpy(scans).to(dev)
    zero6 = torch.zeros(6, device=dev)

    # -- capture with no host synchronisation -----------------------------
    graphs.clear()
    captures = graphs.host_ops["captures"]
    t0 = time.perf_counter()
    with graphs.sync_debug("error"):
        out_c = run_odometry_device(scans, cfg, odo, device=dev)
    torch.cuda.synchronize()
    captures = graphs.host_ops["captures"] - captures
    check(captures >= 5, f"{captures} graphs captured by the first compiled drive")
    print(f"compiled: {captures} graphs captured under set_sync_debug_mode('error') in the "
          f"first drive ({time.perf_counter() - t0:.2f} s with the drive itself)")

    # -- step against step -------------------------------------------------
    m_e = prepare_reference(drive[0], cfg)
    m_c = prepare_reference_jit(drive[0], cfg)
    model_equal = all(torch.equal(a, b) for a, b in zip(m_e, m_c))
    x = zero6
    dx = rel = 0.0
    differs = []
    for k in range(1, drive.shape[0]):
        r_e, n_e = odometry_step(m_e, drive[k], x, cfg)
        r_c, n_c = odometry_step_jit(m_e, drive[k], x, cfg)
        check(r_c.iterations == r_e.iterations,
              f"frame {k}: {r_c.iterations} compiled iterations, {r_e.iterations} eager")
        dx = max(dx, float((r_c.X - r_e.X).abs().max()))
        rel = max(rel, float(((r_c.pred_stds - r_e.pred_stds).abs()
                              / r_e.pred_stds.abs().clamp(min=1e-30)).max()))
        fields = [n for n, a, b in zip(n_e._fields, n_c, n_e) if not torch.equal(a, b)]
        model_equal = model_equal and not fields
        parts = {"X": (r_c.X, r_e.X), "pred_stds": (r_c.pred_stds, r_e.pred_stds),
                 "Q": (r_c.Q, r_e.Q), **{f"diagnostics.{n}": (a, b) for n, a, b in zip(
                     r_e.diagnostics._fields, r_c.diagnostics, r_e.diagnostics)}}
        bad = [n for n, (a, b) in parts.items() if not torch.equal(a, b)] + [
            f"prepared.{n}" for n in fields]
        if bad:
            differs.append((k, bad))
        m_e, x = n_e, r_e.X
    check(dx <= 1e-6, f"compiled X {dx:.3e} m from the eager step's")
    check(rel <= 1e-6, f"compiled pred_stds {rel:.3e} relative from the eager step's")
    check(model_equal, f"compiled prepared models differ: {differs[:3]}")
    print(f"compiled step vs eager step on {drive.shape[0] - 1} frames (same model and seed "
          f"each frame): iterations equal, max |dX| {dx:.3e} m, max pred_stds rel {rel:.3e}, "
          f"prepared models equal; bit-identical: {not differs}"
          + (f" (first differing: frame {differs[0][0]}, {differs[0][1]})" if differs else ""))

    # -- the drives ----------------------------------------------------------
    torch.cuda.synchronize()
    fused_moment_sums.launches = 0
    poses_e, iters_e = eager_drive(drive, cfg, odo)
    torch.cuda.synchronize()
    eager_launches = fused_moment_sums.launches
    fused_moment_sums.launches = 0
    zero_warmups()
    out_c = run_odometry_device(scans, cfg, odo, device=dev)
    torch.cuda.synchronize()
    seq_launches = fused_moment_sums.launches
    fused_moment_sums.launches = 0
    out_p = list(OdometryPipeline(cfg, odo, device=dev).run(scans))
    torch.cuda.synchronize()
    pipe_launches = fused_moment_sums.launches
    check(warmups() == 0, f"{warmups()} warm-up launches: the graphs were not reused")
    ate_e = pose_ate(poses_e, gt)
    ate_c, ate_p = trajectory_ate(out_c, gt), trajectory_ate(out_p, gt)
    iters_c = [f.iterations for f in out_c]
    check(iters_c == iters_e, f"compiled drive iterations {iters_c}, eager {iters_e}")
    check(seq_launches == pipe_launches == eager_launches == sum(iters_e) + len(scans),
          f"fused launches: compiled drive {seq_launches}, pipeline {pipe_launches}, eager "
          f"{eager_launches}, iterations {sum(iters_e)} + prepares {len(scans)}")
    for name, ate in (("run_odometry_device", ate_c), ("OdometryPipeline", ate_p)):
        check(ate <= ATE_MAX_M, f"compiled {name}: ATE {ate * 100:.4f} cm above "
              f"{ATE_MAX_M * 100} cm")
        check(abs(ate - ate_e) <= 1e-6, f"compiled {name}: ATE {ate * 100:.6f} cm, eager "
              f"{ate_e * 100:.6f} cm")
    print(f"compiled drives: run_odometry_device ATE {ate_c * 100:.6f} cm, OdometryPipeline "
          f"{ate_p * 100:.6f} cm, eager chain {ate_e * 100:.6f} cm; fused launches "
          f"{seq_launches} / {pipe_launches} / {eager_launches} = {sum(iters_e)} iterations + "
          f"{len(scans)} prepares")
    s, lc, ms = kitti["runs"]["plain"]
    print(f"compiled eval_kitti plain at 64x2048 (phase 22): ATE {s['ate_odometry_cm']} cm, "
          f"{lc['replays']} graph replays, {ms:.3f} ms a frame by CUDA events ({card})")

    # -- frame times in turns --------------------------------------------------
    kscans = np.stack([sc for sc, _ in KittiOdometrySource(kitti["seq"], max_points=131072)])
    kdrive = torch.from_numpy(kscans.astype(np.float32)).to(dev)
    kcfg = ICETConfig(n_iters=7, min_range=2.0, convergence_tol=1e-4)

    def chain(frames, c, compiled):
        prep, step = ((prepare_reference_jit, odometry_step_jit) if compiled
                      else (prepare_reference, odometry_step))
        m, xx = prep(frames[0], c), zero6
        for k in range(1, frames.shape[0]):
            res, m = step(m, frames[k], xx, c)
            xx = res.X

    for size, frames, c, rounds in (("64x1024, N = 65,536", drive, cfg, 1),
                                    ("64x2048, N = 131,072", kdrive, kcfg, 1)):
        steps = frames.shape[0] - 1
        ms = {"eager": [], "compiled": []}
        for mode in ("eager", "compiled", "compiled", "eager"):
            fn = (lambda f=frames, cc=c, comp=(mode == "compiled"): chain(f, cc, comp))
            ms[mode].append(median_ms(fn, reps=1, rounds=rounds) / steps)
        ops0 = dict(graphs.host_ops)
        chain(frames, c, True)
        torch.cuda.synchronize()
        host = {k: (graphs.host_ops[k] - ops0[k]) / steps
                for k in ("replays", "flag_reads", "copies")}
        # The profile takes the drive's first PROFILE_FRAMES frames: its
        # events of a whole eager chain take minutes to read back.
        prof, short = {}, frames[:PROFILE_FRAMES]
        for mode in ("compiled", "eager"):
            ops = device_profile(lambda f=short, cc=c, comp=(mode == "compiled"):
                                 chain(f, cc, comp), reps=1)
            wall = median_ms(lambda f=short, cc=c, comp=(mode == "compiled"): chain(f, cc, comp),
                             reps=1, rounds=rounds)
            busy = sum(v for v, _ in ops.values())
            n_ops = sum(k for _, k in ops.values()) / (PROFILE_FRAMES - 1)
            prof[mode] = (n_ops, busy / (PROFILE_FRAMES - 1), 1.0 - busy / wall)
        print(f"frame times at {size} ({card}), eager/compiled/compiled/eager: "
              f"{' / '.join(f'{t:.3f}' for t in (ms['eager'][0], *ms['compiled'], ms['eager'][1]))}"
              f" ms a frame (CUDA events over the {steps}-frame chain, median of {rounds})")
        print(f"  host operations a frame: compiled {sum(host.values()):.1f} ({host['replays']:.1f} "
              f"graph replays + {host['flag_reads']:.1f} exit-flag reads + {host['copies']:.1f} "
              f"device copies), eager {prof['eager'][0]:.1f} launches (its device operations)")
        for mode in ("compiled", "eager"):
            n_ops, busy, idle = prof[mode]
            print(f"  {mode}: {n_ops:.1f} device operations a frame, device busy {busy:.3f} ms "
                  f"a frame, idle share {idle:.3f} (torch.profiler and CUDA events over the "
                  f"first {PROFILE_FRAMES} frames)")


def drive_launches(run) -> tuple:
    """``(result, kernel #1 launches, kernel #4 launches, their warm-ups)``
    of one drive ``run()``; the counts are set to 0 just before it."""
    from icet_tpu_torch.ops.bias_encoder import bias_encoder_pool
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums

    torch.cuda.synchronize()
    fused_moment_sums.launches = bias_encoder_pool.launches = 0
    zero_warmups()
    out = run()
    torch.cuda.synchronize()
    return (out, fused_moment_sums.launches, bias_encoder_pool.launches,
            (warmups(), warmups("bias_encoder_pool")))


def max_rel(a, b) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def step_gate(what: str, k: int, r_c, r_e, gates: dict, extra=()) -> None:
    """Phase 27's per-frame gate of a compiled step against the eager one:
    iterations equal, X within 1e-6 m, pred_stds within 1e-6 relative, the
    entries of ``extra`` equal (``(name, compiled, eager)`` for host values,
    ``(name, compiled, eager, exact)`` for tensors: equal, or within 1e-6
    where not ``exact``); ``gates`` collects the maxima and what was not
    bit-identical."""
    check(r_c.iterations == r_e.iterations,
          f"{what} frame {k}: {r_c.iterations} compiled iterations, {r_e.iterations} eager")
    gates["dx"] = max(gates.get("dx", 0.0), float((r_c.X - r_e.X).abs().max()))
    gates["rel"] = max(gates.get("rel", 0.0), max_rel(r_c.pred_stds, r_e.pred_stds))
    parts = [("X", r_c.X, r_e.X), ("pred_stds", r_c.pred_stds, r_e.pred_stds),
             ("Q", r_c.Q, r_e.Q)] + [
        (f"diagnostics.{n}", a, b) for n, a, b in zip(r_e.diagnostics._fields,
                                                      r_c.diagnostics, r_e.diagnostics)]
    bad = [n for n, a, b in parts if not torch.equal(a, b)]
    for name, a, b, *exact in extra:
        if isinstance(a, bool) or isinstance(b, bool):
            check(a == b, f"{what} frame {k}: {name} {a} compiled, {b} eager")
            continue
        if not torch.equal(a, b):
            bad.append(name)
            diff = float((a.float() - b.float()).abs().max())
            check(not exact[0] and diff <= 1e-6,
                  f"{what} frame {k}: {name} differs by {diff:.3e}")
    check(gates["dx"] <= 1e-6, f"{what} frame {k}: X {gates['dx']:.3e} m from the eager step")
    check(gates["rel"] <= 1e-6, f"{what} frame {k}: pred_stds {gates['rel']:.3e} relative")
    if bad:
        gates.setdefault("differs", []).append((k, bad))


def gate_line(what: str, n: int, gates: dict) -> str:
    differs = gates.get("differs", [])
    return (f"{what} on {n} frames (same model and seed each frame): iterations equal, max "
            f"|dX| {gates['dx']:.3e} m, max pred_stds rel {gates['rel']:.3e}; bit-identical: "
            f"{not differs}" + (f" (first differing: frame {differs[0][0]}, {differs[0][1]}; "
                                f"{len(differs)} frames differ)" if differs else ""))


def keyframe_steps(drive, cfg, kf_cfg, bm_cfg, net, dev) -> tuple[dict, int]:
    """Phase 27: the keyframe loop chained through the eager step and spawn
    (``net`` given: the DNN step), the compiled step and spawn called on the
    same inputs each frame (model, carry, uniforms, keyframe samples), each
    on its own copy of the block map; maps, spawn flags, keyframe models and
    samples compared.  Returns the gates and the spawns."""
    from icet_tpu_torch import keyframe as kfm
    from icet_tpu_torch.filters import model_voxel_samples, model_voxel_samples_jit
    from icet_tpu_torch.ops.geometry import compose_states

    K, gates = bm_cfg.points_per_scan, {"map_dp": 0.0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    zero6, zero2 = torch.zeros(6, device=dev), torch.zeros(2, device=dev)

    def spawn(bm_e, bm_c, k, world, first=False):
        u = torch.rand(K, generator=gen, device=dev)
        m_e, bm_e = kfm.keyframe_spawn(bm_e, drive[k], world, u, True, cfg, bm_cfg)
        m_c, bm_c = kfm.keyframe_spawn_jit(bm_c, drive[k], world, u, True, cfg, bm_cfg)
        bad = [n for n, a, b in zip(m_e._fields, m_c, m_e) if not torch.equal(a, b)]
        samples = None
        if net is not None:
            samples = model_voxel_samples(m_e, drive[k], cfg)
            s_c = model_voxel_samples_jit(m_e, drive[k], cfg)
            bad += [n for n, a, b in zip(("samples", "counts"), s_c, samples)
                    if not torch.equal(a, b)]
        check(not bad, f"keyframe spawn at frame {k}: compiled {bad} differ")
        return m_e, samples, bm_e, bm_c

    model, samples, bm_e, bm_c = spawn(kfm.blockmap_init(bm_cfg, dev),
                                       kfm.blockmap_init(bm_cfg, dev), 0, zero6)
    x_rel, delta, h0, world_key, key, spawns = zero6, zero6, zero2, zero6, 0, 0
    for k in range(1, drive.shape[0]):
        u = torch.rand(K, generator=gen, device=dev)
        if net is None:
            args = (model, None, drive[k], x_rel, delta, u, h0, cfg, kf_cfg, bm_cfg)
            steps = (kfm.keyframe_step_jit, kfm.keyframe_step)
        else:
            args = (model, None, drive[k], drive[key], samples, x_rel, delta, u, h0, cfg, kf_cfg,
                    bm_cfg, net)
            steps = (kfm.keyframe_step_dnn_jit, kfm.keyframe_step_dnn)
        r_c, X_c, d_c, div_c, sp_c, h_c, bm_c = steps[0](*args[:1], bm_c, *args[2:])
        r_e, X_e, d_e, div_e, sp_e, h_e, bm_e = steps[1](*args[:1], bm_e, *args[2:])
        check((bm_c.n_blocks, bm_c.cursor) == (bm_e.n_blocks, bm_e.cursor),
              f"keyframe frame {k}: map counters {(bm_c.n_blocks, bm_c.cursor)} compiled, "
              f"{(bm_e.n_blocks, bm_e.cursor)} eager")
        check(torch.equal(bm_c.valid, bm_e.valid) and torch.equal(bm_c.poses, bm_e.poses),
              f"keyframe frame {k}: block map validity or poses differ")
        dp = float((bm_c.points - bm_e.points).abs().max())
        gates["map_dp"] = max(gates["map_dp"], dp)
        check(dp <= 1e-5, f"keyframe frame {k}: block map points differ by {dp:.3e} m")
        step_gate("keyframe step", k, r_c, r_e, gates,
                  [("spawn", sp_c, sp_e), ("X_rel", X_c, X_e, False),
                   ("delta", d_c, d_e, False), ("diverged", div_c, div_e, True),
                   ("health", h_c, h_e, False), ("map.points", bm_c.points, bm_e.points, False)])
        h0 = kfm.update_health0(h0, h_e)
        world = compose_states(world_key, X_e)
        delta = d_e
        if sp_e:
            spawns += 1
            model, samples, bm_e, bm_c = spawn(bm_e, bm_c, k, world)
            x_rel, h0, world_key, key = zero6, zero2, world, k
        else:
            x_rel = X_e
    return gates, spawns


def phase_compiled_dnn_keyframe(scans, gt, cfg, dcfg, kf_cfg, bm_cfg, odo, net, dev, card,
                                kitti: dict) -> None:
    """Phase 27: the compiled DNN and keyframe paths.  Their graphs captured
    under ``set_sync_debug_mode("error")`` in the drives through
    ``OdometryPipeline`` (DNN), ``KeyframeOdometry`` (plain and DNN) and
    ``run_keyframe_device``, each against the eager route (ATE gated,
    kernels #1's and #4's launches equal to the eager drive's plus the
    warm-ups); step against step on every frame; phase 22's compiled
    eval_kitti --dnn and --keyframe; frame times compiled and eager in turns
    at 64x1024 and 64x2048 with host operations, device operations and idle
    share."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.config import ICETConfig, KeyframeConfig
    from icet_tpu_torch.datasets.kitti import KittiOdometrySource
    from icet_tpu_torch.filters import (
        model_voxel_samples,
        model_voxel_samples_jit,
        odometry_step_dnn,
        odometry_step_dnn_jit,
    )
    from icet_tpu_torch.keyframe import KeyframeOdometry, run_keyframe_device
    from icet_tpu_torch.odometry import OdometryPipeline
    from icet_tpu_torch.solver import prepare_reference, prepare_reference_jit

    drive = torch.from_numpy(scans).to(dev)
    zero6 = torch.zeros(6, device=dev)
    n_pre = max(min(dcfg.dnn_start_iter, dcfg.n_iters - 1), 1)
    n_post = dcfg.n_iters - n_pre

    # -- the drives: captured with no host synchronisation, against eager ----
    graphs.clear()
    captures = graphs.host_ops["captures"]
    t0 = time.perf_counter()
    drives = {
        "OdometryPipeline (DNN)": lambda: OdometryPipeline(dcfg, odo, device=dev),
        "KeyframeOdometry": lambda: KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev),
        "KeyframeOdometry (DNN)": lambda: KeyframeOdometry(dcfg, kf_cfg, bm_cfg, device=dev),
    }
    refs = {"OdometryPipeline (DNN)": DNN_ATE_REF_M, "KeyframeOdometry": KF_ATE_REF_M,
            "KeyframeOdometry (DNN)": DNN_KF_ATE_REF_M}
    def run(runner):
        return runner, list(runner.run(scans))

    compiled = {}
    with graphs.sync_debug("error"):
        for name, make in drives.items():
            compiled[name] = drive_launches(lambda m=make: run(m()))
        dev_run = drive_launches(lambda: run_keyframe_device(scans, cfg, kf_cfg, bm_cfg,
                                                             device=dev))
    torch.cuda.synchronize()
    captures = graphs.host_ops["captures"] - captures
    check(captures >= 20, f"{captures} graphs captured by the first compiled drives")
    print(f"compiled DNN and keyframe paths: {captures} graphs captured under "
          f"set_sync_debug_mode('error') in the first drives ({time.perf_counter() - t0:.2f} s "
          f"with the four drives themselves)")
    for name, make in drives.items():
        (runner, out), fused, enc, (w1, w4) = compiled[name]
        (eager_runner, eout), efused, eenc, ew = drive_launches(lambda m=make: run(eager(m())))
        check(ew == (0, 0), f"{name}: the eager drive warmed up {ew}")
        its, eits = [f.iterations for f in out], [f.iterations for f in eout]
        check(its == eits, f"{name}: compiled iterations {its}, eager {eits}")
        check((fused, enc) == (efused + w1, eenc + w4),
              f"{name}: launches of #1/#4 {fused}/{enc}, eager {efused}/{eenc} + warm-ups "
              f"{w1}/{w4}")
        ate, eate = trajectory_ate(out, gt), trajectory_ate(eout, gt)
        check(ate <= refs[name] + ATE_SLACK_M,
              f"compiled {name}: ATE {ate * 100:.4f} cm above {(refs[name] + ATE_SLACK_M) * 100:.4f}")
        check(abs(ate - eate) <= 1e-6,
              f"compiled {name}: ATE {ate * 100:.6f} cm, eager {eate * 100:.6f} cm")
        kfs, ekfs = (getattr(r, "keyframe_indices", None) for r in (runner, eager_runner))
        check(kfs == ekfs, f"{name}: keyframes {kfs} compiled, {ekfs} eager")
        print(f"compiled {name}: ATE {ate * 100:.6f} cm, eager {eate * 100:.6f} cm (JAX "
              f"package on the CPU: {refs[name] * 100:.4f} cm); launches of #1 {fused} = eager "
              f"{efused} + {w1} warm-ups, of #4 {enc} = eager {eenc} + {w4} warm-ups"
              + (f"; keyframes {kfs}" if kfs is not None else ""))
    (dframes, dbm), dfused, _, (dw1, _) = dev_run
    host = compiled["KeyframeOdometry"][0][0]
    dkfs = [0] + [f.index for f in dframes if f.is_keyframe]
    check(dkfs == host.keyframe_indices,
          f"run_keyframe_device keyframes {dkfs}, KeyframeOdometry {host.keyframe_indices}")
    d_ate = trajectory_ate(dframes, gt)
    check(d_ate <= KF_ATE_REF_M + ATE_SLACK_M, f"run_keyframe_device ATE {d_ate * 100:.4f} cm")
    want = sum(f.iterations for f in dframes) + len(dkfs) + dw1
    check(dfused == want, f"run_keyframe_device: #1 launches {dfused} != {want}")
    print(f"compiled run_keyframe_device: keyframes {dkfs} = KeyframeOdometry's, ATE "
          f"{d_ate * 100:.6f} cm, launches of #1 {dfused} = {want - dw1} + {dw1} warm-ups, "
          f"block map {int(dbm.valid.sum())} points in {dbm.n_blocks} blocks")

    # -- step against step ----------------------------------------------------
    m = prepare_reference(drive[0], dcfg)
    smp = model_voxel_samples(m, drive[0], dcfg)
    x, gates = zero6, {}
    for k in range(1, drive.shape[0]):
        r_e, n_e, s_e, f_e = odometry_step_dnn(m, drive[k - 1], smp, drive[k], x, dcfg, net)
        r_c, n_c, s_c, f_c = odometry_step_dnn_jit(m, drive[k - 1], smp, drive[k], x, dcfg, net,
                                                   return_filter=True)
        step_gate("DNN step", k, r_c, r_e, gates,
                  [("keep", f_c.keep, f_e.keep, True),
                   ("n_rejected", f_c.n_rejected, f_e.n_rejected, True)]
                  + [(f"prepared.{n}", a, b, True) for n, a, b in zip(n_e._fields, n_c, n_e)]
                  + [("samples", s_c[0], s_e[0], True), ("counts", s_c[1], s_e[1], True)])
        m, smp, x = n_e, s_e, r_e.X
    print("compiled " + gate_line("odometry_step_dnn_jit vs odometry_step_dnn", drive.shape[0] - 1,
                                  gates) + "; keep masks, n_rejected, prepared models and "
          "samples equal")
    for what, c, n in (("keyframe_step_jit vs keyframe_step", cfg, None),
                       ("keyframe_step_dnn_jit vs keyframe_step_dnn", dcfg, net)):
        g, spawns = keyframe_steps(drive, c, kf_cfg, bm_cfg, n, dev)
        print("compiled " + gate_line(what, drive.shape[0] - 1, g) + f"; spawn flags, "
              f"{spawns} spawns (keyframe models{' and samples' if n else ''} equal), block "
              f"maps' validity, poses and counters equal, points within {g['map_dp']:.3e} m")

    for mode in ("dnn", "keyframe"):
        s_k, lc, ms = kitti["runs"][mode]
        print(f"compiled eval_kitti --{mode} at 64x2048 (phase 22): ATE {s_k['ate_odometry_cm']} "
              f"cm, {lc['replays']} graph replays, {ms:.3f} ms a frame by CUDA events ({card})")

    # -- frame times in turns ------------------------------------------------
    kscans = np.stack([sc for sc, _ in KittiOdometrySource(kitti["seq"], max_points=131072)])
    kdrive = torch.from_numpy(kscans[:KF_TIMED_FRAMES].astype(np.float32)).to(dev)
    kcfg = ICETConfig(n_iters=7, min_range=2.0, convergence_tol=1e-4)
    kkf = KeyframeConfig(spawn_distance=3.0, spawn_angle=0.3, delta_clamp=2.5)

    def dnn_chain(frames, c, comp):
        prep, samp, step = ((prepare_reference_jit, model_voxel_samples_jit,
                             odometry_step_dnn_jit) if comp
                            else (prepare_reference, model_voxel_samples, odometry_step_dnn))
        mm = prep(frames[0], c)
        ss, xx = samp(mm, frames[0], c), zero6
        for k in range(1, frames.shape[0]):
            out = step(mm, frames[k - 1], ss, frames[k], xx, c, net)
            mm, ss, xx = out[1], out[2], out[0].X

    def kf_chain(frames, c, kc, comp):
        runner = KeyframeOdometry(c, kc, bm_cfg, device=dev)
        (runner if comp else eager(runner)).run(frames)

    for size, frames, c, kc, rounds in (("64x1024, N = 65,536", drive[:TIMED_FRAMES], cfg,
                                         kf_cfg, 1),
                                        ("64x2048, N = 131,072", kdrive, kcfg, kkf, 1)):
        steps = frames.shape[0] - 1
        dc = c.replace(dnn_filter=True)
        paths = {"DNN": lambda comp, f=frames, dc=dc: dnn_chain(f, dc, comp),
                 "keyframe": lambda comp, f=frames, c=c, kc=kc: kf_chain(f, c, kc, comp),
                 "DNN keyframe": lambda comp, f=frames, dc=dc, kc=kc: kf_chain(f, dc, kc, comp)}
        for path, chain in paths.items():
            ms = {"eager": [], "compiled": []}
            for mode in ("eager", "compiled", "compiled", "eager"):
                ms[mode].append(median_ms(lambda ch=chain, cm=(mode == "compiled"): ch(cm),
                                          reps=1, rounds=rounds) / steps)
            ops0 = dict(graphs.host_ops)
            chain(True)
            torch.cuda.synchronize()
            host = {k: (graphs.host_ops[k] - ops0[k]) / steps
                    for k in ("replays", "flag_reads", "spawn_reads", "copies", "draws",
                              "map_writes")}
            prof, short = {}, frames[:PROFILE_FRAMES]
            for mode in ("compiled", "eager"):
                fn = (lambda ch=chain, cm=(mode == "compiled"): ch(cm, short))
                ops = device_profile(fn, reps=1)
                wall = median_ms(fn, reps=1, rounds=rounds)
                busy = sum(v for v, _ in ops.values())
                n_ops = sum(k for _, k in ops.values()) / (PROFILE_FRAMES - 1)
                prof[mode] = (n_ops, busy / (PROFILE_FRAMES - 1), 1.0 - busy / wall)
            print(f"{path} frame at {size} ({card}), eager/compiled/compiled/eager: "
                  f"{' / '.join(f'{t:.3f}' for t in (ms['eager'][0], *ms['compiled'], ms['eager'][1]))}"
                  f" ms a frame (CUDA events over the {steps}-frame chain, median of {rounds})")
            print(f"  host operations a frame: compiled {sum(host.values()):.1f} "
                  f"({host['replays']:.1f} graph replays + {host['flag_reads']:.1f} exit-flag "
                  f"reads + {host['spawn_reads']:.1f} spawn-flag reads + {host['copies']:.1f} "
                  f"device copies + {host['draws']:.1f} uniform draws + "
                  f"{host['map_writes']:.1f} block-map writes), eager {prof['eager'][0]:.1f} "
                  f"launches (its device operations)")
            for mode in ("compiled", "eager"):
                n_ops, busy, idle = prof[mode]
                print(f"  {mode}: {n_ops:.1f} device operations a frame, device busy "
                      f"{busy:.3f} ms a frame, idle share {idle:.3f} (torch.profiler and CUDA "
                      f"events over the first {PROFILE_FRAMES} frames)")


def map_frames_ms(drive, mcfg, map_cfg, odo, compiled: bool) -> tuple[float, dict]:
    """ms a ``MapMaker`` frame by CUDA events over frames 2 onward of
    ``drive`` (the seed frame and the first step, where a new ring's map
    graphs are captured, go untimed), and the compiled route's host
    operations a frame."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.mapping import MapMaker

    maker = MapMaker(mcfg, map_cfg, odo, device=drive.device)
    if not compiled:
        eager(maker)
    maker.step(drive[0])
    maker.step(drive[1])
    torch.cuda.synchronize()
    ops0 = dict(graphs.host_ops)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for d in drive[2:]:
        maker.step(d)
    end.record()
    torch.cuda.synchronize()
    n = drive.shape[0] - 2
    return start.elapsed_time(end) / n, {k: (graphs.host_ops[k] - ops0[k]) / n for k in ops0}


def phase_compiled_back_end(scans, mcfg, map_cfg, odo, lc_loops, lc_solves, dev, card) -> None:
    """Phase 27, the HD-mapping back end: the MapMaker frame, a loop pair of
    phase 17's drive (its first 16 candidates, one chunk) and phase 17's
    K = 250 solve, compiled and eager in turns (CUDA events); the dense
    solve of that graph captured under a global MAGMA preference."""
    import icet_tpu_torch.pose_graph as pose_graph
    from icet_tpu_torch import graphs

    drive = torch.from_numpy(scans[:TIMED_FRAMES]).to(dev)
    ms = {"eager": [], "compiled": []}
    host = {}
    for mode in ("eager", "compiled", "compiled", "eager"):
        t, host[mode] = map_frames_ms(drive, mcfg, map_cfg, odo, mode == "compiled")
        ms[mode].append(t)
    h = host["compiled"]
    print(f"MapMaker frame at 64x1024 ({card}), eager/compiled/compiled/eager: "
          f"{' / '.join(f'{t:.3f}' for t in (ms['eager'][0], *ms['compiled'], ms['eager'][1]))}"
          f" ms a frame (CUDA events over frames 2-{drive.shape[0] - 1}); host operations a "
          f"frame, compiled: {h['replays']:.1f} graph replays, {h['flag_reads']:.1f} exit-flag "
          f"reads, {h['copies']:.1f} device copies, {h['captures']:.1f} captures")

    ((scans_lc, cands, cfg), kw), = lc_loops.args
    pairs = cands[:16]

    def loops(compiled):
        with patched(pose_graph, "compiled_route", lambda c: compiled):
            return pose_graph.close_loops(scans_lc, pairs, cfg, batch=16, **kw)

    ms = {"eager": [], "compiled": []}
    out = {}
    for mode in ("eager", "compiled", "compiled", "eager"):
        # One call a turn: phase 17 captured the compiled pairs' graphs.
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out[mode] = loops(mode == "compiled")
        end.record()
        torch.cuda.synchronize()
        ms[mode].append(start.elapsed_time(end) / len(pairs))
    print(f"loop pair of the loop-closure drive ({card}), eager/compiled/compiled/eager: "
          f"{' / '.join(f'{t:.3f}' for t in (ms['eager'][0], *ms['compiled'], ms['eager'][1]))}"
          f" ms a pair (CUDA events over close_loops of {len(pairs)} candidates, batch 16, one "
          f"read back; {len(out['compiled'])} loops kept both ways)")

    (args, kw), = lc_solves.args
    ms = {"eager": [], "compiled": []}
    for mode in ("eager", "compiled", "compiled", "eager"):
        solve = (pose_graph.optimize_poses_sparse if mode == "compiled"
                 else pose_graph.optimize_poses_sparse_eager)
        ms[mode].append(median_ms(lambda f=solve: out.__setitem__(f, f(*args, **kw)), reps=1,
                                  rounds=2))
    dx = float((out[pose_graph.optimize_poses_sparse]
                - out[pose_graph.optimize_poses_sparse_eager]).abs().max())
    print(f"pose-graph solve of the loop-closure drive (K = {args[0].shape[0]}, "
          f"{args[1].idx_i.shape[0]} factors, {args[2]} x {args[3]}, {kw}; {card}), "
          f"eager/compiled/compiled/eager: "
          f"{' / '.join(f'{t:.3f}' for t in (ms['eager'][0], *ms['compiled'], ms['eager'][1]))}"
          f" ms a solve (CUDA events, median of 2); compiled against eager: max |d state| "
          f"{dx:.3e}, bit-identical: {dx == 0.0}")
    check(dx <= 2e-3, f"K = 250 solve: compiled states {dx:.3e} from the eager loop's")

    # The dense solve captured under a global MAGMA preference (its
    # factorisations pinned to cuSOLVER inside the stage), against the
    # eager loop; first use of this graph set, so its graph is captured here.
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("magma")
    try:
        with graphs.sync_debug("error"):
            dense = pose_graph.optimize_poses(args[0], args[1], 10, device=dev)
        dense_e = pose_graph.optimize_poses_eager(args[0], args[1], 10, device=dev)
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)
    dx = float((dense - dense_e).abs().max())
    check(dx <= 2e-3, f"K = 250 dense solve: compiled states {dx:.3e} from the eager loop's")
    print(f"dense pose-graph solve of the same graph (10 steps), captured under a global "
          f"preferred_linalg_library('magma'): compiled against eager max |d state| {dx:.3e}")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from icet_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1
    from icet_tpu_torch.config import (
        PROFILES,
        BlockMapConfig,
        ICETConfig,
        KeyframeConfig,
        MapConfig,
        OdometryConfig,
    )
    from icet_tpu_torch.datasets.replay import CityDriveSource
    from icet_tpu_torch.device import resolve_device
    from icet_tpu_torch.filters import model_voxel_samples, odometry_step_dnn, pretrained_dnn
    from icet_tpu_torch.keyframe import KeyframeOdometry, np_pose_matrix, run_keyframe_device
    from icet_tpu_torch.mapping import MapMaker
    from icet_tpu_torch.odometry import OdometryPipeline, run_odometry_device
    from icet_tpu_torch.ops.bias_encoder import bias_encoder_pool, encoder_pool_reference
    from icet_tpu_torch.ops.fused_moments import (
        fused_moment_sums,
        fused_moment_sums_reference,
        fused_moment_sums_windowed,
        fused_moment_sums_windowed_reference,
    )
    from icet_tpu_torch.scan_matcher import ScanMatcher
    from icet_tpu_torch.ops.grid import fixed_shell_bounds, voxel_anchors
    from icet_tpu_torch.ops.moment_scatter import moment_scatter_reference, moment_scatter_sums
    from icet_tpu_torch.solver import odometry_step, prepare_reference, register_pair
    from icet_tpu_torch import graphs

    dev = resolve_device("cuda")
    card = device_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"build {name}:\n{log.strip()}")
    for name, usage in ptxas_usage(logs).items():
        print(f"ptxas {name}: {usage}")

    # -- data: the drive bench.py times -----------------------------------
    t0 = time.perf_counter()
    src = CityDriveSource(n_frames=24, speed=1.0, n_beams=64, n_azimuth=1024)
    frames = [(s, T) for s, T in src]
    scans = np.stack([s for s, _ in frames]).astype(np.float32)
    gt = [T for _, T in frames]
    print(f"data: {scans.shape} in {time.perf_counter() - t0:.1f} s")
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)
    dcfg = cfg.replace(dnn_filter=True)
    odo = OdometryConfig(divergence_clamp=2.5)

    # -- fused moments kernel vs plain ------------------------------------
    model = prepare_reference(torch.from_numpy(scans[0]).to(dev), cfg)
    pts = torch.from_numpy(scans[1]).to(dev)
    rng = np.random.default_rng(0)
    X_step = torch.tensor([1.0, 0.05, 0.0, 0.0, 0.0, 0.02], device=dev)
    cases = {
        "X=0": (pts, torch.zeros(6, device=dev)),
        "X=1m/0.02rad": (pts, X_step),
        "X=3m/0.1rad": (pts, torch.tensor([3.0, -0.2, 0.05, 0.01, -0.01, 0.1], device=dev)),
    }
    perm = torch.from_numpy(rng.permutation(pts.shape[0])).to(dev)
    cases["shuffled"] = (pts[perm].contiguous(), X_step)
    holes = scans[1].copy()
    rows = rng.permutation(holes.shape[0])
    holes[rows[:2000]] = np.nan
    holes[rows[2000:4000]] = 0.0
    holes[rows[4000:4100], 1] = np.nan
    cases["nan+zero rows"] = (torch.from_numpy(holes).to(dev), X_step)
    report = []
    max_err = 0.0
    outs = {}
    for name, (p, X) in cases.items():
        err, outs[name] = compare(name, p, X, model, cfg, report)
        max_err = max(max_err, err)
    check(bool((outs["shuffled"][:, 0] == outs["X=1m/0.02rad"][:, 0]).all()),
          "shuffled order changed the kernel's counts")
    zero6 = torch.zeros(6, device=dev)
    vox_pts, vox_model = one_voxel_case(cfg, dev, pts.shape[0], rng)
    far = types.SimpleNamespace(bounds=torch.full_like(model.bounds, 1e4),
                                anchors=model.anchors)
    single = next(k for k in range(0, pts.shape[0], 97)
                  if edge_points(pts[k:k + 1], X_step, cfg) == 0
                  and float(fused_moment_sums_reference(pts[k:k + 1], X_step, model.bounds,
                                                        model.anchors, cfg)[:, 0].sum()) == 1.0)
    edge_cases = {
        "one voxel, N=65536": (vox_pts, zero6, vox_model),
        "no member": (pts, X_step, far),
        "N=1": (pts[single:single + 1].contiguous(), X_step, model),
        "N=65537": (torch.cat([pts, pts[single:single + 1]]).contiguous(), X_step, model),
    }
    for name, (p, X, m) in edge_cases.items():
        err, outs[name] = compare(name, p, X, m, cfg, report)
        max_err = max(max_err, err)
    vox = outs["one voxel, N=65536"][:, 0]
    check(float(vox.sum()) == vox_pts.shape[0] and int((vox > 0).sum()) == 1,
          "one voxel: not every point counted in one row")
    check(bool((outs["no member"] == 0).all()), "no member: nonzero sums")
    check(float(outs["N=1"][:, 0].sum()) == 1.0, "N=1: the point is not counted once")
    check(torch.equal(outs["N=65537"][:, 0] - outs["X=1m/0.02rad"][:, 0], outs["N=1"][:, 0]),
          "N=65537: counts are not N=65536's plus N=1's")
    for line in report:
        print(f"fused moments vs plain, {line}")

    # -- encoder kernel vs plain ------------------------------------------
    net = pretrained_dnn(dcfg, dev)
    samples0 = model_voxel_samples(model, torch.from_numpy(scans[0]).to(dev), dcfg)
    x_enc = filter_input(model, samples0, pts, X_step, dcfg)
    tag = np.tile(np.r_[-np.ones(100), np.ones(100)].astype(np.float32), (37, 1))
    x37 = torch.from_numpy(np.concatenate(
        [rng.normal(size=(37, 200, 3)).astype(np.float32) * 0.5, tag[..., None]], -1)).to(dev)
    report = []
    enc_err = max(encoder_compare("drive filter input", net, x_enc, report),
                  encoder_compare("37-voxel batch", net, x37, report))
    for b_enc in (1, 37, 1801):
        for p_enc in (1, 63, 64, 65, 200):
            xyz = rng.normal(size=(b_enc, p_enc, 3)).astype(np.float32) * 0.5
            tag = np.where(np.arange(p_enc) < p_enc // 2, -1.0, 1.0).astype(np.float32)
            xs = np.concatenate([xyz, np.broadcast_to(tag[None, :, None], (b_enc, p_enc, 1))], -1)
            enc_err = max(enc_err, encoder_compare(f"B={b_enc} P={p_enc}", net,
                                                   torch.from_numpy(xs).to(dev), report))
    for line in report:
        print(f"encoder vs plain, {line}")

    # -- scatter kernel vs index_add_ -------------------------------------
    fixed = cfg.replace(radial_mode="fixed")
    fbounds = fixed_shell_bounds(fixed, dev)
    report = []
    vid_s, feats_s = scatter_inputs(pts, X_step, model.bounds, model.anchors, cfg)
    vid_f, feats_f = scatter_inputs(pts, X_step, fbounds, voxel_anchors(fbounds, fixed), fixed)
    scat_err = max(scatter_compare("shared table", vid_s, feats_s, cfg.n_voxels, report),
                   scatter_compare("global atomics", vid_f, feats_f, fixed.n_voxels, report))
    scat_cases = scatter_edge_cases(vid_s, feats_s, cfg.n_voxels, rng)
    for name, (v, f) in scat_cases.items():
        scat_err = max(scat_err, scatter_compare(name, v, f, cfg.n_voxels, report))
    v_big = scat_cases["out-of-range ids"][0].clone()
    v_big[v_big == cfg.n_voxels + 1] = fixed.n_voxels + 1
    scat_err = max(scat_err, scatter_compare("out-of-range ids, V=90000", v_big, feats_f,
                                             fixed.n_voxels, report))
    one = moment_scatter_sums(*scat_cases["one voxel, N=65536"], cfg.n_voxels)
    sentinel = moment_scatter_sums(*scat_cases["all on the sentinel"], cfg.n_voxels)
    dropped = moment_scatter_sums(*scat_cases["out-of-range ids"], cfg.n_voxels)
    kept = scat_cases["out-of-range ids"][0] == vid_s
    n = vid_s.shape[0]
    check(float(one[37, 0]) == n and float(one[:, 0].sum()) == n,
          "one voxel: not every point counted in its row")
    check(float(sentinel[-1, 0]) == n and bool((sentinel[:-1] == 0).all()),
          "all on the sentinel: not every point counted in row V")
    check(int(kept.sum()) == n - 5000
          and float(dropped[:, 0].sum()) == float(feats_s[kept, 0].sum()),
          "out-of-range ids: not dropped")
    # One device operation a call (no memset, no second kernel) and no host
    # synchronisation, in both table branches.
    for name, (v, f, nv) in {"shared table": (vid_s, feats_s, cfg.n_voxels),
                             "global atomics": (vid_f, feats_f, fixed.n_voxels)}.items():
        check_one_launch(name, lambda: moment_scatter_sums(v, f, nv), moment_scatter_sums,
                         "scatter_kernel", report)
    for line in report:
        print(f"scatter vs index_add_, {line}")

    # -- sequence odometry ------------------------------------------------
    torch.cuda.synchronize()
    fused_moment_sums.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    out = run_odometry_device(scans, cfg, odo, device="cuda")
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    fused_launches = fused_moment_sums.launches
    seq_warm = warmups()
    iters = [f.iterations for f in out]
    check(len(out) == len(scans) - 1, f"{len(out)} frames out of {len(scans) - 1}")
    check(all(np.isfinite(f.X).all() and np.isfinite(f.pred_stds).all() for f in out),
          "non-finite X or pred_stds")
    check(not any(f.diverged for f in out), "a frame diverged")
    check(fused_launches == sum(iters) + len(scans) + seq_warm,
          f"fused launches {fused_launches} != iterations {sum(iters)} + prepares {len(scans)} "
          f"+ warm-ups before capture {seq_warm}")
    ate = trajectory_ate(out, gt)
    print(f"sequence odometry (compiled): {len(out)} frames in {path_s:.2f} s with the graphs' "
          f"capture, fused launches {fused_launches} = {sum(iters)} iterations + {len(scans)} "
          f"prepares + {seq_warm} warm-ups before capture, "
          f"mean iterations/frame {np.mean(iters):.3f}, ATE {ate * 100:.3f} cm")
    check(ate <= ATE_MAX_M, f"ATE {ate * 100:.3f} cm above {ATE_MAX_M * 100} cm")

    # -- DNN-filtered odometry --------------------------------------------
    # n_pre = max(min(dnn_start_iter, n_iters - 1), 1) plain iterations, then
    # n_post filtered ones, each with one filter pass (one fused-moments
    # launch over the aligned scan, refine_steps encoder launches).
    n_pre = max(min(dcfg.dnn_start_iter, dcfg.n_iters - 1), 1)
    n_post = dcfg.n_iters - n_pre
    torch.cuda.synchronize()
    fused_moment_sums.launches = 0
    bias_encoder_pool.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    dout = list(OdometryPipeline(dcfg, odo, device="cuda").run(scans))
    torch.cuda.synchronize()
    dnn_s = time.perf_counter() - t0
    dnn_fused, enc_launches = fused_moment_sums.launches, bias_encoder_pool.launches
    dnn_warm, enc_warm = warmups(), warmups("bias_encoder_pool")
    diters = [f.iterations for f in dout]
    n_frames = len(dout)
    check(n_frames == len(scans) - 1, f"DNN drive: {n_frames} frames out of {len(scans) - 1}")
    check(all(np.isfinite(f.X).all() and np.isfinite(f.pred_stds).all() for f in dout),
          "DNN drive: non-finite X or pred_stds")
    check(not any(f.diverged for f in dout), "DNN drive: a frame diverged")
    want_enc = n_frames * n_post * dcfg.dnn_refine_steps + enc_warm
    check(enc_launches == want_enc,
          f"encoder launches {enc_launches} != {want_enc - enc_warm} filtered iterations + "
          f"{enc_warm} warm-ups before capture")
    want_fused = sum(diters) + n_frames * n_post + len(scans) + dnn_warm
    check(dnn_fused == want_fused,
          f"DNN drive: fused launches {dnn_fused} != iterations {sum(diters)} + filter "
          f"passes {n_frames * n_post} + prepares {len(scans)} + warm-ups {dnn_warm}")
    dnn_ate = trajectory_ate(dout, gt)
    t0 = time.perf_counter()
    dout_eager = list(eager(OdometryPipeline(dcfg, odo, device="cuda")).run(scans))
    torch.cuda.synchronize()
    dnn_eager_s = time.perf_counter() - t0
    dnn_eager_ate = trajectory_ate(dout_eager, gt)
    print(f"DNN-filtered odometry (compiled): {n_frames} frames in {dnn_s:.2f} s with the "
          f"graphs' capture, n_pre {n_pre}, n_post {n_post}, encoder launches {enc_launches} "
          f"= {want_enc - enc_warm} + {enc_warm} warm-ups, fused launches {dnn_fused} = "
          f"{sum(diters)} iterations + {n_frames * n_post} filter passes + {len(scans)} "
          f"prepares + {dnn_warm} warm-ups, mean iterations/frame {np.mean(diters):.3f}, "
          f"ATE {dnn_ate * 100:.4f} cm (eager: {dnn_eager_ate * 100:.4f} cm in "
          f"{dnn_eager_s:.2f} s; JAX package on the CPU: {DNN_ATE_REF_M * 100:.4f} cm)")
    print(f"DNN-filtered odometry: n_rejected per frame {[f.n_rejected for f in dout]}")
    for what, a in (("compiled", dnn_ate), ("eager", dnn_eager_ate)):
        check(a <= DNN_ATE_MAX_M,
              f"DNN drive ({what}) ATE {a * 100:.4f} cm above {DNN_ATE_MAX_M * 100:.4f} cm")

    # -- pallas moments ---------------------------------------------------
    pcfg = cfg.replace(moment_method="pallas")
    torch.cuda.synchronize()
    moment_scatter_sums.launches = 0
    pout = run_odometry_device(scans[:PALLAS_FRAMES], pcfg, odo, device="cuda")
    torch.cuda.synchronize()
    scat_launches = moment_scatter_sums.launches
    piters = [f.iterations for f in pout]
    check(not any(f.diverged for f in pout), "pallas drive: a frame diverged")
    check(scat_launches == sum(piters) + PALLAS_FRAMES,
          f"scatter launches {scat_launches} != iterations {sum(piters)} + "
          f"prepares {PALLAS_FRAMES}")
    pate = trajectory_ate(pout, gt)
    print(f"pallas moments: {len(pout)} frames, scatter launches {scat_launches} = "
          f"{sum(piters)} iterations + {PALLAS_FRAMES} prepares, ATE {pate * 100:.3f} cm")
    check(pate <= ATE_MAX_M, f"pallas drive ATE {pate * 100:.3f} cm above {ATE_MAX_M * 100} cm")

    # -- fixed radial mode ------------------------------------------------
    # Seeded 10 cm off the drive's 1 m step, as a warm start would be.
    x0 = np.array([0.9, 0.05, 0.0, 0.0, 0.0, 0.0], np.float32)
    fres = register_pair(scans[0], scans[1], x0, fixed, device="cuda")
    fcpu = register_pair(scans[0], scans[1], x0, fixed, device="cpu")
    fX, cX = fres.X.cpu().numpy(), fcpu.X.numpy()
    check(bool(np.isfinite(fX).all()) and abs(fX[0] - 1.0) < 0.1, f"fixed mode: X {fX}")
    check(float(np.abs(fX - cX).max()) <= 1e-3,
          f"fixed mode: card X {fX} vs CPU X {cX}")
    print(f"fixed radial mode (V = {fixed.n_voxels}): card X {np.round(fX, 5).tolist()}, "
          f"max |card - CPU| {float(np.abs(fX - cX).max()):.3e}")

    # -- windowed moments kernel vs plain, then its own path ----------------
    fanchors = voxel_anchors(fbounds, fixed)
    report = []
    win_cases = {
        "beam-major X=0": (pts, zero6, model.bounds, model.anchors, cfg),
        "beam-major X=1m/0.02rad": (pts, X_step, model.bounds, model.anchors, cfg),
        "shuffled X=1m/0.02rad": (cases["shuffled"][0], X_step, model.bounds, model.anchors,
                                  cfg),
        "fixed radial X=1m/0.02rad": (pts, X_step, fbounds, fanchors, fixed),
    }
    win_err, win_out = 0.0, {}
    for name, args in win_cases.items():
        err, got, ovf = windowed_compare(name, *args, report)
        win_err, win_out[name] = max(win_err, err), (got, ovf)
    check(win_out["shuffled X=1m/0.02rad"][1] > 0, "shuffled input did not overflow")
    # Edge inputs, overflow and counts exact: more point blocks than SMs,
    # narrower and wider windows, a ragged last block, one voxel, no member.
    ragged = torch.cat([pts, pts[:217]]).contiguous()
    win_edge = {
        "block 64": (pts, X_step, model.bounds, model.anchors, cfg, 64, WIN_WINDOW),
        "window 128": (pts, X_step, model.bounds, model.anchors, cfg, WIN_BLOCK, 128),
        "window 512": (pts, X_step, model.bounds, model.anchors, cfg, WIN_BLOCK, 512),
        "ragged N=65753": (ragged, X_step, model.bounds, model.anchors, cfg, WIN_BLOCK,
                           WIN_WINDOW),
        "one voxel, N=65536": (vox_pts, zero6, vox_model.bounds, vox_model.anchors, cfg,
                               WIN_BLOCK, WIN_WINDOW),
        "no member": (pts, X_step, far.bounds, far.anchors, cfg, WIN_BLOCK, WIN_WINDOW),
    }
    for name, (*args, blk, win) in win_edge.items():
        err, got, ovf = windowed_compare(name, *args, report, blk, win, exact=True)
        win_err, win_out[name] = max(win_err, err), (got, ovf)
    vox = win_out["one voxel, N=65536"]
    check(float(vox[0][:, 0].sum()) == vox_pts.shape[0] and vox[1] == 0,
          "windowed, one voxel: not every point counted in its row")
    check(bool((win_out["no member"][0] == 0).all()) and win_out["no member"][1] > 0,
          "windowed, no member: nonzero sums or no overflow")
    for name, args in {"adaptive": win_cases["beam-major X=1m/0.02rad"],
                       "fixed radial": win_cases["fixed radial X=1m/0.02rad"]}.items():
        check_one_launch(name, lambda: fused_moment_sums_windowed(*args, WIN_BLOCK, WIN_WINDOW),
                         fused_moment_sums_windowed, "windowed_kernel", report)
    got0, ovf0 = win_out["beam-major X=0"]
    if ovf0 == 0:
        # At X = 0 the raw and transformed range gates agree: with nothing
        # off-window the windowed sums are kernel #1's.
        dense = fused_moment_sums(pts, zero6, model.bounds, model.anchors, cfg)
        same = got0[:, 0] == dense[:, 0]
        err = (got0[same, :10] - dense[same, :10]).abs()
        check(bool((err <= ATOL + RTOL * dense[same, :10].abs()).all()),
              f"windowed vs fused at X=0: features differ by up to {float(err.max())}")
        report.append(f"beam-major X=0 vs kernel #1: rows with equal counts "
                      f"{int(same.sum())}/{same.numel()}, max |err| {float(err.max()):.3e}")
    for line in report:
        print(f"windowed moments vs plain, {line}")
    # Its own path: one windowed pass a frame at the sequence drive's
    # solutions against the previous frame's model, as the TPU package's
    # solver would have run it.
    drive = torch.from_numpy(scans).to(dev)
    models = [prepare_reference(drive[k], cfg) for k in range(drive.shape[0] - 1)]
    torch.cuda.synchronize()
    fused_moment_sums_windowed.launches = 0
    win_path = [fused_moment_sums_windowed(drive[k + 1], torch.from_numpy(out[k].X).to(dev),
                                           models[k].bounds, models[k].anchors, cfg,
                                           WIN_BLOCK, WIN_WINDOW)
                for k in range(len(models))]
    torch.cuda.synchronize()
    win_launches = fused_moment_sums_windowed.launches
    check(win_launches == len(out), f"windowed launches {win_launches} != {len(out)} frames")
    check(all(bool(torch.isfinite(s).all()) for s, _ in win_path), "non-finite windowed sums")
    win_ovf = [int(o) for _, o in win_path]
    print(f"windowed moments path: {win_launches} launches (one a frame at the drive's "
          f"solutions), overflow a frame {win_ovf}")

    # -- keyframe odometry --------------------------------------------------
    kf_cfg = KeyframeConfig(spawn_distance=3.0, spawn_angle=0.3, delta_clamp=2.5)
    bm_cfg = BlockMapConfig()
    torch.cuda.synchronize()
    fused_moment_sums.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    kout, bm = run_keyframe_device(scans, cfg, kf_cfg, bm_cfg, device="cuda")
    torch.cuda.synchronize()
    kf_s = time.perf_counter() - t0
    kf_fused, kf_warm = fused_moment_sums.launches, warmups()
    kf_idx = [0] + [f.index for f in kout if f.is_keyframe]
    kiters = sum(f.iterations for f in kout)
    check(len(kout) == len(scans) - 1, f"keyframe drive: {len(kout)} frames")
    check(all(np.isfinite(f.X).all() and np.isfinite(f.pred_stds).all() for f in kout),
          "keyframe drive: non-finite X or pred_stds")
    check(not any(f.diverged for f in kout), "keyframe drive: a frame diverged")
    check(kf_fused == kiters + len(kf_idx) + kf_warm,
          f"keyframe drive: fused launches {kf_fused} != iterations {kiters} + "
          f"keyframe prepares {len(kf_idx)} + warm-ups {kf_warm}")
    check(bm.n_blocks == len(kf_idx), f"block map holds {bm.n_blocks} blocks, "
          f"{len(kf_idx)} keyframes spawned")
    # Every frame inserts K stratified samples once (spawn frames as their
    # block's seed), less the samples that fall on range-gated rows: about
    # K times each frame's share of them.
    K = bm_cfg.points_per_scan
    gated = (torch.sum(drive * drive, dim=-1) <= cfg.min_range**2).double().mean(dim=1)
    want_fill = float((K * (1.0 - gated)).sum())
    sigma = float(torch.sqrt((K * gated * (1.0 - gated)).sum()))
    fill = int(bm.valid.sum())
    check(abs(fill - want_fill) <= 4.0 * sigma + 1.0,
          f"block map holds {fill} points, expected {want_fill:.1f} +- {4 * sigma + 1:.1f}")
    kodo = KeyframeOdometry(cfg, kf_cfg, bm_cfg, device="cuda")
    khost = kodo.run(scans)
    check(kodo.keyframe_indices == kf_idx,
          f"keyframe indices: host loop {kodo.keyframe_indices}, device runner {kf_idx}")
    check(not any(f.diverged for f in khost), "keyframe host loop: a frame diverged")
    kf_ate, kf_host_ate = trajectory_ate(kout, gt), trajectory_ate(khost, gt)
    keager = eager(KeyframeOdometry(cfg, kf_cfg, bm_cfg, device="cuda"))
    kf_eager_ate = trajectory_ate(keager.run(scans), gt)
    print(f"keyframe odometry (compiled): {len(kout)} frames in {kf_s:.2f} s with the graphs' "
          f"capture, keyframes {kf_idx} (JAX package on the CPU: {KF_INDICES_REF}), fused "
          f"launches {kf_fused} = {kiters} iterations + {len(kf_idx)} keyframe prepares + "
          f"{kf_warm} warm-ups, block map {fill} points in {bm.n_blocks} blocks (expected "
          f"{want_fill:.1f}), ATE {kf_ate * 100:.4f} cm, host loop {kf_host_ate * 100:.4f} cm "
          f"(eager host loop: {kf_eager_ate * 100:.4f} cm, keyframes "
          f"{keager.keyframe_indices}; JAX package on the CPU: {KF_ATE_REF_M * 100:.4f} cm)")
    for name, a in (("device runner", kf_ate), ("host loop", kf_host_ate),
                    ("eager host loop", kf_eager_ate)):
        check(a <= KF_ATE_REF_M + ATE_SLACK_M,
              f"keyframe {name} ATE {a * 100:.4f} cm above "
              f"{(KF_ATE_REF_M + ATE_SLACK_M) * 100:.4f} cm")

    # -- DNN-filtered keyframe odometry -----------------------------------
    torch.cuda.synchronize()
    fused_moment_sums.launches = 0
    bias_encoder_pool.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    dkodo = KeyframeOdometry(dcfg, kf_cfg, bm_cfg, device="cuda")
    dkout = dkodo.run(scans)
    torch.cuda.synchronize()
    dkf_s = time.perf_counter() - t0
    dkf_fused, dkf_enc = fused_moment_sums.launches, bias_encoder_pool.launches
    dkf_warm, dkf_enc_warm = warmups(), warmups("bias_encoder_pool")
    dk_iters = sum(f.iterations for f in dkout)
    check(len(dkout) == len(scans) - 1, f"DNN keyframe drive: {len(dkout)} frames")
    check(all(np.isfinite(f.X).all() and np.isfinite(f.pred_stds).all() for f in dkout),
          "DNN keyframe drive: non-finite X or pred_stds")
    check(not any(f.diverged for f in dkout), "DNN keyframe drive: a frame diverged")
    want_enc = len(dkout) * n_post * dcfg.dnn_refine_steps
    check(dkf_enc == want_enc + dkf_enc_warm,
          f"DNN keyframe drive: encoder launches {dkf_enc} != {want_enc} + {dkf_enc_warm} "
          "warm-ups")
    n_kf = len(dkodo.keyframe_indices)
    want_fused = dk_iters + len(dkout) * n_post + n_kf
    check(dkf_fused == want_fused + dkf_warm,
          f"DNN keyframe drive: fused launches {dkf_fused} != iterations {dk_iters} + filter "
          f"passes {len(dkout) * n_post} + keyframe prepares {n_kf} + warm-ups {dkf_warm}")
    dkf_ate = trajectory_ate(dkout, gt)
    dkeager = eager(KeyframeOdometry(dcfg, kf_cfg, bm_cfg, device="cuda"))
    dkf_eager_ate = trajectory_ate(dkeager.run(scans), gt)
    print(f"DNN-filtered keyframe odometry (compiled): {len(dkout)} frames in {dkf_s:.2f} s "
          f"with the graphs' capture, keyframes {dkodo.keyframe_indices} (JAX package on the "
          f"CPU: {DNN_KF_INDICES_REF}), encoder launches {dkf_enc} = {want_enc} + "
          f"{dkf_enc_warm} warm-ups, fused launches {dkf_fused} = {dk_iters} iterations + "
          f"{len(dkout) * n_post} filter passes + {n_kf} keyframe prepares + {dkf_warm} "
          f"warm-ups, ATE {dkf_ate * 100:.4f} cm (eager: {dkf_eager_ate * 100:.4f} cm, "
          f"keyframes {dkeager.keyframe_indices}; JAX package on the CPU: "
          f"{DNN_KF_ATE_REF_M * 100:.4f} cm)")
    for what, a in (("compiled", dkf_ate), ("eager", dkf_eager_ate)):
        check(a <= DNN_KF_ATE_REF_M + ATE_SLACK_M,
              f"DNN keyframe ({what}) ATE {a * 100:.4f} cm above "
              f"{(DNN_KF_ATE_REF_M + ATE_SLACK_M) * 100:.4f} cm")

    # -- MapMaker -----------------------------------------------------------
    # The compiled route (map_step_jit), its graphs captured here with no
    # host synchronisation, against the eager route frame by frame.
    mcfg, map_cfg = PROFILES["mapping"], MapConfig()
    torch.cuda.synchronize()
    fused_moment_sums.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    maker = MapMaker(mcfg, map_cfg, odo, device="cuda")
    with graphs.sync_debug("error"):
        mout = [f for f in (maker.step(s) for s in scans) if f is not None]
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    map_fused, map_warm = fused_moment_sums.launches, warmups()
    fused_moment_sums.launches = 0
    t0 = time.perf_counter()
    maker_e = eager(MapMaker(mcfg, map_cfg, odo, device="cuda"))
    mout_e = [f for f in (maker_e.step(s) for s in scans) if f is not None]
    torch.cuda.synchronize()
    map_eager_s, map_eager_fused = time.perf_counter() - t0, fused_moment_sums.launches
    check(len(mout) == len(scans) - 1, f"MapMaker: {len(mout)} frames")
    check(not any(f.diverged for f in mout), "MapMaker: a frame diverged")
    check(all(np.isfinite(f.X).all() and np.isfinite(f.pred_stds).all() for f in mout),
          "MapMaker: non-finite X or pred_stds")
    # The mapping profile runs every solve to n_iters (no early exit), and
    # every scan is prepared once.
    want_fused = len(mout) * mcfg.n_iters + len(scans)
    check(map_fused == want_fused + map_warm and map_eager_fused == want_fused,
          f"MapMaker: fused launches compiled {map_fused} != {want_fused} + {map_warm} "
          f"warm-ups, eager {map_eager_fused}")
    n_ok = (torch.sum(drive * drive, dim=-1) > mcfg.min_range**2).sum(dim=1)
    want_fill = min(map_cfg.capacity, int(torch.clamp(n_ok, max=map_cfg.points_per_scan).sum()))
    check(mout[-1].n_map_points == want_fill,
          f"MapMaker: ring holds {mout[-1].n_map_points} points, expected {want_fill}")
    map_dx = max(float(np.abs(f.X - g.X).max()) for f, g in zip(mout, mout_e))
    map_diff = [f.index for f, g in zip(mout, mout_e)
                if not (np.array_equal(f.X, g.X) and np.array_equal(f.pred_stds, g.pred_stds)
                        and (f.diverged, f.n_map_points) == (g.diverged, g.n_map_points))]
    ring_equal = all(torch.equal(getattr(maker.state, k), getattr(maker_e.state, k))
                     for k in ("points", "valid", "trail"))
    check((maker.state.write_ptr, maker.state.trail_len)
          == (maker_e.state.write_ptr, maker_e.state.trail_len)
          and [(f.diverged, f.n_map_points) for f in mout]
          == [(f.diverged, f.n_map_points) for f in mout_e],
          "MapMaker: compiled flags, fill or counters differ from the eager route's")
    check(map_dx <= 1e-6, f"MapMaker: compiled X {map_dx:.3e} m from the eager route's")
    poses = [np.eye(4)]
    for f in mout:
        poses.append(poses[-1] @ np_pose_matrix(f.X))
    map_ate = pose_ate(poses[1:], gt)
    print(f"MapMaker (compiled, graphs captured under set_sync_debug_mode('error')): "
          f"{len(mout)} frames in {map_s:.2f} s with the captures (eager route "
          f"{map_eager_s:.2f} s), fused launches {map_fused} = {len(mout)} x {mcfg.n_iters} "
          f"iterations + {len(scans)} prepares + {map_warm} warm-ups (eager "
          f"{map_eager_fused}), ring fill {mout[-1].n_map_points} (expected {want_fill}), ATE "
          f"{map_ate * 100:.4f} cm (JAX package on the CPU: {MAP_ATE_REF_M * 100:.4f} cm); "
          f"against the eager route frame by frame: max |dX| {map_dx:.3e} m, bit-identical "
          f"frames: {not map_diff}" + (f" (first differing: {map_diff[:3]})" if map_diff else "")
          + f", rings equal: {ring_equal}")
    check(map_ate <= MAP_ATE_REF_M + ATE_SLACK_M,
          f"MapMaker ATE {map_ate * 100:.4f} cm above "
          f"{(MAP_ATE_REF_M + ATE_SLACK_M) * 100:.4f} cm")

    # -- ScanMatcher ----------------------------------------------------------
    matcher = ScanMatcher(cfg, divergence_clamp=odo.divergence_clamp, device="cuda")
    sres = [matcher.step(s) for s in scans[:MATCHER_FRAMES]]
    statuses = [r.status for r in sres]
    check(statuses == ["first_frame"] + ["ok"] * (MATCHER_FRAMES - 1),
          f"ScanMatcher statuses {statuses}")
    check(all(r.aligned.shape == scans[0].shape and np.isfinite(r.aligned).all() for r in sres),
          "ScanMatcher: aligned clouds not finite or misshapen")
    print(f"ScanMatcher: statuses {statuses}, X[0] "
          f"{[round(float(r.X[0]), 4) for r in sres[1:]]}, trail {sres[-1].trail.shape}")

    # -- times ------------------------------------------------------------
    model0 = prepare_reference(drive[0], cfg)
    samples_0 = model_voxel_samples(model0, drive[0], dcfg)

    def odometry_pass():
        m, x = model0, torch.zeros(6, device=dev)
        for k in range(1, drive.shape[0]):
            res, m = odometry_step(m, drive[k], x, cfg)
            x = res.X

    def dnn_pass():
        m, s, x = model0, samples_0, torch.zeros(6, device=dev)
        for k in range(1, drive.shape[0]):
            res, m, s, _ = odometry_step_dnn(m, drive[k - 1], s, drive[k], x, dcfg, net)
            x = res.X

    steps = drive.shape[0] - 1
    frame_ms = median_ms(odometry_pass, reps=1, rounds=1) / steps
    dnn_frame_ms = median_ms(dnn_pass, reps=1, rounds=1) / steps
    # Keyframe frames: the whole drive through a fresh runner (its first
    # frame is the seed spawn, no solve).  One round each: phase 27 times
    # these frames again, in turns with the compiled ones, and the MapMaker
    # frame only there.
    kf_frame_ms = median_ms(
        lambda: eager(KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev)).run(drive),
        reps=1, rounds=1) / steps
    dkf_frame_ms = median_ms(
        lambda: eager(KeyframeOdometry(dcfg, kf_cfg, bm_cfg, device=dev)).run(drive),
        reps=1, rounds=1) / steps

    def pallas_pass():
        m, x = model0, torch.zeros(6, device=dev)
        for k in range(1, PALLAS_FRAMES):
            res, m = odometry_step(m, drive[k], x, pcfg)
            x = res.X

    pallas_frame_ms = median_ms(pallas_pass, reps=1, rounds=1) / (PALLAS_FRAMES - 1)

    fused_ms, fused_ev = kernel_times(
        lambda: fused_moment_sums(pts, X_step, model.bounds, model.anchors, cfg), reps=100)
    fused_plain_ms, fused_plain_ev = kernel_times(
        lambda: fused_moment_sums_reference(pts, X_step, model.bounds, model.anchors, cfg),
        reps=20)
    members = float(fused_moment_sums_reference(
        pts, X_step, model.bounds, model.anchors, cfg)[:, 0].sum())
    n, v1 = pts.shape[0], cfg.n_voxels + 1
    # Bytes: points, X, bounds, anchors read once; (V+1, 16) sums written.
    # Operations: per point the raw norm (6), transform (18), nan scrub and
    # r' (6), theta/phi with atan2/acos counted as 20 each (43), binning and
    # gates (10); per member the anchor offset (3) and 10 accumulated
    # features (6 products + 10 adds).
    fused_bound, fused_by = bound(n * 12 + 6 * 4 + v1 * 8 + v1 * 12 + v1 * 16 * 4,
                                  n * 83 + members * 19, PEAK_FP32_PER_S)

    win_args = (pts, X_step, model.bounds, model.anchors, cfg, WIN_BLOCK, WIN_WINDOW)
    win_ms, win_ev = kernel_times(lambda: fused_moment_sums_windowed(*win_args), reps=100)
    win_plain_ms, win_plain_ev = kernel_times(
        lambda: fused_moment_sums_windowed_reference(*win_args), reps=20)
    win_members = float(fused_moment_sums_windowed_reference(*win_args)[0][:, 0].sum())
    # As kernel #1 (no raw-range gate: 6 operations fewer a point), plus
    # the overflow word written.
    win_bound, win_by = bound(n * 12 + 6 * 4 + v1 * 8 + v1 * 12 + v1 * 16 * 4 + 4,
                              n * 77 + win_members * 19, PEAK_FP32_PER_S)

    w = net.encoder_weights()
    enc_ms, enc_ev = kernel_times(lambda: bias_encoder_pool(x_enc, w), reps=20)
    enc_plain_ms, enc_plain_ev = kernel_times(lambda: encoder_pool_reference(x_enc, w), reps=5)
    b, p, _ = x_enc.shape
    # Operations: 2 (4*64 + 64*128 + 128*256) flop a point (bf16 products);
    # bytes: the input read once, the codes written, the weights read.
    enc_bytes = b * p * 16 + b * 256 * 4 + sum(t.numel() * t.element_size() for t in w)
    enc_bound, enc_by = bound(enc_bytes, 2.0 * (4 * 64 + 64 * 128 + 128 * 256) * b * p,
                              PEAK_BF16_PER_S)
    # The second floor: ~16 float32 instructions an element of the three
    # LayerNorm epilogues (64 + 128 + 256 elements a point), at the card's
    # float32 issue rate (half the published flop rate, which counts an FMA
    # as two).
    epi_instr = 16.0 * (64 + 128 + 256) * b * p
    epi_floor = epi_instr / (PEAK_FP32_PER_S / 2) * 1e3

    scat_ms, scat_ev = kernel_times(
        lambda: moment_scatter_sums(vid_s, feats_s, cfg.n_voxels), reps=100)
    scat_plain_ms, scat_plain_ev = kernel_times(
        lambda: moment_scatter_reference(vid_s, feats_s, cfg.n_voxels), reps=100)
    table = torch.zeros((v1, 16), device=dev)
    vid_long = vid_s.long()
    scat_lib_ms, scat_lib_ev = kernel_times(
        lambda: table.zero_().index_add_(0, vid_long, feats_s), reps=100)
    # Bytes: ids and features read once, the table written; one add an element.
    scat_bound, scat_by = bound(n * 4 + n * 64 + v1 * 64, n * 16, PEAK_FP32_PER_S)

    print(f"times ({card}), eager frames (phases 26-27 time the compiled ones): odometry "
          f"frame {frame_ms:.4f} ms, DNN-filtered frame {dnn_frame_ms:.4f} ms, keyframe frame "
          f"{kf_frame_ms:.4f} ms, DNN-filtered keyframe frame {dkf_frame_ms:.4f} ms, "
          f"pallas-moments frame {pallas_frame_ms:.4f} ms (the MapMaker frame: phase 27)")
    print(f"times ({card}), device ms a call by the profiler (CUDA events over "
          f"back-to-back calls in brackets):")
    print(f"  fused moments {fused_ms:.5f} ({fused_ev:.5f}) at N={n} V={cfg.n_voxels}, plain "
          f"{fused_plain_ms:.4f} ({fused_plain_ev:.4f}), bound {fused_bound:.6f} ({fused_by}); "
          f"no single PyTorch call computes this fused function, so library_ms is null")
    print(f"  windowed moments {win_ms:.5f} ({win_ev:.5f}) at N={n} V={cfg.n_voxels} block "
          f"{WIN_BLOCK} window {WIN_WINDOW}, plain {win_plain_ms:.4f} ({win_plain_ev:.4f}), "
          f"bound {win_bound:.6f} ({win_by}); no single PyTorch call computes this fused "
          f"function, so library_ms is null")
    print(f"  encoder {enc_ms:.5f} ({enc_ev:.5f}) at B={b} P={p} tile 16, plain "
          f"{enc_plain_ms:.4f} ({enc_plain_ev:.4f}), bound {enc_bound:.6f} ({enc_by}: "
          f"{enc_bytes} B), epilogue floor {epi_floor:.6f} ({epi_instr:.3e} float32 "
          f"instructions); no single PyTorch call computes Dense+LayerNorm+ReLU x3 + "
          f"max-pool, so library_ms is null")
    print(f"  scatter {scat_ms:.5f} ({scat_ev:.5f}) at N={n} V={cfg.n_voxels}, plain "
          f"{scat_plain_ms:.5f} "
          f"({scat_plain_ev:.5f}), index_add_ {scat_lib_ms:.5f} ({scat_lib_ev:.5f}), bound "
          f"{scat_bound:.6f} ({scat_by})")
    # -- 14. C6: a grid above the fused kernel's shared-memory table ----------
    from icet_tpu_torch.solver import moment_route

    big = cfg.replace(n_theta=150, n_phi=48)
    check(moment_route(big) == "plain" and moment_route(cfg) == "fused",
          f"routes: {moment_route(big)} at V={big.n_voxels}, {moment_route(cfg)} at "
          f"V={cfg.n_voxels}")
    x0 = np.array([0.9, 0.05, 0.0, 0.0, 0.0, 0.0], np.float32)
    torch.cuda.synchronize()
    fused_before = fused_moment_sums.launches
    bres = register_pair(scans[0], scans[1], x0, big, device="cuda")
    torch.cuda.synchronize()
    big_fused = fused_moment_sums.launches - fused_before
    bcpu = register_pair(scans[0], scans[1], x0, big, device="cpu")
    bX, bcX = bres.X.cpu().numpy(), bcpu.X.numpy()
    check(big_fused == 0, f"V={big.n_voxels}: {big_fused} fused launches")
    check(bool(np.isfinite(bX).all()) and abs(bX[0] - 1.0) < 0.1, f"V={big.n_voxels}: X {bX}")
    check(float(np.abs(bX - bcX).max()) <= 1e-3, f"V={big.n_voxels}: card X {bX} vs CPU {bcX}")
    print(f"C6, 150x48 grid (V = {big.n_voxels}): route {moment_route(big)}, fused launches "
          f"{big_fused}, {bres.iterations} iterations, card X {np.round(bX, 5).tolist()}, "
          f"max |card - CPU| {float(np.abs(bX - bcX).max()):.3e}")

    # -- 15. BiasNet training at full width ------------------------------------
    import tempfile

    from icet_tpu_torch.models.bias_net import (
        apply_bias_net,
        load_pretrained,
        make_patch_batch,
        train_bias_net,
        train_step,
    )
    from icet_tpu_torch.convert import bias_net_params_to_numpy
    from icet_tpu_torch.models.train_data import raycast_batch_iter, train_bias_net_mixed
    from icet_tpu_torch.utils.checkpoint import save_checkpoint

    torch.cuda.synchronize()
    bias_encoder_pool.launches = 0
    t0 = time.perf_counter()
    tstate, tlosses, (ps1, ps2) = train_bias_net_mixed(
        steps=TRAIN_STEPS, batch=256, sample_pts=100, lr=1e-3, seed=0, n_pairs=6,
        device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check(bias_encoder_pool.launches == 0,
          "training launched the encoder kernel (it trains through flax's forward)")
    check(all(np.isfinite(tlosses)), "training: a loss is not finite")
    first10, last10 = float(np.mean(tlosses[:10])), float(np.mean(tlosses[-10:]))
    check(last10 < first10, f"training: last ten {last10:.4f} not below first ten {first10:.4f}")
    pgen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    _, plosses = train_bias_net(pgen, steps=40, batch=128, sample_pts=32, device="cuda")
    patch_s = time.perf_counter() - t0
    check(plosses[-1] < 0.7 * plosses[0],
          f"40-step patch case: last loss {plosses[-1]:.4f} not below 0.7 x {plosses[0]:.4f}")
    print(f"BiasNet training ({len(ps1)} raycast voxel pairs): {TRAIN_STEPS} steps in "
          f"{train_s:.2f} s with the pairs' build, loss first ten {first10:.4f} -> last ten "
          f"{last10:.4f} (JAX package on the CPU: {MIXED_LOSS_REF[0]:.4f} -> "
          f"{MIXED_LOSS_REF[1]:.4f}); "
          f"40-step patch case in {patch_s:.2f} s, loss {plosses[0]:.4f} -> {plosses[-1]:.4f} "
          f"(JAX package on the CPU: {PATCH_LOSS_REF[0]:.4f} -> {PATCH_LOSS_REF[1]:.4f})")
    # The trained weights through the npz format and the serving encoder.
    report = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bias_net_trained.npz")
        save_checkpoint(path, bias_net_params_to_numpy(tstate.model))
        served = load_pretrained(path=path).to(dev)
    xb, _ = make_patch_batch(torch.Generator(device=dev).manual_seed(5), 64, 100)
    enc_err = max(enc_err, encoder_compare("trained net, drive filter input", served, x_enc,
                                           report),
                  encoder_compare("trained net, patch batch", served, xb, report))
    with torch.no_grad():
        fwd_err = float((served(xb) - tstate.model(xb)).abs().max())
    check(fwd_err <= OUT_ATOL, f"trained net: serving vs training forward differ by {fwd_err}")
    for line in report:
        print(f"encoder vs plain, {line}")
    # The bundled s100 net through the serving path (kernel #4).
    xm, ym = make_patch_batch(torch.Generator(device=dev).manual_seed(7), 64, 100)
    torch.cuda.synchronize()
    bias_encoder_pool.launches = 0
    mae = float(torch.mean(torch.abs(apply_bias_net(net, xm) - ym)))
    mae_launches = bias_encoder_pool.launches
    check(mae_launches == 1, f"bundled net: {mae_launches} encoder launches")
    check(mae < 0.12, f"bundled net: MAE {mae:.4f} m not below 0.12")
    # ms a training step: CUDA events around train_step, on the same
    # alternation of raycast and patch batches, after the run above.
    tgen = torch.Generator(device=dev).manual_seed(1)
    ray = raycast_batch_iter(ps1, ps2, tgen, 256)
    step_ms = []
    for i in range(TIMED_STEPS):
        xt, yt = next(ray) if i % 2 == 0 else make_patch_batch(tgen, 256, 100)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        tstate, _ = train_step(tstate, xt, yt)
        ev1.record()
        torch.cuda.synchronize()
        step_ms.append(ev0.elapsed_time(ev1))
    train_step_ms = float(np.median(step_ms[5:]))
    print(f"BiasNet training: trained net vs training forward max |diff| {fwd_err:.3e}; bundled "
          f"s100 net MAE {mae:.4f} m through the encoder kernel ({mae_launches} launch); "
          f"train_step {train_step_ms:.4f} ms (median of steps 6-{TIMED_STEPS}, CUDA events, "
          f"batch 256, S = 100; {card})")

    # -- 16. the backbone kernels, then the 10,000-pose solve -----------------
    from icet_tpu_torch.ops.tridiag import (
        tridiag_apply,
        tridiag_apply_reference,
        tridiag_factor,
        tridiag_factor_reference,
    )
    from icet_tpu_torch.pose_graph import (
        _sparse_normals,
        optimize_poses_sparse,
        optimize_poses_sparse_eager,
    )

    t0 = time.perf_counter()
    ring0, ring, ring_true = ring_graph(RING_POSES)
    ring_s = time.perf_counter() - t0
    b10, D10, _, _, E10 = _sparse_normals(torch.from_numpy(ring0).to(dev), ring.to(dev),
                                          1e8, 1e-6)
    r10 = (-b10).contiguous()
    report, tri = [], {}
    for K in (RING_POSES, 1000):
        D, E, r = D10[:K].contiguous(), E10[:K - 1].contiguous(), r10[:K].contiguous()
        S, U = tridiag_factor(D, E)
        S2, U2 = tridiag_factor(D, E)
        y = tridiag_apply(S, U, r)
        y2 = tridiag_apply(S, U, r)
        ev0, ev1, ev2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        ev0.record()
        Sr, Ur = tridiag_factor_reference(D, E)
        ev1.record()
        yr = tridiag_apply_reference(Sr, Ur, r)
        ev2.record()
        torch.cuda.synchronize()
        errs = (block_rel_err(S, Sr), block_rel_err(U, Ur), block_rel_err(y[None], yr[None]))
        check(all(np.isfinite(errs)) and max(errs) <= TRI_RTOL,
              f"backbone K={K}: relative errors S_inv/U/y {errs}")
        rtr = max(float((S - S2).abs().max()), float((U - U2).abs().max()),
                  float((y - y2).abs().max()))
        tri[K] = dict(D=D, E=E, r=r, S=S, U=U, err=float((y - yr).abs().max()),
                      plain_factor_ms=ev0.elapsed_time(ev1), plain_apply_ms=ev1.elapsed_time(ev2))
        report.append(f"K={K}: relative error S_inv {errs[0]:.3e}, U {errs[1]:.3e}, y "
                      f"{errs[2]:.3e}; max |y err| {tri[K]['err']:.3e}; run-to-run max |diff| "
                      f"{rtr:.3e}")
    # Synthetic chains (backbone_cases): the ring's edges and the forced
    # fallbacks; one launch a call, counted by the wrappers.
    for K, forced, offset in backbone_cases():
        Dn, En, rn = backbone_chain(K, seed=K, fallback_at=forced)
        D, E, r = (on_device(x, dev, offset) for x in (Dn, En, rn))
        before = (tridiag_factor.launches, tridiag_apply.launches)
        S, U = tridiag_factor(D, E)
        y = tridiag_apply(S, U, r)
        counted = (tridiag_factor.launches - before[0], tridiag_apply.launches - before[1])
        Sr, Ur = tridiag_factor_reference(D, E)
        yr = tridiag_apply_reference(Sr, Ur, r)
        torch.cuda.synchronize()
        errs = (block_rel_err(S, Sr), block_rel_err(U, Ur), block_rel_err(y[None], yr[None]))
        check(all(np.isfinite(errs)) and max(errs) <= TRI_RTOL and counted == (1, 1),
              f"backbone K={K}, fallbacks {forced}, offset {offset}: relative errors "
              f"S_inv/U/y {errs}, launches {counted}")
        taken = [k for k in range(1, K) if bool((U[k - 1] == 0).all())]
        taken_plain = [k for k in range(1, K) if bool((Ur[k - 1] == 0).all())]
        check(set(forced) <= set(taken) and taken == taken_plain,
              f"backbone K={K}: fallbacks at {taken}, plain at {taken_plain}, forced {forced}")
        report.append(f"K={K}{', inputs one float in' if offset else ''}: relative error "
                      f"S_inv {errs[0]:.3e}, U {errs[1]:.3e}, y {errs[2]:.3e}; fallbacks at "
                      f"{taken} (plain {taken_plain}); one launch each")
    big_k = tri[RING_POSES]
    check_one_launch("apply K=10000",
                     lambda: tridiag_apply(big_k["S"], big_k["U"], big_k["r"]),
                     tridiag_apply, "tridiag_apply_kernel", report, reps=10,
                     records_required=False)
    check_one_launch("factor K=10000", lambda: tridiag_factor(big_k["D"], big_k["E"]),
                     tridiag_factor, "tridiag_factor_kernel", report, reps=10,
                     records_required=False)
    for line in report:
        print(f"backbone vs plain, {line}")
    # The compiled solve (its three graphs captured here with no host
    # synchronisation; the backbone's launches counted through the replays,
    # the warm-ups before the captures beside them), against the eager loop.
    torch.cuda.synchronize()
    tridiag_factor.launches = tridiag_apply.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    with graphs.sync_debug("error"):
        ring_opt_t = optimize_poses_sparse(ring0, ring, 10, 25, device="cuda")
    torch.cuda.synchronize()
    ring_first_s = time.perf_counter() - t0
    ring_launches = (tridiag_factor.launches, tridiag_apply.launches)
    ring_warm = (warmups("tridiag_factor"), warmups("tridiag_apply"))
    check((ring_launches[0] - ring_warm[0], ring_launches[1] - ring_warm[1]) == (10, 10 * 26),
          f"10k solve: factor/apply launches {ring_launches} less warm-ups {ring_warm}, "
          f"expected (10, 260)")
    tridiag_factor.launches = tridiag_apply.launches = 0
    ring_eager_t = optimize_poses_sparse_eager(ring0, ring, 10, 25, device="cuda")
    torch.cuda.synchronize()
    ring_eager_launches = (tridiag_factor.launches, tridiag_apply.launches)
    check(ring_eager_launches == (10, 260), f"10k solve, eager: launches {ring_eager_launches}")
    ring_dx = float((ring_opt_t - ring_eager_t).abs().max())
    check(ring_dx <= 2e-3, f"10k solve: compiled states {ring_dx:.3e} from the eager loop's")
    # The normals' index_add_ sums with float atomics on the card, in no
    # fixed order: the eager loop against itself.
    ring_spread = float((optimize_poses_sparse_eager(ring0, ring, 10, 25, device="cuda")
                         - ring_eager_t).abs().max())
    ring_turns = {"eager": [], "compiled": []}
    for mode in ("eager", "compiled", "compiled", "eager"):
        solve = optimize_poses_sparse if mode == "compiled" else optimize_poses_sparse_eager
        ring_turns[mode].append(median_ms(lambda f=solve: f(ring0, ring, 10, 25, device="cuda"),
                                          reps=1, rounds=1))
    ring_solve_ms = float(np.mean(ring_turns["compiled"]))
    ring_opt = ring_opt_t.cpu().numpy()
    err0 = np.linalg.norm(ring0[:, :3] - ring_true[:, :3], axis=1).mean()
    err1 = np.linalg.norm(ring_opt[:, :3] - ring_true[:, :3], axis=1).mean()
    check(bool(np.isfinite(ring_opt).all()) and err1 < 0.5 * err0,
          f"10k solve: mean position error {err1:.4f} m from {err0:.4f} m")
    turns = (ring_turns["eager"][0], *ring_turns["compiled"], ring_turns["eager"][1])
    print(f"10k-pose solve (graph built in {ring_s:.1f} s): optimize_poses_sparse(states0, "
          f"graph, 10, 25) eager/compiled/compiled/eager {' / '.join(f'{t:.2f}' for t in turns)}"
          f" ms (CUDA events, {card}); compiled factor/apply launches {ring_launches} = "
          f"(10, 260) + warm-ups {ring_warm} (eager {ring_eager_launches}); the first "
          f"compiled call with its captures {ring_first_s:.2f} s; compiled against eager: max "
          f"|d state| {ring_dx:.3e}, bit-identical: {ring_dx == 0.0} (eager against eager: "
          f"{ring_spread:.3e}); mean position error {err0:.4f} -> {err1:.4f} m")

    # -- 17. the loop-closure drive at full width, through eval_citydrive ------
    from icet_tpu_torch.examples import eval_citydrive

    lc_argv = ["--frames", str(LC_DRIVE["n_frames"]), "--speed", str(LC_DRIVE["speed"]),
               "--beams", str(LC_DRIVE["n_beams"]), "--azimuth", str(LC_DRIVE["n_azimuth"]),
               "--scene", "block", "--rect", *map(str, LC_DRIVE["rect"]),
               "--radius", "6", "--min-gap", "80", "--device", "cuda"]
    import icet_tpu_torch.pose_graph as pose_graph

    lcfg = ICETConfig()
    torch.cuda.synchronize()
    fused_moment_sums.launches = tridiag_factor.launches = tridiag_apply.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    # The drive's calls of the back end, kept for the comparisons below and
    # phase 27's times.
    with spy(pose_graph, "close_loops") as lc_loops, \
            spy(pose_graph, "optimize_poses_sparse") as lc_solves:
        lc = eval_citydrive.run(eval_citydrive.build_parser().parse_args(lc_argv))
    torch.cuda.synchronize()
    lc_s = time.perf_counter() - t0
    # odometry, loop verification and the solve through the compiled paths:
    # less their warm-ups
    lc_fused = fused_moment_sums.launches - warmups()
    lc_tri = (tridiag_factor.launches - warmups("tridiag_factor"),
              tridiag_apply.launches - warmups("tridiag_apply"))
    n_lc = LC_DRIVE["n_frames"]
    check(lc["frames"] == n_lc - 1, f"loop-closure drive: {lc['frames']} frames")
    check(lc["divergences"] == 0, "loop-closure drive: a frame diverged")
    # Odometry: its iterations and one prepare a scan; close_loops: one
    # prepare a candidate pair and all n_iters iterations (ICETConfig() has
    # no early exit).
    want_lc = lc["iterations"] + n_lc + lc["loop_candidates"] * (1 + lcfg.n_iters)
    check(lc_fused == want_lc,
          f"loop-closure drive: fused launches {lc_fused} != iterations {lc['iterations']} + "
          f"prepares {n_lc} + {lc['loop_candidates']} candidate pairs x {1 + lcfg.n_iters}")
    check(lc["loop_factors"] >= 30, f"loop-closure drive: {lc['loop_factors']} verified loops")
    check(lc_tri == (10, 10 * 51), f"loop-closure solve: factor/apply launches {lc_tri}")
    st = lc["stages"]
    print(f"loop-closure drive through eval_citydrive.run ({n_lc} frames of "
          f"{LC_DRIVE['n_beams']}x{LC_DRIVE['n_azimuth']}, {lc_s:.1f} s with the drive's "
          f"raycasting): odometry ATE {lc['ate_odometry_cm']} cm (JAX package on the CPU: "
          f"{LC_ODO_ATE_REF_M * 100:.4f} cm), RPE {lc['rpe_t_cm']} cm / {lc['rpe_r_deg']} deg "
          f"a frame, {lc['loop_candidates']} candidates, {lc['loop_factors']} verified loops "
          f"(JAX package: {LC_LOOPS_REF}), refined ATE {lc['ate_refined_cm']} cm (JAX package "
          f"on the CPU: {LC_ATE_REF_M * 100:.4f} cm)")
    print(f"loop-closure drive times ({card}): odometry step {st['step']['mean_ms']:.2f} ms a "
          f"frame, close_loops {st['loops']['mean_ms'] / max(lc['loop_candidates'], 1):.2f} ms a "
          f"pair, pose-graph solve {st['solve']['mean_ms']:.2f} ms (StageTimer, synchronised); "
          f"fused launches {lc_fused} ({lc['iterations']} iterations + {n_lc} prepares + "
          f"{lc['loop_candidates']} x {1 + lcfg.n_iters}), factor/apply launches {lc_tri}")
    check(lc["ate_refined_cm"] < lc["ate_odometry_cm"],
          f"refined ATE {lc['ate_refined_cm']} cm not below odometry {lc['ate_odometry_cm']} cm")
    check(lc["ate_refined_cm"] <= (LC_ATE_REF_M + ATE_SLACK_M) * 100,
          f"refined ATE {lc['ate_refined_cm']} cm above "
          f"{(LC_ATE_REF_M + ATE_SLACK_M) * 100:.4f} cm")
    # The compiled loop verification against the eager route on the first
    # 16 candidates (one chunk), factor by factor.
    ((lc_args, lc_kw),), (lc_factors,) = lc_loops.args, lc_loops.results
    cands16 = lc_args[1][:16]
    with patched(pose_graph, "compiled_route", lambda c: False):
        eager16 = pose_graph.close_loops(lc_args[0], cands16, *lc_args[2:], **lc_kw)
    comp16 = [f for f in lc_factors if (f[0], f[1]) in set(cands16)]
    check([f[:2] for f in comp16] == [f[:2] for f in eager16],
          f"loop factors of the first 16 candidates: compiled {[f[:2] for f in comp16]}, "
          f"eager {[f[:2] for f in eager16]}")
    lc_dx = max([float(np.abs(a[2] - b[2]).max()) for a, b in zip(comp16, eager16)] or [0.0])
    lc_di = max([float(np.abs(a[3] - b[3]).max() / np.abs(b[3]).max())
                 for a, b in zip(comp16, eager16)] or [0.0])
    check(lc_dx <= 1e-4 and lc_di <= 1e-3, f"loop factors: compiled X {lc_dx:.3e} from eager, "
          f"information {lc_di:.3e} relative")
    print(f"loop factors of the first 16 candidates, compiled against eager: "
          f"{len(comp16)} kept by both, max |dX| {lc_dx:.3e}, information {lc_di:.3e} relative "
          f"to its largest entry; bit-identical: {lc_dx == 0.0 and lc_di == 0.0}")

    # Times of the backbone kernels at K = 10,000: one factor and one apply,
    # by CUDA events over back-to-back calls.  torch.profiler records only
    # about one in ten of these long launches on the H100 (phase 16's
    # one-launch check), and a launch's host time is below 0.1% of their
    # device time, so the events time the kernels.
    tri_f_ms = median_ms(lambda: tridiag_factor(big_k["D"], big_k["E"]), reps=5, rounds=3)
    tri_a_ms = median_ms(lambda: tridiag_apply(big_k["S"], big_k["U"], big_k["r"]), reps=20)
    k1 = tri[1000]
    tri_f1_ms = median_ms(lambda: tridiag_factor(k1["D"], k1["E"]), reps=20, rounds=3)
    tri_a1_ms = median_ms(lambda: tridiag_apply(k1["S"], k1["U"], k1["r"]), reps=50, rounds=3)
    tri_ms = tri_f_ms + tri_a_ms
    tri_plain_ms = big_k["plain_factor_ms"] + big_k["plain_apply_ms"]
    Kb = RING_POSES
    # Bytes: D, E read and S_inv, U written (factor); S_inv, U, r read and y
    # written (apply).  Operations a step: the factor's ~1,270 float64 flop
    # (the Cholesky ~115, six columns of L^-T L^-1 432, W = L^-1 E 216, the
    # 21 entries of D - W^T W 294, U = L^-T W 216), taken at the float64 rate
    # as float32-rate equivalents; the apply's 216 float32 flop (three 6x6
    # matrix-vector products).
    tri_bytes = 4 * (Kb * 36 + (Kb - 1) * 36) * 2 + 4 * (Kb * 36 + (Kb - 1) * 36 + 2 * Kb * 6)
    tri_ops = Kb * (1270 * PEAK_FP32_PER_S / PEAK_FP64_PER_S + 216)
    tri_bound, tri_by = bound(tri_bytes, tri_ops, PEAK_FP32_PER_S)
    # The chain's floor: each step depends on the one before.  Dependent
    # instructions a factor step: 7 (U) + 8 (S) + 12 divisions and square
    # roots of the Cholesky and 6 of the inverse at ~10 each + 60 products
    # and sums between them + 7 (L^-T L^-1) = 262; an apply step: 9 a sweep,
    # two sweeps.
    tri_chain_ms = Kb * (262 + 18) * FMA_LATENCY_CYCLES / BOOST_HZ * 1e3
    f_floor, a_floor = (Kb * n * FMA_LATENCY_CYCLES / BOOST_HZ * 1e3 for n in (262, 18))
    print(f"  backbone at K={Kb} (CUDA events over back-to-back calls; {card}): factor "
          f"{tri_f_ms:.4f} (chain floor {f_floor:.4f}, {tri_f_ms / f_floor:.2f}x), apply "
          f"{tri_a_ms:.4f} (floor {a_floor:.4f}, {tri_a_ms / a_floor:.2f}x); at K=1000 factor "
          f"{tri_f1_ms:.4f}, apply {tri_a1_ms:.4f}; plain factor "
          f"{big_k['plain_factor_ms']:.2f}, plain apply {big_k['plain_apply_ms']:.2f} (CUDA "
          f"events, once); bound {tri_bound:.6f} ({tri_by}), chain-latency floor "
          f"{tri_chain_ms:.4f} ms; no single PyTorch call solves a block-tridiagonal system, "
          f"so library_ms is null")
    for name, usage in ptxas_usage(logs).items():
        if "tridiag" in name:
            print(f"  ptxas {name}: {usage}")

    # -- 18-21: sharded, multi-process and elastic registration; recovery --
    # Pairs k -> k+1 of the drive, each seeded with the previous pair's
    # solution from the sequence drive (the "previous" warm start).
    s1, s2 = scans[:SHARD_PAIRS], scans[1:SHARD_PAIRS + 1]
    x0s = np.stack([np.zeros(6, np.float32)]
                   + [out[k].X for k in range(SHARD_PAIRS - 1)]).astype(np.float32)
    t0 = time.perf_counter()
    ref, sharded = phase_sharded(s1, s2, x0s, cfg, dev, card)
    phase_sharded_blockmap(scans, cfg, kf_cfg, bm_cfg, dev)
    t18 = time.perf_counter() - t0
    phase_processes(s1, s2, x0s, cfg, dev, ref, sharded, card)
    t19 = time.perf_counter() - t0 - t18
    phase_elastic(s1, s2, x0s, cfg, dev, ref, card)
    t20 = time.perf_counter() - t0 - t18 - t19
    phase_recovery(scans, gt, cfg, dcfg, kf_cfg, bm_cfg, mcfg, map_cfg, odo, dev, card,
                   {"dnn_odometry": dout, "keyframe": khost, "mapmaker": mout})
    t21 = time.perf_counter() - t0 - t18 - t19 - t20
    print(f"phases 18-21: {t18:.1f} / {t19:.1f} / {t20:.1f} / {t21:.1f} s")

    # -- 22-25: the user entry points, replay and prefetch, the leftovers --
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        kitti = phase_kitti(tmp, dev, card)
        t22 = time.perf_counter() - t0
        phase_replay(kitti["seq"], dev, card)
        t23 = time.perf_counter() - t0 - t22
        phase_citydrive_entry(tmp, dev, card)
        t24 = time.perf_counter() - t0 - t22 - t23
        phase_leftovers(kitti, scans, cfg, dev, card, fused_ev,
                        (pts, X_step, model.bounds, model.anchors))
        t25 = time.perf_counter() - t0 - t22 - t23 - t24
        phase_compiled(scans, gt, cfg, odo, dev, card, kitti)
        t26 = time.perf_counter() - t0 - t22 - t23 - t24 - t25
        phase_compiled_dnn_keyframe(scans, gt, cfg, dcfg, kf_cfg, bm_cfg, odo, net, dev, card,
                                    kitti)
        phase_compiled_back_end(scans, mcfg, map_cfg, odo, lc_loops, lc_solves, dev, card)
        t27 = time.perf_counter() - t0 - t22 - t23 - t24 - t25 - t26
    print(f"phases 22-27: {t22:.1f} / {t23:.1f} / {t24:.1f} / {t25:.1f} / {t26:.1f} / "
          f"{t27:.1f} s")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {
            "name": "fused_moment_sums",
            "route": "cuda",
            "source": "icet_tpu_torch/csrc/fused_moments.cu",
            "replaces": "icet_tpu/ops/pallas_fused.py:73",
            "launches": fused_launches,
            "max_abs_err": max_err,
            "ms": fused_ms,
            "plain_ms": fused_plain_ms,
            "bound_ms": fused_bound,
            "bound_by": fused_by,
            "library_ms": None,
        },
        {
            "name": "fused_moment_sums_windowed",
            "route": "cuda",
            "source": "icet_tpu_torch/csrc/fused_moments_windowed.cu",
            "replaces": "icet_tpu/ops/pallas_fused.py:171",
            "launches": win_launches,
            "max_abs_err": win_err,
            "ms": win_ms,
            "plain_ms": win_plain_ms,
            "bound_ms": win_bound,
            "bound_by": win_by,
            "library_ms": None,
        },
        {
            "name": "bias_encoder_pool",
            "route": "cuda",
            "source": "icet_tpu_torch/csrc/bias_encoder.cu",
            "replaces": "icet_tpu/models/bias_net.py:121",
            "launches": enc_launches,
            "max_abs_err": enc_err,
            "ms": enc_ms,
            "plain_ms": enc_plain_ms,
            "bound_ms": enc_bound,
            "bound_by": enc_by,
            "library_ms": None,
        },
        {
            "name": "tridiag_backbone",
            "route": "cuda",
            "source": "icet_tpu_torch/csrc/tridiag_backbone.cu",
            "replaces": "icet_tpu/pose_graph.py:193",
            "launches": ring_launches[0] + ring_launches[1],
            "max_abs_err": big_k["err"],
            "ms": tri_ms,
            "plain_ms": tri_plain_ms,
            "bound_ms": tri_bound,
            "bound_by": tri_by,
            "library_ms": None,
        },
        {
            "name": "moment_scatter_sums",
            "route": "cuda",
            "source": "icet_tpu_torch/csrc/moment_scatter.cu",
            "replaces": "icet_tpu/ops/pallas_moments.py:39",
            "launches": scat_launches,
            "max_abs_err": scat_err,
            "ms": scat_ms,
            "plain_ms": scat_plain_ms,
            "bound_ms": scat_bound,
            "bound_by": scat_by,
            "library_ms": scat_lib_ms,
        },
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        sys.exit(worker(json.loads(sys.argv[2])))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
