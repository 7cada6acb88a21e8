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
      ragged last block); each launched twice, the two bitwise equal; then
      its sorted parts (fixed radial mode and tables past one block's
      shared memory): fixed radial mode at 90,001 rows at three transforms,
      shuffled, with NaN and zero rows, at N = 131,072 (a 64x2048 frame)
      beam-major and shuffled, one voxel, no member, N = 1 and N = 65,537;
      the 150x48 grid (7,201 rows) beam-major and shuffled; 75x77 (V =
      5,775, the first grid past the shared table); a fixed grid of 800
      shells (1,440,001 rows), whose part bitmaps live in device memory; counts
      exact up to the points within EDGE_RAD of a bin or shell edge, each
      launched twice, the two bitwise equal; one device operation a call
      and no host synchronisation;
   b. the BiasNet encoder on the drive's real filter input (1,801 voxels x
      200 points, frames 0 -> 1), on a 37-voxel batch and at P in {1, 63,
      64, 65, 200} x B in {1, 37, 1,801}: codes within one bf16 ulp on
      >= 99.5% of entries, outputs within 2e-2, tiles 8/16/32 bitwise
      equal;
   c. the moment scatter against ``index_add_`` at V = 1,800 (shared
      table) and in fixed radial mode at V = 90,000 (sorted parts); then
      shuffled ids, 65,536 points in one voxel, every id on the sentinel,
      N = 1, N = 65,537 and out-of-range ids (dropped) at V = 1,800, and
      out-of-range ids at V = 90,000; counts exact, each launched twice,
      the two bitwise equal; one device operation a call and no host
      synchronisation in both branches;
4. sequence odometry: the 24-frame drive through ``run_odometry_device``
   (the compiled runner, ``odometry_sequence_jit``), fused-moments
   launches counted with the warm-ups before each graph's capture;
5. DNN-filtered odometry: the same drive through ``OdometryPipeline`` with
   the filter on (the compiled ``odometry_step_dnn_jit``); encoder and
   fused-moments launches counted with the warm-ups, ATE gated, the eager
   pipeline's ATE beside it;
6. the other moment routes, each drive compiled (its graphs captured
   under ``set_sync_debug_mode("error")``) and eager in turns: the first 8
   frames at ``moment_method="pallas"`` (kernel #3 inside the graphs; its
   launches iterations + prepares, plus the warm-ups where it captures),
   4 frames at ``"onehot"``; X of every drive equal bit for bit, compiled
   to eager and eager to eager, the compiled ATE within 0.1 cm of the
   eager one; ms a frame, host operations, device operations and idle
   share, the memory its graph sets reserve; one fixed-radial-mode pair on
   the scatter route (#3's sorted parts) and 4 DNN-filtered frames on it
   (#3 and #4 in one set of graphs), compiled against eager bit for bit;
7. fixed radial mode: one registration on the card through the fused
   route (#1's sorted parts, launches counted) against the CPU path, and
   the same pair at ``moment_method="segsum"`` (PyTorch binning, then #3)
   beside it, whether the two routes' X are bit-equal reported;
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
   figure plus 0.5 cm, the eager chain's (``tests/eager_chains.py``)
   beside it;
10. DNN-filtered keyframe odometry: ``KeyframeOdometry`` with the filter
    (compiled); encoder and fused-moments launches counted with the
    warm-ups, ATE gated likewise, the eager chain's beside it;
11. MapMaker at ``PROFILES["mapping"]`` on the compiled route
    (``map_step_jit``; its graphs captured under
    ``set_sync_debug_mode("error")``) against the eager chain frame by
    frame (X within 1e-6 m, flags, fill and counters equal; bit-identical
    or not, and the rings): launches counted with the warm-ups, ring fill
    exact, trajectory ATE gated likewise;
12. ScanMatcher: 6 frames, statuses and aligned clouds;
13. times: CUDA-event times (one round after a warm-up) of the eager
    odometry, DNN, keyframe, DNN keyframe and pallas-moments frames (the
    eager chains); for each kernel, its plain version and, where one exists, the
    one PyTorch call that computes the same function, the device time a
    call by torch.profiler (what the JSON line reports) and the CUDA-event
    time over back-to-back calls; the encoder's LayerNorm-epilogue floor;
    #1's sorted parts at fixed radial mode's 90,001 rows (N = 65,536 and
    131,072), 7,201 and 5,776 rows beside the plain version and the plain
    route's moments pass (PyTorch binning, then #3);
14. a grid above the fused kernel's shared-memory table (150x48, V =
    7,200): one registration through the fused route (#1's sorted parts,
    launches counted), X within 1e-3 m of the CPU path's, the segsum route
    beside it as in phase 7;
15. BiasNet training at ``train_bias_net_mixed``'s published size (batch
    256, S = 100, 6 raycast pairs), cut to TRAIN_STEPS steps: the captured
    ``train_step`` against ``train_step_eager`` (three steps from one seed:
    the first loss within 1e-6 relative, 95% of the parameters within
    1e-4, none more than 2 lr steps off; the mixed run on each, its last
    ten losses within 5%; ms a step in turns, device operations and idle
    share a step); every loss finite, the last ten below the first ten,
    ms a step; the JAX test's
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
    states equal to the eager loop's bit for bit and the eager loop to
    itself, the mean position error at most half
    the initial one; the kernels' times at K = 10,000 and 1,000 beside the
    chain floor, and their registers;
17. the loop-closure drive through ``icet_tpu_torch.examples.eval_citydrive.run``
    (tests/test_citydrive.py's block at 64x1024, 250 frames): odometry, loop
    candidates, ``close_loops``, ``optimize_poses_sparse(..., 10, 50,
    robust_delta=3.5)``, all compiled; launches counted, at least 30 loops,
    the refined ATE below the odometry ATE and within ATE_SLACK_M of the
    JAX package's CPU figure; the loop factors of the first 16 candidates
    against the eager chain's;
18. the in-process mesh (``parallel.sharding``) on repeats of the card at
    (dp, sp) in SHARD_SHAPES, 4 pairs of the drive, the compiled step
    (captured under ``set_sync_debug_mode("error")``) and the eager one:
    each pair against the unsharded ``register_pair`` at the JAX package's
    sharding tolerances, fused launches sp x (prepares + iterations), plus
    the warm-ups on the compiled step; ms a pair in turns, host operations
    a pair; a (1, 4) pair's device operations and idle share; the distributed
    clustering on 4 shards bit-identical to the replicated one at capacity
    2.0 and 0.02, beam-major and shuffled; ms a pair per shape; no
    exit-flag or overflow read on a captured row; the keyframe drive with
    its block map over two repeats of the card (``shard_blockmap``) on the
    compiled step against the eager chain over the same map and against
    the unsharded map;
19. ``run_distributed_registration`` as spawned processes (this script
    with ``--worker``), each joined with a timeout: two over gloo at
    (1, 2) and at (2, 1) (the eager step, no replay), one over NCCL at
    (1, 1) (the compiled step, its NCCL collective inside the graphs);
    results against the
    unsharded solve and phase 18's at the same shape, equal iterations on
    the ranks of a row, launches counted; ms, collectives and bytes a pair;
20. the elastic runner on four repeats of the card, prefer_dp 2, on the
    compiled step: one step raises and one probe entry fails, the runner
    rebuilds to (1, 3), results within the tolerances; a refresh to two
    repeats drops the old mesh's graph sets and captures new ones; a
    blocking probe returns within its 1 s timeout;
21. recovery: ``OdometryPipeline`` (plain, through ``odometry_step_jit``,
    and DNN, through ``odometry_step_dnn_jit``), ``KeyframeOdometry``
    (through ``keyframe_step_jit``) and ``MapMaker`` (through
    ``map_step_jit``) on the drive with one
    step raising a RuntimeError at frame FAIL_AT: one recovery (the
    compiled pipelines' graphs captured anew; the MapMaker's kept, its
    ring restored in place), the frames against a clean run within a
    bound from two clean runs (the keyframe runner re-seeds a keyframe
    there, as the JAX package's does), ATE and ms a recovery; then a
    resume of the odometry and keyframe runners from a mid-drive
    checkpoint;
22. KITTI evaluation at KITTI scale: the 24-frame city drive at 64x2048
    (131,072 rays a sweep) written as a KITTI sequence with a non-identity
    ``calib.txt``, through ``eval_kitti.run`` with the native prefetch
    queue: plain (TUM files and the HTML map written), ``--keyframe``,
    ``--dnn`` and ``--refine --strict-real``; launches of #1, #4 and the
    backbone counted (every mode through the compiled pipelines, graph
    replays counted, warm-ups added), ATE gated at the JAX package's CPU figure
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
    eager chain with its semantics (ATE gated and within 1e-4 cm of it,
    iterations and keyframes equal, kernel #1's and #4's launches equal to
    the eager chain's plus the warm-ups), ``run_keyframe_device``'s keyframes equal to
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
    share (torch.profiler); then the HD-mapping back end: the MapMaker
    frame and phase 17's K = 250 solve compiled and eager in turns, a loop
    pair (phase 17's first 16 candidates) in two turns; the dense solve of that graph
    captured under a global ``preferred_linalg_library("magma")``;
28. the IF nodes: the captured solve's and the DNN-filtered solve's graphs
    (node types of the graph and of its guarded bodies, no host or event
    node in a body), capture and instantiate seconds, the pools' MiB; the
    sharded pose-graph solves on two factor shards (repeats of the card):
    dense and sparse at phase 17's K = 250, sparse on phase 16's 10,000-pose
    ring, compiled (under ``set_sync_debug_mode("error")``) against the
    eager loops (bit for bit, the eager loop to itself too, the backbone's
    launches equal) and timed in turns; what the IF nodes cost: a warm iteration
    as a graph of its own against the same iteration in an IF body (taken
    and skipped), and a fixed-run-length solve as one unrolled graph
    against its stages replayed one by one;
29. the keyframe spawn decided on the card: ``run_keyframe_device`` on the
    drive at 64x1024 and at 64x2048 (phase 22's sequence), compiled (its
    graphs captured under ``set_sync_debug_mode("error")``) against the
    eager chain, bit for bit (frames, map tables and counters), a second
    compiled drive
    against the first and a second eager drive against the first; no spawn-flag, exit-flag or map write on the
    host inside a block, one read a block; kernel #1's settled launches
    equal to the eager drive's plus the warm-ups, one of them in the
    spawn's IF body a spawn; a block with a spawn every frame into a ring
    of fewer blocks (eviction), a block over a map sharded on two repeats
    of the card and a block on the scatter route (#3 in the spawn body),
    each against eager bit for bit; a
    warm block under the global ``set_sync_debug_mode("error")`` save its
    block-end read; the sequence frame eager and compiled in turns at both
    sizes, host operations, device operations and idle share;
    ``KeyframeOdometry``'s compiled frame: one read, no map write, one
    host synchronisation a frame without a spawn;
30. run to run: kernels #1 and #2 at N = 65,536 and 131,072 (V = 1,800)
    and #3 and #1's sorted parts at V = 1,800 and at fixed radial mode's
    90,001 rows, each launched twice on one input, all 16 columns bitwise
    equal; two compiled fixed-radial-mode drives equal; two eager
    and two compiled 10,000-pose solves equal; whether two 100-step
    BiasNet training runs from one seed repeat, reported without a gate.
    Every float sum of the port's card paths is in an order the code
    fixes, so each phase's compiled-against-eager gate is bit for bit.

31. kernel #6, the normal-equation assembly (run after phase 3): against
    its plain version at 75x24, 150x48 and fixed radial mode, in every
    branch (a mask, the moving-object test before and from
    ``rm_start_iter``, the range sensitivity, all together): masks and
    counts equal, sums within ``GN_RTOL``, two launches equal bit for bit;
    rows held alone by the mask bit for bit; one device operation a call;
    two graph replays equal an eager launch; a compiled solve launches it
    once an iteration (and once for the range sensitivity); its
    ``-Xptxas -v``, ms a launch, bound and the plain chain's ms.

32. kernel #7, the 6x6 eigensystem and its pruned update: against its
    plain version on the iterations of lap solves at 75x24 and 150x48, on
    random SPD matrices at condition numbers 1e2-1e9 and on one with a
    repeated eigenvalue, cold and warm (both outcomes of the warm test):
    w6 within ``EIGH6_W_RTOL`` of max |w|, keep and the dropped count
    equal, the reconstructions, the separated eigenvectors (up to sign) and
    X + dx within their limits; two launches and two graph replays equal
    bit for bit; one device operation a call; the compiled odometry and
    mapping runners launch it 7 and 12 times a frame; its ``-Xptxas -v``
    and ms cold and warm beside the plain chain's.

33. kernel #8, the prepare's voxel-model fit: against its plain version
    on the fits of lap frames at 75x24, 150x48 and fixed radial mode, with
    the NDT test and with the clip-fill guard, and on fits whose safeguard
    commits 0, 1 and 2 extra sweeps (one of them held only by the sentinel
    or by an invalid row): every field of the model bit for bit; two
    launches and two graph replays bit for bit; two device operations a
    fit; the compiled odometry, filtered odometry and mapping runners
    launch it twice a frame; its ``-Xptxas -v`` and ms at 1,801, 7,201 and
    90,001 rows beside the plain chain's.

``python3 chip_smoke.py --parent DIR`` (an earlier tree unpacked in DIR)
runs none of these phases: it times that tree's compiled paths against
this one's (among them the fixed-radial-mode and 150x48 frames, which an
earlier tree may take through its plain route), each tree in a process of
its own (``--time-tree``), in the turns parent, this, this, parent.

Every compiled phase gates its host exit-flag reads at 0: the solves'
early exits run on the card, in IF conditional nodes (phases 6, 18, 19,
26, 27, 29), and so does the keyframe sequence runner's spawn (phase 29);
launch counts read ``graphs.settle()`` first, which adds the launches of
the guarded bodies run since.

It prints, before the last line, one JSON object with the kernels' numbers
and, as the last line, ``{"ok": true, "device": {...}}``.  It imports
nothing of JAX or of ``icet_tpu``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
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
#: different orders (the kernels' fixed orders vs index_add_'s)
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
#: phase 6: frames of the one-hot drive; the compiled drive's ATE at most
#: the eager one's plus this (m)
ONEHOT_FRAMES, ROUTE_ATE_SLACK_M = 4, 0.001
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
#: frames of phase 30's compiled fixed-radial-mode drive
FIXED_DRIVE_FRAMES = 8
#: frames of phase 26-27's profiled chains (prepare, then PROFILE_FRAMES - 1
#: steps)
PROFILE_FRAMES = 4
#: frames of phase 27's timed chains at 64x2048 (the eager DNN frame there
#: takes ~0.2 s), and at 64x1024 (the DNN, keyframe and MapMaker frames;
#: the eager MapMaker frame takes ~0.35 s)
KF_TIMED_FRAMES = 8
TIMED_FRAMES = 12
#: profiles of one call before :func:`device_ms` gives up on a profiler
#: that records no device operation
PROFILE_TRIES = 3
#: the Hopper FP32 pipe's latency between dependent instructions (cycles) and the H100
#: SXM's boost clock, for the backbone's chain-latency floor
FMA_LATENCY_CYCLES, BOOST_HZ = 4, 1.98e9


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def settle() -> None:
    """Add to the wrappers' counts the launches of the compiled path's
    guarded bodies (its IF nodes) run since the last read: one host read
    of the device tallies (``graphs.settle``).  Called before every read
    or reset of a count."""
    from icet_tpu_torch import graphs

    graphs.settle()


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


def load_eager_chains() -> types.ModuleType:
    """``tests/eager_chains.py``: the eager functions chained with each
    runner's semantics, the plain version the compiled runners are held
    to.  Loaded from its file, once: an installed package named ``tests``
    can shadow the repository's directory of that name."""
    mod = sys.modules.get("eager_chains")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "eager_chains", os.path.join(ROOT, "tests", "eager_chains.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["eager_chains"] = mod
    return mod


def on_device(scans, dev) -> torch.Tensor:
    """``scans`` as one float32 tensor on ``dev``: the eager chains
    (:func:`load_eager_chains`) run on the device of their scans."""
    if isinstance(scans, torch.Tensor):
        return scans.to(dev)
    return torch.from_numpy(np.asarray(scans, np.float32)).to(dev)


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
    next call.  torch.profiler has dropped a whole call's records on the
    card now and then: a call that recorded nothing is profiled again, up
    to PROFILE_TRIES times in all, before the check fails."""
    ops = {}
    for _ in range(PROFILE_TRIES):
        ops = device_profile(fn, reps)
        if ops:
            break
        print("profiler: no device operation recorded; profiling again")
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
    to the next voxel), or, in fixed radial mode, whose shell index lies
    within EDGE_RAD of a shell edge (``log`` rounds too); theta == 0 exactly
    (y == 0, x > 0) is not an edge case, as every atan2 returns 0 there."""
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
    near = on_theta | on_phi
    if cfg.radial_mode == "fixed":
        fs = torch.log(rtp[:, 0].clamp(min=cfg.min_range) / cfg.min_range) / math.log(
            cfg.shell_growth)
        near |= ((fs - torch.round(fs)).abs() < EDGE_RAD) & (rtp[:, 0] >= cfg.min_range)
    return int((near & (point_norm(pts) >= cfg.min_range)).sum())


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
    check(torch.equal(got, again), f"{name}: two launches differ by up to {run_to_run}")
    report.append(
        f"{name}: members {int(want[:, 0].sum())}, edge points {edges}, "
        f"count diffs {int(dcount.sum())}, max |err| {float(err.max()):.3e}, "
        f"run-to-run max |diff| {run_to_run:.3e} (bitwise equal)"
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
    run_to_run = float((got - again).abs().max())
    check(torch.equal(got, again), f"{name}: two launches differ by up to {run_to_run}")
    report.append(
        f"{name}: N={pts.shape[0]} V={cfg.n_voxels} block {block} window {window}, in-window "
        f"members {int(want[:, 0].sum())}, overflow {ovf} (plain {want_ovf}), edge points "
        f"{edges}, count diffs {int(dcount.sum())}, max |err| {float(err.max()):.3e}, "
        f"run-to-run max |diff| {run_to_run:.3e} (bitwise equal)"
    )
    return float(err.max()), got, ovf


def check_one_launch(what: str, fn, wrapper, kernel: str, report, reps: int = 10,
                     records_required: bool = True, launches: int = 1) -> None:
    """``fn`` runs ``kernel`` and no other device operation (no memset, no
    copy, no other kernel), at most ``launches`` times a call (kernels
    whose names hold ``kernel``), with any host synchronisation an error
    (``torch.cuda.set_sync_debug_mode``), and ``wrapper``'s launch counter
    rises by ``launches`` a call.  The profiler can miss a record
    (:func:`device_profile`), so fewer than ``launches`` recorded a call is
    reported, not failed; with ``records_required`` False, none recorded
    at all is reported too (the backbone's long launches, of which the
    profiler recorded about one in ten on the H100), and every operation
    it does record must still be ``kernel``."""

    def strict():
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    settle()
    before = wrapper.launches
    prof = device_profile(strict, reps)
    settle()
    launched = wrapper.launches - before
    ops = sum(k for _, k in prof.values())
    others = sorted(name for name in prof if kernel not in name)
    check(not others and (0 < ops or not records_required) and ops <= launches
          and launched == launches * (reps + 1),
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


def rows_read(pts, X, cfg) -> int:
    """Distinct voxel rows whose bounds and anchors kernel #1 reads on this
    input: those of the points past the raw range gate that fall in the
    grid's band (``voxel_ids`` below V)."""
    from icet_tpu_torch.ops.geometry import cart_to_spherical, point_norm, transform_points
    from icet_tpu_torch.ops.grid import voxel_ids

    vid = voxel_ids(cart_to_spherical(transform_points(pts, X)), cfg)
    return int(torch.unique(vid[(point_norm(pts) >= cfg.min_range) & (vid < cfg.n_voxels)])
               .numel())


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
    run_to_run = float((got - again).abs().max())
    check(torch.equal(got, again), f"{name}: two launches differ by up to {run_to_run}")
    report.append(f"{name}: N={vid.shape[0]} V={n_voxels}, count {int(want[:, 0].sum())}, "
                  f"counts exact, max |err| {float(err.max()):.3e}, run-to-run max |diff| "
                  f"{run_to_run:.3e} (bitwise equal)")
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
    lattice; in fixed radial mode a 0.25 m cube in the middle of shell 45,
    7.8 m out) with bounds that admit every range and that voxel's anchor at
    the cube's centre: at X = 0 every offset, square and product is a short
    dyadic number and every sum of them is exact in float32, so kernel and
    plain version agree whatever their order of addition."""
    it, ip = 10, 12
    theta = (it + 0.5) * 2 * np.pi / cfg.n_theta
    phi = cfg.phi_min + (ip + 0.5) * (cfg.phi_max - cfg.phi_min) / cfg.n_phi
    fixed = cfg.radial_mode == "fixed"
    r, spread, row = 20.0, 4, ip * cfg.n_theta + it
    if fixed:
        shell = 45
        r, spread = cfg.min_range * cfg.shell_growth ** (shell + 0.5), 2
        row += shell * cfg.n_angular
    c = np.round(r * np.array([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                               np.cos(phi)]) * 16) / 16
    pts = (c + rng.integers(-spread, spread + 1, size=(n, 3)) / 16.0).astype(np.float32)
    bounds = torch.zeros((cfg.n_voxels + 1, 2), device=dev)
    bounds[:, 1] = 1000.0
    anchors = torch.zeros((cfg.n_voxels + 1, 3), device=dev)
    anchors[row] = torch.from_numpy(c.astype(np.float32)).to(dev)
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
#: times two clean runs' largest |dX| (0 where the runs repeat bit for
#: bit), and by at least this floor (m)
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
    """Phase 18: the in-process mesh on repeats of the one card, the
    compiled step (its graphs captured under ``set_sync_debug_mode
    ("error")``) and the eager one in turns."""
    from icet_tpu_torch import graphs
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
        make_sharded_register_eager,
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
        steps = {"compiled": make_sharded_register(cfg, mesh),
                 "eager": make_sharded_register_eager(cfg, mesh)}
        batch = shard_scan_batch(s1, s2, x0s, mesh)
        out = {}
        for mode in ("compiled", "eager"):
            torch.cuda.synchronize()
            settle()
            fused_moment_sums.launches = 0
            zero_warmups()
            with graphs.sync_debug("error" if mode == "compiled" else None):
                res = steps[mode](*batch)
            torch.cuda.synchronize()
            settle()
            launches, warm = fused_moment_sums.launches, warmups()
            iters = res.iterations.tolist()
            want = sp * sum(1 + it for it in iters) + warm
            check(launches == want, f"sharded ({dp}, {sp}, {mode}): fused launches {launches} "
                  f"!= sp x (prepares + iterations) + {warm} warm-ups = {want}")
            host = {k: getattr(res, k).cpu().numpy() for k in ("X", "pred_stds", "static_mask")}
            dX = max(shard_gate(f"sharded ({dp}, {sp}, {mode}) pair {b}", host["X"][b],
                                host["pred_stds"][b], host["static_mask"][b], ref[b])
                     for b in range(B))
            out[mode] = dict(host, iterations=iters, launches=launches, warm=warm, dX=dX)
        c, e = out["compiled"], out["eager"]
        dce = float(np.abs(c["X"] - e["X"]).max())
        check(c["iterations"] == e["iterations"],
              f"sharded ({dp}, {sp}): iterations {c['iterations']} compiled, {e['iterations']} "
              "eager")
        ops0 = dict(graphs.host_ops)
        ms = {m: [] for m in steps}
        for mode in ("eager", "compiled", "compiled", "eager"):
            ms[mode].append(wall_ms(lambda f=steps[mode]: f(*batch), rounds=2) / B)
        n_calls = 2 * 3
        host_ops = {k: (graphs.host_ops[k] - ops0[k]) / (n_calls * B)
                    for k in ("replays", "flag_reads", "overflow_reads", "copies")}
        check(host_ops["flag_reads"] == 0 and host_ops["overflow_reads"] == 0,
              f"sharded ({dp}, {sp}): {host_ops['flag_reads']} exit-flag and "
              f"{host_ops['overflow_reads']} overflow reads a pair on a captured row")
        results[(dp, sp)] = dict(c, ms=ms)
        print(f"sharded register ({dp}, {sp}) on {dp * sp} x {dev} ({card}): ms a pair "
              f"eager/compiled/compiled/eager {ms['eager'][0]:.2f} / {ms['compiled'][0]:.2f} / "
              f"{ms['compiled'][1]:.2f} / {ms['eager'][1]:.2f}; iterations {c['iterations']}, "
              f"fused launches compiled {c['launches']} = {sp} x "
              f"{sum(1 + it for it in c['iterations'])} + {c['warm']} warm-ups, eager "
              f"{e['launches']}; max |dX| vs unsharded {c['dX']:.3e} / {e['dX']:.3e}, compiled "
              f"vs eager {dce:.3e}; host operations a pair, compiled: "
              f"{host_ops['replays']:.1f} replays, {host_ops['flag_reads']:.1f} exit-flag and "
              f"{host_ops['overflow_reads']:.1f} overflow reads, {host_ops['copies']:.1f} copies")
    print(f"unsharded register_pair (compiled): {ref_ms:.2f} ms a pair ({card}), iterations "
          f"{[int(r.iterations) for r in ref]}")
    phase_sharded_split(s1, s2, x0s, cfg, dev, card)
    # A pair's device operations and idle share at (1, 4), compiled and eager.
    mesh = registration_mesh(1, 4, [dev] * 4)
    one = shard_scan_batch(s1[:1], s2[:1], x0s[:1], mesh)
    for mode, step in (("compiled", make_sharded_register(cfg, mesh)),
                       ("eager", make_sharded_register_eager(cfg, mesh))):
        with graphs.sync_debug("error"):
            step(*one)
        ops = device_profile(lambda f=step: f(*one), reps=2)
        wall = wall_ms(lambda f=step: f(*one), rounds=3)
        busy = sum(v for v, _ in ops.values())
        print(f"sharded pair (1, 4), {mode}: {sum(k for _, k in ops.values()):.1f} device "
              f"operations, busy {busy:.3f} ms, wall {wall:.3f} ms, idle share "
              f"{1.0 - busy / wall:.3f} (torch.profiler, host clock; {card})")

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


def phase_sharded_split(s1, s2, x0s, cfg, dev, card) -> None:
    """Phase 18's row of distinct devices, the card and the CPU: the split
    layout of ``graphs.ShardedGraphs`` (each shard step a graph on its
    shard's device, a plain call on the CPU shard; each replicated step a
    graph on the card; the axis's joins between the replays), its captures
    under ``set_sync_debug_mode("error")``, held bit for bit against the
    eager step on the same mesh, kernel #1 counted through the card
    shard's replays."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums
    from icet_tpu_torch.parallel.sharding import (
        make_sharded_register,
        make_sharded_register_eager,
        registration_mesh,
        shard_scan_batch,
    )

    mesh = registration_mesh(1, 2, [dev, torch.device("cpu")])
    batch = shard_scan_batch(s1[:2], s2[:2], x0s[:2], mesh)
    compiled = make_sharded_register(cfg, mesh)
    out = {}
    for mode, step in (("compiled", compiled), ("eager", make_sharded_register_eager(cfg, mesh)),
                       ("compiled again", compiled)):
        torch.cuda.synchronize()
        settle()
        fused_moment_sums.launches = 0
        zero_warmups()
        ops0 = dict(graphs.host_ops)
        t0 = time.perf_counter()
        with graphs.sync_debug("error" if mode != "eager" else None):
            res = step(*batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 2
        settle()
        out[mode] = (res, fused_moment_sums.launches, warmups(),
                     {k: graphs.host_ops[k] - ops0[k] for k in ("captures", "replays")}, ms)
    check(all(sg.split for sg in compiled.sets.values()), "split row: the set is not split")
    e, le, we, _, ms_e = out["eager"]
    iters = e.iterations.tolist()
    check(le == sum(1 + it for it in iters) and we == 0,
          f"split row (eager): fused launches {le} != one card shard x (prepares + iterations "
          f"{iters})")
    for mode in ("compiled", "compiled again"):
        c, lc, wc, ops, _ = out[mode]
        check(lc == le + wc, f"split row ({mode}): fused launches {lc} != eager {le} + "
              f"{wc} warm-ups")
        check(ops["replays"] > 0 and (ops["captures"] > 0) == (mode == "compiled"),
              f"split row ({mode}): {ops['captures']} captures, {ops['replays']} replays")
        for k in ("X", "pred_stds", "Q", "static_mask", "iterations"):
            check(torch.equal(getattr(c, k).cpu(), getattr(e, k).cpu()),
                  f"split row ({mode}): {k} is not bit-identical to the eager step")
        for k, a, b in zip(e.diagnostics._fields, c.diagnostics, e.diagnostics):
            check(torch.equal(a.cpu(), b.cpu()),
                  f"split row ({mode}): diagnostics.{k} is not bit-identical to the eager step")
    c, lc, wc, ops, ms_c = out["compiled again"]
    print(f"sharded register, a split row of {dev} and cpu ({card}): compiled bit-identical to "
          f"eager (X, pred_stds, Q, static_mask, diagnostics, iterations {iters}); fused "
          f"launches through the card shard's replays {out['compiled'][1]} = {le} + "
          f"{out['compiled'][2]} warm-ups, then {lc} with {ops['replays']} replays, eager {le}; "
          f"{out['compiled'][3]['captures']} captures; ms a pair (host clock, a CPU shard "
          f"included) eager {ms_e:.1f}, compiled {ms_c:.1f}")


def phase_sharded_blockmap(scans, cfg, kf_cfg, bm_cfg, dev) -> None:
    """Phase 18's block map: the keyframe drive with the map's block axis
    over two repeats of the card, on the compiled step (its graphs captured
    under ``set_sync_debug_mode("error")``, no exit-flag read) against the
    eager chain over the same sharded map (bit-identical) and against the
    unsharded map."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.keyframe import (
        KeyframeOdometry,
        blockmap_init,
        shard_blockmap,
        whole_table,
    )
    from icet_tpu_torch.parallel.sharding import registration_mesh
    eager_chains = load_eager_chains()

    plain = KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev)
    mesh = registration_mesh(2, 1, [dev] * 2)
    sharded = KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev)
    sharded.blockmap = shard_blockmap(sharded.blockmap, mesh)
    reads = graphs.host_ops["flag_reads"]
    with graphs.sync_debug("error"):
        b = sharded.run(scans)
    reads = graphs.host_ops["flag_reads"] - reads
    eb, ebm, ekfs = eager_chains.keyframe_odometry(
        on_device(scans, dev), cfg, kf_cfg, bm_cfg,
        blockmap=shard_blockmap(blockmap_init(bm_cfg, dev), mesh))
    check(reads == 0, f"sharded block map (compiled): {reads} exit-flag reads")
    check(ekfs == sharded.keyframe_indices
          and [f.iterations for f in b] == [f.iterations for f in eb],
          "sharded block map: the compiled drive's keyframes or iterations differ from the "
          "eager chain's")
    dT_e = max(float(np.abs(f.T_world - g.T_world).max()) for f, g in zip(b, eb))
    dP_e = max(float((whole_table(getattr(sharded.blockmap, k)).float()
                      - whole_table(getattr(ebm, k)).float()).abs().max())
               for k in ("points", "valid", "poses"))
    check(dT_e <= 1e-6 and dP_e <= 1e-5, f"sharded block map: the compiled drive is {dT_e:.3e} "
          f"(poses), {dP_e:.3e} (map) from the eager drive")
    a = plain.run(scans)
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
    print(f"sharded block map over 2 x {dev}, compiled step: {len(b)} keyframe frames, "
          f"keyframes {sharded.keyframe_indices}, {pts[1].shape[0]} points, 0 exit-flag reads; "
          f"against the eager chain over the same map: iterations equal, max |dT| {dT_e:.3e}, "
          f"map {dP_e:.3e} (bit-identical: {dT_e == 0.0 and dP_e == 0.0}); max |dT| {dT:.3e}, "
          f"max |dp| {dP:.3e} vs the unsharded map")


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
    from icet_tpu_torch import graphs
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
    # First pass: group and kernel set-up, and on NCCL the graphs' captures
    # (each collective warmed up once before its capture).
    with graphs.sync_debug("error"):
        run_distributed_registration(*args)
    torch.cuda.synchronize()
    dist.barrier()
    axis = mesh.axis("sp")
    settle()
    c0, b0 = axis.collectives, axis.bytes
    fused_moment_sums.launches = 0
    ops0 = dict(graphs.host_ops)
    res, local = run_distributed_registration(*args)
    torch.cuda.synchronize()
    reads = sum(graphs.host_ops[k] - ops0[k] for k in ("flag_reads", "overflow_reads"))
    settle()
    launches, collectives, nbytes = fused_moment_sums.launches, axis.collectives, axis.bytes
    replays = graphs.host_ops["replays"] - ops0["replays"]
    times = []
    for _ in range(3):
        dist.barrier()
        t0 = time.perf_counter()
        run_distributed_registration(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / b_local)
    np.savez(spec["out"], X=res.X.cpu().numpy(), pred_stds=res.pred_stds.cpu().numpy(),
             static_mask=res.static_mask.cpu().numpy(), iterations=res.iterations.cpu().numpy(),
             start=local.start, row=mesh.row, col=mesh.col, ms=float(np.median(times)),
             launches=launches, collectives=collectives - c0, bytes=nbytes - b0,
             compiled=mesh.compiled, replays=replays, reads=reads)
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
            for g in ranks:
                # NCCL runs the compiled step (graph replays); gloo the eager one.
                compiled = backend == "nccl"
                check(bool(g["compiled"]) == compiled and (int(g["replays"]) > 0) == compiled,
                      f"{name}: compiled {bool(g['compiled'])}, {int(g['replays'])} replays")
                # The compiled step's exit and clustering branch are IF nodes.
                check(int(g["reads"]) == 0, f"{name}: {int(g['reads'])} flag reads a call")
            rows = {}
            for g in ranks:
                rows.setdefault(int(g["row"]), []).append(g["iterations"].tolist())
            for row, its in rows.items():
                check(all(i == its[0] for i in its), f"{name}: row {row} iterations differ {its}")
            per = [(float(g["ms"]), int(g["collectives"]) / g["X"].shape[0],
                    int(g["bytes"]) / g["X"].shape[0]) for g in ranks]
            print(f"processes {name} (mesh {shape}, {world} process(es) on one card, "
                  f"{'compiled' if backend == 'nccl' else 'eager'} step, replays a rank "
                  f"{[int(g['replays']) for g in ranks]}): ms a pair "
                  f"{[round(p[0], 2) for p in per]} ({card}), collectives a pair "
                  f"{[p[1] for p in per]}, bytes a pair {[int(p[2]) for p in per]}, iterations "
                  f"{sorted(rows.items())}, launches a rank {[int(g['launches']) for g in ranks]}, "
                  f"host flag reads a rank {[int(g['reads']) for g in ranks]}, "
                  f"{wall:.1f} s with start-up")


def phase_elastic(s1, s2, x0s, cfg, dev, ref, card):
    """Phase 20: the elastic runner on four repeats of the card."""
    import threading

    import icet_tpu_torch.parallel.elastic as elastic
    from icet_tpu_torch import graphs

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
        with graphs.sync_debug("error"):
            res = runner.run(s1, s2, x0s)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        elastic.probe_devices = real_probe
    check(runner.rebuilds == 1 and runner.shape == (1, 3),
          f"elastic: {runner.rebuilds} rebuilds, shape {runner.shape}")
    check(runner._step is runner.sharded and len(runner.sharded.sets) == 1,
          "elastic: the rebuilt mesh does not run the compiled step")
    # The runner padded the points to a multiple of sp = 3 with zeros.
    dX = max(shard_gate(f"elastic pair {b}", res.X[b], res.pred_stds[b],
                        res.static_mask[b][: s1.shape[1]], ref[b]) for b in range(s1.shape[0]))
    # A refresh to two devices drops the (1, 3) mesh's graph sets.
    old = runner.sharded
    runner.refresh([dev] * 2)
    with graphs.sync_debug("error"):
        res2 = runner.run(s1, s2, x0s)
    check(old.sets == {} and runner.shape == (2, 1) and len(runner.sharded.sets) == 1,
          f"elastic refresh: old sets {len(old.sets)}, shape {runner.shape}")
    dX = max(dX, *(shard_gate(f"elastic (2, 1) pair {b}", res2.X[b], res2.pred_stds[b],
                              res2.static_mask[b], ref[b]) for b in range(s1.shape[0])))
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
    print(f"elastic (compiled step): (2, 2) -> (1, 3) after one failed step and one failed "
          f"probe entry, then a refresh to (2, 1), {runner.rebuilds} rebuilds, {s1.shape[0]} "
          f"pairs in {run_s:.2f} s with the rebuild "
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
        print(f"recovery {what}: recoveries {recoveries}, {len(frames)} frames, "
              f"max |dX| vs clean {dx:.3e} m (two clean runs {spread:.3e} m, bound "
              f"{bound_m:.3e} m), ATE {ate * 100:.4f} cm (clean {ate_clean * 100:.4f} cm), "
              f"{rec_ms:.2f} ms a recovery ({card})")

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
        settle()
        fused_moment_sums.launches = bias_encoder_pool.launches = 0
        tridiag_factor.launches = tridiag_apply.launches = 0
        zero_warmups()
        replays = graphs.host_ops["replays"]
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        s = eval_kitti.run(eval_kitti.build_parser().parse_args(base + extra))
        ev1.record()
        torch.cuda.synchronize()
        settle()
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
        settle()
        fused_moment_sums.launches = 0
        zero_warmups()
        s = eval_odometry.run(eval_odometry.build_parser().parse_args(
            ["--scans", ndir, "--poses", poses, "--device", dev.type]))
        torch.cuda.synchronize()
        check(s["frames"] == REPLAY_FRAMES - 1 and s["divergences"] == 0,
              f"eval_odometry: {s}")
        settle()
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
        settle()
        fused_moment_sums.launches = 0
        zero_warmups()
        t0 = time.perf_counter()
        s = eval_citydrive.run(eval_citydrive.build_parser().parse_args(
            CD_SHORT + ["--device", dev.type] + extra))
        torch.cuda.synchronize()
        settle()
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

    from icet_tpu_torch import graphs
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums
    from icet_tpu_torch.solver import moment_route, register_pair
    from icet_tpu_torch.utils.profiling import device_time_ms

    ocfg = cfg.replace(moment_method="onehot")
    check(moment_route(ocfg) == "onehot", f"onehot route: {moment_route(ocfg)}")
    x0 = np.array([0.9, 0.05, 0.0, 0.0, 0.0, 0.0], np.float32)
    torch.cuda.synchronize()
    settle()
    before = fused_moment_sums.launches
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    # The compiled pair (its finish graph with the static mask is new here).
    with graphs.sync_debug("error"):
        card_res = register_pair(scans[0], scans[1], x0, ocfg, device=dev)
    ev1.record()
    torch.cuda.synchronize()
    settle()
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
          f"{cfg.moment_block}): {int(card_res.iterations)} iterations in {onehot_ms:.2f} ms "
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


def route_drive(scans, c, odo, compiled: bool):
    """``run_odometry_device`` or, with ``compiled`` False, the eager chain
    with its semantics."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.odometry import run_odometry_device
    eager_chains = load_eager_chains()

    if not compiled:
        return eager_chains.odometry_device(on_device(scans, "cuda"), c, odo)
    with graphs.sync_debug("error"):
        return run_odometry_device(scans, c, odo, device="cuda")


def route_turns(name, scans, gt, c, odo, kernel=None):
    """Phase 6's turns of one route: a compiled drive that captures, then
    eager/compiled/compiled/eager; X of every drive equal bit for bit (the
    eager drives to each other, the compiled ones to the eager ones), ATE
    within ROUTE_ATE_SLACK_M; ``kernel``'s launches (a counted wrapper)
    equal to iterations + prepares (+ warm-ups, compiled).  Returns the
    turns' ``(frames, launches, warm-ups, ms a frame, host operations a
    frame)`` by route and the first compiled drive's launches."""
    from icet_tpu_torch import graphs

    runs = {"compiled": [], "eager": []}
    first_launches = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = (graph_pool_bytes(), torch.cuda.memory_reserved())
    for mode in ("compiled", "eager", "compiled", "compiled", "eager"):
        compiled = mode == "compiled"
        torch.cuda.synchronize()
        if kernel is not None:
            settle()
            kernel.launches = 0
        zero_warmups()
        ops0 = dict(graphs.host_ops)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        frames = route_drive(scans, c, odo, compiled)
        end.record()
        torch.cuda.synchronize()
        n = len(frames)
        host = {k: (graphs.host_ops[k] - ops0[k]) / n for k in ("replays", "flag_reads", "copies")}
        check(host["flag_reads"] == 0, f"{name} drive ({mode}): {host['flag_reads']} exit-flag "
              "reads a frame")
        settle()
        launches = kernel.launches if kernel is not None else 0
        warm = warmups(kernel.__name__) if kernel is not None else 0
        iters = [f.iterations for f in frames]
        check(not any(f.diverged for f in frames), f"{name} drive ({mode}): a frame diverged")
        if kernel is not None:
            check(launches == sum(iters) + len(scans) + warm,
                  f"{name} drive ({mode}): {kernel.__name__} launches {launches} != iterations "
                  f"{sum(iters)} + prepares {len(scans)} + warm-ups {warm}")
            check(compiled or warm == 0, f"{name} drive (eager): {warm} warm-up launches")
        if first_launches is None:
            first_launches = launches
            pools = graph_pool_bytes()
            mem = (f"{(pools - mem0[0]) / 2**20:.1f} MiB" if pools is not None
                   else "not measured", torch.cuda.memory_reserved() - mem0[1])
        runs[mode].append((frames, launches, warm, start.elapsed_time(end) / n, host))
    X = {m: [np.stack([f.X for f in r[0]]) for r in runs[m]] for m in runs}
    spread = float(np.abs(X["eager"][0] - X["eager"][1]).max())
    d_c = max(float(np.abs(xc - xe).max()) for xc in X["compiled"] for xe in X["eager"])
    ate = {m: [trajectory_ate(r[0], gt) for r in runs[m]] for m in runs}
    check(spread == 0.0 and d_c == 0.0,
          f"{name} drive: compiled X {d_c:.3e} from the eager drives, eager from eager "
          f"{spread:.3e} (bit for bit required)")
    check(max(ate["compiled"]) <= min(ate["eager"]) + ROUTE_ATE_SLACK_M,
          f"{name} drive: compiled ATE {max(ate['compiled']) * 100:.4f} cm above the eager "
          f"{min(ate['eager']) * 100:.4f} cm + {ROUTE_ATE_SLACK_M * 100} cm")
    return runs, first_launches, d_c, spread, ate, mem


def graph_pool_bytes():
    """Bytes of the current device's memory segments in CUDA-graph private
    pools (``torch.cuda.memory_snapshot``'s ``segment_pool_id``), or None
    where this PyTorch does not report the pool of a segment."""
    segs = torch.cuda.memory_snapshot()
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    dev = torch.cuda.current_device()
    return sum(g["total_size"] for g in segs
               if g["device"] == dev and tuple(g["segment_pool_id"]) != (0, 0))


def route_profile(scans, c, odo, compiled: bool) -> tuple:
    """(device operations a frame, busy ms a frame, idle share) of the
    route's drive on PROFILE_FRAMES frames (torch.profiler and CUDA events)."""
    short = scans[:PROFILE_FRAMES]
    ops = device_profile(lambda: route_drive(short, c, odo, compiled), reps=1)
    wall = median_ms(lambda: route_drive(short, c, odo, compiled), reps=1, rounds=1)
    busy = sum(v for v, _ in ops.values())
    steps = PROFILE_FRAMES - 1
    return sum(k for _, k in ops.values()) / steps, busy / steps, 1.0 - busy / wall


def phase_routes(scans, gt, cfg, dcfg, odo, dev, card) -> int:
    """Phase 6: the scatter route (kernel #3) and the one-hot route, the
    drive compiled and eager in turns; the scatter route in fixed radial
    mode (#3's sorted parts) and with the DNN filter (#3 and #4 in one set
    of graphs), each compiled against eager bit for bit.  Returns the first compiled scatter drive's #3
    launches (through the replays and the warm-ups)."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.filters import pretrained_dnn
    from icet_tpu_torch.odometry import OdometryPipeline
    from icet_tpu_torch.ops.bias_encoder import bias_encoder_pool
    from icet_tpu_torch.ops.moment_scatter import moment_scatter_sums
    from icet_tpu_torch.solver import moment_route, register_pair_impl, register_pair_jit
    eager_chains = load_eager_chains()

    pcfg, ocfg = cfg.replace(moment_method="pallas"), cfg.replace(moment_method="onehot")
    check(moment_route(pcfg) == "scatter" and moment_route(ocfg) == "onehot", "routes")
    lines = []
    for name, c, n_frames, kernel in (("pallas", pcfg, PALLAS_FRAMES, moment_scatter_sums),
                                      ("one-hot", ocfg, ONEHOT_FRAMES, None)):
        drive = scans[:n_frames]
        runs, first, d_c, spread, ate, pool = route_turns(name, drive, gt, c, odo, kernel)
        ms = {m: [r[3] for r in runs[m]] for m in runs}
        h = runs["compiled"][1][4]
        prof = {m: route_profile(drive, c, odo, m == "compiled") for m in ("compiled", "eager")}
        iters = [[f.iterations for f in r[0]] for r in runs["compiled"]]
        lines.append(
            f"{name} route, {n_frames}-frame drive ({card}): compiled against eager max |dX| "
            f"{d_c:.3e} (eager run-to-run {spread:.3e}); ATE compiled "
            f"{' / '.join(f'{a * 100:.4f}' for a in ate['compiled'])} cm, eager "
            f"{' / '.join(f'{a * 100:.4f}' for a in ate['eager'])} cm; iterations {iters[0]}"
            + (f"; #3 launches {first} = {sum(iters[0])} iterations + {n_frames} prepares + "
               f"{runs['compiled'][0][2]} warm-ups, replays {runs['compiled'][1][1]} and eager "
               f"{runs['eager'][0][1]} without" if kernel is not None else "")
            + f"; the capturing drive's graph pools {pool[0]}, all it reserved "
              f"{pool[1] / 2**20:.1f} MiB (buffers, scratch twins, warm-ups, pools)")
        lines.append(
            f"  ms a frame, eager/compiled/compiled/eager (after a capturing drive "
            f"{ms['compiled'][0]:.3f}): {ms['eager'][0]:.3f} / {ms['compiled'][1]:.3f} / "
            f"{ms['compiled'][2]:.3f} / {ms['eager'][1]:.3f} (CUDA events over the drive); host "
            f"operations a frame, compiled: {h['replays']:.1f} replays, {h['flag_reads']:.1f} "
            f"flag reads, {h['copies']:.1f} copies")
        for m in ("compiled", "eager"):
            n_ops, busy, idle = prof[m]
            lines.append(f"  {m}: {n_ops:.1f} device operations a frame, busy {busy:.3f} ms a "
                         f"frame, idle share {idle:.3f} (first {PROFILE_FRAMES} frames)")
        if kernel is not None:
            scat_launches = first
            pout = runs["compiled"][0][0]
            pate = ate["compiled"][0]
            check(pate <= ATE_MAX_M,
                  f"pallas drive ATE {pate * 100:.3f} cm above {ATE_MAX_M * 100} cm")

    # #3's sorted parts: fixed radial mode (V + 1 = 90,001 rows).
    fcfg = cfg.replace(radial_mode="fixed", moment_method="pallas")
    s1, s2 = (torch.from_numpy(scans[k]).to(dev) for k in (0, 1))
    x0 = torch.tensor([0.9, 0.05, 0.0, 0.0, 0.0, 0.0], device=dev)
    torch.cuda.synchronize()
    settle()
    moment_scatter_sums.launches = 0
    zero_warmups()
    with graphs.sync_debug("error"):
        fc = register_pair_jit(s1, s2, x0, fcfg)
    fe = register_pair_impl(s1, s2, x0, fcfg)
    fe2 = register_pair_impl(s1, s2, x0, fcfg)
    torch.cuda.synchronize()
    settle()
    f_launch, f_warm = moment_scatter_sums.launches, warmups("moment_scatter_sums")
    want = (1 + int(fc.iterations)) + (1 + fe.iterations) + (1 + fe2.iterations) + f_warm
    check(f_launch == want, f"fixed-mode scatter: #3 launches {f_launch} != {want} (prepares, "
          f"iterations, {f_warm} warm-ups)")
    f_spread = float((fe.X - fe2.X).abs().max())
    f_d = float((fc.X - fe.X).abs().max())
    check(f_spread == 0.0 and f_d == 0.0,
          f"fixed-mode scatter: compiled X {f_d:.3e} from eager, eager from eager {f_spread:.3e} "
          f"(bit for bit required)")
    lines.append(f"fixed radial mode on the scatter route (V + 1 = {fcfg.n_voxels + 1} rows, "
                 f"#3's sorted parts): compiled against eager max |dX| {f_d:.3e} (eager "
                 f"run-to-run {f_spread:.3e}), iterations {int(fc.iterations)} / {fe.iterations}, "
                 f"#3 launches {f_launch} with {f_warm} warm-ups")

    # The DNN filter on the scatter route: #3 and #4 in one set of graphs.
    dpcfg = dcfg.replace(moment_method="pallas")
    n_post = dpcfg.n_iters - max(min(dpcfg.dnn_start_iter, dpcfg.n_iters - 1), 1)
    drive = scans[:ONEHOT_FRAMES]
    out = {}
    for mode in ("compiled", "eager"):
        torch.cuda.synchronize()
        settle()
        moment_scatter_sums.launches = bias_encoder_pool.launches = 0
        zero_warmups()
        if mode == "eager":
            frames = eager_chains.odometry(on_device(drive, dev), dpcfg, odo,
                                           pretrained_dnn(dpcfg, dev))
        else:
            with graphs.sync_debug("error"):
                frames = list(OdometryPipeline(dpcfg, odo, device=dev).run(drive))
        torch.cuda.synchronize()
        n = len(frames)
        its = sum(f.iterations for f in frames)
        w3, w4 = warmups("moment_scatter_sums"), warmups("bias_encoder_pool")
        settle()
        check(bias_encoder_pool.launches == n * n_post * dpcfg.dnn_refine_steps + w4,
              f"DNN scatter drive ({mode}): #4 launches {bias_encoder_pool.launches}")
        # #3: a pass an iteration, a filter pass a filtered iteration, a
        # prepare a frame (the seed frame's too).
        want3 = its + n * n_post + len(drive) + w3
        settle()
        check(moment_scatter_sums.launches == want3,
              f"DNN scatter drive ({mode}): #3 launches {moment_scatter_sums.launches} != "
              f"{want3} ({w3} warm-ups)")
        settle()
        out[mode] = (frames, moment_scatter_sums.launches, bias_encoder_pool.launches, w3, w4)
    d_dnn = max(float(np.abs(a.X - b.X).max()) for a, b in zip(out["compiled"][0],
                                                                 out["eager"][0]))
    check(d_dnn == 0.0, f"DNN scatter drive: compiled X {d_dnn:.3e} from eager (bit for bit "
          f"required)")
    lines.append(f"DNN filter on the scatter route, {len(drive)} frames: compiled #3 / #4 "
                 f"launches {out['compiled'][1]} / {out['compiled'][2]} (warm-ups "
                 f"{out['compiled'][3]} / {out['compiled'][4]}), eager {out['eager'][1]} / "
                 f"{out['eager'][2]}; compiled against eager max |dX| {d_dnn:.3e}")
    for line in lines:
        print(line)
    print(f"pallas moments: {len(pout)} frames compiled, ATE {pate * 100:.3f} cm")
    return scat_launches


def phase_train_compiled(pairs, dev, card) -> str:
    """Phase 15's compiled step: three steps of ``train_step`` (captured
    under ``set_sync_debug_mode("error")``) against ``train_step_eager``
    from one seed at batch 256, S = 100 (the first loss within 1e-6
    relative; after three steps at least 95% of the parameters within 1e-4
    and none off by more than 2 lr steps); ``train_bias_net_mixed`` at
    TRAIN_STEPS compiled and eager (losses fall, the last ten's means
    within 5%); ms a step in turns, device operations and idle share a
    step.  Then a fourth step at half the learning rate replays the same
    graph (the Adam constants are a buffer) under the same gates, and the
    training graph's private pool is measured and released with its
    optimizer.  Returns the summary line's end."""
    import gc

    import icet_tpu_torch.models.train_data as train_data
    from icet_tpu_torch import graphs
    from icet_tpu_torch.models import bias_net as bn

    lr, steps = 1e-3, 3
    gen = torch.Generator(device=dev).manual_seed(11)
    batches = [bn.make_patch_batch(gen, 256, 100) for _ in range(steps + 1)]
    states = {m: bn.create_train_state(torch.Generator(device=dev).manual_seed(0), lr, 100, dev)
              for m in ("compiled", "eager")}
    losses = {"compiled": [], "eager": []}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool0 = graph_pool_bytes()
    captures = graphs.host_ops["captures"]
    for k, (x, y) in enumerate(batches):
        if k == steps:
            for st in states.values():
                st.opt.param_groups[0]["lr"] = lr / 2
        with graphs.sync_debug("error"):
            states["compiled"], loss = bn.train_step(states["compiled"], x, y)
        losses["compiled"].append(float(loss))
        states["eager"], loss = bn.train_step_eager(states["eager"], x, y)
        losses["eager"].append(float(loss))
        if k == steps - 1:
            rel = abs(losses["compiled"][0] - losses["eager"][0]) / abs(losses["eager"][0])
            check(rel <= 1e-6, f"training: first loss {losses['compiled'][0]} compiled, "
                  f"{losses['eager'][0]} eager ({rel:.3e} relative)")
            with torch.no_grad():
                diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(
                    states["compiled"].model.parameters(), states["eager"].model.parameters())])
            share = float((diffs <= 1e-4).double().mean())
            check(share >= 0.95 and float(diffs.max()) <= 2 * lr * steps,
                  f"training: after {steps} steps {share:.4f} of the parameters within 1e-4 of "
                  f"eager, max |diff| {float(diffs.max()):.3e}")
            pool1 = graph_pool_bytes()
    check(graphs.host_ops["captures"] - captures == 1,
          f"training: {graphs.host_ops['captures'] - captures} graphs captured for one state "
          "and two learning rates")
    with torch.no_grad():
        diffs4 = torch.cat([(a - b).abs().flatten() for a, b in zip(
            states["compiled"].model.parameters(), states["eager"].model.parameters())])
    share4 = float((diffs4 <= 1e-4).double().mean())
    check(share4 >= 0.95 and float(diffs4.max()) <= 2 * lr * (steps + 1),
          f"training: after a step at lr / 2, {share4:.4f} of the parameters within 1e-4 of "
          f"eager, max |diff| {float(diffs4.max()):.3e}")
    del states, st
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pool2 = graph_pool_bytes()
    if pool0 is None:
        pool = "the graph pool not measured (no segment_pool_id in this PyTorch)"
    else:
        check(pool2 <= pool0, f"training: the graph pool {(pool2 - pool0) / 2**20:.1f} MiB not "
              "released with its optimizer")
        pool = (f"the training graph's pool {(pool1 - pool0) / 2**20:.1f} MiB at batch 256, "
                f"S = 100, released with its optimizer ({(pool2 - pool0) / 2**20:.1f} MiB left)")

    def mixed(step):
        with patched(train_data, "make_raycast_voxel_pairs", lambda **kw: pairs), \
                patched(train_data, "train_step", step), graphs.sync_debug("error"):
            return train_data.train_bias_net_mixed(steps=TRAIN_STEPS, batch=256,
                                                   sample_pts=100, lr=lr, seed=0, n_pairs=6,
                                                   device=dev)[1]

    curves = {"compiled": mixed(bn.train_step), "eager": mixed(bn.train_step_eager)}
    last = {}
    for m, ls in curves.items():
        check(all(np.isfinite(ls)), f"training ({m}): a loss is not finite")
        first10, last[m] = float(np.mean(ls[:10])), float(np.mean(ls[-10:]))
        check(last[m] < first10, f"training ({m}): last ten {last[m]:.4f} not below first ten "
              f"{first10:.4f}")
    check(abs(last["compiled"] - last["eager"]) <= 0.05 * last["eager"],
          f"training: last ten {last['compiled']:.4f} compiled, {last['eager']:.4f} eager")

    # ms a step in turns on one batch; a step's device operations and idle.
    x, y = batches[0]
    ms = {"compiled": [], "eager": []}
    st = {m: bn.create_train_state(torch.Generator(device=dev).manual_seed(0), lr, 100, dev)
          for m in ("compiled", "eager")}
    fns = {"compiled": bn.train_step, "eager": bn.train_step_eager}

    def one(m):
        with graphs.sync_debug("error"):
            st[m] = fns[m](st[m], x, y)[0]

    for m in ("eager", "compiled", "compiled", "eager"):
        ms[m].append(median_ms(lambda m=m: one(m), reps=TIMED_STEPS, rounds=1))
    prof = {}
    for m in ("compiled", "eager"):
        ops = device_profile(lambda m=m: one(m), reps=5)
        busy = sum(v for v, _ in ops.values())
        prof[m] = (sum(k for _, k in ops.values()), busy, 1.0 - busy / np.mean(ms[m]))
    return (f"compiled against eager: first loss {rel:.3e} relative, after {steps} steps "
            f"{share:.4f} of the parameters within 1e-4 (max |diff| {float(diffs.max()):.3e}), "
            f"after a fourth at lr / 2 on the same graph {share4:.4f} (max |diff| "
            f"{float(diffs4.max()):.3e}); {pool}; "
            f"{TRAIN_STEPS}-step mixed run last ten {last['compiled']:.4f} compiled, "
            f"{last['eager']:.4f} eager; ms a step eager/compiled/compiled/eager "
            f"{ms['eager'][0]:.4f} / {ms['compiled'][0]:.4f} / {ms['compiled'][1]:.4f} / "
            f"{ms['eager'][1]:.4f} (CUDA events over {TIMED_STEPS} steps, {card}); device "
            f"operations a step {prof['compiled'][0]:.1f} / {prof['eager'][0]:.1f}, busy "
            f"{prof['compiled'][1]:.4f} / {prof['eager'][1]:.4f} ms, idle share "
            f"{prof['compiled'][2]:.3f} / {prof['eager'][2]:.3f} (compiled / eager, "
            f"torch.profiler over 5 steps)")


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
    eager_chains = load_eager_chains()

    drive = torch.from_numpy(scans).to(dev)
    zero6 = torch.zeros(6, device=dev)

    # -- capture with no host synchronisation -----------------------------
    graphs.clear()
    # Graphs, each guarded body one of its own (a solve is one capture).
    captures = graphs.capture_stats["graphs"]
    t0 = time.perf_counter()
    with graphs.sync_debug("error"):
        out_c = run_odometry_device(scans, cfg, odo, device=dev)
    torch.cuda.synchronize()
    captures = graphs.capture_stats["graphs"] - captures
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
    settle()
    fused_moment_sums.launches = 0
    frames_e = eager_chains.odometry_device(drive, cfg, odo, block=drive.shape[0])
    poses_e, iters_e = [f.T_world for f in frames_e], [f.iterations for f in frames_e]
    torch.cuda.synchronize()
    settle()
    eager_launches = fused_moment_sums.launches
    settle()
    fused_moment_sums.launches = 0
    zero_warmups()
    out_c = run_odometry_device(scans, cfg, odo, device=dev)
    torch.cuda.synchronize()
    settle()
    seq_launches = fused_moment_sums.launches
    settle()
    fused_moment_sums.launches = 0
    out_p = list(OdometryPipeline(cfg, odo, device=dev).run(scans))
    torch.cuda.synchronize()
    settle()
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
        check(host["flag_reads"] == 0, f"compiled chain at {size}: {host['flag_reads']} "
              "exit-flag reads a frame")
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
    settle()
    fused_moment_sums.launches = bias_encoder_pool.launches = 0
    zero_warmups()
    out = run()
    torch.cuda.synchronize()
    settle()
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
    ``run_keyframe_device``, each against the eager functions chained with
    its semantics (ATE gated, kernels #1's and #4's launches equal to the
    eager chain's plus the warm-ups); step against step on every frame; phase 22's compiled
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
        pretrained_dnn,
    )
    from icet_tpu_torch.keyframe import KeyframeOdometry, run_keyframe_device
    from icet_tpu_torch.odometry import OdometryPipeline
    from icet_tpu_torch.solver import prepare_reference, prepare_reference_jit
    eager_chains = load_eager_chains()

    drive = torch.from_numpy(scans).to(dev)
    zero6 = torch.zeros(6, device=dev)
    n_pre = max(min(dcfg.dnn_start_iter, dcfg.n_iters - 1), 1)
    n_post = dcfg.n_iters - n_pre

    # -- the drives: captured with no host synchronisation, against eager ----
    graphs.clear()
    # Graphs, each guarded body one of its own (a solve is one capture).
    captures = graphs.capture_stats["graphs"]
    t0 = time.perf_counter()
    drives = {
        "OdometryPipeline (DNN)": lambda: OdometryPipeline(dcfg, odo, device=dev),
        "KeyframeOdometry": lambda: KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev),
        "KeyframeOdometry (DNN)": lambda: KeyframeOdometry(dcfg, kf_cfg, bm_cfg, device=dev),
    }
    # The eager chains with the runners' semantics: (frames, keyframes).
    chains = {
        "OdometryPipeline (DNN)": lambda: (eager_chains.odometry(drive, dcfg, odo, net), None),
        "KeyframeOdometry": lambda: eager_chains.keyframe_odometry(drive, cfg, kf_cfg,
                                                                   bm_cfg)[::2],
        "KeyframeOdometry (DNN)": lambda: eager_chains.keyframe_odometry(drive, dcfg, kf_cfg,
                                                                         bm_cfg, net)[::2],
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
    captures = graphs.capture_stats["graphs"] - captures
    check(captures >= 20, f"{captures} graphs captured by the first compiled drives")
    print(f"compiled DNN and keyframe paths: {captures} graphs captured under "
          f"set_sync_debug_mode('error') in the first drives ({time.perf_counter() - t0:.2f} s "
          f"with the four drives themselves)")
    for name in drives:
        (runner, out), fused, enc, (w1, w4) = compiled[name]
        (eout, ekfs), efused, eenc, ew = drive_launches(chains[name])
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
        kfs = getattr(runner, "keyframe_indices", None)
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
        if comp:
            KeyframeOdometry(c, kc, bm_cfg, device=dev).run(frames)
        else:
            eager_chains.keyframe_odometry(frames, c, kc, bm_cfg,
                                           pretrained_dnn(c, dev) if c.dnn_filter else None)

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
                    for k in ("replays", "flag_reads", "spawn_reads", "copies", "draws")}
            check(host["flag_reads"] == 0, f"compiled {path} chain at {size}: "
                  f"{host['flag_reads']} exit-flag reads a frame")
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
                  f"device copies + {host['draws']:.1f} uniform draws), eager "
                  f"{prof['eager'][0]:.1f} launches (its device operations)")
            for mode in ("compiled", "eager"):
                n_ops, busy, idle = prof[mode]
                print(f"  {mode}: {n_ops:.1f} device operations a frame, device busy "
                      f"{busy:.3f} ms a frame, idle share {idle:.3f} (torch.profiler and CUDA "
                      f"events over the first {PROFILE_FRAMES} frames)")


def map_frames_ms(drive, mcfg, map_cfg, odo, compiled: bool) -> tuple[float, dict]:
    """ms a ``MapMaker`` frame by CUDA events over frames 2 onward of
    ``drive`` (the seed frame and the first step, where a new ring's map
    graphs are captured, go untimed), and its host operations a frame; with
    ``compiled`` False the eager chain's frames 2 onward (the chain over
    ``drive`` less the chain over its first two frames) and no host
    operations."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.mapping import MapMaker
    eager_chains = load_eager_chains()

    n = drive.shape[0] - 2
    if not compiled:
        ms = []
        for frames in (drive, drive[:2]):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            eager_chains.map_maker(frames, mcfg, map_cfg, odo)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        return (ms[0] - ms[1]) / n, {}
    maker = MapMaker(mcfg, map_cfg, odo, device=drive.device)
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
    return start.elapsed_time(end) / n, {k: (graphs.host_ops[k] - ops0[k]) / n for k in ops0}


def phase_compiled_back_end(scans, mcfg, map_cfg, odo, lc_loops, lc_solves, dev, card) -> None:
    """Phase 27, the HD-mapping back end: the MapMaker frame and phase 17's
    K = 250 solve, compiled and eager in turns, and a loop pair of phase
    17's drive (its first 16 candidates, one chunk) in two turns (CUDA
    events); the dense solve of that graph captured under a global MAGMA
    preference."""
    import icet_tpu_torch.pose_graph as pose_graph
    from icet_tpu_torch import graphs

    drive = torch.from_numpy(scans[:TIMED_FRAMES]).to(dev)
    ms = {"eager": [], "compiled": []}
    host = {}
    for mode in ("eager", "compiled", "compiled", "eager"):
        t, host[mode] = map_frames_ms(drive, mcfg, map_cfg, odo, mode == "compiled")
        ms[mode].append(t)
    h = host["compiled"]
    check(h["flag_reads"] == 0, f"compiled MapMaker: {h['flag_reads']} exit-flag reads a frame")
    print(f"MapMaker frame at 64x1024 ({card}), eager/compiled/compiled/eager: "
          f"{' / '.join(f'{t:.3f}' for t in (ms['eager'][0], *ms['compiled'], ms['eager'][1]))}"
          f" ms a frame (CUDA events over frames 2-{drive.shape[0] - 1}); host operations a "
          f"frame, compiled: {h['replays']:.1f} graph replays, {h['flag_reads']:.1f} exit-flag "
          f"reads, {h['copies']:.1f} device copies, {h['captures']:.1f} captures")

    ((scans_lc, cands, cfg), kw), = lc_loops.args
    pairs = cands[:16]

    ms = []
    for _ in range(2):
        # One call a turn: phase 17 captured the pairs' graphs.
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        kept = pose_graph.close_loops(scans_lc, pairs, cfg, batch=16, **kw)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / len(pairs))
    print(f"loop pair of the loop-closure drive ({card}): "
          f"{' / '.join(f'{t:.3f}' for t in ms)} ms a pair in two turns (CUDA events over "
          f"close_loops of {len(pairs)} candidates, batch 16, one read back; {len(kept)} loops "
          f"kept)")

    (args, kw), = lc_solves.args
    ms = {"eager": [], "compiled": []}
    out = {}
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
    check(dx == 0.0, f"K = 250 solve: compiled states {dx:.3e} from the eager loop's (bit for "
          f"bit required)")

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


def conditional_report(dev, n: int, cfg, dcfg, card) -> None:
    """Phase 28a: the IF nodes of the compiled solve (the sequence drive's
    config) and of the DNN-filtered solve, as captured: the main graph's
    node types, its guarded bodies' (each cloned into one IF node), what
    the captures cost and the memory the private pools hold."""
    from icet_tpu_torch import graphs

    for what, c, kind in (("solve", cfg, "solve"), ("DNN-filtered solve", dcfg, "dnn")):
        fg = graphs.frame_graphs(dev, n, c)
        entries = [(k, e) for k, e in fg._graphs.items() if k[0] == kind]
        check(bool(entries), f"no captured {what} graph at {n} points")
        key, e = entries[0]
        main = graphs.node_types(e.graph)
        bodies = [graphs.node_types(b) for b in e.bodies]
        check(main.get("conditional", 0) == len(e.bodies) > 0,
              f"{what}: {main.get('conditional', 0)} IF nodes for {len(e.bodies)} bodies")
        refused = {"host", "event_record", "wait_event", "mem_alloc", "mem_free"}
        check(not any(refused & set(b) for b in bodies), f"{what}: a body holds {bodies}")
        total = {}
        for b in bodies:
            for name, k in b.items():
                total[name] = total.get(name, 0) + k
        print(f"IF nodes of the compiled {what} ({n} points, n_iters {c.n_iters}; {card}): "
              f"main graph {main}; {len(bodies)} guarded bodies, together {total}; the set's "
              f"graphs {graphs.graph_nodes(fg)}")
    pool = graph_pool_bytes()
    s = graphs.capture_stats
    print(f"captures so far: {s['graphs']} graphs (guarded bodies included), "
          f"{s['capture_s']:.2f} s warming up and capturing, {s['instantiate_s']:.2f} s "
          f"instantiating; graph pools "
          f"{'not reported' if pool is None else f'{pool / 2**20:.1f} MiB'} ({card})")


def sharded_solve_case(what, solve, solve_eager, args, launches_want, dev, card) -> None:
    """One sharded pose-graph solve, compiled (its stages captured under
    ``set_sync_debug_mode("error")``) and eager in turns: the states equal
    bit for bit (compiled to eager, eager to eager), the backbone kernels'
    launches through the replays equal the eager loop's."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.ops.tridiag import tridiag_apply, tridiag_factor

    def counted(fn):
        torch.cuda.synchronize()
        settle()
        tridiag_factor.launches = tridiag_apply.launches = 0
        zero_warmups()
        out = fn()
        torch.cuda.synchronize()
        settle()
        return out, (tridiag_factor.launches - warmups("tridiag_factor"),
                     tridiag_apply.launches - warmups("tridiag_apply"))

    t0 = time.perf_counter()
    with graphs.sync_debug("error"):
        got, l_c = counted(lambda: solve(*args))
    first_s = time.perf_counter() - t0
    want, l_e = counted(lambda: solve_eager(*args))
    spread = float((solve_eager(*args) - want).abs().max())
    dx = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and dx == 0.0 and spread == 0.0,
          f"{what}: compiled states {dx:.3e} from the eager loop's, eager from eager "
          f"{spread:.3e} (bit for bit required)")
    check(l_c == l_e == launches_want, f"{what}: factor/apply launches compiled {l_c}, eager "
          f"{l_e}, want {launches_want}")
    ms = {"eager": [], "compiled": []}
    for mode in ("eager", "compiled", "compiled", "eager"):
        fn = solve if mode == "compiled" else solve_eager
        ms[mode].append(median_ms(lambda f=fn: f(*args), reps=1, rounds=2))
    print(f"{what} ({card}): eager/compiled/compiled/eager "
          f"{' / '.join(f'{t:.2f}' for t in (ms['eager'][0], *ms['compiled'], ms['eager'][1]))}"
          f" ms a solve (CUDA events, median of 2); the first compiled call with its captures "
          f"{first_s:.2f} s; compiled against eager max |d state| {dx:.3e} (eager against "
          f"eager {spread:.3e}, bit-identical: {dx == 0.0}); factor/apply launches {l_c}")


def phase_sharded_solves(lc_solves, dev, card) -> None:
    """Phase 28b: ``optimize_poses_sharded`` and
    ``optimize_poses_sparse_sharded`` with the factors over two repeats of
    the card (a (2, 1) mesh: the factor axis is the mesh's first), on
    phase 17's K = 250 graph and on the 10,000-pose ring of phase 16."""
    import icet_tpu_torch.pose_graph as pose_graph
    from icet_tpu_torch.parallel.sharding import registration_mesh

    mesh = registration_mesh(2, 1, [dev] * 2)
    (args, kw), = lc_solves.args
    states0, graph = args[0], args[1]
    n_it, cg = args[2], args[3]
    robust = kw.get("robust_delta", 0.0)
    K = states0.shape[0]
    sharded_solve_case(
        f"sharded dense solve, K = {K}, {graph.idx_i.shape[0]} factors over 2 shards, 10 steps",
        pose_graph.optimize_poses_sharded, pose_graph.optimize_poses_sharded_eager,
        (states0, graph, mesh, 10), (0, 0), dev, card)
    sharded_solve_case(
        f"sharded sparse solve, K = {K}, {graph.idx_i.shape[0]} factors over 2 shards, "
        f"{n_it} x {cg}, robust_delta {robust}",
        lambda *a: pose_graph.optimize_poses_sparse_sharded(*a, robust_delta=robust),
        lambda *a: pose_graph.optimize_poses_sparse_sharded_eager(*a, robust_delta=robust),
        (states0, graph, mesh, n_it, cg), (n_it, n_it * (1 + cg)), dev, card)
    ring0, ring, _ = ring_graph(RING_POSES)
    sharded_solve_case(
        f"sharded sparse solve, the {RING_POSES}-pose ring over 2 shards, 10 x 25",
        pose_graph.optimize_poses_sparse_sharded, pose_graph.optimize_poses_sparse_sharded_eager,
        (ring0, ring, mesh, 10, 25), (10, 10 * 26), dev, card)


def phase_if_cost(scans, cfg, dev, card) -> None:
    """Phase 28c: what the device-side control flow costs on the card, by
    CUDA events over back-to-back replays: one warm iteration as a graph
    of its own against the same iteration inside an IF node's body (flag
    true, and false), and a fixed-run-length solve (7 iterations; the
    mapping profile's 12) as one unrolled graph (the production solve)
    against its stages replayed one by one (the earlier design), in turns."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.config import PROFILES
    from icet_tpu_torch.solver import (_stage_finish, _stage_first, _stage_warm,
                                       compiled_graphs, prepare_reference)

    s0, s1 = (torch.from_numpy(scans[k]).to(dev) for k in (0, 1))
    fixed = cfg.replace(convergence_tol=0.0, convergence_stat_scale=0.0)
    for name, c in (("fixed run length", fixed), ("mapping profile", PROFILES["mapping"])):
        fg = compiled_graphs(s1, c)
        b = fg.buffers
        fg.load(scan=s1, x0=torch.zeros(6, device=dev), model=prepare_reference(s0, c))
        stages = ([lambda bb: _stage_first(bb, c)]
                  + [lambda bb, g=k: _stage_warm(bb, c, g) for k in range(1, c.n_iters)]
                  + [lambda bb: _stage_finish(bb, c, False)])

        def warm_one(bb):
            bb.it.zero_()
            _stage_warm(bb, c, 1)

        fg._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(fg._stream):
            for st in stages + [warm_one]:
                st(b)
        torch.cuda.synchronize()

        def capture(fns, flag=None, body=False):
            # A body is captured as the compiled path captures one: kept as
            # a graph, never instantiated, and cloned into its IF node.
            g = torch.cuda.CUDAGraph(keep_graph=True)
            inner = capture(fns, body=True) if flag is not None else None
            with torch.cuda.graph(g, pool=fg._pool, stream=fg._stream):
                if flag is None:
                    for fn in fns:
                        fn(b)
                else:
                    graphs._add_if(flag, inner)
            if not body:
                g.instantiate()
            g.body = inner
            return g

        staged = [capture([st]) for st in stages]
        flag = torch.ones((), dtype=torch.bool, device=dev)
        top, guarded = capture([warm_one]), capture([warm_one], flag)
        fg.solve(False)
        runs = {"stages replayed": lambda: [g.replay() for g in staged],
                "one solve graph": lambda: fg.solve(False)}
        ms = {k: [] for k in runs}
        for k in ("stages replayed", "one solve graph", "one solve graph", "stages replayed"):
            ms[k].append(median_ms(runs[k], reps=10, rounds=3))
        it_ms = [median_ms(top.replay, reps=20, rounds=3),
                 median_ms(guarded.replay, reps=20, rounds=3)]
        flag.fill_(False)
        it_ms.append(median_ms(guarded.replay, reps=20, rounds=3))
        check(all(t > 0 for t in it_ms), f"{name}: IF node timing failed")
        print(f"IF cost, {name} at 64x1024 ({card}): a warm iteration as its own graph "
              f"{it_ms[0]:.4f} ms, inside an IF body {it_ms[1]:.4f} ms, the IF skipped "
              f"{it_ms[2]:.4f} ms; a {c.n_iters}-iteration solve, stages replayed / one "
              f"unrolled graph / one unrolled graph / stages replayed: "
              f"{ms['stages replayed'][0]:.3f} / {ms['one solve graph'][0]:.3f} / "
              f"{ms['one solve graph'][1]:.3f} / {ms['stages replayed'][1]:.3f} ms (CUDA events)")


#: ``--parent DIR``: the compiled paths timed in a tree's own process
#: (``--time-tree``), the parent's and this tree's in turns
#: phase 29: the spawn-every-frame block (frames, and the blocks of its map:
#: fewer than its spawns, so the ring evicts) and the scatter-route block
EVERY_FRAMES, EVERY_BLOCKS = 12, 8
#: phase 29: the sharded map's blocks (two a chunk: the drive's keyframes
#: wrap round both chunks)
SHARD_BLOCKS = 4
SCATTER_FRAMES = 9


def frames_differ(got, want) -> list:
    """``(index, fields)`` of each frame where two runs' ``KeyframeFrame``
    records differ in a bit."""
    out = [(-1, ["count"])] if len(got) != len(want) else []
    for g, w in zip(got, want):
        bad = [n for n in ("X", "pred_stds", "T_world", "X_rel", "n_corr")
               if not np.array_equal(getattr(g, n), getattr(w, n))]
        bad += [n for n in ("index", "is_keyframe", "diverged", "iterations")
                if getattr(g, n) != getattr(w, n)]
        if bad:
            out.append((w.index, bad))
    return out


def maps_differ(a, b) -> list:
    """The tables (sharded ones gathered) and counters in which two block
    maps differ in a bit."""
    from icet_tpu_torch.keyframe import whole_table

    bad = [n for n in ("points", "valid", "poses")
           if not torch.equal(whole_table(getattr(a, n)), whole_table(getattr(b, n)))]
    return bad + (["counters"] if (a.n_blocks, a.cursor) != (b.n_blocks, b.cursor) else [])


def frames_equal(what: str, got, want) -> None:
    bad = frames_differ(got, want)
    check(not bad, f"{what}: {len(bad)} frames differ, the first {bad[:1]}")


def maps_equal(what: str, a, b) -> None:
    bad = maps_differ(a, b)
    check(not bad, f"{what}: the maps differ in {bad} (counters {(a.n_blocks, a.cursor)} "
          f"against {(b.n_blocks, b.cursor)})")


def sequence_block(frames, c, kc, bc, compiled: bool, dev, mesh=None) -> tuple:
    """One ``keyframe_sequence_jit`` (or eager ``keyframe_sequence``) block
    over ``frames[1:]`` from an eager seed spawn at ``frames[0]`` (the map
    sharded over ``mesh`` where given), generator seed 0: ``(model, map,
    carry, outputs on the host, iterations)``."""
    from icet_tpu_torch import keyframe as kfm

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    zero6, zero2 = torch.zeros(6, device=dev), torch.zeros(2, device=dev)
    bm = kfm.blockmap_init(bc, dev)
    if mesh is not None:
        bm = kfm.shard_blockmap(bm, mesh)
    model, bm = kfm.keyframe_spawn(bm, frames[0], zero6,
                                   kfm._uniforms(gen, bc.points_per_scan, dev), True, c, bc)
    carry = (zero6, zero6, zero6, zero2, zero6)
    if compiled:
        (model, bm, cc), outs, iters = kfm.keyframe_sequence_jit(
            frames[1:], model, bm, (*carry[:3], gen, *carry[3:]), c, kc, bc,
            return_iterations=True)
        carry = (*cc[:3], *cc[4:])
    else:
        (model, bm, carry), o = kfm.keyframe_sequence(frames[1:], model, bm, carry, gen, c, kc,
                                                      bc)
        d2, stds, world6, div, x2, n_corr, is_kf, iters = o
        outs = (d2, stds, world6, div, x2, is_kf, n_corr)
    return model, bm, carry, [o.cpu() for o in outs], [int(i) for i in iters]


def blocks_equal(what: str, got, want) -> None:
    names = ("delta", "delta_stds", "world6", "diverged", "x_rel", "is_keyframe", "n_corr")
    (m_g, bm_g, c_g, o_g, i_g), (m_w, bm_w, c_w, o_w, i_w) = got, want
    bad = [n for n, a, b in zip(names, o_g, o_w) if not torch.equal(a, b.to(a.dtype))]
    bad += [n for n, a, b in zip(m_w._fields, m_g, m_w) if not torch.equal(a, b)]
    bad += [f"carry[{k}]" for k in range(5) if not torch.equal(c_g[k], c_w[k])]
    check(not bad and i_g == i_w, f"{what}: compiled and eager differ in {bad} (iterations "
          f"{i_g} against {i_w})")
    maps_equal(what, bm_g, bm_w)


def phase_device_spawn(scans, wide, gt, cfg, kf_cfg, bm_cfg, dev, card) -> None:
    """Phase 29: the keyframe spawn decided on the card.  ``run_keyframe_device``
    on the drive at 64x1024 and at 64x2048, compiled (captured under
    ``set_sync_debug_mode("error")``) against the eager chain with its
    semantics, bit for bit, twice;
    host operations (no spawn, exit-flag or map write inside a block, one
    read a block); kernel #1's launches (settled) equal to eager's plus the
    warm-ups, and its one launch in the spawn's IF body; a block with a
    spawn every frame and a ring that evicts, a block over a map sharded on
    two repeats of the card, and a block on the scatter route (#3 in the
    spawn body too); a warm block under the global sync debug mode "error"
    save its one block-end read; ms a frame in turns with host operations
    and idle share; ``KeyframeOdometry``'s compiled frame, one read and no
    map write."""
    import warnings

    from icet_tpu_torch import graphs
    from icet_tpu_torch import keyframe as kfm
    from icet_tpu_torch.config import BlockMapConfig, ICETConfig, KeyframeConfig
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums
    from icet_tpu_torch.ops.moment_scatter import moment_scatter_sums
    from icet_tpu_torch.parallel.sharding import registration_mesh
    eager_chains = load_eager_chains()

    kcfg = ICETConfig(n_iters=7, min_range=2.0, convergence_tol=1e-4)  # phase 27's at 64x2048
    keys = ("replays", "flag_reads", "spawn_reads", "block_reads", "copies", "draws")
    fused_slot = graphs.COUNTED.index(fused_moment_sums)
    t0 = time.perf_counter()

    def at() -> str:
        return f"[{time.perf_counter() - t0:.1f} s]"

    def run(sc, c, compiled=True):
        if compiled:
            return kfm.run_keyframe_device(sc, c, kf_cfg, bm_cfg, device=dev)
        return eager_chains.keyframe_device(on_device(sc, dev), c, kf_cfg, bm_cfg)

    # -- the drives, compiled against eager -----------------------------------
    for size, sc, c in (("64x1024", scans, cfg), ("64x2048", wide, kcfg)):
        n_frames = sc.shape[0] - 1
        graphs.clear()
        runs = {}
        for turn, mode in enumerate(("compiled", "eager", "compiled", "eager")):
            ops0 = dict(graphs.host_ops)
            with graphs.sync_debug("error" if turn == 0 else None):
                (frames, bm), fused, _, (w1, _) = drive_launches(
                    lambda m=mode: run(sc, c, m == "compiled"))
            ops = {k: graphs.host_ops[k] - ops0[k] for k in keys}
            runs.setdefault(mode, []).append((frames, bm, fused, w1, ops))
        (got, bm_g, fused, w1, ops), (again, bm_a, fused2, w1b, ops2) = runs["compiled"]
        (want, bm_w, efused, ew, _), (want2, _, _, _, _) = runs["eager"]
        kfs = [0] + [f.index for f in got if f.is_keyframe]
        for what, frames, bm, n, w in (("compiled", got, bm_g, fused, w1),
                                       ("second compiled", again, bm_a, fused2, w1b),
                                       ("eager", want, bm_w, efused, ew)):
            check([0] + [f.index for f in frames if f.is_keyframe] == kfs,
                  f"run_keyframe_device {size}: the {what} drive's keyframes differ from {kfs}")
            its = sum(f.iterations for f in frames)
            check(n == its + len(kfs) + w and bm.n_blocks == len(kfs),
                  f"run_keyframe_device {size}, {what} drive: #1 launches {n} != {its} "
                  f"iterations + {len(kfs)} prepares + {w} warm-ups; {bm.n_blocks} blocks")
        check(ew == 0 and w1b == 0, f"run_keyframe_device {size}: warm-ups {ew} (eager), "
              f"{w1b} (second compiled drive)")
        for o in (ops, ops2):
            check(o["block_reads"] == -(-n_frames // 64) and o["spawn_reads"] == 0
                  and o["flag_reads"] == 0,
                  f"run_keyframe_device {size}: host operations {o}")

        pairs = ((got, bm_g, want, bm_w), (again, bm_a, got, bm_g), (want2, runs["eager"][1][1],
                                                                    want, bm_w))
        for (a, ma, b, mb), what in zip(pairs, ("compiled against eager", "compiled against "
                                                "compiled", "eager against eager")):
            bad = frames_differ(a, b)
            check(not bad and not maps_differ(ma, mb),
                  f"run_keyframe_device {size}, {what}: {len(bad)} frames differ (the first "
                  f"{bad[:1]}), maps in {maps_differ(ma, mb)}; bit for bit required")
        check(fused == efused + w1, f"run_keyframe_device {size}: #1 launches {fused}, "
              f"eager {efused} + warm-ups {w1}")
        agree = "compiled = eager bit for bit (frames and map), twice; eager = eager"
        fg = graphs.frame_graphs(dev, sc.shape[1], c)
        entry = next(e for k, e in fg._graphs.items() if k[0] == "kf_frame")
        nodes = graphs.node_types(entry.graph)
        spawn_runs = int(entry.tally[-1])
        body = entry.body_counts[-1][fused_slot]
        check(body == 1 and spawn_runs == 2 * (len(kfs) - 1),
              f"run_keyframe_device {size}: the spawn body holds {body} launches of #1 and ran "
              f"{spawn_runs} times for {len(kfs) - 1} spawns a drive, two drives")
        ate = f", ATE {trajectory_ate(got, gt) * 100:.6f} cm" if size == "64x1024" else ""
        print(f"{at()} phase 29 run_keyframe_device {size} ({card}): {agree}; keyframes "
              f"{kfs}{ate}; "
              f"#1 launches {fused} = {fused - len(kfs) - w1} iterations + {len(kfs)} prepares "
              f"+ {w1} warm-ups (eager {efused}, the second compiled drive {fused2}); the spawn "
              f"body holds 1 launch of #1 and ran {spawn_runs} times; host operations a frame "
              + ", ".join(f"{k} {v / n_frames:.2f}" for k, v in ops.items())
              + f"; the frame graph's nodes {nodes}")

    # -- a spawn every frame (the ring evicts), a sharded map, the scatter route -
    drive = torch.from_numpy(scans).to(dev)
    every = KeyframeConfig(delta_clamp=1e-4)
    small = BlockMapConfig(n_blocks=EVERY_BLOCKS)
    got = sequence_block(drive[:EVERY_FRAMES], cfg, every, small, True, dev)
    blocks_equal("every-frame spawn block", got, sequence_block(drive[:EVERY_FRAMES], cfg,
                                                                 every, small, False, dev))
    n_every = got[1].n_blocks
    check(n_every == EVERY_FRAMES > EVERY_BLOCKS and bool(got[3][5].all()),
          f"every-frame spawn block: {n_every} blocks in a ring of {EVERY_BLOCKS}")
    mesh, ring = registration_mesh(2, 1, [dev] * 2), BlockMapConfig(n_blocks=SHARD_BLOCKS)
    got = sequence_block(drive, cfg, kf_cfg, ring, True, dev, mesh)
    blocks_equal("sharded map block", got, sequence_block(drive, cfg, kf_cfg, ring, False,
                                                          dev, mesh))
    check(isinstance(got[1].valid, kfm.BlockShards) and got[1].n_blocks > SHARD_BLOCKS
          and all(bool(ch.any()) for ch in got[1].valid.chunks),
          f"sharded map block: {got[1].n_blocks} blocks, a chunk holds no point")
    print(f"{at()} phase 29 blocks, compiled = eager bit for bit: a spawn every frame over "
          f"{EVERY_FRAMES} frames ({n_every} blocks opened in a ring of {EVERY_BLOCKS}: it "
          f"evicted); the 24-frame drive over a {SHARD_BLOCKS}-block map sharded on 2 x {dev} "
          f"({got[1].n_blocks} blocks opened, both chunks written)")
    pcfg = cfg.replace(moment_method="pallas")
    counts = {}
    for mode in ("compiled", "eager"):
        torch.cuda.synchronize()
        settle()
        moment_scatter_sums.launches = 0
        zero_warmups()
        blk = sequence_block(drive[:SCATTER_FRAMES], pcfg, kf_cfg, bm_cfg, mode == "compiled",
                             dev)
        torch.cuda.synchronize()
        settle()
        counts[mode] = (blk, moment_scatter_sums.launches, warmups("moment_scatter_sums"))
    (bc, sc3, sw3), (be, se3, _) = counts["compiled"], counts["eager"]
    dx = float((bc[3][2] - be[3][2]).abs().max())
    blocks_equal("scatter-route block", bc, be)
    check(bool(bc[3][5].any()), f"scatter-route block: no spawn in {bc[3][5].tolist()}")
    check(sc3 == se3 + sw3 and bc[4] == be[4],
          f"scatter-route block: #3 launches {sc3}, eager {se3} + warm-ups {sw3}; iterations "
          f"{bc[4]} against {be[4]}")
    print(f"{at()} phase 29 scatter-route block ({SCATTER_FRAMES - 1} frames, spawns "
          f"{int(bc[3][5].sum())}): #3 launches {sc3} = eager {se3} + {sw3} warm-ups, compiled "
          f"= eager bit for bit (world poses {dx:.3e} apart)")

    # -- a warm block under the global sync debug mode ----------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    zero6 = torch.zeros(6, device=dev)
    model, bm = kfm.keyframe_spawn_jit(kfm.blockmap_init(bm_cfg, dev), drive[0], zero6, gen,
                                       True, cfg, bm_cfg)
    carry = (zero6, zero6, zero6, gen, torch.zeros(2, device=dev), zero6)
    torch.cuda.synchronize()
    real_read, reads = kfm._read_block, []

    def exempt(rows):
        torch.cuda.set_sync_debug_mode(0)
        try:
            reads.append(rows.shape)
            return real_read(rows)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    ops0 = dict(graphs.host_ops)
    with patched(kfm, "_read_block", exempt):
        torch.cuda.set_sync_debug_mode("error")
        try:
            (_, bm2, _), outs = kfm.keyframe_sequence_jit(drive[1:], model, bm, carry, cfg, kf_cfg,
                                                          bm_cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    ops = {k: graphs.host_ops[k] - ops0[k] for k in keys}
    ref, _ = run(scans, cfg)
    check(len(reads) == 1 and ops["block_reads"] == 1 and ops["spawn_reads"] == 0
          and ops["replays"] == 2 * (drive.shape[0] - 1),
          f"the warm block: {len(reads)} exempt reads, host operations {ops}")
    check(np.array_equal(outs[0].numpy(), np.stack([f.X for f in ref]))
          and outs[5].tolist() == [f.is_keyframe for f in ref],
          "the warm block under sync debug mode differs from run_keyframe_device's")
    print(f"{at()} phase 29 warm block of {drive.shape[0] - 1} frames under "
          f"set_sync_debug_mode('error')"
          f": no host synchronisation but the block-end read; host operations {ops}; "
          f"{bm2.n_blocks} blocks, outputs equal to run_keyframe_device's")

    # -- ms a frame in turns, host operations and idle share ----------------------
    # A map made once a size and the frames on the card: the timed call is the
    # seed spawn and one block, as run_keyframe_device runs them, without its
    # uploads and without the map-write graph's capture for a new map.
    for size, sc, c in (("64x1024", scans, cfg), ("64x2048", wide, kcfg)):
        frames = torch.from_numpy(sc).to(dev)
        n_frames = frames.shape[0] - 1
        bm0 = kfm.blockmap_init(bm_cfg, dev)

        def block(compiled, frames=frames, c=c, bm0=bm0):
            g = torch.Generator(device=dev)
            g.manual_seed(0)
            z6, z2 = torch.zeros(6, device=dev), torch.zeros(2, device=dev)
            bm = bm0._replace(n_blocks=0, cursor=0)
            if compiled:
                m, bm = kfm.keyframe_spawn_jit(bm, frames[0], z6, g, True, c, bm_cfg)
                kfm.keyframe_sequence_jit(frames[1:], m, bm, (z6, z6, z6, g, z2, z6), c, kf_cfg,
                                          bm_cfg)
            else:
                m, bm = kfm.keyframe_spawn(bm, frames[0], z6,
                                           kfm._uniforms(g, bm_cfg.points_per_scan, dev), True,
                                           c, bm_cfg)
                kfm.keyframe_sequence(frames[1:], m, bm, (z6, z6, z6, z2, z6), g, c, kf_cfg,
                                      bm_cfg)

        ms = {"eager": [], "compiled": []}
        for mode in ("eager", "compiled", "compiled", "eager"):
            ms[mode].append(median_ms(lambda m=mode: block(m == "compiled"), reps=1,
                                      rounds=1) / n_frames)
        ops0 = dict(graphs.host_ops)
        block(True)
        torch.cuda.synchronize()
        host = {k: (graphs.host_ops[k] - ops0[k]) / n_frames for k in keys}
        prof, short = {}, frames[:PROFILE_FRAMES + 1]
        for mode in ("compiled", "eager"):
            fn = (lambda m=mode: block(m == "compiled", short))
            dops = device_profile(fn, reps=1)
            wall = median_ms(fn, reps=1, rounds=1)
            busy = sum(v for v, _ in dops.values())
            prof[mode] = (sum(k for _, k in dops.values()) / PROFILE_FRAMES,
                          busy / PROFILE_FRAMES, 1.0 - busy / wall)
        print(f"{at()} keyframe sequence frame {size} ({card}), eager / compiled / compiled / "
              f"eager: "
              f"{ms['eager'][0]:.3f} / {ms['compiled'][0]:.3f} / {ms['compiled'][1]:.3f} / "
              f"{ms['eager'][1]:.3f} ms a frame (CUDA events over the seed spawn and the "
              f"{n_frames}-frame block)")
        print(f"  host operations a frame, compiled: {sum(host.values()):.2f} ("
              + ", ".join(f"{k} {v:.2f}" for k, v in host.items()) + ")")
        for mode in ("compiled", "eager"):
            n_ops, busy, idle = prof[mode]
            print(f"  {mode}: {n_ops:.1f} device operations a frame, device busy {busy:.3f} ms "
                  f"a frame, idle share {idle:.3f} (torch.profiler and CUDA events over the "
                  f"seed spawn and a {PROFILE_FRAMES}-frame block)")

    # -- KeyframeOdometry's compiled frame: one read, no map write ---------------
    kfm.KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev).run(drive)  # every graph captured
    odo = kfm.KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev, snapshot_every=10**6)
    odo.step(drive[0])
    odo.step(drive[1])
    torch.cuda.synchronize()
    ops0, syncs = dict(graphs.host_ops), []
    for k in range(2, drive.shape[0]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                f = odo.step(drive[k])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs.append((f.is_keyframe, sum("synchroniz" in str(w.message) for w in caught)))
    ops = {k: graphs.host_ops[k] - ops0[k] for k in keys}
    plain = [n for spawn, n in syncs if not spawn]
    spawned = [n for spawn, n in syncs if spawn]
    check(ops["spawn_reads"] == len(syncs) and ops["flag_reads"] == 0 and set(plain) == {1},
          f"KeyframeOdometry's compiled frame: host operations {ops}, synchronisations a frame "
          f"{syncs}")
    print(f"{at()} phase 29 KeyframeOdometry compiled frame ({card}): {len(syncs)} frames, host "
          f"operations a frame " + ", ".join(f"{k} {v / len(syncs):.2f}" for k, v in ops.items())
          + f"; synchronisations (set_sync_debug_mode('warn')) {plain[0]} a frame without a "
          f"spawn (the one read), {spawned} on spawn frames (the read and the pose's upload)")


TREE_TIMEOUT_S = 400


def phase_run_to_run(scans, wide, pairs, cfg, dev, card) -> None:
    """Phase 30: the card's results repeat run to run.  Kernels #1 and #2 at
    N = 65,536 and 131,072 (V = 1,800), #3 at V = 1,800 and at fixed radial
    mode's 90,001 rows and #1's sorted parts at 90,001 rows, each launched
    twice on one input: all 16 columns equal (and #2's overflow); two
    compiled fixed-radial-mode drives equal; two eager and two compiled
    10,000-pose solves all equal; and, reported without a gate, whether two
    100-step BiasNet training runs repeat."""
    import icet_tpu_torch.models.train_data as train_data
    from icet_tpu_torch.config import OdometryConfig
    from icet_tpu_torch.odometry import run_odometry_device
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums, fused_moment_sums_windowed
    from icet_tpu_torch.ops.grid import fixed_shell_bounds, voxel_anchors
    from icet_tpu_torch.ops.moment_scatter import moment_scatter_sums
    from icet_tpu_torch.pose_graph import optimize_poses_sparse, optimize_poses_sparse_eager
    from icet_tpu_torch.solver import prepare_reference

    t0 = time.perf_counter()
    X = torch.tensor([1.0, 0.05, 0.0, 0.0, 0.0, 0.02], device=dev)
    fixed = cfg.replace(radial_mode="fixed")
    fb = fixed_shell_bounds(fixed, dev)
    fa = voxel_anchors(fb, fixed)
    lines = []
    for size, sc in (("64x1024", scans), ("64x2048", wide)):
        model = prepare_reference(torch.from_numpy(sc[0]).to(dev), cfg)
        pts = torch.from_numpy(sc[1]).to(dev)
        n = pts.shape[0]
        vid_s, feats_s = scatter_inputs(pts, X, model.bounds, model.anchors, cfg)
        vid_f, feats_f = scatter_inputs(pts, X, fb, fa, fixed)
        calls = {
            f"#1 N={n} V={cfg.n_voxels}":
                lambda: fused_moment_sums(pts, X, model.bounds, model.anchors, cfg),
            f"#2 N={n} V={cfg.n_voxels}":
                lambda: torch.cat([t.reshape(-1).float() for t in fused_moment_sums_windowed(
                    pts, X, model.bounds, model.anchors, cfg, WIN_BLOCK, WIN_WINDOW)]),
            f"#3 N={n} V+1={cfg.n_voxels + 1}":
                lambda: moment_scatter_sums(vid_s, feats_s, cfg.n_voxels),
            f"#3 N={n} V+1={fixed.n_voxels + 1}":
                lambda: moment_scatter_sums(vid_f, feats_f, fixed.n_voxels),
            f"#1 sorted parts N={n} V+1={fixed.n_voxels + 1}":
                lambda: fused_moment_sums(pts, X, fb, fa, fixed),
        }
        for what, fn in calls.items():
            a, b = fn(), fn()
            torch.cuda.synchronize()
            d = float((a - b).abs().max())
            check(bool(torch.isfinite(a).all()) and torch.equal(a, b),
                  f"phase 30, {what}: two launches differ by up to {d}")
            lines.append(f"{what}: two launches bitwise equal ({int(a.numel())} values)")
    # The compiled fixed-radial-mode drive (#1's sorted parts in its graphs), twice.
    drives = [run_odometry_device(scans[:FIXED_DRIVE_FRAMES], fixed,
                                  OdometryConfig(divergence_clamp=2.5), device="cuda")
              for _ in range(2)]
    torch.cuda.synchronize()
    xs = [np.stack([np.asarray(f.X) for f in d]) for d in drives]
    d = float(np.abs(xs[0] - xs[1]).max())
    check(np.array_equal(xs[0], xs[1]) and bool(np.isfinite(xs[0]).all()),
          f"phase 30, compiled fixed-mode drive: two runs differ by up to {d}")
    lines.append(f"compiled fixed-radial-mode drive ({FIXED_DRIVE_FRAMES} frames 64x1024): two "
                 f"runs equal bit for bit")
    ring0, ring, _ = ring_graph(RING_POSES)
    solves = [optimize_poses_sparse_eager(ring0, ring, 10, 25, device="cuda") for _ in range(2)]
    solves += [optimize_poses_sparse(ring0, ring, 10, 25, device="cuda") for _ in range(2)]
    torch.cuda.synchronize()
    d = max(float((x - solves[0]).abs().max()) for x in solves[1:])
    check(all(torch.equal(x, solves[0]) for x in solves[1:]),
          f"phase 30, {RING_POSES}-pose solve: two eager and two compiled differ by up to {d}")
    lines.append(f"{RING_POSES}-pose sparse solve (10 x 25): two eager and two compiled equal bit "
                 f"for bit")
    runs = []
    for _ in range(2):
        with patched(train_data, "make_raycast_voxel_pairs", lambda **kw: pairs):
            state, losses, _ = train_data.train_bias_net_mixed(
                steps=TRAIN_STEPS, batch=256, sample_pts=100, lr=1e-3, seed=0, n_pairs=6,
                device="cuda")
        runs.append((np.asarray(losses), [p.detach().clone() for p in state.model.parameters()]))
    torch.cuda.synchronize()
    (l1, p1), (l2, p2) = runs
    same_loss = int(np.argmax(l1 != l2)) if not np.array_equal(l1, l2) else None
    dp = max(float((a - b).abs().max()) for a, b in zip(p1, p2))
    lines.append(f"BiasNet training, two {TRAIN_STEPS}-step runs from seed 0 (not gated): losses "
                 + ("equal" if same_loss is None else f"first differ at step {same_loss}")
                 + f", parameters max |diff| {dp:.3e}, bit-identical: "
                 f"{same_loss is None and dp == 0.0}")
    for line in lines:
        print(f"phase 30 run to run ({card}): {line}")
    print(f"phase 30: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Kernel #6: the Gauss-Newton normal-equation assembly
# ---------------------------------------------------------------------------

#: kernel #6 vs its plain version: each row's values are equal bit for bit;
#: the sums over rows are added in another order (block partials, then the
#: blocks in order, against torch.sum's), so the sums agree to this share
#: of their largest entry
GN_RTOL = 1e-5
#: the grids of kernel #6's checks: 75x24 (1,801 rows), 150x48 (7,201),
#: fixed radial mode (90,001)
GN_GRIDS = (("75x24", {}), ("150x48", {"n_theta": 150, "n_phi": 48}),
            ("fixed", {"radial_mode": "fixed"}))
#: rows of each grid held alone (the sums then exact in any order)
GN_SINGLE_ROWS = 12


def gn_branches(cfg, rows: int, dev):
    """``(name, cfg, it, corr_mask, want_range_sens)`` of every branch of
    kernel #6: plain, a mask, the moving-object test before and from
    ``rm_start_iter``, the range sensitivity, and all three together."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    mask = (torch.rand(rows, generator=gen) > 0.25).to(dev)
    moving = cfg.replace(remove_moving=True, rm_start_iter=2)
    return [("plain", cfg, 0, None, False), ("mask", cfg, 0, mask, False),
            ("moving, it 1 (off)", moving, 1, None, False),
            ("moving, it 2", moving, 2, None, False),
            ("range sensitivity", cfg, 0, None, True),
            ("mask + moving it 3 + range sensitivity", moving, 3, mask, True)]


def gn_outputs(out) -> list:
    """Kernel #6's outputs as a flat list of tensors (HTWg left out when
    None)."""
    return [t for t in out if t is not None]


def gn_bits(t: torch.Tensor) -> torch.Tensor:
    """The bytes of ``t`` (so -0.0 and 0.0, and NaNs, compare by bits)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def gn_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b|."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale > 0 else float((a - b).abs().max())


def gn_compare(what: str, args: tuple, report: list) -> dict:
    """Kernel #6 against its plain version on the card, twice: the masks and
    counts equal, the sums within :data:`GN_RTOL`, the two launches equal
    bit for bit."""
    from icet_tpu_torch.ops.gn_assembly import gn_assembly, gn_assembly_reference

    got = gn_outputs(gn_assembly(*args))
    again = gn_outputs(gn_assembly(*args))
    want = gn_outputs(gn_assembly_reference(*args))
    check(torch.equal(got[0], want[0]), f"{what}: corr differs from the plain version's")
    check(int(got[1]) == int(want[1]) and int(got[2]) == int(want[2]),
          f"{what}: n_corr {int(got[1])} / {int(want[1])}, n_rejected {int(got[2])} / "
          f"{int(want[2])} (kernel / plain)")
    rel = max(gn_rel(g, w) for g, w in zip(got[3:], want[3:]))
    check(rel <= GN_RTOL, f"{what}: sums {rel:.3e} off the plain version's (limit {GN_RTOL})")
    check(all(torch.equal(gn_bits(a), gn_bits(b)) for a, b in zip(got, again)),
          f"{what}: two launches differ")
    report.append(f"{what}: n_corr {int(got[1])}, n_rejected {int(got[2])}, sums {rel:.3e} "
                  f"of their largest entry off the plain version's, two launches equal")
    return {"rel": rel, "n_rejected": int(got[2])}


def gn_single_rows(what: str, args: tuple, report: list) -> None:
    """Each of :data:`GN_SINGLE_ROWS` correspondences held alone by the mask:
    the sums over rows are then that row's values, exact in any order, so
    the kernel's must equal the plain version's bit for bit."""
    from icet_tpu_torch.ops.gn_assembly import gn_assembly, gn_assembly_reference

    model, sums, X, dR, it, cfg, _, sens = args
    corr = gn_assembly_reference(*args)[0]
    rows = torch.nonzero(corr).flatten()
    check(rows.numel() > 0, f"{what}: no correspondence to hold alone")
    picks = sorted(set(rows[torch.linspace(0, rows.numel() - 1, GN_SINGLE_ROWS).long()].tolist()))
    for r in picks:
        one = torch.zeros_like(corr)
        one[r] = True
        a = (model, sums, X, dR, it, cfg, one, sens)
        got, want = gn_outputs(gn_assembly(*a)), gn_outputs(gn_assembly_reference(*a))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"{what}: row {r} alone differs from the plain version's bits")
    report.append(f"{what}: {len(picks)} rows alone equal the plain version bit for bit")


def graph_replays(what: str, fn, dev, report: list) -> None:
    """``fn`` (a kernel wrapper's call; its outputs, None left out)
    captured once in a CUDA graph: two replays give an eager call's
    bits."""
    eager_out = [t.clone() for t in fn() if t is not None]
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # the warm-up the capture needs
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = [t for t in fn() if t is not None]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize(dev)
        check(all(torch.equal(gn_bits(a), gn_bits(b)) for a, b in zip(out, eager_out)),
              f"{what}: a graph replay differs from the eager launch")
    report.append(f"{what}: two graph replays equal the eager launch bit for bit")


def gn_solve_launches(scan1, scan2, cfg, report: list) -> None:
    """The compiled solve launches #6 once an iteration: a second
    registration (no capture) adds its iterations to the count, its guarded
    iterations counted through ``graphs.settle``."""
    from icet_tpu_torch.ops.gn_assembly import gn_assembly
    from icet_tpu_torch.solver import register_pair_jit

    x0 = torch.zeros(6, device=scan1.device)
    register_pair_jit(scan1, scan2, x0, cfg)
    for _ in range(2):
        settle()
        before = gn_assembly.launches
        res = register_pair_jit(scan1, scan2, x0, cfg)
        settle()
        launched = gn_assembly.launches - before
        want = int(res.iterations) + (1 if cfg.range_sigma > 0.0 else 0)
        check(launched == want, f"compiled solve: {launched} launches of #6 for {want}")
    report.append(f"compiled solve ({cfg.n_iters} at most, early exit on the card): "
                  f"{launched} launches for {int(res.iterations)} iterations"
                  + (" + the range sensitivity" if cfg.range_sigma > 0.0 else ""))


def gn_timing(args: tuple, rows: int) -> dict:
    """Kernel #6 and its plain chain at one shape: device ms a call and
    device operations a call (torch.profiler), CUDA-event ms a call of
    back-to-back launches, and the bound (the sums and the model read once,
    the mask and 48 floats written, at 3.35 TB/s)."""
    from icet_tpu_torch.ops.gn_assembly import gn_assembly, gn_assembly_reference

    k_ms, k_event_ms = kernel_times(lambda: gn_assembly(*args), 50)
    plain_ops = device_profile(lambda: gn_assembly_reference(*args), 3)
    nbytes = rows * (16 * 4 + 113 + 1) + 48 * 4 + 8
    b_ms, by = bound(nbytes, 0, PEAK_FP32_PER_S)
    return {"ms": k_ms, "event_ms": k_event_ms,
            "plain_ms": sum(ms for ms, _ in plain_ops.values()),
            "plain_launches": sum(k for _, k in plain_ops.values()),
            "bound_ms": b_ms, "bound_by": by}


def phase_gn_assembly(scan1, scan2, cfg, dev, card) -> dict:
    """Kernel #6 against its plain version on the card, at 75x24, 150x48 and
    fixed radial mode, in every branch; rows alone bit for bit; graph
    replays; the launches of a compiled solve; its ms beside its bound and
    the plain chain's."""
    from icet_tpu_torch import _build
    from icet_tpu_torch.ops.geometry import rotation_jacobian
    from icet_tpu_torch.ops.gn_assembly import gn_assembly
    from icet_tpu_torch.solver import _sums, prepare_reference, register

    t0 = time.perf_counter()
    for name, usage in ptxas_usage(_build.build(["gn_assembly"])).items():
        print(f"ptxas {name}: {usage}")
    report, rel, rejected, times = [], 0.0, 0, {}
    for grid, kw in GN_GRIDS:
        c = cfg.replace(**kw)
        model = prepare_reference(scan1, c)
        X = register(model, scan2, torch.zeros(6, device=dev), c, want_static_mask=False).X
        X = X + torch.tensor([0.05, -0.03, 0.01, 0.002, -0.001, 0.004], device=dev)
        sums = _sums(scan2, X, model.bounds, model.anchors, c)
        dR = rotation_jacobian(X[3:6])
        # The compiled paths' model buffers are contiguous; so is this one.
        model = type(model)(*(t.contiguous() for t in model))
        rows = c.n_voxels + 1
        for name, cb, it, mask, sens in gn_branches(c, rows, dev):
            args = (model, sums, X, dR, it, cb, mask, sens)
            what = f"{grid} (V+1={rows}) {name}"
            r = gn_compare(what, args, report)
            rel = max(rel, r["rel"])
            rejected += r["n_rejected"]
            if name == "plain":
                check_one_launch(what, lambda: gn_assembly(*args), gn_assembly,
                                 "gn_assembly_kernel", report)
                gn_single_rows(what, args, report)
                graph_replays(what, lambda: gn_assembly(*args), dev, report)
                times[grid] = gn_timing(args, rows)
            if name.startswith("mask + moving"):
                graph_replays(what, lambda: gn_assembly(*args), dev, report)
    check(rejected > 0, "the moving-object test rejected nothing: its branch is untested")
    gn_solve_launches(scan1, scan2, cfg, report)
    gn_solve_launches(scan1, scan2, cfg.replace(range_sigma=0.02, convergence_tol=0.0,
                                                convergence_stat_scale=0.0), report)
    for line in report:
        print(f"gn_assembly vs plain, {line}")
    for grid, t in times.items():
        print(f"gn_assembly {grid} ({card}): {t['ms']:.5f} ms a launch (CUDA events "
              f"{t['event_ms']:.5f}), bound {t['bound_ms']:.6f} ({t['bound_by']}); plain chain "
              f"{t['plain_ms']:.4f} ms in {t['plain_launches']:g} device operations")
    print(f"phase 31: {time.perf_counter() - t0:.1f} s")
    return {"rel": rel, "times": times}


# ---------------------------------------------------------------------------
# Kernel #7: the Gauss-Newton 6x6 eigensystem and its pruned update
# ---------------------------------------------------------------------------

#: kernel #7 vs its plain version: the eigenvalues agree to this share of
#: the largest |w| (float32 rotations whose sums the kernel adds in its
#: fixed order and cuBLAS, behind the plain version, in its own)
EIGH6_W_RTOL = 1e-6
#: the two routes' U2 diag(w6) U2^T agree to this share of the largest |w|
#: (each is within ~1e-6 of the symmetrised input after 40 rounds)
EIGH6_RECON_RTOL = 2e-6
#: an eigenvector is compared where its eigenvalue stands apart from the
#: others by EIGH6_GAP of the largest |w|; there the two agree, up to the
#: column's sign, within EIGH6_VEC_TOL over that gap (the Davis-Kahan bound
#: of a difference of EIGH6_VEC_TOL of the largest |w| between the inputs
#: the two routes' rounding leaves)
EIGH6_GAP, EIGH6_VEC_TOL = 1e-3, 1e-5
#: X + dx agrees within EIGH6_DX_RTOL times the kept axes' condition times
#: |dx| (a relative difference of the system, amplified by its condition),
#: plus two float32 ulps of X
EIGH6_DX_RTOL = 1e-5
#: condition numbers of the random symmetric positive definite inputs; the
#: cutoff's 1e6 itself is left out (an eigenvalue ratio of exactly the
#: cutoff is kept or dropped by its last bit, in either route)
EIGH6_CONDS = (1e2, 1e3, 1e4, 1e5, 3e6, 1e7, 1e8, 1e9)
#: the lap frames of the solves whose iterations give inputs: pairs
#: (k, k + 1) from EIGH6_LAP_FIRST
EIGH6_LAP_FIRST, EIGH6_LAP_PAIRS = 100, 2
#: frames each runner steps in the launch count (the first two capture)
EIGH6_RUNNER_FRAMES = 5


def bench_config(name: str) -> dict:
    """``benchmark/configs/<name>.json``."""
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


def lap_scans(dev, first: int, n: int) -> list[torch.Tensor]:
    """Frames ``first`` .. ``first + n - 1`` of the benchmark's stream lap
    (``benchmark/traffic/stream.json``) as the OS1-64 of
    ``os1-64.odo.json`` sees them, without range noise, on ``dev``."""
    from benchmark import lap as lapgen

    with open(os.path.join(ROOT, "benchmark", "traffic", "stream.json")) as f:
        traffic = json.load(f)
    sensor = bench_config("os1-64.odo")["sensor"]
    circuit = lapgen.Circuit(tuple(traffic["rect"]), traffic["corner_radius"])
    step = circuit.length / int(traffic["frames_per_lap"])
    R, t = zip(*(circuit.pose(step * i) for i in range(first, first + n)))
    R = torch.from_numpy(np.stack(R)).to(dev)
    t = torch.from_numpy(np.stack(t)).to(dev)
    d = lapgen.beam_directions(sensor["n_beams"], sensor["n_azimuth"], sensor["elev_min"],
                               sensor["elev_max"], dev)
    rng = lapgen.raycast(R, t, d, lapgen.city_boxes(int(traffic["scene_seed"])),
                         traffic["ground_z"], traffic["max_range"])
    scans = (d[None] * rng[..., None]).float()
    return [s.contiguous() for s in scans]


def eigh6_solve_inputs(scan1, scan2, cfg) -> list[tuple]:
    """``gn_eigh6``'s arguments at every iteration of an eager solve of the
    pair on the card: the first cold, the others warm."""
    from icet_tpu_torch import solver

    model = solver.prepare_reference(scan1, cfg)
    with spy(solver, "gn_eigh6") as calls:
        solver.register(model, scan2, torch.zeros(6, device=scan1.device), cfg,
                        want_static_mask=False)
    return [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            for args, _ in calls.args]


def eigh6_random_inputs(dev, cutoff: float) -> list[tuple[str, tuple]]:
    """Random symmetric positive definite H^T W H at the condition numbers
    of :data:`EIGH6_CONDS`, and one with a repeated eigenvalue, each cold,
    warm from its own eigenbasis (the warm test passes) and warm from a
    random orthogonal basis (the second sweep runs)."""
    rng = np.random.default_rng(23)
    spectra = [(f"cond {c:.0e}", 1e4 * np.logspace(0, -np.log10(c), 6)) for c in EIGH6_CONDS]
    spectra.append(("repeated eigenvalue", np.array([1e4, 1e4, 2e2, 50.0, 3.0, 0.5])))
    cases = []
    for name, w in spectra:
        Q = np.linalg.qr(rng.standard_normal((6, 6)))[0]
        H = (Q * w) @ Q.T
        b, X = rng.standard_normal(6) * 1e2, rng.standard_normal(6) * 0.1
        bases = [("cold", None), ("warm from its eigenbasis", Q[:, np.argsort(w, kind="stable")]),
                 ("warm from a random basis", np.linalg.qr(rng.standard_normal((6, 6)))[0])]
        for how, U in bases:
            args = tuple(None if a is None else torch.tensor(a, dtype=torch.float32, device=dev)
                         for a in (H, b, X, U))
            cases.append((f"{name}, {how}", (*args, cutoff)))
    return cases


def eigh6_converged(H, V0) -> bool:
    """``eigh_small_warm_safe``'s test on the card's plain route, read on
    the host."""
    from icet_tpu_torch.ops.linalg import eigh_small

    A0 = V0.T @ H @ V0
    _, V1 = eigh_small(A0, sweeps=1)
    R = V1.T @ A0 @ V1
    dg = torch.diagonal(R)
    off = torch.linalg.norm(R - dg[:, None] * torch.eye(6, device=H.device))
    return bool(off <= 1e-5 * torch.clamp(torch.linalg.norm(dg), min=1e-30))


def eigh6_compare(what: str, args: tuple, report: list) -> dict:
    """Kernel #7 against its plain version on the card, launched twice: w6
    within :data:`EIGH6_W_RTOL`, keep and the dropped count equal, the
    reconstructions within :data:`EIGH6_RECON_RTOL`, separated columns up to
    sign (:data:`EIGH6_GAP`, :data:`EIGH6_VEC_TOL`), X + dx and |dx| within
    :data:`EIGH6_DX_RTOL` of their condition; the condition from its own
    w6; the two launches equal bit for bit."""
    from icet_tpu_torch.ops.gn_eigh6 import gn_eigh6, gn_eigh6_reference

    got = gn_eigh6(*args)
    again = gn_eigh6(*args)
    Xr, wr, kr, Ur, _, dr, nr = gn_eigh6_reference(*args)
    Xk, wk, kk, Uk, ck, dk, nk = got
    X = args[2]
    scale = float(wr.abs().max())
    w_err = float((wk - wr).abs().max()) / scale
    check(w_err <= EIGH6_W_RTOL, f"{what}: w6 {w_err:.3e} of max |w| off the plain version's "
          f"(limit {EIGH6_W_RTOL})")
    check(torch.equal(kk, kr) and int(nk) == int(nr),
          f"{what}: keep {kk.tolist()} / {kr.tolist()}, dropped {int(nk)} / {int(nr)} "
          "(kernel / plain)")
    r_err = float(((Uk * wk) @ Uk.T - (Ur * wr) @ Ur.T).abs().max()) / scale
    check(r_err <= EIGH6_RECON_RTOL, f"{what}: U2 diag(w6) U2^T {r_err:.3e} of max |w| off "
          f"the plain version's (limit {EIGH6_RECON_RTOL})")
    v_ratio, flips, compared = 0.0, 0, 0
    w_host = wr.double().cpu().numpy()
    for c in range(6):
        gap = min(abs(w_host[c] - w_host[k]) for k in range(6) if k != c) / scale
        if gap < EIGH6_GAP:
            continue
        sign = 1.0 if float(Uk[:, c] @ Ur[:, c]) >= 0 else -1.0
        flips += sign < 0
        compared += 1
        err = float((Uk[:, c] - sign * Ur[:, c]).abs().max())
        v_ratio = max(v_ratio, err * gap / EIGH6_VEC_TOL)
    check(v_ratio <= 1.0, f"{what}: an eigenvector {v_ratio:.3f} of its limit off the plain "
          "version's")
    kappa = scale / float(wr.abs()[kr].min())
    dx = float((Xr - X).abs().max())
    x_lim = EIGH6_DX_RTOL * kappa * dx + 2 * 2.0**-23 * float(Xr.abs().max())
    x_err = float((Xk - Xr).abs().max())
    check(x_err <= x_lim, f"{what}: X + dx {x_err:.3e} off the plain version's (limit "
          f"{x_lim:.3e}, condition {kappa:.3e})")
    d_err = abs(float(dk) - float(dr))
    check(d_err <= math.sqrt(6) * x_lim, f"{what}: |dx| {d_err:.3e} off the plain version's")
    cond = torch.abs(wk[-1]) / torch.clamp(torch.abs(wk[0]), min=1e-30)
    check(torch.equal(ck, cond), f"{what}: the condition is not |w6[5]| / |w6[0]| of its w6")
    check(all(torch.equal(gn_bits(a), gn_bits(b)) for a, b in zip(got, again)),
          f"{what}: two launches differ")
    report.append(f"{what}: w6 {w_err:.2e}, U2 diag(w6) U2^T {r_err:.2e} of max |w|, "
                  f"{compared} columns within {v_ratio:.3f} of their limit ({flips} of opposite "
                  f"sign), X + dx {x_err:.2e} ({x_err / x_lim:.3f} of its limit), "
                  f"{int(nk)} dropped, two launches equal")
    return {"w": w_err, "recon": r_err, "vec": v_ratio, "x": x_err / x_lim}


def runner_launches(label: str, wrapper, wants: dict, scans, dev, report: list) -> dict:
    """``wrapper``'s launches a frame of the compiled runners named in
    ``wants`` (``"odometry"``, ``"filtered odometry"``, ``"mapping"``) at
    the benchmark's configurations, on lap frames: ``wants[name]`` a frame
    once the first two frames have captured the runner's graphs."""
    from icet_tpu_torch import graphs
    from icet_tpu_torch.config import MapConfig, OdometryConfig
    from icet_tpu_torch.mapping import MapMaker
    from icet_tpu_torch.odometry import OdometryPipeline
    from benchmark.common import solver_config

    def odometry(c):
        return OdometryPipeline(solver_config(c), OdometryConfig(
            divergence_clamp=c["divergence_clamp"], warm_start=c["warm_start"],
            warm_start_mode=c["warm_start_mode"], sensor_hz=c["sensor"]["rate_hz"]), device=dev)

    def mapping(c):
        return MapMaker(solver_config(c), MapConfig(capacity=c["capacity"],
                                                    points_per_scan=c["points_per_scan"]),
                        OdometryConfig(divergence_clamp=c["divergence_clamp"]), seed=1,
                        device=dev, snapshot_every=c["snapshot_every"])

    makers = {"odometry": lambda: odometry(bench_config("os1-64.odo")),
              "filtered odometry": lambda: odometry(bench_config("os1-64.odo-dnn")),
              "mapping": lambda: mapping(bench_config("os1-64.map"))}
    per_frame = {}
    for name, want in wants.items():
        runner, counts = makers[name](), []
        for s in scans:
            settle()
            before = wrapper.launches
            runner.step(s.cpu().numpy())
            settle()
            counts.append(wrapper.launches - before)
        check(all(k == want for k in counts[2:]),
              f"{name}: {label} launches a frame {counts} (after two frames {want} each "
              "expected)")
        per_frame[name] = counts
        report.append(f"compiled {name} at the benchmark's configuration: {label} launches a "
                      f"frame {counts} (the first two capture)")
        del runner
        graphs.clear(dev)
    return per_frame


def eigh6_timing(cold: tuple, warm: tuple) -> dict:
    """Kernel #7 and its plain chain, cold and warm: device ms a call and
    device operations a call (torch.profiler), CUDA-event ms a call of
    back-to-back launches."""
    from icet_tpu_torch.ops.gn_eigh6 import gn_eigh6, gn_eigh6_reference

    out = {}
    for name, args in (("cold", cold), ("warm", warm)):
        k_ms, k_event_ms = kernel_times(lambda: gn_eigh6(*args), 50)
        plain_ops = device_profile(lambda: gn_eigh6_reference(*args), 3)
        out[name] = {"ms": k_ms, "event_ms": k_event_ms,
                     "plain_ms": sum(ms for ms, _ in plain_ops.values()),
                     "plain_launches": sum(k for _, k in plain_ops.values())}
    return out


def phase_gn_eigh6(dev, card) -> dict:
    """Kernel #7 against its plain version on the card: the iterations of
    lap solves at 75x24 and 150x48, random SPD matrices at condition numbers
    1e2-1e9 and one with a repeated eigenvalue, cold and warm with both
    outcomes of the warm test; two launches and two graph replays bit for
    bit; one device operation a call; the launches a frame of the compiled
    runners; its ms cold and warm beside the plain chain's."""
    from icet_tpu_torch import _build
    from icet_tpu_torch.ops.gn_eigh6 import gn_eigh6
    from benchmark.common import solver_config

    t0 = time.perf_counter()
    for name, usage in ptxas_usage(_build.build(["gn_eigh6"])).items():
        print(f"ptxas {name}: {usage}")
    report, worst = [], {"w": 0.0, "recon": 0.0, "vec": 0.0, "x": 0.0}
    outcomes = {True: 0, False: 0}
    scans = lap_scans(dev, EIGH6_LAP_FIRST, max(EIGH6_LAP_PAIRS + 1, EIGH6_RUNNER_FRAMES))
    cfg = solver_config(bench_config("os1-64.odo"))
    cases = []
    for grid, kw in (("75x24", {}), ("150x48", {"n_theta": 150, "n_phi": 48})):
        for k in range(EIGH6_LAP_PAIRS):
            for it, args in enumerate(eigh6_solve_inputs(scans[k], scans[k + 1],
                                                         cfg.replace(**kw))):
                cases.append((f"lap {grid} frames {EIGH6_LAP_FIRST + k}-"
                              f"{EIGH6_LAP_FIRST + k + 1} iteration {it}", args))
    check(len(cases) == 2 * EIGH6_LAP_PAIRS * cfg.n_iters,
          f"{len(cases)} eigensystems in the lap solves")
    cases += eigh6_random_inputs(dev, cfg.condition_cutoff)
    for what, args in cases:
        if args[3] is not None:
            flag = eigh6_converged(args[0], args[3])
            outcomes[flag] += 1
            what = f"{what} (warm test {'passes' if flag else 'fails'})"
        r = eigh6_compare(what, args, report)
        worst = {k: max(v, r[k]) for k, v in worst.items()}
    check(outcomes[True] > 0 and outcomes[False] > 0,
          f"the warm test's outcomes {outcomes}: one branch untested")
    cold, warm = cases[0][1], cases[1][1]
    for name, args in (("cold", cold), ("warm", warm)):
        check_one_launch(f"lap 75x24 {name}", lambda: gn_eigh6(*args), gn_eigh6,
                         "gn_eigh6_kernel", report)
        graph_replays(f"lap 75x24 {name}", lambda: gn_eigh6(*args), dev, report)
    odo_c, map_c = bench_config("os1-64.odo"), bench_config("os1-64.map")
    launches = runner_launches("#7", gn_eigh6, {"odometry": odo_c["n_iters"],
                                                "mapping": map_c["n_iters"]},
                               scans[:EIGH6_RUNNER_FRAMES], dev, report)
    times = eigh6_timing(cold, warm)
    for line in report:
        print(f"gn_eigh6 vs plain, {line}")
    print(f"gn_eigh6: warm test passed {outcomes[True]}, failed {outcomes[False]}; worst w6 "
          f"{worst['w']:.3e}, reconstruction {worst['recon']:.3e} of max |w|, eigenvectors "
          f"{worst['vec']:.3f} and X + dx {worst['x']:.3f} of their limits")
    for name, t in times.items():
        print(f"gn_eigh6 {name} ({card}): {t['ms']:.5f} ms a launch (CUDA events "
              f"{t['event_ms']:.5f}); plain chain {t['plain_ms']:.4f} ms in "
              f"{t['plain_launches']:g} device operations")
    print(f"phase 32: {time.perf_counter() - t0:.1f} s")
    return {"worst": worst, "times": times, "launches": launches, "outcomes": outcomes}


# ---------------------------------------------------------------------------
# Kernel #8: the prepare's voxel-model fit
# ---------------------------------------------------------------------------

#: the fit's grids on lap frames: the benchmark's 75x24, 150x48, fixed radial
#: mode, and 75x24 with the NDT test and with the clip-fill guard
FIT_GRIDS = (("75x24", {}), ("150x48", {"n_theta": 150, "n_phi": 48}),
             ("fixed", {"radial_mode": "fixed"}), ("75x24 ndt", {"suppression": "ndt"}),
             ("75x24 clip_fill 0.6", {"clip_fill": 0.6}))
#: the lap frames whose fits are compared
FIT_LAP_FIRST, FIT_LAP_FRAMES = 100, 2
#: the model's fields as ``model_fit`` returns them
FIT_FIELDS = ("count", "mean", "cov", "basis", "lmask", "valid")


def fit_inputs(scan, cfg) -> tuple:
    """``model_fit``'s arguments in ``prepare_reference`` of ``scan`` on the
    card."""
    from icet_tpu_torch import solver

    with spy(solver, "model_fit") as calls:
        solver.prepare_reference(scan, cfg)
    (sums, clusters, anchors, c), _ = calls.args[0]
    return sums.clone(), type(clusters)(*(t.clone() for t in clusters)), anchors.clone(), c


def fit_extra_sweeps(sums, anchors, sweeps: int) -> int:
    """The extra sweeps ``eigh3_planes`` commits after ``sweeps`` on these
    sums, its flags read on the host."""
    from icet_tpu_torch.ops import wls_planes
    from icet_tpu_torch.ops.model_fit import RTOL
    from icet_tpu_torch.ops.moments import finalize_moments_planes

    A = [list(r) for r in wls_planes._sym_planes(finalize_moments_planes(sums, anchors)[2])]
    V = wls_planes._identity_planes(A[0][0])
    for _ in range(sweeps):
        A, V = wls_planes._sweep3(A, V)
    extra = 0
    while extra < 2 and bool(wls_planes._unconverged3(A, RTOL)):
        A, V = wls_planes._sweep3(A, V)
        extra += 1
    return extra


def fit_safeguard_cases(sums, clusters, anchors, cfg) -> list[tuple[str, tuple, int]]:
    """``(name, model_fit arguments, extra sweeps wanted)``: the lap fit at
    4 sweeps (its rows converge: none), at 0 sweeps (two); every row made
    diagonal (its mean at the anchor, no cross moments) but one whose x-y
    block needs one rotation, at 0 sweeps (one), that row the sentinel or
    an invalid row in the middle of the table."""
    cases = [("lap, 4 sweeps", (sums, clusters, anchors, cfg, 4), 0),
             ("lap, 0 sweeps", (sums, clusters, anchors, cfg, 0), 2)]
    diag = sums.clone()
    diag[:, 1:4] = 0.0
    diag[:, 7:10] = 0.0
    one = torch.tensor([30.0, 0.0, 0.0, 0.0, 2.0, 1.0, 1.0, 0.5], device=sums.device)
    for where, row in (("the sentinel", sums.shape[0] - 1), ("an invalid row",
                                                             sums.shape[0] // 2)):
        s = diag.clone()
        s[row, :8] = one
        found = clusters.found.clone()
        found[row] = False
        cases.append((f"diagonal but {where}, 0 sweeps",
                      (s, type(clusters)(clusters.bounds, found), anchors, cfg, 0), 1))
    return cases


def fit_compare(what: str, args: tuple, report: list) -> None:
    """Kernel #8 against its plain version on the card, twice: every field
    of the model equal bit for bit, and the two launches too."""
    from icet_tpu_torch.ops.model_fit import model_fit, model_fit_reference

    got = model_fit(*args)
    again = model_fit(*args)
    want = model_fit_reference(*args)
    for name, g, w in zip(FIT_FIELDS, got, want):
        check(g.dtype == w.dtype and g.shape == w.shape and torch.equal(gn_bits(g), gn_bits(w)),
              f"{what}: {name} differs from the plain version's in "
              f"{int((g != w).reshape(g.shape[0], -1).any(-1).sum())} rows")
    check(all(torch.equal(gn_bits(a), gn_bits(b)) for a, b in zip(got, again)),
          f"{what}: two launches differ")
    report.append(f"{what}: {int(got[5].sum())} valid of {got[0].shape[0]} rows, "
                  f"{int(got[4].sum())} axes kept, every field equal to the plain version's "
                  "bit for bit, two launches equal")


def fit_timing(args: tuple) -> dict:
    """Kernel #8 and its plain chain on one fit: device ms a call and device
    operations a call (torch.profiler), CUDA-event ms a call of
    back-to-back calls, and the bound (the sums, bounds, found flags and
    anchors read once, the model written, at 3.35 TB/s)."""
    from icet_tpu_torch.ops.model_fit import model_fit, model_fit_reference

    rows = args[0].shape[0]
    k_ms, k_event_ms = kernel_times(lambda: model_fit(*args), 50)
    plain_ops = device_profile(lambda: model_fit_reference(*args), 3)
    b_ms, by = bound(rows * ((16 + 2 + 3) * 4 + 1 + (1 + 3 + 9 + 9 + 3) * 4 + 1), 0,
                     PEAK_FP32_PER_S)
    return {"rows": rows, "ms": k_ms, "event_ms": k_event_ms,
            "plain_ms": sum(ms for ms, _ in plain_ops.values()),
            "plain_launches": sum(k for _, k in plain_ops.values()),
            "bound_ms": b_ms, "bound_by": by}


def phase_model_fit(dev, card) -> dict:
    """Kernel #8 against its plain version on the card: the fits of lap
    frames at 75x24, 150x48, fixed radial mode, with the NDT test and with
    the clip-fill guard, and fits whose safeguard commits 0, 1 and 2 extra
    sweeps (one held only by the sentinel or an invalid row), every field
    bit for bit; two launches and two graph replays bit for bit; two device
    operations a fit; the launches a frame of the compiled runners; its ms
    at 1,801, 7,201 and 90,001 rows beside the plain chain's."""
    from icet_tpu_torch import _build
    from icet_tpu_torch.ops.model_fit import LAUNCHES, model_fit
    from benchmark.common import solver_config

    t0 = time.perf_counter()
    for name, usage in ptxas_usage(_build.build(["model_fit"])).items():
        print(f"ptxas {name}: {usage}")
    report, extras, timed = [], {}, {}
    scans = lap_scans(dev, FIT_LAP_FIRST, max(FIT_LAP_FRAMES, EIGH6_RUNNER_FRAMES))
    cfg = solver_config(bench_config("os1-64.odo"))
    for k in range(FIT_LAP_FRAMES):
        for grid, kw in FIT_GRIDS:
            sums, clusters, anchors, c = fit_inputs(scans[k], cfg.replace(**kw))
            args = (sums, clusters, anchors, c)
            what = f"lap frame {FIT_LAP_FIRST + k} {grid} (V+1={sums.shape[0]})"
            extras[what] = fit_extra_sweeps(sums, anchors, 4)
            fit_compare(f"{what}, {extras[what]} extra sweeps", args, report)
            if k == 0 and not kw.get("suppression") and not kw.get("clip_fill"):
                timed[grid] = args
            if k == 0 and grid == "75x24":
                for name, sargs, want in fit_safeguard_cases(*args):
                    got = fit_extra_sweeps(sargs[0], sargs[2], sargs[4])
                    check(got == want, f"{name}: the plain version commits {got} extra "
                          f"sweeps, the case wants {want}")
                    extras[name] = got
                    fit_compare(f"{name} ({got} extra sweeps)", sargs, report)
    check({0, 1, 2} <= set(extras.values()), f"extra sweeps {sorted(set(extras.values()))}: "
          "a branch of the safeguard is untested")
    args = timed["75x24"]
    check_one_launch("lap 75x24", lambda: model_fit(*args), model_fit, "model_fit_kernel",
                     report, launches=LAUNCHES)
    graph_replays("lap 75x24", lambda: model_fit(*args), dev, report)
    graph_replays("lap fixed", lambda: model_fit(*timed["fixed"]), dev, report)
    launches = runner_launches("#8", model_fit, dict.fromkeys(
        ("odometry", "filtered odometry", "mapping"), LAUNCHES), scans[:EIGH6_RUNNER_FRAMES],
        dev, report)
    times = {grid: fit_timing(a) for grid, a in timed.items()}
    for line in report:
        print(f"model_fit vs plain, {line}")
    for grid, t in times.items():
        print(f"model_fit {grid} ({t['rows']} rows, {card}): {t['ms']:.5f} ms a fit (CUDA "
              f"events {t['event_ms']:.5f}), bound {t['bound_ms']:.6f} ({t['bound_by']}); "
              f"plain chain {t['plain_ms']:.4f} ms in {t['plain_launches']:g} device operations")
    print(f"phase 33: {time.perf_counter() - t0:.1f} s")
    return {"times": times, "launches": launches, "extras": extras}


def time_tree(spec: dict) -> int:
    """A spawned process of phase 28c: the compiled entry points of the tree
    at ``spec["root"]`` (this one or an earlier one; only the entry points
    both keep are called) timed on the drives in ``spec["data"]``, ms a
    frame, a pair or a solve by CUDA events after one warm call; the times
    written to ``spec["out"]`` as JSON."""
    sys.path.insert(0, spec["root"])
    import icet_tpu_torch

    check(os.path.dirname(os.path.abspath(icet_tpu_torch.__file__))
          == os.path.join(os.path.abspath(spec["root"]), "icet_tpu_torch"),
          f"the tree at {spec['root']} was not imported")
    from icet_tpu_torch import _build
    from icet_tpu_torch import pose_graph
    from icet_tpu_torch.config import (PROFILES, BlockMapConfig, ICETConfig, KeyframeConfig,
                                       MapConfig, OdometryConfig)
    from icet_tpu_torch.keyframe import KeyframeOdometry, run_keyframe_device
    from icet_tpu_torch.mapping import MapMaker
    from icet_tpu_torch.odometry import OdometryPipeline, odometry_sequence_jit
    from icet_tpu_torch.parallel.sharding import (make_sharded_register, registration_mesh,
                                                  shard_scan_batch)
    from icet_tpu_torch.solver import prepare_reference_jit, register_pair_jit

    _build.build()
    dev = torch.device("cuda")
    data = np.load(spec["data"])
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)
    odo = OdometryConfig(divergence_clamp=2.5)
    kf_cfg = KeyframeConfig(**spec["kf"])
    bm_cfg = BlockMapConfig(**spec["bm"])
    drive = torch.from_numpy(data["scans"]).to(dev)
    wide = torch.from_numpy(data["wide"]).to(dev)
    out = {}

    def timed(name, fn, per, rounds=5):
        fn()
        torch.cuda.synchronize()
        out[name] = median_ms(fn, reps=1, rounds=rounds) / per

    def sequence(frames, c=cfg):
        model = prepare_reference_jit(frames[0], c)

        def run():
            odometry_sequence_jit(frames[1:], model, torch.zeros(6, device=dev),
                                  torch.eye(4, device=dev), c, 2.5, True, "previous")
        return run

    short = drive[:TIMED_FRAMES]

    def runner(name, r):
        # Frames 0-1 capture (a new ring's map graphs among them); 2 on timed.
        r.step(short[0])
        r.step(short[1])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for s in short[2:]:
            r.step(s)
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / (len(short) - 2)

    # The card's clocks ramp up over the first second of work: burn in.
    burn, t0 = sequence(drive), time.perf_counter()
    while time.perf_counter() - t0 < 2.0:
        burn()
    torch.cuda.synchronize()
    timed("sequence frame 64x1024", sequence(drive), drive.shape[0] - 1)
    timed("sequence frame 64x2048", sequence(wide), wide.shape[0] - 1)
    timed("scatter-route frame 64x1024", sequence(short, cfg.replace(moment_method="pallas")),
          len(short) - 1)
    timed("fixed-radial-mode frame 64x1024",
          sequence(short, cfg.replace(radial_mode="fixed")), len(short) - 1)
    timed("150x48 frame 64x1024", sequence(short, cfg.replace(n_theta=150, n_phi=48)),
          len(short) - 1)
    runner("DNN frame 64x1024", OdometryPipeline(cfg.replace(dnn_filter=True), odo, device=dev))
    runner("keyframe frame 64x1024", KeyframeOdometry(cfg, kf_cfg, bm_cfg, device=dev))
    # The whole drive through the public runner, its uploads and seed spawn included.
    timed("keyframe sequence frame 64x1024",
          lambda: run_keyframe_device(data["scans"], cfg, kf_cfg, bm_cfg, device=dev),
          drive.shape[0] - 1, 3)
    runner("MapMaker frame 64x1024", MapMaker(PROFILES["mapping"], MapConfig(), odo, device=dev))
    lcfg = ICETConfig()
    n_pairs = min(8, drive.shape[0] - 3)
    timed("loop pair 64x1024", lambda: [register_pair_jit(
        drive[k], drive[k + 3], torch.zeros(6, device=dev), lcfg, want_static_mask=False)
        for k in range(n_pairs)], n_pairs)
    s1, s2 = data["scans"][:2], data["scans"][1:3]
    x0s = np.zeros((2, 6), np.float32)
    for dp, sp in ((1, 2), (1, 4)):
        mesh = registration_mesh(dp, sp, [dev] * (dp * sp))
        step, batch = make_sharded_register(cfg, mesh), shard_scan_batch(s1, s2, x0s, mesh)
        timed(f"sharded pair ({dp}, {sp})", lambda st=step, bt=batch: st(*bt), 2)
    ring0, ring, _ = ring_graph(RING_POSES)
    timed("sparse solve, 10k ring, 10 x 25",
          lambda: pose_graph.optimize_poses_sparse(ring0, ring, 10, 25, device=dev), 1, 3)
    # The ring's first 250 poses and their odometry factors (a chain).
    chain = pose_graph.PoseGraph(*(t[:249] for t in ring))
    timed("sparse solve, K = 250 chain, 10 x 50, robust 3.5",
          lambda: pose_graph.optimize_poses_sparse(ring0[:250], chain, 10, 50, robust_delta=3.5,
                                                   device=dev), 1, 3)
    timed("dense solve, K = 250 chain, 10 steps",
          lambda: pose_graph.optimize_poses(ring0[:250], chain, 10, device=dev), 1, 3)
    mesh = registration_mesh(2, 1, [dev] * 2)
    timed("sharded sparse solve, 10k ring, 10 x 25",
          lambda: pose_graph.optimize_poses_sparse_sharded(ring0, ring, mesh, 10, 25), 1, 2)
    timed("sharded dense solve, K = 250, 10 steps",
          lambda: pose_graph.optimize_poses_sharded(ring0[:250], chain, mesh, 10), 1, 2)
    with open(spec["out"], "w") as f:
        json.dump(out, f)
    return 0


def parent_times(parent: str) -> int:
    """``--parent DIR`` (an earlier tree unpacked there), in place of the
    phases: the compiled paths of the parent tree and of this one, each
    timed in a process of its own (``--time-tree``), in the turns parent,
    this, this, parent, on the sequence drive (and 8 frames of it at
    64x2048)."""
    import tempfile

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from icet_tpu_torch.config import BlockMapConfig, KeyframeConfig
    from icet_tpu_torch.datasets.replay import CityDriveSource

    card = device_line()
    scans, wide = (np.stack([s for s, _ in CityDriveSource(n_frames=f, speed=1.0, n_beams=64,
                                                            n_azimuth=az)]).astype(np.float32)
                   for f, az in ((24, 1024), (8, 2048)))
    kf_cfg = KeyframeConfig(spawn_distance=3.0, spawn_angle=0.3, delta_clamp=2.5)
    bm_cfg = BlockMapConfig()
    times = {"parent": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "drives.npz")
        np.savez(data, scans=scans, wide=wide)
        for k, (name, root) in enumerate((("parent", parent), ("this", ROOT), ("this", ROOT),
                                          ("parent", parent))):
            spec = {"root": os.path.abspath(root), "data": data,
                    "out": os.path.join(tmp, f"times{k}.json"),
                    "kf": dataclasses_dict(kf_cfg), "bm": dataclasses_dict(bm_cfg)}
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--time-tree",
                                   json.dumps(spec)], capture_output=True, text=True,
                                  timeout=TREE_TIMEOUT_S, cwd=tmp)
            check(proc.returncode == 0, f"--time-tree {name} failed:\n{proc.stdout[-3000:]}"
                  f"\n{proc.stderr[-3000:]}")
            with open(spec["out"]) as f:
                times[name].append(json.load(f))
    for path in times["this"][0]:
        p, t = [r[path] for r in times["parent"]], [r[path] for r in times["this"]]
        print(f"{path} ({card}), compiled route of the parent / this / this / parent: "
              f"{p[0]:.3f} / {t[0]:.3f} / {t[1]:.3f} / {p[1]:.3f} ms (CUDA events, median of "
              f"the rounds, each tree in its own process)")
    return 0


def route_pair(scans, x0, c, what: str) -> tuple[np.ndarray, int]:
    """Phases 7 and 14: frames 0 -> 1 registered on the card through the
    fused route (the compiled ``register_pair``; #1's sorted parts), against
    the CPU path (X within 1e-3 m) and beside the same pair on the card at
    ``moment_method="segsum"`` (PyTorch binning, then #3), whether the two
    routes' X are equal bit for bit reported; returns (X, #1's settled
    launches in the fused registration, warm-ups included)."""
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums
    from icet_tpu_torch.ops.moment_scatter import moment_scatter_sums
    from icet_tpu_torch.solver import register_pair

    torch.cuda.synchronize()
    settle()
    fused_moment_sums.launches = 0
    zero_warmups()
    res = register_pair(scans[0], scans[1], x0, c, device="cuda")
    torch.cuda.synchronize()
    settle()
    launches, warm = fused_moment_sums.launches, warmups()
    before = (fused_moment_sums.launches, moment_scatter_sums.launches)
    seg = register_pair(scans[0], scans[1], x0, c.replace(moment_method="segsum"), device="cuda")
    torch.cuda.synchronize()
    settle()
    seg_fused = fused_moment_sums.launches - before[0]
    seg_scat = moment_scatter_sums.launches - before[1]
    cpu = register_pair(scans[0], scans[1], x0, c, device="cpu")
    X, sX, cX = res.X.cpu().numpy(), seg.X.cpu().numpy(), cpu.X.numpy()
    check(launches > warm, f"{what}: #1 launches {launches} with {warm} warm-ups")
    check(seg_fused == 0 and seg_scat > 0,
          f"{what}, segsum: #1 launches {seg_fused}, #3 launches {seg_scat}")
    check(bool(np.isfinite(X).all()) and abs(X[0] - 1.0) < 0.1, f"{what}: X {X}")
    check(float(np.abs(X - cX).max()) <= 1e-3, f"{what}: card X {X} vs CPU X {cX}")
    check(float(np.abs(sX - cX).max()) <= 1e-3, f"{what}, segsum: card X {sX} vs CPU X {cX}")
    print(f"{what} (V = {c.n_voxels}, fused route, #1's sorted parts): #1 launches {launches} "
          f"({warm} warm-ups before capture), {int(res.iterations)} iterations, card X "
          f"{np.round(X, 5).tolist()}, max |card - CPU| {float(np.abs(X - cX).max()):.3e}; "
          f"segsum route on the card: #3 launches {seg_scat}, {int(seg.iterations)} iterations, "
          f"max |fused - segsum| {float(np.abs(X - sX).max()):.3e} (bit-equal: "
          f"{bool(np.array_equal(X, sX))})")
    return X, launches


def dataclasses_dict(obj) -> dict:
    import dataclasses

    return dataclasses.asdict(obj)


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
    from icet_tpu_torch.ops.gn_assembly import gn_assembly
    from icet_tpu_torch.ops.gn_eigh6 import gn_eigh6
    from icet_tpu_torch.ops.model_fit import LAUNCHES as FIT_LAUNCHES
    from icet_tpu_torch.ops.model_fit import model_fit
    from icet_tpu_torch.ops.moment_scatter import moment_scatter_reference, moment_scatter_sums
    from icet_tpu_torch.solver import odometry_step, prepare_reference, register_pair
    from icet_tpu_torch import graphs
    eager_chains = load_eager_chains()

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

    # -- 3a, #1's sorted parts: fixed radial mode and tables past shared memory
    fixed = cfg.replace(radial_mode="fixed")
    fbounds = fixed_shell_bounds(fixed, dev)
    fmodel = types.SimpleNamespace(bounds=fbounds, anchors=voxel_anchors(fbounds, fixed))
    big = cfg.replace(n_theta=150, n_phi=48)     # V + 1 = 7,201
    past = cfg.replace(n_theta=75, n_phi=77)     # V = 5,775, the first past the shared table
    # 800 shells, V + 1 = 1,440,001: a part's bitmap no longer fits shared
    # memory (the points fill the first ~70 shells).
    huge = fixed.replace(n_shells=800)
    hbounds = fixed_shell_bounds(huge, dev)
    hmodel = types.SimpleNamespace(bounds=hbounds, anchors=voxel_anchors(hbounds, huge))
    bmodel = prepare_reference(torch.from_numpy(scans[0]).to(dev), big)
    pmodel = prepare_reference(torch.from_numpy(scans[0]).to(dev), past)
    wide_pts = torch.from_numpy(np.ascontiguousarray(next(iter(CityDriveSource(
        n_frames=1, speed=1.0, n_beams=64, n_azimuth=2048)))[0], np.float32)).to(dev)
    wperm = torch.from_numpy(rng.permutation(wide_pts.shape[0])).to(dev)
    fvox_pts, fvox_model = one_voxel_case(fixed, dev, pts.shape[0], rng)
    ffar = types.SimpleNamespace(bounds=torch.full_like(fbounds, 1e4), anchors=fmodel.anchors)
    fsingle = next(k for k in range(0, pts.shape[0], 97)
                   if edge_points(pts[k:k + 1], X_step, fixed) == 0
                   and float(fused_moment_sums_reference(pts[k:k + 1], X_step, fbounds,
                                                         fmodel.anchors, fixed)[:, 0].sum()) == 1.0)
    large_cases = {
        "fixed X=0": (pts, zero6, fmodel, fixed),
        "fixed X=1m/0.02rad": (pts, X_step, fmodel, fixed),
        "fixed X=3m/0.1rad": (pts, cases["X=3m/0.1rad"][1], fmodel, fixed),
        "fixed shuffled": (cases["shuffled"][0], X_step, fmodel, fixed),
        "fixed nan+zero rows": (cases["nan+zero rows"][0], X_step, fmodel, fixed),
        "fixed N=131072": (wide_pts, X_step, fmodel, fixed),
        "fixed N=131072 shuffled": (wide_pts[wperm].contiguous(), X_step, fmodel, fixed),
        "fixed one voxel, N=65536": (fvox_pts, zero6, fvox_model, fixed),
        "fixed no member": (pts, X_step, ffar, fixed),
        "fixed N=1": (pts[fsingle:fsingle + 1].contiguous(), X_step, fmodel, fixed),
        "fixed N=65537": (torch.cat([pts, pts[fsingle:fsingle + 1]]).contiguous(), X_step, fmodel,
                          fixed),
        "150x48 X=1m/0.02rad": (pts, X_step, bmodel, big),
        "150x48 shuffled": (cases["shuffled"][0], X_step, bmodel, big),
        "75x77 X=1m/0.02rad": (pts, X_step, pmodel, past),
        "fixed 800 shells (bitmap in device memory)": (pts, X_step, hmodel, huge),
    }
    report, large_err = [], 0.0
    for name, (p, X, m, c) in large_cases.items():
        err, outs[name] = compare(f"{name} (V+1={c.n_voxels + 1})", p, X, m, c, report)
        large_err = max(large_err, err)
    check(torch.equal(outs["fixed shuffled"][:, 0], outs["fixed X=1m/0.02rad"][:, 0])
          and torch.equal(outs["150x48 shuffled"][:, 0], outs["150x48 X=1m/0.02rad"][:, 0]),
          "sorted parts: shuffled order changed the kernel's counts")
    vox = outs["fixed one voxel, N=65536"][:, 0]
    check(float(vox.sum()) == fvox_pts.shape[0] and int((vox > 0).sum()) == 1,
          "sorted parts, one voxel: not every point counted in one row")
    check(bool((outs["fixed no member"] == 0).all()), "sorted parts, no member: nonzero sums")
    check(float(outs["fixed N=1"][:, 0].sum()) == 1.0,
          "sorted parts, N=1: the point is not counted once")
    check(torch.equal(outs["fixed N=65537"][:, 0] - outs["fixed X=1m/0.02rad"][:, 0],
                      outs["fixed N=1"][:, 0]),
          "sorted parts, N=65537: counts are not N=65536's plus N=1's")
    # One device operation a call (no memset, no second kernel) and no host
    # synchronisation, in both branches of the sorted parts.
    for name, (p, m, c) in {"sorted parts, fixed": (pts, fmodel, fixed),
                            "sorted parts, 150x48": (pts, bmodel, big),
                            "sorted parts, bitmap in device memory": (pts, hmodel, huge)}.items():
        check_one_launch(name, lambda: fused_moment_sums(p, X_step, m.bounds, m.anchors, c),
                         fused_moment_sums, "fused_large_kernel", report)
    for line in report:
        print(f"fused moments (sorted parts) vs plain, {line}")

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
    report = []
    vid_s, feats_s = scatter_inputs(pts, X_step, model.bounds, model.anchors, cfg)
    vid_f, feats_f = scatter_inputs(pts, X_step, fbounds, voxel_anchors(fbounds, fixed), fixed)
    scat_err = max(scatter_compare("shared table", vid_s, feats_s, cfg.n_voxels, report),
                   scatter_compare("sorted parts", vid_f, feats_f, fixed.n_voxels, report))
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
                             "sorted parts": (vid_f, feats_f, fixed.n_voxels)}.items():
        check_one_launch(name, lambda: moment_scatter_sums(v, f, nv), moment_scatter_sums,
                         "scatter_kernel", report)
    for line in report:
        print(f"scatter vs index_add_, {line}")

    # -- 31. kernel #6, the normal-equation assembly, vs plain ---------------
    gn = phase_gn_assembly(torch.from_numpy(scans[0]).to(dev), torch.from_numpy(scans[1]).to(dev),
                           cfg, dev, card)

    # -- 32. kernel #7, the 6x6 eigensystem and its update, vs plain -------
    eigh6 = phase_gn_eigh6(dev, card)

    # -- 33. kernel #8, the prepare's voxel-model fit, vs plain -------------
    fit = phase_model_fit(dev, card)

    # -- sequence odometry ------------------------------------------------
    torch.cuda.synchronize()
    settle()
    fused_moment_sums.launches = 0
    gn_assembly.launches = 0
    gn_eigh6.launches = 0
    model_fit.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    out = run_odometry_device(scans, cfg, odo, device="cuda")
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    settle()
    fused_launches = fused_moment_sums.launches
    seq_warm = warmups()
    gn_launches, gn_warm = gn_assembly.launches, warmups("gn_assembly")
    eigh6_launches, eigh6_warm = gn_eigh6.launches, warmups("gn_eigh6")
    fit_launches, fit_warm = model_fit.launches, warmups("model_fit")
    iters = [f.iterations for f in out]
    check(len(out) == len(scans) - 1, f"{len(out)} frames out of {len(scans) - 1}")
    check(all(np.isfinite(f.X).all() and np.isfinite(f.pred_stds).all() for f in out),
          "non-finite X or pred_stds")
    check(not any(f.diverged for f in out), "a frame diverged")
    check(fused_launches == sum(iters) + len(scans) + seq_warm,
          f"fused launches {fused_launches} != iterations {sum(iters)} + prepares {len(scans)} "
          f"+ warm-ups before capture {seq_warm}")
    check(gn_launches == sum(iters) + gn_warm,
          f"#6 launches {gn_launches} != iterations {sum(iters)} + warm-ups {gn_warm}")
    check(eigh6_launches == sum(iters) + eigh6_warm,
          f"#7 launches {eigh6_launches} != iterations {sum(iters)} + warm-ups {eigh6_warm}")
    check(fit_launches == FIT_LAUNCHES * len(scans) + fit_warm,
          f"#8 launches {fit_launches} != {FIT_LAUNCHES} x prepares {len(scans)} + warm-ups "
          f"{fit_warm}")
    ate = trajectory_ate(out, gt)
    print(f"sequence odometry (compiled): {len(out)} frames in {path_s:.2f} s with the graphs' "
          f"capture, fused launches {fused_launches} = {sum(iters)} iterations + {len(scans)} "
          f"prepares + {seq_warm} warm-ups before capture, "
          f"mean iterations/frame {np.mean(iters):.3f}, ATE {ate * 100:.3f} cm; "
          f"#6 launches {gn_launches} = {sum(iters)} iterations + {gn_warm} warm-ups; "
          f"#7 launches {eigh6_launches} = {sum(iters)} iterations + {eigh6_warm} warm-ups; "
          f"#8 launches {fit_launches} = {FIT_LAUNCHES} x {len(scans)} prepares + {fit_warm} "
          "warm-ups")
    check(ate <= ATE_MAX_M, f"ATE {ate * 100:.3f} cm above {ATE_MAX_M * 100} cm")

    # -- DNN-filtered odometry --------------------------------------------
    # n_pre = max(min(dnn_start_iter, n_iters - 1), 1) plain iterations, then
    # n_post filtered ones, each with one filter pass (one fused-moments
    # launch over the aligned scan, refine_steps encoder launches).
    n_pre = max(min(dcfg.dnn_start_iter, dcfg.n_iters - 1), 1)
    n_post = dcfg.n_iters - n_pre
    torch.cuda.synchronize()
    settle()
    fused_moment_sums.launches = 0
    bias_encoder_pool.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    dout = list(OdometryPipeline(dcfg, odo, device="cuda").run(scans))
    torch.cuda.synchronize()
    dnn_s = time.perf_counter() - t0
    settle()
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
    dout_eager = eager_chains.odometry(on_device(scans, "cuda"), dcfg, odo, net)
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

    # -- pallas moments and the one-hot route, compiled and eager ----------
    pcfg = cfg.replace(moment_method="pallas")
    scat_launches = phase_routes(scans, gt, cfg, dcfg, odo, dev, card)

    # -- 7. fixed radial mode: #1's sorted parts -----------------------------
    # Seeded 10 cm off the drive's 1 m step, as a warm start would be.
    x0 = np.array([0.9, 0.05, 0.0, 0.0, 0.0, 0.0], np.float32)
    _, large_launches = route_pair(scans, x0, fixed, "fixed radial mode")


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
    settle()
    fused_moment_sums_windowed.launches = 0
    win_path = [fused_moment_sums_windowed(drive[k + 1], torch.from_numpy(out[k].X).to(dev),
                                           models[k].bounds, models[k].anchors, cfg,
                                           WIN_BLOCK, WIN_WINDOW)
                for k in range(len(models))]
    torch.cuda.synchronize()
    settle()
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
    settle()
    fused_moment_sums.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    kout, bm = run_keyframe_device(scans, cfg, kf_cfg, bm_cfg, device="cuda")
    torch.cuda.synchronize()
    kf_s = time.perf_counter() - t0
    settle()
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
    keager, _, keager_kfs = eager_chains.keyframe_odometry(on_device(scans, "cuda"), cfg,
                                                           kf_cfg, bm_cfg)
    kf_eager_ate = trajectory_ate(keager, gt)
    print(f"keyframe odometry (compiled): {len(kout)} frames in {kf_s:.2f} s with the graphs' "
          f"capture, keyframes {kf_idx} (JAX package on the CPU: {KF_INDICES_REF}), fused "
          f"launches {kf_fused} = {kiters} iterations + {len(kf_idx)} keyframe prepares + "
          f"{kf_warm} warm-ups, block map {fill} points in {bm.n_blocks} blocks (expected "
          f"{want_fill:.1f}), ATE {kf_ate * 100:.4f} cm, host loop {kf_host_ate * 100:.4f} cm "
          f"(eager chain: {kf_eager_ate * 100:.4f} cm, keyframes "
          f"{keager_kfs}; JAX package on the CPU: {KF_ATE_REF_M * 100:.4f} cm)")
    for name, a in (("device runner", kf_ate), ("host loop", kf_host_ate),
                    ("eager chain", kf_eager_ate)):
        check(a <= KF_ATE_REF_M + ATE_SLACK_M,
              f"keyframe {name} ATE {a * 100:.4f} cm above "
              f"{(KF_ATE_REF_M + ATE_SLACK_M) * 100:.4f} cm")

    # -- DNN-filtered keyframe odometry -----------------------------------
    torch.cuda.synchronize()
    settle()
    fused_moment_sums.launches = 0
    bias_encoder_pool.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    dkodo = KeyframeOdometry(dcfg, kf_cfg, bm_cfg, device="cuda")
    dkout = dkodo.run(scans)
    torch.cuda.synchronize()
    dkf_s = time.perf_counter() - t0
    settle()
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
    dkeager, _, dkeager_kfs = eager_chains.keyframe_odometry(on_device(scans, "cuda"), dcfg,
                                                             kf_cfg, bm_cfg, net)
    dkf_eager_ate = trajectory_ate(dkeager, gt)
    print(f"DNN-filtered keyframe odometry (compiled): {len(dkout)} frames in {dkf_s:.2f} s "
          f"with the graphs' capture, keyframes {dkodo.keyframe_indices} (JAX package on the "
          f"CPU: {DNN_KF_INDICES_REF}), encoder launches {dkf_enc} = {want_enc} + "
          f"{dkf_enc_warm} warm-ups, fused launches {dkf_fused} = {dk_iters} iterations + "
          f"{len(dkout) * n_post} filter passes + {n_kf} keyframe prepares + {dkf_warm} "
          f"warm-ups, ATE {dkf_ate * 100:.4f} cm (eager: {dkf_eager_ate * 100:.4f} cm, "
          f"keyframes {dkeager_kfs}; JAX package on the CPU: "
          f"{DNN_KF_ATE_REF_M * 100:.4f} cm)")
    for what, a in (("compiled", dkf_ate), ("eager", dkf_eager_ate)):
        check(a <= DNN_KF_ATE_REF_M + ATE_SLACK_M,
              f"DNN keyframe ({what}) ATE {a * 100:.4f} cm above "
              f"{(DNN_KF_ATE_REF_M + ATE_SLACK_M) * 100:.4f} cm")

    # -- MapMaker -----------------------------------------------------------
    # The compiled route (map_step_jit), its graphs captured here with no
    # host synchronisation, against the eager chain frame by frame.
    mcfg, map_cfg = PROFILES["mapping"], MapConfig()
    torch.cuda.synchronize()
    settle()
    fused_moment_sums.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    maker = MapMaker(mcfg, map_cfg, odo, device="cuda")
    with graphs.sync_debug("error"):
        mout = [f for f in (maker.step(s) for s in scans) if f is not None]
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    settle()
    map_fused, map_warm = fused_moment_sums.launches, warmups()
    settle()
    fused_moment_sums.launches = 0
    t0 = time.perf_counter()
    mout_e, maker_e_state = eager_chains.map_maker(on_device(scans, "cuda"), mcfg, map_cfg, odo)
    torch.cuda.synchronize()
    settle()
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
    ring_equal = all(torch.equal(getattr(maker.state, k), getattr(maker_e_state, k))
                     for k in ("points", "valid", "trail"))
    check((maker.state.write_ptr, maker.state.trail_len)
          == (maker_e_state.write_ptr, maker_e_state.trail_len)
          and [(f.diverged, f.n_map_points) for f in mout]
          == [(f.diverged, f.n_map_points) for f in mout_e],
          "MapMaker: compiled flags, fill or counters differ from the eager chain's")
    check(map_dx <= 1e-6, f"MapMaker: compiled X {map_dx:.3e} m from the eager chain's")
    poses = [np.eye(4)]
    for f in mout:
        poses.append(poses[-1] @ np_pose_matrix(f.X))
    map_ate = pose_ate(poses[1:], gt)
    print(f"MapMaker (compiled, graphs captured under set_sync_debug_mode('error')): "
          f"{len(mout)} frames in {map_s:.2f} s with the captures (eager chain "
          f"{map_eager_s:.2f} s), fused launches {map_fused} = {len(mout)} x {mcfg.n_iters} "
          f"iterations + {len(scans)} prepares + {map_warm} warm-ups (eager "
          f"{map_eager_fused}), ring fill {mout[-1].n_map_points} (expected {want_fill}), ATE "
          f"{map_ate * 100:.4f} cm (JAX package on the CPU: {MAP_ATE_REF_M * 100:.4f} cm); "
          f"against the eager chain frame by frame: max |dX| {map_dx:.3e} m, bit-identical "
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
    # Keyframe frames: the whole drive through the eager chain (its first
    # frame is the seed spawn, no solve).  One round each: phase 27 times
    # these frames again, in turns with the compiled ones, and the MapMaker
    # frame only there.
    kf_frame_ms = median_ms(
        lambda: eager_chains.keyframe_odometry(drive, cfg, kf_cfg, bm_cfg),
        reps=1, rounds=1) / steps
    dkf_frame_ms = median_ms(
        lambda: eager_chains.keyframe_odometry(drive, dcfg, kf_cfg, bm_cfg, net),
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
    # Bytes: points and X read once, the bounds and anchors (8 + 12 B) of
    # the rows the points fall in, the (V+1, 16) sums written.  Operations:
    # per point the raw norm (6), transform (18), nan scrub and r' (6),
    # theta/phi with atan2/acos counted as 20 each (43), binning and gates
    # (10); per member the anchor offset (3) and 10 accumulated features (6
    # products + 10 adds).
    fused_rows = rows_read(pts, X_step, cfg)
    fused_bound, fused_by = bound(n * 12 + 6 * 4 + fused_rows * 20 + v1 * 16 * 4,
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

    # #1's sorted parts at each size, beside the plain version and the
    # plain route's moments pass (PyTorch binning, then #3) on the same input.
    from icet_tpu_torch.solver import _scatter_sums

    large_rows = []
    for what, p, m, c in (("fixed N=65536", pts, fmodel, fixed),
                          ("fixed N=131072", wide_pts, fmodel, fixed),
                          ("150x48 N=65536", pts, bmodel, big),
                          ("75x77 N=65536", pts, pmodel, past)):
        args = (p, X_step, m.bounds, m.anchors, c)
        k_ms, k_ev = kernel_times(lambda: fused_moment_sums(*args), reps=100)
        pl_ms, pl_ev = kernel_times(lambda: fused_moment_sums_reference(*args), reps=20)
        rt_ms, rt_ev = kernel_times(lambda: _scatter_sums(*args, "pallas"), reps=20)
        mem = float(fused_moment_sums_reference(*args)[:, 0].sum())
        nn, vv, read = p.shape[0], c.n_voxels + 1, rows_read(p, X_step, c)
        # As kernel #1 above (the bounds and anchors of the rows read, the
        # whole table written); fixed mode adds the shell's log and divide
        # (about 24 operations) a point.
        kb, kby = bound(nn * 12 + 6 * 4 + read * 20 + vv * 16 * 4,
                        nn * (107 if c.radial_mode == "fixed" else 83) + mem * 19,
                        PEAK_FP32_PER_S)
        large_rows.append({"what": what, "rows": vv, "rows_read": read, "ms": k_ms, "ev": k_ev,
                           "plain_ms": pl_ms, "plain_ev": pl_ev, "route_ms": rt_ms,
                           "route_ev": rt_ev, "bound_ms": kb, "bound_by": kby})

    print(f"times ({card}), eager frames (phases 26-27 time the compiled ones): odometry "
          f"frame {frame_ms:.4f} ms, DNN-filtered frame {dnn_frame_ms:.4f} ms, keyframe frame "
          f"{kf_frame_ms:.4f} ms, DNN-filtered keyframe frame {dkf_frame_ms:.4f} ms, "
          f"pallas-moments frame {pallas_frame_ms:.4f} ms (the MapMaker frame: phase 27)")
    print(f"times ({card}), device ms a call by the profiler (CUDA events over "
          f"back-to-back calls in brackets):")
    print(f"  fused moments {fused_ms:.5f} ({fused_ev:.5f}) at N={n} V={cfg.n_voxels}, plain "
          f"{fused_plain_ms:.4f} ({fused_plain_ev:.4f}), bound {fused_bound:.6f} ({fused_by}, "
          f"{fused_rows} rows read); "
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
    for r in large_rows:
        print(f"  fused moments, sorted parts, {r['what']} V+1={r['rows']} ({r['rows_read']} "
              f"rows read): {r['ms']:.5f} "
              f"({r['ev']:.5f}), plain {r['plain_ms']:.4f} ({r['plain_ev']:.4f}), the plain "
              f"route's pass (PyTorch binning + #3) {r['route_ms']:.5f} ({r['route_ev']:.5f}), "
              f"bound {r['bound_ms']:.6f} ({r['bound_by']})")
    # -- 14. a grid above the fused kernel's shared-memory table (#1's sorted parts)
    from icet_tpu_torch.solver import moment_route

    check(moment_route(big) == "fused" and moment_route(cfg) == "fused",
          f"routes: {moment_route(big)} at V={big.n_voxels}, {moment_route(cfg)} at "
          f"V={cfg.n_voxels}")
    _, big_launches = route_pair(scans, x0, big, "150x48 grid")
    large_launches += big_launches

    # -- 15. BiasNet training at full width ------------------------------------
    import tempfile

    import icet_tpu_torch.models.train_data as train_data
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

    t0 = time.perf_counter()
    pairs = train_data.make_raycast_voxel_pairs(n_pairs=6, samples_per_voxel=100, seed=0,
                                                device=dev)
    pairs_s = time.perf_counter() - t0
    train_cmp = phase_train_compiled(pairs, dev, card)
    torch.cuda.synchronize()
    settle()
    bias_encoder_pool.launches = 0
    t0 = time.perf_counter()
    with patched(train_data, "make_raycast_voxel_pairs", lambda **kw: pairs), \
            graphs.sync_debug("error"):
        tstate, tlosses, (ps1, ps2) = train_bias_net_mixed(
            steps=TRAIN_STEPS, batch=256, sample_pts=100, lr=1e-3, seed=0, n_pairs=6,
            device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    settle()
    check(bias_encoder_pool.launches == 0,
          "training launched the encoder kernel (it trains through flax's forward)")
    check(all(np.isfinite(tlosses)), "training: a loss is not finite")
    first10, last10 = float(np.mean(tlosses[:10])), float(np.mean(tlosses[-10:]))
    check(last10 < first10, f"training: last ten {last10:.4f} not below first ten {first10:.4f}")
    pgen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    with graphs.sync_debug("error"):
        _, plosses = train_bias_net(pgen, steps=40, batch=128, sample_pts=32, device="cuda")
    patch_s = time.perf_counter() - t0
    check(plosses[-1] < 0.7 * plosses[0],
          f"40-step patch case: last loss {plosses[-1]:.4f} not below 0.7 x {plosses[0]:.4f}")
    print(f"BiasNet training ({len(ps1)} raycast voxel pairs, built in {pairs_s:.2f} s): "
          f"{TRAIN_STEPS} compiled steps in {train_s:.2f} s, loss first ten {first10:.4f} -> "
          f"last ten {last10:.4f} (JAX package on the CPU: {MIXED_LOSS_REF[0]:.4f} -> "
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
    settle()
    bias_encoder_pool.launches = 0
    mae = float(torch.mean(torch.abs(apply_bias_net(net, xm) - ym)))
    settle()
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
          f"train_step {train_step_ms:.4f} ms (compiled; median of steps 6-{TIMED_STEPS}, CUDA "
          f"events, batch 256, S = 100; {card}); {train_cmp}")

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
        settle()
        before = (tridiag_factor.launches, tridiag_apply.launches)
        S, U = tridiag_factor(D, E)
        y = tridiag_apply(S, U, r)
        settle()
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
    settle()
    tridiag_factor.launches = tridiag_apply.launches = 0
    zero_warmups()
    t0 = time.perf_counter()
    with graphs.sync_debug("error"):
        ring_opt_t = optimize_poses_sparse(ring0, ring, 10, 25, device="cuda")
    torch.cuda.synchronize()
    ring_first_s = time.perf_counter() - t0
    settle()
    ring_launches = (tridiag_factor.launches, tridiag_apply.launches)
    ring_warm = (warmups("tridiag_factor"), warmups("tridiag_apply"))
    check((ring_launches[0] - ring_warm[0], ring_launches[1] - ring_warm[1]) == (10, 10 * 26),
          f"10k solve: factor/apply launches {ring_launches} less warm-ups {ring_warm}, "
          f"expected (10, 260)")
    settle()
    tridiag_factor.launches = tridiag_apply.launches = 0
    ring_eager_t = optimize_poses_sparse_eager(ring0, ring, 10, 25, device="cuda")
    torch.cuda.synchronize()
    settle()
    ring_eager_launches = (tridiag_factor.launches, tridiag_apply.launches)
    check(ring_eager_launches == (10, 260), f"10k solve, eager: launches {ring_eager_launches}")
    ring_dx = float((ring_opt_t - ring_eager_t).abs().max())
    # The eager loop against itself: the normals are summed in the
    # incidence's fixed order, so it repeats bit for bit.
    ring_spread = float((optimize_poses_sparse_eager(ring0, ring, 10, 25, device="cuda")
                         - ring_eager_t).abs().max())
    check(ring_dx == 0.0 and ring_spread == 0.0,
          f"10k solve: compiled states {ring_dx:.3e} from the eager loop's, eager from eager "
          f"{ring_spread:.3e} (bit for bit required)")
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
    settle()
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
    settle()
    lc_fused = fused_moment_sums.launches - warmups()
    settle()
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
    # The loop verification against the eager chain on the first 16
    # candidates (one chunk), factor by factor.
    ((lc_args, lc_kw),), (lc_factors,) = lc_loops.args, lc_loops.results
    cands16 = lc_args[1][:16]
    eager16 = eager_chains.close_loops(lc_args[0], cands16, *lc_args[2:], **lc_kw)
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
        from icet_tpu_torch.datasets.kitti import KittiOdometrySource

        wide = np.stack([sc for sc, _ in KittiOdometrySource(kitti["seq"], max_points=131072)]
                        ).astype(np.float32)
    print(f"phases 22-27: {t22:.1f} / {t23:.1f} / {t24:.1f} / {t25:.1f} / {t26:.1f} / "
          f"{t27:.1f} s")

    # -- 28: the IF nodes, the sharded solves --------------------------------
    t0 = time.perf_counter()
    conditional_report(dev, scans.shape[1], cfg, dcfg, card)
    phase_sharded_solves(lc_solves, dev, card)
    phase_if_cost(scans, cfg, dev, card)
    print(f"phase 28: {time.perf_counter() - t0:.1f} s")

    # -- 29: the keyframe spawn on the card -----------------------------------
    t0 = time.perf_counter()
    phase_device_spawn(scans, wide, gt, cfg, kf_cfg, bm_cfg, dev, card)
    print(f"phase 29: {time.perf_counter() - t0:.1f} s")

    # -- 30: run to run ---------------------------------------------------------
    phase_run_to_run(scans, wide, pairs, cfg, dev, card)
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
            "name": "fused_moment_sums (sorted parts, fixed radial mode V+1=90001)",
            "route": "cuda",
            "source": "icet_tpu_torch/csrc/fused_moments.cu",
            "replaces": "icet_tpu/ops/pallas_fused.py:73",
            "launches": large_launches,
            "max_abs_err": large_err,
            "ms": large_rows[0]["ms"],
            "plain_ms": large_rows[0]["plain_ms"],
            "bound_ms": large_rows[0]["bound_ms"],
            "bound_by": large_rows[0]["bound_by"],
            "library_ms": None,
            "sizes": large_rows,
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
            "name": "gn_assembly",
            "route": "cuda",
            "source": "icet_tpu_torch/csrc/gn_assembly.cu",
            "replaces": None,
            "launches": gn_launches,
            "max_rel_err": gn["rel"],
            "ms": gn["times"]["75x24"]["ms"],
            "plain_ms": gn["times"]["75x24"]["plain_ms"],
            "bound_ms": gn["times"]["75x24"]["bound_ms"],
            "bound_by": gn["times"]["75x24"]["bound_by"],
            "library_ms": None,
        },
        {
            "name": "gn_eigh6",
            "route": "cuda",
            "source": "icet_tpu_torch/csrc/gn_eigh6.cu",
            "replaces": None,
            "launches": eigh6_launches,
            "max_w_rel_err": eigh6["worst"]["w"],
            "ms": eigh6["times"]["cold"]["ms"],
            "warm_ms": eigh6["times"]["warm"]["ms"],
            "plain_ms": eigh6["times"]["cold"]["plain_ms"],
            "warm_plain_ms": eigh6["times"]["warm"]["plain_ms"],
            "bound_ms": None,
            "bound_by": "a dependent chain of Jacobi rounds",
            "library_ms": None,
        },
        {
            "name": "model_fit",
            "route": "cuda",
            "source": "icet_tpu_torch/csrc/model_fit.cu",
            "replaces": None,
            "launches": fit_launches,
            "bits_equal": True,
            "ms": fit["times"]["75x24"]["ms"],
            "plain_ms": fit["times"]["75x24"]["plain_ms"],
            "bound_ms": fit["times"]["75x24"]["bound_ms"],
            "bound_by": fit["times"]["75x24"]["bound_by"],
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
    if len(sys.argv) == 3 and sys.argv[1] == "--time-tree":
        sys.exit(time_tree(json.loads(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == "--parent":
        sys.exit(parent_times(sys.argv[2]))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
