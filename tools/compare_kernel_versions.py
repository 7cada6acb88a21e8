#!/usr/bin/env python3
"""Times the port's CUDA kernels of an earlier tree against this tree's, in
one process on one card: fused moments (#1), windowed fused moments (#2),
the moment scatter (#3) and the BiasNet encoder (#4).

Unpack the earlier tree into a directory that .gitignore lists, then run
from the repository root on a machine with an NVIDIA GPU:

    git archive <commit> | tar -x -C _checkout/parent
    python3 tools/compare_kernel_versions.py --parent _checkout/parent

The earlier tree's ``csrc/*.cu`` of the four kernels are built with this
tree's nvcc flags and called through their own C interfaces (those of the
tree before the redesign of #2 and #3: the windowed pass as two kernels
with a (blocks, window, 10) partial, the scatter with a memset and its
banded shared table).  Inputs are ``chip_smoke.py``'s: the drive's frame 1
against frame 0's model at X = [1, 0.05, 0, 0, 0, 0.02] (N = 65,536,
V = 1,800; #2 at block 512, window 256; #3 on the ``moment_method="pallas"``
ids and features of the same frame), and the DNN filter's encoder input
on it (1,801 x 200 x 4, tile 16).  The kernels run in turns, earlier,
this, this, earlier; each turn records the device time a call by
torch.profiler (``chip_smoke.device_profile``, with the device operations
it recorded a call), the CUDA-event time over back-to-back
calls and the host time to enqueue a call.  The two versions' results are checked against
each other first.  For the earlier #3 it also splits the profiler's device
time by operation (its memset and its kernel) and times the launches
queued behind a spin kernel, so that the host cannot hold the device back.
The last line is one JSON object with every number and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    device_line,
    device_profile,
    filter_input,
    median_ms,
    scatter_inputs,
)
from icet_tpu_torch import _build  # noqa: E402

KERNELS = ["fused_moments", "fused_moments_windowed", "moment_scatter", "bias_encoder"]


def host_us(fn, reps: int = 200) -> float:
    """Host time to enqueue a call, over ``reps`` calls in a row (the
    device runs behind)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def device_ms_by_op(fn, reps: int) -> dict[str, float]:
    """Device ms a call of each device operation ``fn`` runs, by name."""
    return {name[:60]: ms for name, (ms, _) in device_profile(fn, reps).items()}


def device_ms_ops(fn, reps: int) -> tuple[float, float]:
    """(device ms a call, device operations the profiler recorded a call):
    ``chip_smoke.device_profile`` makes up for a missed record; the count
    shows whether there was one."""
    prof = device_profile(fn, reps)
    return sum(ms for ms, _ in prof.values()), sum(k for _, k in prof.values())


def queued_ms(fn, reps: int) -> float:
    """Device ms a call with the calls queued behind a spin kernel (4e7
    cycles, ~20 ms at the H100's clock): the device runs them back to back,
    whatever the host's rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_parent(parent: str, names: list[str]) -> dict[str, ctypes.CDLL]:
    out_dir = os.path.join(ROOT, "_checkout", "parent_build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(parent, "icet_tpu_torch", "csrc", f"{name}.cu")
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", os.path.dirname(src), "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the earlier {name}.cu:\n{log}")
        print(f"earlier {name}.cu:\n{log.strip()}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def turns(fns, reps: int) -> list[dict]:
    """Earlier, this, this, earlier: device ms by the profiler, CUDA-event
    ms over back-to-back calls, host us to enqueue."""
    rows = []
    for which in (0, 1, 1, 0):
        fn = fns[which]
        dev_ms, ops = device_ms_ops(fn, reps)
        rows.append({"version": ("earlier", "this")[which], "device_ms": dev_ms,
                     "device_ops": ops, "event_ms": median_ms(fn, reps),
                     "host_us": host_us(fn)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=os.path.join(ROOT, "_checkout", "parent"))
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernel_versions: CUDA is not available", file=sys.stderr)
        return 1

    from icet_tpu_torch.config import ICETConfig
    from icet_tpu_torch.datasets.replay import CityDriveSource
    from icet_tpu_torch.filters import model_voxel_samples, pretrained_dnn
    from icet_tpu_torch.ops import bias_encoder as be
    from icet_tpu_torch.ops import fused_moments as fm
    from icet_tpu_torch.ops import moment_scatter as ms
    from icet_tpu_torch.solver import prepare_reference

    card = device_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    logs = _build.build(KERNELS)
    for name, log in logs.items():
        print(f"this {name}.cu:\n{log.strip()}")
    old = build_parent(args.parent, KERNELS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old_fused = old["fused_moments"].icet_fused_moment_sums
    old_fused.argtypes = [p, i, p, p, p, i, i, i, f, f, f, p, i, i, i, p, p]
    old_fused.restype = i
    old_enc = old["bias_encoder"].icet_bias_encoder
    old_enc.argtypes = [p, i, i, p, p, i, i, p]
    old_enc.restype = i
    old_win = old["fused_moments_windowed"].icet_fused_moment_sums_windowed
    old_win.argtypes = [p, i, p, p, p, i, i, i, f, f, f, i, i, f, i, i, i, p, p, p, p, p, p]
    old_win.restype = i
    old_scat = old["moment_scatter"].icet_moment_scatter
    old_scat.argtypes = [p, p, i, i, p, i, i, p]
    old_scat.restype = i

    dev = torch.device("cuda")
    src = CityDriveSource(n_frames=2, speed=1.0, n_beams=64, n_azimuth=1024)
    scans = [s.astype(np.float32) for s, _ in src]
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)
    dcfg = cfg.replace(dnn_filter=True)
    model = prepare_reference(torch.from_numpy(scans[0]).to(dev), cfg)
    pts = torch.from_numpy(scans[1]).to(dev)
    X = torch.tensor([1.0, 0.05, 0.0, 0.0, 0.0, 0.02], device=dev)
    n, V, v1 = pts.shape[0], cfg.n_voxels, cfg.n_voxels + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    grid = (V, cfg.n_theta, cfg.n_phi, cfg.phi_min, cfg.phi_max - cfg.phi_min, cfg.min_range)

    # #1: the C interface is unchanged since the redesign of #1.
    nb1, per_block, cap = fm.launch_plan(n, V, sms)

    def fused_old():
        fm._check(pts, X, model.bounds, model.anchors, cfg)
        scratch = torch.empty(fm.scratch_floats(nb1, cap, V), device=dev)
        out = torch.empty((v1, 16), device=dev)
        err = old_fused(pts.data_ptr(), n, X.data_ptr(), model.bounds.data_ptr(),
                        model.anchors.data_ptr(), *grid, scratch.data_ptr(), nb1, per_block,
                        cap, out.data_ptr(), stream)
        assert err == 0, err
        return out

    def fused_new():
        return fm.fused_moment_sums(pts, X, model.bounds, model.anchors, cfg)

    # #2 as the earlier wrapper ran it: five buffers, two kernels.
    block, window = 512, 256
    nb2 = -(-n // block)

    def win_old():
        fm._check_windowed(pts, X, model.bounds, model.anchors, cfg, block, window)
        partial = torch.empty((nb2, window, 10), device=dev)
        starts = torch.empty(nb2, dtype=torch.int32, device=dev)
        block_ovf = torch.empty(nb2, dtype=torch.int32, device=dev)
        out = torch.empty((v1, 16), device=dev)
        overflow = torch.empty((), dtype=torch.int32, device=dev)
        err = old_win(pts.data_ptr(), n, X.data_ptr(), model.bounds.data_ptr(),
                      model.anchors.data_ptr(), *grid, 0, cfg.n_shells,
                      math.log(cfg.shell_growth), block, window, fm._windowed_v_pad(V, window),
                      partial.data_ptr(), starts.data_ptr(), block_ovf.data_ptr(),
                      out.data_ptr(), overflow.data_ptr(), stream)
        assert err == 0, err
        return out, overflow

    def win_new():
        return fm.fused_moment_sums_windowed(pts, X, model.bounds, model.anchors, cfg, block,
                                             window)

    # #3 as the earlier wrapper launched it (memset and kernel; its host read
    # of the ids' range is timed apart, as "earlier wrapper").
    vid, feats = scatter_inputs(pts, X, model.bounds, model.anchors, cfg)
    nb3 = min(sms, -(-n * 16 // 16_384))

    def scat_old():
        ms._check(vid, feats)
        out = torch.empty((v1, 16), device=dev)
        err = old_scat(vid.data_ptr(), feats.data_ptr(), n, v1, out.data_ptr(), nb3, 1, stream)
        assert err == 0, err
        return out

    def scat_old_wrapper():
        lo, hi = torch.aminmax(vid)
        assert not bool((lo < 0) | (hi > V))
        return scat_old()

    def scat_new():
        return ms.moment_scatter_sums(vid, feats, V)

    net = pretrained_dnn(dcfg, dev)
    w = net.encoder_weights()
    samples0 = model_voxel_samples(model, torch.from_numpy(scans[0]).to(dev), dcfg)
    x = filter_input(model, samples0, pts, X, dcfg)
    b, pp, _ = x.shape

    def enc_old():
        be._check(x, w, 16)
        out = torch.empty((b, 256), device=dev)
        err = old_enc(x.data_ptr(), b, pp, be._cached_image(w).data_ptr(), out.data_ptr(), 16,
                      be.encoder_blocks(b, sms), stream)
        assert err == 0, err
        return out

    def enc_new():
        return be.bias_encoder_pool(x, w, 16)

    # The two versions agree before they are timed.
    fo, fn_ = fused_old(), fused_new()
    (wo, wo_ovf), (wn, wn_ovf) = win_old(), win_new()
    so, sn = scat_old(), scat_new()
    eo, en = enc_old(), enc_new()
    torch.cuda.synchronize()
    agree = {
        "fused": (bool(torch.equal(fo[:, 0], fn_[:, 0])), float((fo - fn_).abs().max())),
        "windowed": (bool(torch.equal(wo[:, 0], wn[:, 0])) and int(wo_ovf) == int(wn_ovf),
                     float((wo - wn).abs().max())),
        "scatter": (bool(torch.equal(so[:, 0], sn[:, 0])), float((so - sn).abs().max())),
    }
    enc_close = float(((eo - en).abs() <= 2.0**-7 * eo.abs()).float().mean())
    for name, (counts, diff) in agree.items():
        print(f"{name}: counts (and overflow) equal {counts}, max |earlier - this| {diff:.3e}")
    print(f"encoder: codes within one bf16 ulp {enc_close:.5f}, max |diff| "
          f"{float((eo - en).abs().max()):.3e}; windowed overflow {int(wn_ovf)}")
    if not all(c and d <= 1e-2 for c, d in agree.values()) or enc_close < 0.995:
        print("compare_kernel_versions: the two versions disagree", file=sys.stderr)
        return 1

    # The earlier #3 in detail: its device time by operation, and its
    # launches queued behind a spin kernel (no host gaps).
    scat_ops = device_ms_by_op(scat_old, args.reps)
    scat_queued = {"earlier": queued_ms(scat_old, args.reps), "this": queued_ms(scat_new, args.reps)}
    wrapper_ev = {"earlier wrapper": median_ms(scat_old_wrapper, args.reps)}
    print(f"moment_scatter earlier: device ms a call by operation {scat_ops}; queued behind "
          f"a spin kernel {scat_queued} ms a call; the earlier wrapper with its id check "
          f"{wrapper_ev} ms by CUDA events ({card})")

    rows = {"moment_scatter earlier by operation device_ms": scat_ops,
            "moment_scatter queued_ms": scat_queued,
            "moment_scatter earlier wrapper event_ms": wrapper_ev}
    for kernel, fns, reps in (("fused_moment_sums", (fused_old, fused_new), args.reps),
                              ("fused_moment_sums_windowed", (win_old, win_new), args.reps),
                              ("moment_scatter_sums", (scat_old, scat_new), args.reps),
                              ("bias_encoder_pool", (enc_old, enc_new), max(5, args.reps // 5))):
        rows[kernel] = turns(fns, reps)
        for t in rows[kernel]:
            print(f"{kernel} {t['version']}: device {t['device_ms']:.5f} ms a call "
                  f"({t['device_ops']:g} operations recorded a call), CUDA events {t['event_ms']:.5f} ms, host {t['host_us']:.1f} us to "
                  f"enqueue ({card})")
    print(json.dumps({"card": card, "fused_shape": [n, V], "windowed": [block, window],
                      "encoder_shape": list(x.shape), "turns": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
