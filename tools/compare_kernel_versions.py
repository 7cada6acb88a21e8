#!/usr/bin/env python3
"""Times the port's moment kernels of an earlier tree against this tree's,
in one process on one card: fused moments (#1), windowed fused moments (#2)
and the moment scatter (#3), beside the PyTorch call that computes #3's
function (``index_add_``).

Unpack the earlier tree into a directory that .gitignore lists, then run
from the repository root on a machine with an NVIDIA GPU:

    git archive <commit> | tar -x -C _checkout/parent
    python3 tools/compare_kernel_versions.py --parent _checkout/parent

The earlier tree's ``csrc/*.cu`` of the three kernels are built with this
tree's nvcc flags (and its own ``csrc`` headers) and called through their
own C interfaces: those of the tree before kernel #1 took fixed radial mode
and large tables (#1 with its shared table only, called here directly;
#2 and #3 as this tree's, called through this tree's wrappers with the
earlier library).  Inputs are ``chip_smoke.py``'s: the drive's frame 1
against frame 0's model at X = [1, 0.05, 0, 0, 0, 0.02], at 64x1024 (N =
65,536) and 64x2048 (N = 131,072) with V = 1,800; #2 at block 512, window
256; #3 on the ``moment_method="pallas"`` ids and features of the same
frame, at V = 1,800 and in fixed radial mode (90,001 rows); and the fixed
radial mode's moments pass, the earlier tree's plain route (PyTorch
binning, then its #3) against this tree's #1 (its sorted parts).  The
versions run in turns, earlier, this, this, earlier; each turn records the
device time a call by torch.profiler (``chip_smoke.device_profile``, with
the device operations it recorded a call), the CUDA-event time over
back-to-back calls, the time a call with the calls queued behind a spin
kernel (so that the host cannot hold the device back) and the host time to
enqueue a call.  Both versions are checked against the plain version
first, and each is launched twice on one input: this tree's must repeat
bit for bit; whether the two versions give the same bits is reported.  The
last line is one JSON object with every number and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
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
    median_ms,
    patched,
    scatter_inputs,
)
from icet_tpu_torch import _build  # noqa: E402

KERNELS = ["fused_moments", "fused_moments_windowed", "moment_scatter"]


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
    ms over back-to-back calls, ms a call queued behind a spin kernel, host
    us to enqueue."""
    rows = []
    for which in (0, 1, 1, 0):
        fn = fns[which]
        dev_ms, ops = device_ms_ops(fn, reps)
        rows.append({"version": ("earlier", "this")[which], "device_ms": dev_ms,
                     "device_ops": ops, "event_ms": median_ms(fn, reps),
                     "queued_ms": queued_ms(fn, reps), "host_us": host_us(fn)})
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
    from icet_tpu_torch.ops import fused_moments as fm
    from icet_tpu_torch.ops import moment_scatter as ms
    from icet_tpu_torch import solver
    from icet_tpu_torch.ops.grid import fixed_shell_bounds, voxel_anchors
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
    old["fused_moments_windowed"].icet_fused_moment_sums_windowed.argtypes = [
        p, i, p, p, p, i, i, i, f, f, f, i, i, f, i, i, i, i, i, p, p, p, p]
    old["fused_moments_windowed"].icet_windowed_shared_bytes.argtypes = [i]
    for lib in old.values():
        lib.icet_cuda_error_string.argtypes = [i]
        lib.icet_cuda_error_string.restype = ctypes.c_char_p
    old["moment_scatter"].icet_moment_scatter.argtypes = [p, p, i, i, p, p, i, i, i, i, i, p]
    old["moment_scatter"].icet_moment_scatter.restype = i

    dev = torch.device("cuda")
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)
    fixed = cfg.replace(radial_mode="fixed")
    fb = fixed_shell_bounds(fixed, dev)
    fa = voxel_anchors(fb, fixed)
    X = torch.tensor([1.0, 0.05, 0.0, 0.0, 0.0, 0.02], device=dev)
    V, v1 = cfg.n_voxels, cfg.n_voxels + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def earlier(module, attr, lib, fn):
        """``fn`` through this tree's wrapper with the earlier library."""
        def call():
            with patched(module, attr, lambda: lib):
                return fn()
        return call

    def fused_old(pts, X, bounds, anchors, c):
        """The earlier #1 (its shared table) through its own C interface."""
        def call():
            n = pts.shape[0]
            blocks, per_block, cap = fm.launch_plan(n, c.n_voxels, sms)
            scratch = torch.empty(fm.scratch_floats(blocks, cap, c.n_voxels), device=dev)
            out = torch.empty((c.n_voxels + 1, 16), device=dev)
            err = old_fused(pts.data_ptr(), n, X.data_ptr(), bounds.data_ptr(),
                            anchors.data_ptr(), c.n_voxels, c.n_theta, c.n_phi, c.phi_min,
                            c.phi_max - c.phi_min, c.min_range, scratch.data_ptr(), blocks,
                            per_block, cap, out.data_ptr(), stream)
            assert err == 0, err
            return out
        return call

    rows, agree, ok = {}, {}, True
    for az in (1024, 2048):
        src = CityDriveSource(n_frames=2, speed=1.0, n_beams=64, n_azimuth=az)
        scans = [s.astype(np.float32) for s, _ in src]
        model = prepare_reference(torch.from_numpy(scans[0]).to(dev), cfg)
        pts = torch.from_numpy(scans[1]).to(dev)
        n = pts.shape[0]
        vid, feats = scatter_inputs(pts, X, model.bounds, model.anchors, cfg)
        vid_f, feats_f = scatter_inputs(pts, X, fb, fa, fixed)

        def fused():
            return fm.fused_moment_sums(pts, X, model.bounds, model.anchors, cfg)

        def win():
            return fm.fused_moment_sums_windowed(pts, X, model.bounds, model.anchors, cfg, 512,
                                                 256)[0]

        def fixed_route():
            return solver._scatter_sums(pts, X, fb, fa, fixed, "pallas")

        cases = {
            f"fused_moment_sums N={n}": (
                fused_old(pts, X, model.bounds, model.anchors, cfg), fused,
                lambda: fm.fused_moment_sums_reference(pts, X, model.bounds, model.anchors, cfg),
                None),
            f"fixed-mode moments N={n} V+1={fixed.n_voxels + 1} (earlier: the plain route)": (
                earlier(ms, "_lib", old["moment_scatter"], fixed_route),
                lambda: fm.fused_moment_sums(pts, X, fb, fa, fixed),
                lambda: fm.fused_moment_sums_reference(pts, X, fb, fa, fixed),
                None),
            f"fused_moment_sums_windowed N={n}": (
                earlier(fm, "_windowed_lib", old["fused_moments_windowed"], win), win,
                lambda: fm.fused_moment_sums_windowed_reference(pts, X, model.bounds,
                                                                model.anchors, cfg, 512, 256)[0],
                None),
            f"moment_scatter_sums N={n} V+1={v1}": (
                earlier(ms, "_lib", old["moment_scatter"],
                        lambda: ms.moment_scatter_sums(vid, feats, V)),
                lambda: ms.moment_scatter_sums(vid, feats, V),
                lambda: ms.moment_scatter_reference(vid, feats, V),
                lambda: torch.zeros((v1, 16), device=dev).index_add_(0, vid.long(), feats)),
            f"moment_scatter_sums N={n} V+1={fixed.n_voxels + 1}": (
                earlier(ms, "_lib", old["moment_scatter"],
                        lambda: ms.moment_scatter_sums(vid_f, feats_f, fixed.n_voxels)),
                lambda: ms.moment_scatter_sums(vid_f, feats_f, fixed.n_voxels),
                lambda: ms.moment_scatter_reference(vid_f, feats_f, fixed.n_voxels),
                lambda: torch.zeros((fixed.n_voxels + 1, 16), device=dev).index_add_(
                    0, vid_f.long(), feats_f)),
        }
        for name, (fo, fn_, plain, library) in cases.items():
            want = plain()
            outs = {"earlier": (fo(), fo()), "this": (fn_(), fn_())}
            torch.cuda.synchronize()
            res = {}
            for k, (a, b) in outs.items():
                err = float((a - want).abs().max())
                res[k] = {"max_abs_err": err, "run_to_run": float((a - b).abs().max()),
                          "counts_equal": bool(torch.equal(a[:, 0], want[:, 0]))}
                ok &= bool(((a - want).abs() <= 1e-3 + 1e-4 * want.abs()).all())
            ok &= bool(torch.equal(*outs["this"]))
            res["versions_bit_equal"] = bool(torch.equal(outs["earlier"][0], outs["this"][0]))
            agree[name] = res
            print(f"{name}: {res}")
            rows[name] = turns((fo, fn_), args.reps)
            if library is not None:
                rows[name + " index_add_"] = {"event_ms": median_ms(library, args.reps),
                                               "queued_ms": queued_ms(library, args.reps),
                                               "device_ms": device_ms_ops(library, args.reps)[0]}
                print(f"{name} index_add_: {rows[name + ' index_add_']} ({card})")
            for t in rows[name]:
                print(f"{name} {t['version']}: device {t['device_ms']:.5f} ms a call "
                      f"({t['device_ops']:g} operations recorded a call), CUDA events "
                      f"{t['event_ms']:.5f} ms, queued {t['queued_ms']:.5f} ms, host "
                      f"{t['host_us']:.1f} us to enqueue ({card})")
    if not ok:
        print("compare_kernel_versions: a version disagrees with the plain version, or this "
              "tree's kernel did not repeat bit for bit", file=sys.stderr)
    print(json.dumps({"card": card, "agree": agree, "turns": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
