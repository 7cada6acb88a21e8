#!/usr/bin/env python3
"""Times the fused-moments kernel (#1) and the BiasNet encoder kernel (#4)
of an earlier tree against this tree's, in one process on one card.

Unpack the earlier tree into a directory that .gitignore lists, then run
from the repository root on a machine with an NVIDIA GPU:

    git archive <commit> | tar -x -C _checkout/parent
    python3 tools/compare_kernel_versions.py --parent _checkout/parent

The earlier tree's ``csrc/fused_moments.cu`` and ``csrc/bias_encoder.cu``
are built with this tree's nvcc flags and called through their own C
interfaces (the two-launch fused kernel with its (blocks, V+1, 10) partial,
the one-block-a-tile encoder with its twelve weight pointers).  Inputs are
``chip_smoke.py``'s: the drive's frame 1 against frame 0's model at
X = [1, 0.05, 0, 0, 0, 0.02] (N = 65,536, V = 1,800) and the DNN filter's
encoder input on it (1,801 x 200 x 4, tile 16).  The kernels run in turns,
earlier, this, this, earlier; each turn records the device time a call by
torch.profiler, the CUDA-event time over back-to-back calls and the host
time to enqueue a call.  The two versions' results are checked against
each other first.  The last line is one JSON object with every number and
the card's name and power limit.
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

from chip_smoke import device_line, device_ms, filter_input, median_ms  # noqa: E402
from icet_tpu_torch import _build  # noqa: E402


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


def build_parent(parent: str, names: list[str]) -> dict[str, ctypes.CDLL]:
    out_dir = os.path.join(ROOT, "_checkout", "parent_build")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(parent, "icet_tpu_torch", "csrc", f"{name}.cu")
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src]
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
    from icet_tpu_torch.ops.bias_encoder import _check as enc_check
    from icet_tpu_torch.ops.bias_encoder import bias_encoder_pool
    from icet_tpu_torch.ops.fused_moments import _check as fm_check
    from icet_tpu_torch.ops.fused_moments import fused_moment_sums
    from icet_tpu_torch.solver import prepare_reference

    card = device_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    logs = _build.build(["fused_moments", "bias_encoder"])
    for name, log in logs.items():
        print(f"this {name}.cu:\n{log.strip()}")
    old = build_parent(args.parent, ["fused_moments", "bias_encoder"])
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old_fused = old["fused_moments"].icet_fused_moment_sums
    old_fused.argtypes = [p, i, p, p, p, i, i, i, f, f, f, p, i, p, p]
    old_fused.restype = i
    old_enc = old["bias_encoder"].icet_bias_encoder
    old_enc.argtypes = [p, i, i, *([p] * 12), p, i, p]
    old_enc.restype = i

    dev = torch.device("cuda")
    src = CityDriveSource(n_frames=2, speed=1.0, n_beams=64, n_azimuth=1024)
    scans = [s.astype(np.float32) for s, _ in src]
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)
    dcfg = cfg.replace(dnn_filter=True)
    model = prepare_reference(torch.from_numpy(scans[0]).to(dev), cfg)
    pts = torch.from_numpy(scans[1]).to(dev)
    X = torch.tensor([1.0, 0.05, 0.0, 0.0, 0.0, 0.02], device=dev)
    n, v1 = pts.shape[0], cfg.n_voxels + 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = max(1, min(2 * sms, -(-n // 1024)))
    stream = torch.cuda.current_stream().cuda_stream

    def fused_old():
        # As the earlier wrapper: the same checks, its scratch and output
        # allocated a call.
        fm_check(pts, X, model.bounds, model.anchors, cfg)
        partial = torch.empty((blocks, v1, 10), device=dev)
        out = torch.empty((v1, 16), device=dev)
        err = old_fused(pts.data_ptr(), n, X.data_ptr(), model.bounds.data_ptr(),
                        model.anchors.data_ptr(), cfg.n_voxels, cfg.n_theta, cfg.n_phi,
                        cfg.phi_min, cfg.phi_max - cfg.phi_min, cfg.min_range,
                        partial.data_ptr(), blocks, out.data_ptr(), stream)
        assert err == 0, err
        return out

    def fused_new():
        return fused_moment_sums(pts, X, model.bounds, model.anchors, cfg)

    net = pretrained_dnn(dcfg, dev)
    w = net.encoder_weights()
    samples0 = model_voxel_samples(model, torch.from_numpy(scans[0]).to(dev), dcfg)
    x = filter_input(model, samples0, pts, X, dcfg)
    b, pp, _ = x.shape

    def enc_old():
        enc_check(x, w, 16)
        out = torch.empty((b, 256), device=dev)
        err = old_enc(x.data_ptr(), b, pp, *(t.data_ptr() for t in w), out.data_ptr(), 16,
                      stream)
        assert err == 0, err
        return out

    def enc_new():
        return bias_encoder_pool(x, w, 16)

    # The two versions agree before they are timed.
    fo, fn = fused_old(), fused_new()
    eo, en = enc_old(), enc_new()
    torch.cuda.synchronize()
    fused_diff = float((fo - fn).abs().max())
    counts_equal = bool(torch.equal(fo[:, 0], fn[:, 0]))
    enc_close = float(((eo - en).abs() <= 2.0**-7 * eo.abs()).float().mean())
    print(f"fused: counts equal {counts_equal}, max |earlier - this| {fused_diff:.3e}; "
          f"encoder: codes within one bf16 ulp {enc_close:.5f}, max |diff| "
          f"{float((eo - en).abs().max()):.3e}")
    if not counts_equal or fused_diff > 1e-2 or enc_close < 0.995:
        print("compare_kernel_versions: the two versions disagree", file=sys.stderr)
        return 1

    # The C calls alone, with their buffers allocated once: what the launch
    # itself costs the host.
    from icet_tpu_torch.ops import fused_moments as fm
    partial = torch.empty((blocks, v1, 10), device=dev)
    out = torch.empty((v1, 16), device=dev)
    nb, per_block, cap = fm.launch_plan(n, cfg.n_voxels, sms)
    scratch = torch.empty(fm.scratch_floats(nb, cap, cfg.n_voxels), device=dev)
    new_lib = fm._lib()

    def raw_old():
        old_fused(pts.data_ptr(), n, X.data_ptr(), model.bounds.data_ptr(),
                  model.anchors.data_ptr(), cfg.n_voxels, cfg.n_theta, cfg.n_phi,
                  cfg.phi_min, cfg.phi_max - cfg.phi_min, cfg.min_range,
                  partial.data_ptr(), blocks, out.data_ptr(), stream)

    def raw_new():
        new_lib.icet_fused_moment_sums(
            pts.data_ptr(), n, X.data_ptr(), model.bounds.data_ptr(),
            model.anchors.data_ptr(), cfg.n_voxels, cfg.n_theta, cfg.n_phi,
            cfg.phi_min, cfg.phi_max - cfg.phi_min, cfg.min_range, scratch.data_ptr(), nb,
            per_block, cap, out.data_ptr(), stream)

    raw = {"earlier": [], "this": []}
    for which in ("earlier", "this", "this", "earlier"):
        raw[which].append(host_us(raw_old if which == "earlier" else raw_new))
    print(f"fused_moment_sums C call alone: host us to enqueue {raw} ({card})")

    rows = {"fused_moment_sums C call alone host_us": raw}
    for kernel, fns, reps in (("fused_moment_sums", (fused_old, fused_new), args.reps),
                              ("bias_encoder_pool", (enc_old, enc_new), max(5, args.reps // 5))):
        turns = []
        for which in (0, 1, 1, 0):
            fn = fns[which]
            turns.append({"version": ("earlier", "this")[which],
                          "device_ms": device_ms(fn, reps), "event_ms": median_ms(fn, reps),
                          "host_us": host_us(fn)})
        rows[kernel] = turns
        for t in turns:
            print(f"{kernel} {t['version']}: device {t['device_ms']:.5f} ms a call, "
                  f"CUDA events {t['event_ms']:.5f} ms, host {t['host_us']:.1f} us to "
                  f"enqueue ({card})")
    print(json.dumps({"card": card, "fused_shape": [n, cfg.n_voxels],
                      "encoder_shape": list(x.shape), "turns": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
