"""Times kernel #1's sorted parts with a part's bitmap in shared memory
against the same kernel with the bitmap in device memory.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/time_bitmap_placement.py

``csrc/fused_moments.cu`` keeps a part's bitmap in shared memory where it
fits beside the sort and the staged rows (up to ~1.36 million rows) and in
device memory beyond.  This script builds the source a second time with
``-DICET_SORTED_SMEM_LIMIT=0``, which sends every bitmap to device memory,
and calls both libraries through this tree's wrapper on
``chip_smoke.py``'s inputs: the drive's frame 1 at X = [1, 0.05, 0, 0, 0,
0.02], in fixed radial mode (90,001 rows) at 64x1024 and 64x2048 points,
and on the 150x48 grid (7,201 rows, frame 0's model) at 64x1024.  The two
placements must give the same bits.  They run in turns, shared, device,
device, shared, shared, device; each turn records the device time a call
by torch.profiler and the CUDA-event time over back-to-back calls
(``chip_smoke.kernel_times``).  The last line is one JSON object with
every number and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import device_line, kernel_times, patched  # noqa: E402
from icet_tpu_torch import _build  # noqa: E402


def build_device_bits() -> ctypes.CDLL:
    """``csrc/fused_moments.cu`` with every part's bitmap in device memory,
    built beside the port's own libraries."""
    _build.BUILD_DIR.mkdir(exist_ok=True)
    lib = _build.BUILD_DIR / "fused_moments-device-bits.so"
    src = _build.CSRC / "fused_moments.cu"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DICET_SORTED_SMEM_LIMIT=0",
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(str(lib))
    real = _build.load("fused_moments")
    dll.icet_fused_moment_sums.argtypes = real.icet_fused_moment_sums.argtypes
    dll.icet_fused_moment_sums.restype = ctypes.c_int
    dll.icet_cuda_error_string.argtypes = [ctypes.c_int]
    dll.icet_cuda_error_string.restype = ctypes.c_char_p
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        print("time_bitmap_placement: CUDA is not available", file=sys.stderr)
        return 1
    from icet_tpu_torch.config import ICETConfig
    from icet_tpu_torch.datasets.replay import CityDriveSource
    from icet_tpu_torch.ops import fused_moments as fm
    from icet_tpu_torch.ops.grid import fixed_shell_bounds, voxel_anchors
    from icet_tpu_torch.solver import prepare_reference

    card = device_line()
    print(card, flush=True)
    fm._lib()
    device_bits = build_device_bits()
    dev = torch.device("cuda")
    cfg = ICETConfig(n_iters=7, convergence_tol=1e-4, convergence_stat_scale=1.0)
    fixed = cfg.replace(radial_mode="fixed")
    big = cfg.replace(n_theta=150, n_phi=48)
    X = torch.tensor([1.0, 0.05, 0.0, 0.0, 0.0, 0.02], device=dev)
    scans = np.stack([s for s, _ in CityDriveSource(n_frames=2, speed=1.0, n_beams=64,
                                                    n_azimuth=1024)]).astype(np.float32)
    wide, _ = next(iter(CityDriveSource(n_frames=1, speed=1.0, n_beams=64, n_azimuth=2048)))
    pts = torch.from_numpy(scans[1]).to(dev)
    wide_pts = torch.from_numpy(np.ascontiguousarray(wide, np.float32)).to(dev)
    fb = fixed_shell_bounds(fixed, dev)
    fmodel = types.SimpleNamespace(bounds=fb, anchors=voxel_anchors(fb, fixed))
    bmodel = prepare_reference(torch.from_numpy(scans[0]).to(dev), big)

    ok, rows = True, {}
    for what, p, m, c in (("fixed N=65536", pts, fmodel, fixed),
                          ("fixed N=131072", wide_pts, fmodel, fixed),
                          ("150x48 N=65536", pts, bmodel, big)):
        def shared():
            return fm.fused_moment_sums(p, X, m.bounds, m.anchors, c)

        def device():
            with patched(fm, "_lib", lambda: device_bits):
                return fm.fused_moment_sums(p, X, m.bounds, m.anchors, c)

        same = bool(torch.equal(shared(), device()))
        ok &= same
        turns = []
        for which in ("shared", "device", "device", "shared", "shared", "device"):
            dev_ms, ev_ms = kernel_times(shared if which == "shared" else device, reps=200)
            turns.append({"bitmap": which, "device_ms": dev_ms, "event_ms": ev_ms})
        name = f"{what} V+1={c.n_voxels + 1}"
        rows[name] = {"bits_equal": same, "turns": turns}
        for t in turns:
            print(f"{name}, bitmap in {t['bitmap']} memory: device {t['device_ms']:.6f} ms a "
                  f"call, CUDA events {t['event_ms']:.6f} ms ({card})", flush=True)
        print(f"{name}: the two placements give the same bits: {same}", flush=True)
    if not ok:
        print("time_bitmap_placement: the placements gave different bits", file=sys.stderr)
    print(json.dumps({"card": card, "rows": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
