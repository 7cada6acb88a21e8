#!/usr/bin/env python3
"""Device time of one Gauss-Newton iteration, split by function, cold and
warm.

Builds two consecutive scans of the benchmark's lap (``benchmark/lap.py``,
the OS1-64 pattern; ``chip_smoke.lap_scans``), fits the model to the first
at each benchmark configuration (``benchmark/configs/*.json``), solves once
to warm up, then runs ``--iters`` cold iterations (``solver._iteration``
from X = 0 without a basis, as a solve's first) and ``--iters`` warm ones
(from the solution and its eigenbasis) eagerly under ``torch.profiler``,
each function of the iteration inside a ``record_function`` region of its
own.  Prints one JSON line a configuration: for each kind of iteration and
each region the device ms and the kernels launched an iteration, and their
share of the iteration's.  Regions: ``moments`` (scan 2's moment sums),
``finalize``, ``residual``, ``assembly`` (``assemble_normal_equations``),
``gn_assembly`` and ``gn_eigh6`` (the kernel wrappers, where the program
has them), ``eigh`` (the 6x6 eigensystem as plain operations, where the
program has no kernel for it), ``dR`` (the rotation derivative), ``rest``
(the iteration less all these).  The kernels launched through ctypes (#1,
#6, #7) are not attributed to a region: their device ms and launches an
iteration are given apart, from the trace's records of their symbols
(``kernels``), and ``iteration_ms`` adds them.  With ``--prepare`` it
splits the prepare (``solver.prepare_reference`` of the first scan) the
same way: ``clustering`` (``radial_cluster_bounds``), ``anchors``
(``voxel_anchors``), ``moments`` (#1's wrapper), ``fit``
(``model_from_sums``: the voxel-model fit, kernel #8 where the program has
it), ``rest`` (the scan's spherical coordinates and voxel ids); it runs on
an earlier tree's solver too.  Run from the repository root, on a machine
with a CUDA card:

    python3 tools/profile_gn_split.py [--iters 5] [--prepare]

It imports nothing of JAX or of ``icet_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.common import solver_config  # noqa: E402
from chip_smoke import lap_scans  # noqa: E402
from icet_tpu_torch import solver  # noqa: E402

#: region -> the solver module's names it wraps (those the module has)
REGIONS = {
    "moments": ("_sums",),
    "finalize": ("finalize_moments_planes",),
    "residual": ("residual_compact_planes",),
    "assembly": ("assemble_normal_equations",),
    "gn_assembly": ("gn_assembly",),
    "gn_eigh6": ("gn_eigh6",),
    "eigh": ("eigh_small", "eigh_small_warm_safe"),
    "dR": ("rotation_jacobian",),
}
#: the prepare's regions (``--prepare``)
PREPARE_REGIONS = {
    "clustering": ("radial_cluster_bounds",),
    "anchors": ("voxel_anchors",),
    "moments": ("_sums",),
    "fit": ("model_from_sums",),
}
CONFIGS = ("os1-64.odo", "os1-64.map")
#: the symbols of the kernels launched through ctypes (#1, #6, #7, #8)
KERNELS = ("fused_moments_kernel", "gn_assembly_kernel", "gn_eigh6_kernel", "model_fit_kernel")


@contextlib.contextmanager
def regions(table=None):
    """Wrap each function of ``table`` (default :data:`REGIONS`) in
    ``record_function``."""
    saved = {}

    def wrap(region, fn):
        def inner(*a, **k):
            with torch.profiler.record_function(f"gn.{region}"):
                return fn(*a, **k)
        return inner

    for region, names in (table or REGIONS).items():
        for name in names:
            if hasattr(solver, name):
                saved[name] = getattr(solver, name)
                setattr(solver, name, wrap(region, saved[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(solver, name, fn)


def _device(e) -> tuple[float, int]:
    """Device microseconds and kernels of ``e`` and everything under it."""
    us = sum(k.duration for k in e.kernels)
    n = len(e.kernels)
    for c in e.cpu_children:
        cu, cn = _device(c)
        us += cu
        n += cn
    return us, n


def _kernel_names(e) -> list[str]:
    """The names of the kernels under ``e``."""
    names = [k.name for k in e.kernels]
    for c in e.cpu_children:
        names += _kernel_names(c)
    return names


def profile(model, scan2, X, U2, cfg, iters: int) -> dict:
    """``iters`` iterations from X (warm from ``U2``, cold where it is None)
    under the profiler: each region's and each ctypes kernel's device ms and
    launches an iteration."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    it = 0 if U2 is None else 1
    with regions(), torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            with torch.profiler.record_function("gn.iteration"):
                out = solver._iteration(model, scan2, X, it, cfg, None, U2)
        torch.cuda.synchronize()
    return {**tally(prof, iters), "n_corr": int(out[5][0])}


def profile_prepare(scan, cfg, reps: int) -> dict:
    """``reps`` prepares of ``scan`` under the profiler, split as
    :func:`profile` splits an iteration (the keys ``iteration_*`` are a
    prepare's)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    solver.prepare_reference(scan, cfg)
    torch.cuda.synchronize()
    with regions(PREPARE_REGIONS), torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            with torch.profiler.record_function("gn.iteration"):
                solver.prepare_reference(scan, cfg)
        torch.cuda.synchronize()
    return tally(prof, reps)


def tally(prof, iters: int) -> dict:
    """The regions' and the ctypes kernels' device ms and launches a call
    from a profile of ``iters`` calls in ``gn.iteration`` regions."""
    totals: dict = {}
    kernels = {k: [0.0, 0] for k in KERNELS}
    attributed = False
    for e in prof.events():
        if e.name.startswith("gn."):
            us, n = _device(e)
            if e.name == "gn.iteration":
                attributed |= any(k in name for k in KERNELS for name in _kernel_names(e))
            t = totals.setdefault(e.name[3:], [0.0, 0])
            t[0] += us
            t[1] += n
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            for k in KERNELS:
                if k in e.name:
                    kernels[k][0] += e.time_range.end - e.time_range.start
                    kernels[k][1] += 1
    it_us, it_n = totals.pop("iteration", [0.0, 0])
    # Where the profiler does attribute them, the regions hold them already.
    lib_us = 0.0 if attributed else sum(us for us, _ in kernels.values())
    lib_n = 0 if attributed else sum(n for _, n in kernels.values())
    whole_us = it_us + lib_us
    out_rows = {}
    rest_us, rest_n = it_us, it_n
    for region, (us, n) in totals.items():
        rest_us -= us
        rest_n -= n
        out_rows[region] = {"ms": us / iters / 1e3, "kernels": n / iters,
                            "share": us / whole_us if whole_us else None}
    out_rows["rest"] = {"ms": rest_us / iters / 1e3, "kernels": rest_n / iters,
                        "share": rest_us / whole_us if whole_us else None}
    return {"iteration_ms": whole_us / iters / 1e3, "iteration_kernels": (it_n + lib_n) / iters,
            "regions": out_rows,
            "kernels_in_regions": attributed,
            "kernels": {k: {"ms": us / iters / 1e3, "launches": n / iters,
                            "share": us / whole_us if whole_us else None}
                        for k, (us, n) in kernels.items()}}


def split(cfg, scan1, scan2, iters: int) -> dict:
    """A cold iteration (X = 0, no basis) and a warm one (from the
    solution and its eigenbasis), profiled ``iters`` times each."""
    model = solver.prepare_reference(scan1, cfg)
    x0 = torch.zeros(6, device=scan1.device)
    res = solver.register(model, scan2, x0, cfg, want_static_mask=False)
    X = res.X.clone()
    _, _, _, _, U2, _, _ = solver._iteration(model, scan2, X, 1, cfg)
    torch.cuda.synchronize()
    return {"cold": profile(model, scan2, x0, None, cfg, iters),
            "warm": profile(model, scan2, X, U2, cfg, iters)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--prepare", action="store_true",
                    help="split the prepare instead of the iterations")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    scan1, scan2 = lap_scans(dev, 100, 2)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in CONFIGS:
        with open(os.path.join(root, "benchmark", "configs", f"{name}.json")) as f:
            cfg = solver_config(json.load(f))
        if args.prepare:
            row = {"prepare": profile_prepare(scan1, cfg, args.iters)}
        else:
            row = split(cfg, scan1, scan2, args.iters)
        print(json.dumps({"config": name, "card": card, "torch": torch.__version__, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
