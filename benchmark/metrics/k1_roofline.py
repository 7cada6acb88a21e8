"""Kernel #1's share of its roofline in the profiled stretch, in percent:
the least time the card could take for one launch's work, from the
benchmark's own binning of the stretch's scans, over the mean device time
of a launch the trace recorded.

A launch reads each point once (12 B) and the solution (24 B), the radial
bounds and anchor (20 B) of each voxel row its points fall in, and writes
the ``(V+1, 16)`` float32 sums; it does at least 83 operations a point.
A frame launches it once for the scan's own model, at zero, and once a
Gauss-Newton iteration, at the solution (the frame's final one stands for
each iteration's): the program's count of launches over the stretch says
how many a frame.  Peaks: H100 SXM, 3.35 TB/s and 67 TFLOP/s float32."""

import torch

from benchmark import stats
from benchmark.reference import icet as ref

#: the kernel's symbol in the trace (``csrc/fused_moments.cu``)
SYMBOL = "fused_moments_kernel"


def launch_bound_ms(scan: torch.Tensor, X: torch.Tensor, g: ref.Grid) -> float:
    vid = ref.voxel_ids(ref.cart_to_spherical(ref.transform_points(scan, X)), g)
    rows = int(torch.unique(vid[(ref.point_norm(scan) >= g.min_range)
                                & (vid < g.n_voxels)]).numel())
    n = scan.shape[0]
    return stats.bound_ms(n * 12 + 6 * 4 + rows * 20 + (g.n_voxels + 1) * 16 * 4, n * 83)[0]


def read(ctx):
    prof = ctx.profile
    if prof is None:
        return None
    hits = [(s, t) for name, s, t in prof.events if SYMBOL in name]
    port = prof.after["k1_launches"] - prof.before["k1_launches"]
    ctx.note(f"k1 launches in the profiled stretch: trace {len(hits)}, program {port}"
             + ("" if len(hits) == port else " (the trace misses records)"))
    frames = [r for r in prof.frames if r["out"] is not None]
    if not hits or not frames or port < len(frames):
        return None
    g = ref.grid_of(ctx.config)
    at_solution = port / len(frames) - 1.0  # launches a frame at the solution
    total = 0.0
    for r in frames:
        scan = torch.from_numpy(ctx.lap.scans[r["lap"]]).to(ctx.device)
        total += at_solution * launch_bound_ms(scan, torch.from_numpy(r["out"]["X"]).to(
            ctx.device), g)
        total += launch_bound_ms(scan, torch.zeros(6, device=ctx.device), g)
    bound = total / port
    mean_ms = sum(t - s for s, t in hits) / len(hits) * 1e3
    share = 100.0 * bound / mean_ms
    ctx.note(f"k1: bound {bound:.8f} ms a launch (bytes), trace {mean_ms:.8f} ms a "
             f"launch, {share:.4f}% of the H100 SXM peaks; card after the window: {ctx.card}")
    return share
