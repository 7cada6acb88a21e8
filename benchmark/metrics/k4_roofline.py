"""Kernel #4's share of its roofline in the profiled stretch, in percent:
the least time the card could take for one launch's work over the mean
device time of a launch the trace recorded.

A launch encodes every voxel row of the grid (``V + 1``) over the 2S
points of its two samples: ``rows * 2S * 2 * (4*64 + 64*128 + 128*256)``
bf16 operations (``reference.dnn_filter.encoder_flop``; 2.97e10 at 1,801
rows and S = 100), against its float32 input, codes and weights in bytes.
Operations bound it.  Peaks: H100 SXM, 989 TFLOP/s dense bf16 and 3.35
TB/s.  The program's count of launches over the stretch comes from the
frame log's ``encoder_launches`` value of the stretch's frames."""

from benchmark import stats
from benchmark.reference import dnn_filter as dref

#: the kernel's symbol in the trace (``csrc/bias_encoder.cu``)
SYMBOL = "bias_encoder_kernel"
#: the H100 SXM's dense bf16 peak
PEAK_BF16_PER_S = 989e12


def program_launches(ctx, frames: int) -> int | None:
    """The frame log's encoder launches over the run's last ``frames``
    steps (the stretch traced on the device alone), or None."""
    from icet_tpu_torch.utils import profiling

    rec = profiling.frame_log.records()
    seq, names = rec["seq"], list(rec.get("value_names", ()))
    if "encoder_launches" not in names or not len(seq) or int(seq[-1]) + 1 != len(ctx.records):
        return None
    first = len(ctx.records) - frames
    if first < seq[0]:
        return None
    return int(rec["values"][first - seq[0]:, names.index("encoder_launches")].sum())


def read(ctx):
    prof = ctx.profile
    if prof is None:
        return None
    port = program_launches(ctx, len(prof.frames))
    hits = [(s, t) for name, s, t in prof.events if SYMBOL in name]
    ctx.note(f"k4 launches in the profiled stretch: trace {len(hits)}, program {port}"
             + ("" if len(hits) == port else " (the trace misses records)"))
    if not hits or not port:
        return None
    rows = ctx.config["n_theta"] * ctx.config["n_phi"] + 1
    points = 2 * ctx.config["dnn_sample_pts"]
    bound, by = stats.bound_ms(dref.encoder_bytes(rows, points), dref.encoder_flop(rows, points),
                               PEAK_BF16_PER_S)
    mean_ms = sum(t - s for s, t in hits) / len(hits) * 1e3
    share = 100.0 * bound / mean_ms
    ctx.note(f"k4: bound {bound:.8f} ms a launch ({by}), trace {mean_ms:.8f} ms a launch, "
             f"{share:.4f}% of the H100 SXM peaks; card after the window: {ctx.card}")
    return share
