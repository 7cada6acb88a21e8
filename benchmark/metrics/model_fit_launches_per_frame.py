"""Launches of the voxel-model fit's kernels (kernel #8,
``csrc/model_fit.cu``) a frame in the stretch traced on the device alone:
the trace's records of its symbol over the stretch's frames.  It reads 0
where the program has no such kernel and a chain of PyTorch operations
fits the model; twice a prepare where the kernel does (its two
launches)."""

#: the kernels' symbol in the trace
SYMBOL = "model_fit_kernel"


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof.events or not prof.frames:
        return None
    hits = sum(1 for name, _, _ in prof.events if SYMBOL in name)
    return hits / len(prof.frames)
