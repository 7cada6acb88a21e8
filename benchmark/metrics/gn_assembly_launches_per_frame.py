"""Launches of the normal-equation kernel (kernel #6,
``csrc/gn_assembly.cu``) a frame in the stretch traced on the device
alone: the trace's records of its symbol over the stretch's frames.  It
reads 0 where the program has no such kernel and the plain chain of
PyTorch operations assembles the normal equations; once a Gauss-Newton
iteration where the kernel does."""

#: the kernel's symbol in the trace
SYMBOL = "gn_assembly_kernel"


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof.events or not prof.frames:
        return None
    hits = sum(1 for name, _, _ in prof.events if SYMBOL in name)
    return hits / len(prof.frames)
