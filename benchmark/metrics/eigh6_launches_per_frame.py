"""Launches of the 6x6 eigensystem kernel (kernel #7,
``csrc/gn_eigh6.cu``) a frame in the stretch traced on the device alone:
the trace's records of its symbol over the stretch's frames.  It reads 0
where the program has no such kernel and a chain of PyTorch operations
solves the 6x6 eigensystem; once a Gauss-Newton iteration where the kernel
does."""

#: the kernel's symbol in the trace
SYMBOL = "gn_eigh6_kernel"


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof.events or not prof.frames:
        return None
    hits = sum(1 for name, _, _ in prof.events if SYMBOL in name)
    return hits / len(prof.frames)
