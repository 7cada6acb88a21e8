"""Kernels a frame in the stretch traced on the device alone: the trace's
kernel records (its copies and sets left out) over the stretch's frames.
At tens of thousands of kernels a frame the trace can lose records (as
``k1_roofline``'s count shows), so a high reading may read low."""

#: the trace's names of copies and sets, which are not kernels
NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof.events or not prof.frames:
        return None
    kernels = sum(1 for name, _, _ in prof.events if not name.startswith(NOT_KERNELS))
    return kernels / len(prof.frames)
