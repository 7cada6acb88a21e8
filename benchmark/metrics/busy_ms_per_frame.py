"""Device milliseconds a frame in the stretch traced on the device alone:
the union of the kernel, copy and set intervals of the trace, divided by
its frames."""


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof.events or not prof.frames:
        return None
    return prof.busy_s * 1e3 / len(prof.frames)
