"""Share of the window in which no operation ran on the device (one minus
the union of the traced kernels, copies and sets over the window), in
percent."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.window_s)
