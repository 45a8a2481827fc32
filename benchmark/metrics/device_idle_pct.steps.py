"""Share of the traced window of the fit cells in which nothing ran on the
device (kernels, copies, sets)."""


def read(ctx):
    if ctx.window is None:
        return None
    a, b = ctx.window
    busy = sum(y - x for x, y in ctx.trace.busy(a, b))
    return 100.0 * (1.0 - busy / (b - a)) if busy > 0 else None
