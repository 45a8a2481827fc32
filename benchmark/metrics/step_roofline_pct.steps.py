"""The least time of the fits' chain steps (``benchmark/roofline.py``: the
work of a step from the cell's shapes over the card's peaks) as a share of
the device time of the kernels inside the fit spans."""


def read(ctx):
    if not ctx.units:
        return None
    busy = sum(b - a for a, b, _ in ctx.trace.kernels_in(ctx.units)) * 1e-6
    if busy <= 0:
        return None
    return 100.0 * ctx.least_s_per_step * ctx.nsteps * len(ctx.units) / busy
