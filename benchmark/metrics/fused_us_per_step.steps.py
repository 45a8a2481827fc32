"""Device time of every kernel inside the fit spans, in microseconds per
chain step (nsteps x fits, one chain a fit)."""


def read(ctx):
    if not ctx.units:
        return None
    busy = sum(b - a for a, b, _ in ctx.trace.kernels_in(ctx.units))
    steps = ctx.nsteps * ctx.nchains * len(ctx.units)
    return busy / steps if busy > 0 else None
