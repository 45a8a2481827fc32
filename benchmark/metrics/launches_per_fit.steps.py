"""Device kernels launched per fit: kernels that start inside the
``sampler.fit`` spans of the traced window, over the number of fits."""


def read(ctx):
    if not ctx.units:
        return None
    return len(ctx.trace.kernels_in(ctx.units)) / len(ctx.units)
