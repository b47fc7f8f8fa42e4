"""``kernels_per_request.render``: device kernels launched per request."""


def read(r, suffix):
    if suffix != r.kind or r.units <= 0:
        return None
    return len(r.trace.kernels) / r.units
