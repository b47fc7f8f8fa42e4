"""``kernels_per_step.train``: device kernels launched per training step
(the traced stretch's kernels over its steps)."""


def read(r, suffix):
    if suffix != r.kind or r.units <= 0:
        return None
    return len(r.trace.kernels) / r.units
