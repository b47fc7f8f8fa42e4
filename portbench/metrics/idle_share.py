"""``idle_share.<train|render>``: the share of the stretch in which no
operation ran on the device (the union of kernel, copy and fill intervals
against the stretch's length)."""


def read(r, suffix):
    if suffix != r.kind or r.window_us <= 0:
        return None
    return 100.0 * (1.0 - r.busy_us / r.window_us)
