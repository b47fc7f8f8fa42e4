"""``render_mfu``: the whole request's operations (counted least: the
3x3 2-D convolutions as Winograd products, every other convolution direct) at
the measured window's rate, as a share of the bf16 peak."""
from portbench import work


def read(r, suffix):
    if r.kind != "render" or r.window_units_per_s <= 0:
        return None
    return 100.0 * r.flops_per_unit["least"] * r.window_units_per_s / work.PEAK_FLOPS["bfloat16"]
