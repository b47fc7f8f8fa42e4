"""``resample_roofline.<train|render>``: the resample passes K1 and their
adjoint K4, as a share of its roofline."""
from portbench.metrics import _roofline


def read(r, suffix):
    if suffix != r.kind:
        return None
    return _roofline.share(r, _roofline.K1 + _roofline.K4, ("k1", "k4"))
