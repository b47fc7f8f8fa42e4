"""``k2_roofline.<train|render>``: the 3-D conv K2 (forward and data
gradient) and its weight gradient K2w, as a share of its roofline."""
from portbench.metrics import _roofline


def read(r, suffix):
    if suffix != r.kind:
        return None
    return _roofline.share(r, _roofline.K2 + _roofline.K2W, ("k2", "k2w"))
