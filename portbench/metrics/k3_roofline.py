"""``k3_roofline.<train|render>``: the Winograd 2-D conv K3 (forward and data
gradient), as a share of its roofline."""
from portbench.metrics import _roofline


def read(r, suffix):
    if suffix != r.kind:
        return None
    return _roofline.share(r, _roofline.K3, ("k3",))
