"""``program_idle_share.<train|render>``: the share of the span stretch in
which the device is idle while the host is inside one of the port's spans
(its own dispatch between launches), from ``portbench/spans.py``."""
from portbench import spans


def read(r, suffix):
    if suffix != r.kind:
        return None
    att = spans.of(r)
    return None if att is None else att["program_idle_share"]
