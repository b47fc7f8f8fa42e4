"""``update_idle_ms.train``: the device's idle ms per step while the host is
inside the port's ``update`` span, from the span stretch
(``portbench/spans.py``)."""
from portbench import spans


def read(r, suffix):
    return spans.per_unit(r, suffix, "update", "idle_ms")
