"""``update_ms.train``: the device's busy ms per step in the events launched
inside the port's ``update`` span (Adam's per-tensor update and
``apply_updates``), from the span stretch (``portbench/spans.py``)."""
from portbench import spans


def read(r, suffix):
    return spans.per_unit(r, suffix, "update", "device_ms")
