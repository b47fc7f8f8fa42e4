"""``weights_ms.<train|render>``: the device's busy ms per step or request in
the events launched inside the port's ``weights`` spans (parameters cast
and re-laid at each use, ``nn/layers.py``), from the span stretch
(``portbench/spans.py``)."""
from portbench import spans


def read(r, suffix):
    return spans.per_unit(r, suffix, "weights", "device_ms")
