"""The port's launch counters, read around a stretch: how many launches of
K3, K2, K2w, K1 and K4 it made at each shape (``ops/cuda_*.py``'s
``launches_by_shape`` counters). Each per-layer roofline sums its kernel's
bound over these launches."""
from __future__ import annotations

import importlib
from collections import Counter
from typing import Dict

# family -> (port module, counter): the key of each count is the
# counter's own (the input shape and the output channels, or the pass's
# (BC, R, L, out lanes[, taps])).
COUNTERS = {
    "k3": ("rendernet_tpu_torch.ops.cuda_winograd", "launches_by_shape"),
    "k2": ("rendernet_tpu_torch.ops.cuda_conv3d", "launches_by_shape"),
    "k2w": ("rendernet_tpu_torch.ops.cuda_conv3d", "wgrad_launches_by_shape"),
    "k1": ("rendernet_tpu_torch.ops.cuda_resample", "launches_by_shape"),
    "k4": ("rendernet_tpu_torch.ops.cuda_resample", "bwd_launches_by_shape"),
}


def snapshot() -> Dict[str, Counter]:
    return {f: Counter(getattr(importlib.import_module(m), c)) for f, (m, c) in COUNTERS.items()}


def delta(before: Dict[str, Counter]) -> Dict[str, Counter]:
    """The launches since ``before``, by family and shape."""
    now = snapshot()
    return {f: now[f] - before[f] for f in now}
