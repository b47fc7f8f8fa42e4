"""From a profiler trace of a steady stretch to what the per-layer readers
read: the device's kernel intervals, their union, the idle gaps and what
the host was doing in each, and the ``breakdown`` of the result line.

The trace is ``torch.profiler``'s (CUPTI) in Chrome's format. Busy time is
the union of the device's activity intervals (kernels, copies, fills)
inside the stretch's marker, so overlapping kernels count once.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

MARKER = "portbench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Span(NamedTuple):
    name: str
    start: float  # microseconds, the trace's clock
    end: float


def kernel_name(raw: str) -> str:
    """A device kernel's function name without namespaces, arguments and
    template arguments (``k3_gemm_fold``, ``conv3d_wgrad_tf32_kernel``)."""
    name = re.sub(r"^void ", "", raw.replace("(anonymous namespace)::", ""))
    name = name.split("(")[0].split("<")[0]
    return re.sub(r"^.*::", "", name).strip()


def union(spans: List[Span]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s in sorted(spans, key=lambda s: s.start):
        if out and s.start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], s.end))
        else:
            out.append((s.start, s.end))
    return out


def union_us(spans: List[Span]) -> float:
    return sum(b - a for a, b in union(spans))


class Trace(NamedTuple):
    window: Tuple[float, float]
    kernels: List[Span]  # "kernel" events only
    device: List[Span]  # kernels, copies and fills
    host: List[Span]  # CPU ops, runtime calls and Python frames


def load(prof) -> Trace:
    """The stretch's spans from a finished ``torch.profiler.profile``."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    window = None
    kernels, device, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        span = Span(name, float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if cat == "user_annotation" and name == MARKER:
            window = (span.start, span.end)
        elif cat in DEVICE_CATS:
            device.append(span)
            if cat == "kernel":
                kernels.append(span)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver", "python_function"):
            host.append(span)
    if window is None:
        raise RuntimeError(f"the trace has no {MARKER} span")

    def inside(spans):
        return [Span(s.name, max(s.start, window[0]), min(s.end, window[1])) for s in spans
                if s.end > window[0] and s.start < window[1]]

    return Trace(window, inside(kernels), inside(device), inside(host))


def gaps(tr: Trace) -> List[Tuple[float, float]]:
    """The stretch's idle intervals: where no device activity runs."""
    out, t = [], tr.window[0]
    for a, b in union(tr.device):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if tr.window[1] > t:
        out.append((t, tr.window[1]))
    return out


def _label(host: List[Span], starts: List[float], t: float, depth: int = 256) -> str:
    """The innermost host operation running at ``t``: of the spans that
    contain it, the one that started last (``host`` sorted by start)."""
    i = bisect.bisect_right(starts, t)
    for s in reversed(host[max(0, i - depth):i]):
        if s.end >= t:
            return re.sub(r" at 0x[0-9a-f]+", "", s.name)
    return "host: no operation recorded"


def breakdown(tr: Trace, top: int = 10) -> Dict[str, list]:
    """``device_ops``: device time by kernel name, the largest first;
    ``idle_gaps``: idle time by the host operation running at each gap's
    middle, the largest first; both in seconds."""
    by_name: Dict[str, float] = defaultdict(float)
    for s in tr.device:
        by_name[kernel_name(s.name)] += s.end - s.start
    by_host: Dict[str, float] = defaultdict(float)
    host = sorted(tr.host, key=lambda s: s.start)
    starts = [s.start for s in host]
    for a, b in gaps(tr):
        by_host[_label(host, starts, 0.5 * (a + b))] += b - a

    def ranked(d):
        return [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_name), "idle_gaps": ranked(by_host)}


class Reading(NamedTuple):
    """What a per-layer reader reads: the stretch's trace, the launches the
    port counted in it (``counters.delta``), how many units (steps or
    requests) it ran, and the cell's facts."""

    trace: Trace
    launches: Dict[str, Dict]
    units: int
    kind: str  # "train" | "render"
    dtype: str
    flops_per_unit: Dict[str, float]
    window_units_per_s: float

    @property
    def window_us(self) -> float:
        return self.trace.window[1] - self.trace.window[0]

    @property
    def busy_us(self) -> float:
        return union_us(self.trace.device)

    def kernels_named(self, names) -> List[Span]:
        return [s for s in self.trace.kernels if kernel_name(s.name) in names]
