"""The port's own spans (``rendernet_tpu_torch/utils/spans.py``) over a
second traced stretch, and the device's time attributed to them.

After the traced stretch that the other per-layer readers read, the first
reader of a span metric runs the cell's ``traced_units`` once more, with
the port's span recording on, under ``torch.profiler`` with the CPU and
CUDA activities and without Python stacks. Each device event (kernel, copy,
fill) is tied to its launch through ``args.correlation``, and its time goes
to the innermost span open at that launch: on the launching thread if that
thread has a span open then, else on the thread of the stretch's root spans
(``train_step`` / ``render``), which holds ``backward`` while autograd's
device thread launches the backward's kernels. Each idle gap goes to the
innermost root-thread span open at the gap's middle; a launch or a gap with
no span open is ``outside`` (the caller's loop, its feed, a ``.cpu()``
wait). A device event whose correlation names no launch is unmatched.

The span records carry the host's realtime clock; they are put on the
trace's clock by the offset of each record from its ``rn.<name>``
annotation (their median), or by the trace's ``baseTimeNanoseconds`` where
the trace holds no annotation.

A ``spans`` line, before the result line, gives per unit (step or request)
for each span name: host ms (self time: its duration less its children's
on its thread), device busy ms (the union of its events), idle ms and
kernels; with the unmatched share of device time, the share under a root
span, the idle share, and the stretch's rate against the window's.

Where the port has no ``utils.spans`` (a commit before it), the second
stretch is not run and every span reader returns None.
"""
from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

from portbench import trace

MARKER = "portbench.spans"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ROOTS = ("train_step", "render")


class Rec(NamedTuple):
    """A span record on the trace's clock (microseconds)."""

    name: str
    parent: Optional[int]
    unit: int
    tid: int
    start: float
    end: float


def _records_on_trace_clock(records, annotations, base_ns: int) -> Tuple[List[Rec], dict]:
    """The records shifted onto the trace's clock, and the clock's check:
    ``gap_us``, the median and the largest distance of a record's start from
    its ``rn.`` annotation after the shift (the first pair left out: the
    profiler's first range starts late)."""
    on_base = [Rec(r.name, r.parent, r.unit, r.tid, (r.start_ns - base_ns) / 1e3,
                   (r.end_ns - base_ns) / 1e3) for r in records]
    by_key = defaultdict(list)
    for a in sorted(annotations, key=lambda a: a[2]):
        by_key[a[0], a[1]].append(a[2])
    seen = defaultdict(int)
    diffs = []
    for r in sorted(on_base, key=lambda r: r.start):
        k = ("rn." + r.name, r.tid)
        i = seen[k]
        seen[k] += 1
        if i < len(by_key.get(k, ())):
            diffs.append(by_key[k][i] - r.start)
    if not diffs:
        return on_base, {"pairs": 0}
    off = statistics.median(diffs)
    rest = [abs(d - off) for d in diffs[1:]] or [0.0]
    recs = [r._replace(start=r.start + off, end=r.end + off) for r in on_base]
    return recs, {"pairs": len(diffs), "offset_us": off, "gap_us_median": statistics.median(rest),
                  "gap_us_max": max(rest)}


class _Innermost:
    """The innermost span open at a time on one thread: of the spans that
    started by then, the last; else its nearest enclosing span (spans of
    one thread nest)."""

    def __init__(self, recs: List[Rec], idx: List[int]):
        self.recs = recs
        self.idx = sorted(idx, key=lambda i: recs[i].start)
        self.starts = [recs[i].start for i in self.idx]

    def at(self, t: float) -> Optional[int]:
        k = bisect.bisect_right(self.starts, t) - 1
        i = self.idx[k] if k >= 0 else None
        while i is not None and self.recs[i].end < t:
            i = self.recs[i].parent
        return i


def attribute(events: List[dict], records, base_ns: int) -> Optional[dict]:
    """The stretch's device and idle time by span, per unit, from the
    profiler's Chrome events and the port's span records; None where the
    trace has no stretch marker or no root span inside it."""
    window = None
    device, launches, annotations = [], {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation":
            if name == MARKER:
                window = (ts, end)
            elif name.startswith("rn."):
                annotations.append((name, e.get("tid"), ts))
        elif cat in trace.DEVICE_CATS:
            device.append((trace.Span(name, ts, end), cat, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (ts, e.get("tid"))
    if window is None:
        return None
    recs, clock = _records_on_trace_clock(records, annotations, base_ns)
    roots = [i for i, r in enumerate(recs) if r.name in ROOTS and r.parent is None
             and r.end > window[0] and r.start < window[1]]
    if not roots:
        return None
    units = len({recs[i].unit for i in roots})
    main = recs[roots[0]].tid
    threads = defaultdict(list)
    for i, r in enumerate(recs):
        threads[r.tid].append(i)
    inner = {tid: _Innermost(recs, idx) for tid, idx in threads.items()}

    def owner(t: float, tid) -> str:
        i = inner[tid].at(t) if tid in inner and tid != main else None
        if i is None and main in inner:
            i = inner[main].at(t)
        return "outside" if i is None else recs[i].name

    def clip(s):
        return trace.Span(s.name, max(s.start, window[0]), min(s.end, window[1]))

    inside = [(clip(s), cat, corr) for s, cat, corr in device
              if s.end > window[0] and s.start < window[1]]
    spans_of: Dict[str, List[trace.Span]] = defaultdict(list)
    kernels: Dict[str, int] = defaultdict(int)
    unmatched = []
    for s, cat, corr in inside:
        if corr not in launches:
            unmatched.append(s)
            continue
        who = owner(*launches[corr])
        spans_of[who].append(s)
        kernels[who] += int(cat == "kernel")
    all_dev = [s for s, _, _ in inside]
    busy = trace.union_us(all_dev)
    idle: Dict[str, float] = defaultdict(float)
    gaps = trace.gaps(trace.Trace(window, [], all_dev, []))
    for a, b in gaps:
        idle[owner(0.5 * (a + b), main)] += b - a
    host: Dict[str, float] = defaultdict(float)
    child = defaultdict(float)
    for r in recs:
        if r.parent is not None:
            child[r.parent] += r.end - r.start
    for i, r in enumerate(recs):
        if r.end > window[0] and r.start < window[1]:
            host[r.name] += r.end - r.start - child[i]

    per = 1e-3 / units  # us -> ms per unit
    window_us = window[1] - window[0]
    out = {"units": units, "window_ms": window_us * 1e-3, "device_events": len(inside),
           "clock": clock}
    if not inside:  # a run without a device: host times only
        out["spans"] = {n: {"host_ms": v * per} for n, v in sorted(host.items())}
        return out
    names = sorted(set(host) | set(spans_of) | set(idle), key=lambda n: (n == "outside", n))
    out["spans"] = {n: {"host_ms": host[n] * per if n in host else None,
                        "device_ms": trace.union_us(spans_of[n]) * per,
                        "idle_ms": idle[n] * per, "kernels": kernels[n] / units}
                    for n in names}
    dev_us = sum(s.end - s.start for s in all_dev)
    under = trace.union_us([s for n, ss in spans_of.items() if n != "outside" for s in ss])
    out.update(busy_ms=busy * 1e-3, idle_share=100.0 * (1.0 - busy / window_us),
               program_idle_share=100.0 * sum(v for n, v in idle.items() if n != "outside")
               / window_us,
               unmatched_share=100.0 * sum(s.end - s.start for s in unmatched) / dev_us,
               under_root_share=100.0 * under / busy)
    return out


def _load(prof) -> Tuple[List[dict], int]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data["traceEvents"], int(data.get("baseTimeNanoseconds", 0))


def stretch(mode, units: int, port_spans) -> Tuple[Optional[dict], float]:
    """``units`` more steps or requests of ``mode`` with the port's spans
    recorded, under the profiler without Python stacks: the attribution and
    the stretch's seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = mode.dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(MARKER):
            with port_spans.recording() as rec:
                t0 = time.perf_counter()
                mode.stretch(units)
                dt = time.perf_counter() - t0
    events, base = _load(prof)
    del prof
    if cuda:
        torch.cuda.synchronize()
    return attribute(events, rec.spans, base), dt


def _port_spans():
    try:
        from rendernet_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


_last: list = [None, None]  # [the reading, its attribution]


def _run_of(reading):
    """``run.main``'s mode and cell, from the frame that holds ``reading``
    (the readers' interface passes the reading alone)."""
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        if loc.get("reading") is reading and "mode" in loc and "cell" in loc:
            return loc["mode"], loc["cell"]
        f = f.f_back
    return None, None


def of(reading) -> Optional[dict]:
    """The span attribution of the run that made ``reading``, made once
    (the first span reader runs the stretch and prints the ``spans`` line);
    None where the port has no spans or the stretch ran on no device."""
    if _last[0] is reading:
        return _last[1]
    _last[0], _last[1] = reading, None
    port_spans = _port_spans()
    mode, cell = _run_of(reading)
    if port_spans is None or mode is None:
        return None
    units = cell["mix"]["traced_units"]
    att, dt = stretch(mode, units, port_spans)
    if att is None:
        return None
    att["traced_units_per_s"] = units / dt
    att["window_units_per_s"] = reading.window_units_per_s
    print("spans " + json.dumps(att), flush=True)
    if att["device_events"] == 0:
        return None
    _last[1] = att
    return att


def per_unit(reading, kind: str, name: str, field: str) -> Optional[float]:
    """``field`` of span ``name`` per unit, in a cell of ``kind``."""
    if reading.kind != kind:
        return None
    att = of(reading)
    if att is None or name not in att["spans"]:
        return None
    return att["spans"][name][field]
