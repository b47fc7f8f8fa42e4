"""The span attribution (``portbench/spans.py``) on a small synthetic Chrome
trace: device time by correlation to the innermost span open at its launch
(the launching thread's, else the root thread's), idle gaps split into
spans and ``outside``, the unmatched share; and the span readers' None
where the port records no spans."""
from typing import NamedTuple, Optional

import pytest

from portbench import spans, trace
from portbench.metrics import program_idle_share, update_idle_ms, update_ms, weights_ms

READERS = (update_ms, update_idle_ms, weights_ms, program_idle_share)
MAIN, AUTOGRAD = 11, 12


class R(NamedTuple):  # the fields of the port's SpanRecord
    name: str
    parent: Optional[int]
    unit: int
    tid: int
    start_ns: int
    end_ns: int


def _records(shift_ns=0):
    us = 1000
    rows = [("train_step", None, MAIN, 10, 900), ("warp", 0, MAIN, 20, 100),
            ("encoder3d", 0, MAIN, 100, 300), ("weights", 2, MAIN, 110, 120),
            ("backward", 0, MAIN, 300, 700), ("update", 0, MAIN, 700, 890),
            # a forward recomputed inside the backward, on autograd's thread
            ("weights", None, AUTOGRAD, 400, 410)]
    return [R(n, p, 1, tid, a * us + shift_ns, b * us + shift_ns) for n, p, tid, a, b in rows]


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    launch = [(1, 50, MAIN), (2, 115, MAIN), (3, 405, AUTOGRAD), (4, 500, AUTOGRAD),
              (5, 800, MAIN), (7, 950, MAIN)]
    dev = [("kernel", 1, 60, 100), ("kernel", 2, 160, 10), ("kernel", 3, 420, 20),
           ("kernel", 4, 500, 120), ("gpu_memcpy", 5, 800, 50),
           ("kernel", 6, 860, 10),  # its launch is not in the trace
           ("kernel", 7, 950, 10)]
    return ([_x("user_annotation", spans.MARKER, 0, 1000)]
            + [_x("cuda_runtime", "cudaLaunchKernel", ts, 3, tid, c) for c, ts, tid in launch]
            + [_x(cat, f"k{c}", ts, dur, 7, c) for cat, c, ts, dur in dev])


def _check(att):
    t = att["spans"]
    assert att["units"] == 1 and att["window_ms"] == pytest.approx(1.0)
    # by correlation, to the innermost span open at the launch
    assert t["warp"]["device_ms"] == pytest.approx(0.100)
    assert t["update"]["device_ms"] == pytest.approx(0.050) and t["update"]["kernels"] == 0
    assert t["outside"]["device_ms"] == pytest.approx(0.010)
    # across two threads: autograd's own open span first, else the root thread's
    assert t["weights"]["device_ms"] == pytest.approx(0.030) and t["weights"]["kernels"] == 2
    assert t["backward"]["device_ms"] == pytest.approx(0.120)
    # idle gaps, by the root thread's span at each gap's middle
    assert t["warp"]["idle_ms"] == pytest.approx(0.060)
    assert t["encoder3d"]["idle_ms"] == pytest.approx(0.250)
    assert t["backward"]["idle_ms"] == pytest.approx(0.060)
    assert t["update"]["idle_ms"] == pytest.approx(0.190)
    assert t["outside"]["idle_ms"] == pytest.approx(0.120)
    assert att["program_idle_share"] == pytest.approx(56.0)
    assert att["idle_share"] == pytest.approx(68.0)
    # unmatched: 10 of 320 us of device time
    assert att["unmatched_share"] == pytest.approx(100 * 10 / 320)
    assert att["under_root_share"] == pytest.approx(100 * 300 / 320)
    # host self time: a span less its children on its thread
    assert t["train_step"]["host_ms"] == pytest.approx(0.020)
    assert t["encoder3d"]["host_ms"] == pytest.approx(0.190)
    assert t["outside"]["host_ms"] is None


def test_attribution_on_the_base_clock():
    att = spans.attribute(_events(), _records(), 0)
    _check(att)
    assert att["clock"] == {"pairs": 0}


def test_attribution_takes_the_offset_from_the_annotations():
    """Records on another clock: the ``rn.`` ranges give the offset."""
    events = _events() + [_x("user_annotation", "rn." + r.name, r.start_ns / 1e3 + 0.5,
                             (r.end_ns - r.start_ns) / 1e3, r.tid) for r in _records()]
    att = spans.attribute(events, _records(shift_ns=7_000_000), 0)
    _check(att)
    assert att["clock"]["pairs"] == 7
    assert att["clock"]["offset_us"] == pytest.approx(-7000 + 0.5)
    assert att["clock"]["gap_us_max"] == pytest.approx(0.0, abs=1e-6)


def test_no_marker_or_no_root_is_no_attribution():
    assert spans.attribute(_events()[1:], _records(), 0) is None
    assert spans.attribute(_events(), _records()[1:2], 0) is None


def test_a_run_without_a_device_gives_host_times_only():
    events = [e for e in _events() if e["cat"] not in trace.DEVICE_CATS]
    att = spans.attribute(events, _records(), 0)
    assert att["device_events"] == 0
    assert set(att["spans"]["update"]) == {"host_ms"}


def _reading(kind):
    return trace.Reading(trace.Trace((0.0, 1.0), [], [], []), {}, 2, kind, "bfloat16",
                         {"least": 1.0, "direct": 1.0}, 1.0)


class _NoStretch:
    def stretch(self, units):
        raise AssertionError("no span stretch without the port's spans")


def _read_in_a_run(reader, suffix, reading):
    """A reader called as ``run.main`` calls it: from a frame holding the
    run's ``reading``, ``mode`` and ``cell``."""
    mode, cell = _NoStretch(), {"mix": {"traced_units": 2}}  # noqa: F841 (read by spans.of)
    return reader.read(reading, suffix)


def test_readers_return_none_without_the_ports_spans(monkeypatch):
    monkeypatch.setattr(spans, "_port_spans", lambda: None)
    for kind in ("train", "render"):
        reading = _reading(kind)
        for reader in READERS:
            assert _read_in_a_run(reader, kind, reading) is None
            assert _read_in_a_run(reader, "render" if kind == "train" else "train",
                                  reading) is None


def test_readers_return_none_outside_a_run():
    for reader in READERS:
        assert reader.read(_reading("train"), "train") is None
