"""Finds everything a run needs by name, so that a cell, a configuration, a
mode or a per-layer metric is added by adding a file:

* ``workloads/<cell>.json``: the cell (its configuration, mode, the
  parameters of its traffic mix (``mix``), route flags and the limits of
  its correctness check);
* ``configs/<config>.json``: a model configuration;
* ``modes/<mode>.py``: a way of driving the port (a ``Mode`` class);
* ``metrics/<family>.py``: the reader of a per-layer metric, ``read(reading,
  suffix)``; a metric ``<family>.<suffix>`` shares its family's file;
* ``BENCHMARK.json`` at the checkout's root: which metrics each cell reports.
"""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _checked(name: str) -> str:
    if not NAME.match(name) or ".." in name:
        raise ValueError(f"not a name: {name!r}")
    return name


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    path = HERE / "workloads" / f"{_checked(name)}.json"
    if not path.exists():
        raise KeyError(f"no cell {name!r} (no {path.relative_to(ROOT)})")
    return _json(path)


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{_checked(name)}.json")


def mode(name: str):
    return importlib.import_module(f"portbench.modes.{_checked(name)}").Mode


def metric_reader(name: str):
    """``(read, suffix)`` of a per-layer metric: ``idle_share.train`` reads
    through ``metrics/idle_share.py`` with the suffix ``train``."""
    family, _, suffix = _checked(name).partition(".")
    return importlib.import_module(f"portbench.metrics.{family}").read, (suffix or None)


def names(kind: str) -> List[str]:
    """Every cell (``workloads``), configuration (``configs``), mode
    (``modes``) or metric family (``metrics``) that has a file."""
    ext = ".py" if kind in ("modes", "metrics") else ".json"
    return sorted(p.name[:-len(ext)] for p in (HERE / kind).glob(f"*{ext}")
                  if not p.name.startswith("_"))


def metrics_of(cell: str, section: str, bench: dict | None = None) -> List[Dict]:
    """The entries of ``BENCHMARK.json``'s ``section`` that ``cell`` reports:
    those without ``workloads`` and those that list it."""
    bench = manifest() if bench is None else bench
    return [m for m in bench[section] if "workloads" not in m or cell in m["workloads"]]
