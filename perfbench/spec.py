"""What the benchmark is made of, found by name: ``BENCHMARK.json`` at the
root of the checkout, one file a configuration (``configs/<name>.json``),
one a cell (``workloads/<name>.json``), one module a per-layer metric
(``metrics/<name>.py``, its ``read(ctx)``) and the kernel-name lists that
assign the device's kernels to a phase (``phases/*.json``, their union).
A later change adds a configuration, a cell, a metric or a kernel by
adding files and entries, and edits none of these."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _named(folder: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    path = HERE / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    return path


def config(name: str) -> dict:
    return json.loads(_named("configs", name, ".json").read_text())


def workload(name: str) -> dict:
    return json.loads(_named("workloads", name, ".json").read_text())


def metric(name: str):
    """The reader module of per-layer metric ``name``."""
    _named("metrics", name, ".py")
    return importlib.import_module(f"perfbench.metrics.{name}")


def phases() -> dict:
    """{phase: set of kernel names}, the union of every file in
    ``phases/``."""
    out: dict = {}
    for path in sorted((HERE / "phases").glob("*.json")):
        spec = json.loads(path.read_text())
        out.setdefault(spec["phase"], set()).update(spec["kernels"])
    return out


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries that cell ``cell`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones; an entry with a
    ``workloads`` list only in those cells."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]
