"""Shared builders of the benchmark's CPU tests: the configurations cut to
a 512-bead chain with LE events every few steps, so that a run of a few
steps covers every layer the comparison judges."""

import copy

import pytest
import torch

from perfbench import spec

# the plain versions run on small tensors: one intra-op thread
torch.set_num_threads(1)


def small(cfg: dict, n: int = 512) -> dict:
    c = copy.deepcopy(cfg)
    c["beads"] = n
    c["scene"]["barrier_fraction"] = 0.02
    c["neighbor"]["cell_cap"] = 16
    c["extruders"] = {"table": 64, "seeded": 6}
    c["setup"]["thermalize"]["steps"] = 60
    c["setup"]["settle"]["steps"] = 20
    ev = dict(c["events"])
    c["events"] = [
        ["extrusion", dict(ev["extrusion"], nevery=5)],
        ["ex_load", dict(ev["ex_load"], nevery=7, fraction=0.3,
                         cutoff=1.6)],
        ["ex_unload", dict(ev["ex_unload"], nevery=7, fraction=0.3)]]
    return c


def small_cell(name: str):
    """(workload, configuration) of cell ``name`` at the test size, on the
    CPU: K2's step loop in its plain form (``pallas="interpret"``)."""
    work = dict(spec.workload(name), warm_steps=10, segment_steps=10,
                check_steps=8)
    if work["engine"].get("pallas") == "real":
        work["engine"] = dict(work["engine"], pallas="interpret")
    return work, small(spec.config(work["config"]))


@pytest.fixture
def cell():
    return small_cell
