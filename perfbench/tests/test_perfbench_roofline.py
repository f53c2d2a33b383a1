"""The frozen roofline arithmetic counts the problem's work: the same
count for the same positions whatever cap the engine's grid has; and the
trace reduction on a synthetic trace."""

import pytest
import torch

from perfbench import build, roofline, trace
from perfbench.scene import make_scene

from .conftest import small_cell


def test_same_work_at_two_caps():
    from lammps_le_torch.fast import from_fast, to_fast

    work, cfg = small_cell("le100k.loop")
    scene = make_scene(cfg, 4)
    counts = []
    for cap in (12, 20):
        system = build.program_system(cfg, scene, cell_cap=cap)
        state = build.program_state(cfg, scene, system, "cpu")
        fs = to_fast(state, build.program_sim(cfg, system))
        assert fs.bid.shape[0] == cap
        x = from_fast(fs, system).x
        p = build.reference_params(cfg, scene, "cpu")
        counts.append(roofline.work(x, p["lo"], p["box"],
                                    cfg["pair"]["cutoff"], scene.n - 1, 6))
    assert counts[0] == counts[1]
    assert counts[0]["pairs"] > 0


def test_pair_count_by_brute_force():
    work, cfg = small_cell("le100k.loop")
    scene = make_scene(cfg, 9)
    p = build.reference_params(cfg, scene, "cpu")
    x = torch.tensor(scene.x)
    d = x[:, None] - x[None]
    d = d - p["box"] * torch.round(d / p["box"])
    rsq = (d * d).sum(-1)
    n = x.shape[0]
    brute = int(((rsq < 1.12 ** 2) & ~torch.eye(n, dtype=bool)).sum()) // 2
    assert roofline.work(x, p["lo"], p["box"], 1.12, n - 1, 0)["pairs"] \
        == brute


def test_reduce_a_synthetic_trace():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW,
         "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "ts": 10.0, "dur": 20.0,
         "name": "void (anonymous namespace)::stencil_kernel<1>(float*)"},
        {"ph": "X", "cat": "kernel", "ts": 20.0, "dur": 20.0,
         "name": "void langevin_kernel(float*)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 70.0, "dur": 10.0,
         "name": "Memcpy DtoD (Device -> Device)"},
        {"ph": "X", "cat": "cpu_op", "ts": 35.0, "dur": 40.0,
         "name": "aten::sort"},
    ]
    r = trace.reduce(ev, 2, {"pair": {"stencil_kernel"},
                             "stream": {"langevin_kernel"}})
    assert r["busy_s"] == pytest.approx(40e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["n_kernels"] == 2
    assert r["phase_s"]["pair"] == pytest.approx(20e-6)
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::sort"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)


def test_cap_search_counts_by_the_numpy_rule():
    """The cap search's count on the device (``calibrate.Fullest``) is the
    numpy binning's (``calibrate.cell_counts``) fullest cell."""
    from perfbench import calibrate

    work, cfg = small_cell("le100k.loop")
    scene = make_scene(cfg, 6)
    system = build.program_system(cfg, scene)
    full = calibrate.Fullest(system)
    x = torch.tensor(scene.x) + torch.tensor([[3.0, -40.0, 0.5]])
    full.count(x)
    counts = calibrate.cell_counts(x.numpy(), full.lo, full.box, full.dims)
    assert int(full.most) == int(counts.max())
    assert counts.sum() == scene.n
