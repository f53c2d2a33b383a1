"""The reference against the program on a 512-bead chain (the
configurations cut to test size, LE events every few steps), on the CPU:
each cell's run through the harness, and the reference's parts against
the program's own on the same state."""

import time

import numpy as np
import pytest
import torch

from perfbench import build, check, harness, spec
from perfbench.drivers import DRIVERS
from perfbench.reference import events, forces, threefry
from perfbench.reference import step as ref_step
from perfbench.scene import make_scene, serpentine

from .conftest import small_cell

CELLS = ["le100k.loop", "chr1m.chain", "le100k.ens8", "le100k.ens32"]


def replays(name, seed=11, seconds=0.2):
    """A cell's set-up, window and replays at the test size: (pairs,
    reference params, workload)."""
    work, cfg = small_cell(name)
    scene = make_scene(cfg, seed)
    system = build.program_system(cfg, scene)
    state = build.settle(cfg, scene, system, "cpu")
    driver = DRIVERS[work["driver"]](cfg, work, system, state, "cpu")
    driver.warm(work["warm_steps"])
    harness.window(driver, work, seconds, "cpu")
    plan = check.Plan(cfg, work["check_steps"])
    check.complete(plan, driver, work)
    assert not plan.missing
    pairs = check.program_side(driver, plan)
    return pairs, build.reference_params(cfg, scene, "cpu"), work


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name):
    work, cfg = small_cell(name)
    line, rows = harness.run_cell(name, 2 ** 31 + 12345, 0.2, False,
                                  time.perf_counter(), device="cpu",
                                  cfg=cfg, work=work)
    assert line["correct"], rows
    assert set(line["metrics"]) == {
        m["name"] for m in spec.cell_metrics(spec.benchmark(), name, False)}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_replays_cover_every_layer(name):
    """The replayed steps hold extrusion moves, loads and unloads, a
    rebuild's wrap (image counters) and the thermostat, and the reference
    follows each to float32's rounding."""
    pairs, params, work = replays(name)
    moved = sum(e["n_moves"] - s["n_moves"] for s, e in pairs)
    loaded = sum(e["n_loads"] - s["n_loads"] for s, e in pairs)
    unloaded = sum(e["n_unloads"] - s["n_unloads"] for s, e in pairs)
    assert moved > 0 and loaded > 0 and unloaded > 0
    assert any(bool((s["img"] != 0).any()) for s, _ in pairs)
    got = check.reference_side(pairs, params, work["check_steps"], "cpu")
    assert got["le_gap"] < 1e-4
    assert got["x_gap"] < 1e-4 and got["v_gap"] < 1e-3
    assert got["f_gap"] < 1e-3


def test_threefry_streams_are_the_programs():
    from lammps_le_torch import rng

    key = (0x1234ABCD, 0x0BADF00D)
    assert threefry.fold_in(key, 77) == rng.fold_in(key, 77)
    assert threefry.split(key) == [tuple(k) for k in rng.split(key)]
    u = threefry.uniform(key, 1000, "cpu")
    assert torch.equal(u, rng.uniform(key, 1000, "cpu").double())
    beads = torch.arange(300)
    mine = threefry.counter_uniform3(key, beads, 12345)
    theirs = rng.uniform3(key, beads, 12345, torch.float64)
    assert torch.equal(mine, theirs.T)


def test_serpentine_is_the_engines():
    from lammps_le_torch.scene import serpentine as engine_serpentine

    d = engine_serpentine(3000, spacing=0.97, row_gap=1.1, seed=5,
                          barrier_fraction=0.003)
    x, types, lo, hi = serpentine(3000, 0.97, 1.1, 0.02, 0.003, (2, 3, 4),
                                  np.random.default_rng(5))
    assert np.array_equal(x, d.x) and np.array_equal(types, d.types)
    assert hi == d.box_hi


def test_forces_against_the_programs_plain_stencil():
    """Pair, FENE and spring forces of one placed state against the
    program's plain full stencil + springs, in float64."""
    from lammps_le_torch.fast import to_fast
    from lammps_le_torch.fast.engine import extract_beads
    from lammps_le_torch.fast.maps import fast_maps

    work, cfg = small_cell("le100k.loop")
    cfg["dtype"] = "float64"
    scene = make_scene(cfg, 3)
    system = build.program_system(cfg, scene)
    state = build.seed_extruders(
        build.program_state(cfg, scene, system, "cpu"), scene)
    fs = to_fast(state, build.program_sim(cfg, system))
    x, _, f = extract_beads(fs, fast_maps(system))
    p = build.reference_params(cfg, scene, "cpu")
    mine, _ = forces.forces(x + fs.img.double() * p["box"], p["chain"][1],
                            state.ex_left, state.ex_right, p["forces"],
                            p["lo"], p["box"])
    assert float((mine - f).abs().max()) < 1e-9 * float(f.abs().max())


def test_event_keys_follow_the_programs_schedule():
    from lammps_le_torch import rng

    key = (5, 6)
    want = rng.fold_in(rng.fold_in(rng.fold_in(key, 701), (2 << 20) + 1),
                       684474)
    assert events.event_key(key, 701, "ex_load", 1, 684474) == want


def test_step_keeps_the_state_dtype():
    work, cfg = small_cell("le100k.loop")
    scene = make_scene(cfg, 1)
    p = build.reference_params(cfg, scene, "cpu")
    n = scene.n
    st = {"x": torch.tensor(scene.x), "v": torch.tensor(scene.v),
          "f": torch.zeros(n, 3, dtype=torch.float64),
          "types": torch.tensor(scene.types),
          "ex_left": torch.full((8,), -1), "ex_right": torch.full((8,), -1),
          "key_words": (1, 2), "step": 0, "flags": 0, "n_moves": 0,
          "n_loads": 0, "n_unloads": 0, "clamps": 0}
    ref_step.follow(st, 3, p)
    assert st["x"].dtype == torch.float64 and st["step"] == 3
