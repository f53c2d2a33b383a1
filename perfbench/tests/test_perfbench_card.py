"""One short run of each cell on the card through the command, as the
check runs it (skips without a card)."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "perfbench", "--workload", name, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_deck_stays_healthy_past_the_window(name):
    """The cell's set-up and then the steps its configuration records
    under ``assumed.endurance`` (several times what a window reaches):
    healthy, every cell under the cap, the table under its size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench import calibrate

    work = spec.workload(name)
    cfg = spec.config(work["config"])
    steps = cfg["assumed"]["endurance"][name]["steps"]
    out = calibrate.endurance(work, cfg, 2147483677, steps, "cuda")
    h, lim = out["health"], cfg["health"]
    assert h["error_flags"] == 0, out
    assert h["clamps_per_move"] <= lim["clamps_per_move"], out
    assert lim["t_low"] < h["t_min"] and h["t_max"] < lim["t_high"], out
    assert out["fullest_cell"] < cfg["neighbor"]["cell_cap"], out
    assert out["most_extruders"] < cfg["extruders"]["table"], out
