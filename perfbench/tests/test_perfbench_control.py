"""The control: the reference computed in bfloat16, the precision below
the configurations' float32, put in the program's place, must come out
not correct under each cell's limits (at the test size on the CPU; the
limits' readings at the cells' own size are in PERF.md)."""

import pytest

from perfbench import check

from .test_perfbench_reference import replays


@pytest.mark.parametrize("name", ["le100k.loop", "chr1m.chain",
                                  "le100k.ens8", "le100k.ens32"])
def test_control_fails_the_limits(name):
    pairs, params, work = replays(name, seed=21)
    got = check.control_side(pairs, params, work["check_steps"], "cpu")
    failed = [k for k, v in got.items() if v > work["limits"][k]]
    assert failed, got
    sound = check.reference_side(pairs, params, work["check_steps"], "cpu")
    assert all(sound[k] <= work["limits"][k] for k in sound), sound
