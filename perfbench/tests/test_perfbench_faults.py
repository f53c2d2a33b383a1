"""The check catches a broken timed path: the harness's run (its look for
a card skipped, on the CPU at the test size) with the program broken
underneath must come out not correct, once for each fault the cells can
have.  One card each, so no exchange between chips exists to leave out;
the one-run cells have no batch, so half a batch is left out of the
replicas' only."""

import dataclasses
import time

import pytest
import torch

from perfbench import harness

from .conftest import small_cell


def run(name, monkeypatch, breaks):
    import lammps_le_torch.fast as fast

    make = fast.make_fast_segment

    def broken_segment(*a, **kw):
        segment, step = make(*a, **kw)
        return (lambda fs, *args: breaks(segment, fs, *args)), step

    monkeypatch.setattr(fast, "make_fast_segment", broken_segment)
    work, cfg = small_cell(name)
    line, rows = harness.run_cell(name, 77, 0.2, False, time.perf_counter(),
                                  device="cpu", cfg=cfg, work=work)
    return line, {r[0]: r for r in rows}


def unchanged(segment, state, *args):
    """A step that returns its state unchanged."""
    return state


def shift_anchor(ex_left):
    """The extruder table with its first active left anchor past bead 1
    moved one bead down the chain."""
    flat = ex_left.reshape(-1).clone()
    k = int(torch.nonzero(flat > 1)[0])
    flat[k] -= 1
    return flat.reshape(ex_left.shape)


def altered_answer(segment, state, *args):
    """The answer altered where it is produced: one bead's velocity and
    one extruder's anchor."""
    out = segment(state, *args)
    out.gv = out.gv.clone()
    out.gv[..., 0, 0, :] += 0.1 * (out.bid[..., 0, :] < 10 ** 9)
    out.ex_left = shift_anchor(out.ex_left)
    return out


def half_the_batch(segment, state, *args):
    """Half of the replicas left out of the step."""
    keep = dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})
    out = segment(state, *args)
    half = out.bid.shape[0] // 2
    for f in dataclasses.fields(out):
        val = getattr(out, f.name)
        if isinstance(val, torch.Tensor) and val.dim() >= 1 \
                and val.shape[0] == 2 * half:
            val = val.clone()
            val[half:] = getattr(keep, f.name)[half:]
            setattr(out, f.name, val)
    return out


@pytest.mark.parametrize("name", ["le100k.loop", "chr1m.chain",
                                  "le100k.ens8", "le100k.ens32"])
@pytest.mark.parametrize("fault", [unchanged, altered_answer])
def test_fault_is_not_correct(name, fault, monkeypatch):
    line, rows = run(name, monkeypatch, fault)
    assert not line["correct"]
    failed = {k for k, r in rows.items() if not r[3]}
    assert failed, rows


@pytest.mark.parametrize("name", ["le100k.ens8", "le100k.ens32"])
def test_half_the_replicas_is_not_correct(name, monkeypatch):
    line, rows = run(name, monkeypatch, half_the_batch)
    assert not line["correct"]
    assert not rows["x_gap"][3]
