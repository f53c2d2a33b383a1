"""The port's public contract held to the reference's: code written
against ``lammps_le_tpu`` runs on ``lammps_le_torch`` and means the same.

(a) Names: every public top-level ``def`` / ``class`` of each reference
module (walked over the package's files), and every name a reference
``__init__`` exports, imports from the port's counterpart module.
(b) Signatures: for every public function of both, the port's parameters
begin with the reference's in the reference's order, a positional one
positional and a defaulted one defaulted; each parameter the port adds
comes after them and has a default.
(c) ``fast_block_reason``: the reference's text, order of checks and
verdicts on one melt32 Simulation per reason; ``make_fast_segment``
refuses each refused one.
(d) Reference-style calls: ``extruder_partner(state, n)``,
``to_fast(state, sim, groups)`` and the 9-argument positional ``run``.

The only exemptions are ROADMAP.md's "Not ported, by design" names and
arguments (BY_DESIGN_NAMES, BY_DESIGN_ARGS)."""

import ast
import dataclasses
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lammps_le_torch.fixes as tf
import lammps_le_tpu.fixes as jf
import lammps_le_tpu.state as jstate
from lammps_le_torch.fast import fast_block_reason, make_fast_segment, to_fast
from lammps_le_torch.integrate import Simulation
from lammps_le_torch.state import extruder_partner, state_from_arrays
from lammps_le_tpu.fast import engine as ref_engine
from lammps_le_tpu.integrate import Simulation as RefSimulation
from lammps_le_tpu.system import (ANGLE_HARMONIC, BOND_NONE, AngleParams,
                                  BondParams)
from torch_parity import (UnoptimisedJax, general_start, general_system,
                          jax_state, le_fixes, make_system, melt_arrays)

REPO = Path(__file__).resolve().parents[1]
REF_ROOT = REPO / "lammps_le_tpu"

# ROADMAP.md, "Not ported, by design"
BY_DESIGN_MODULES = {"compile_cache"}
BY_DESIGN_NAMES = {"pick_cl", "make_offset_loop", "make_halo_consts",
                   "make_extruder_pass", "ex_window", "near_springs_enabled"}
BY_DESIGN_ARGS = {"interpret", "tile", "cl", "sp_axis", "dp_axis",
                  "use_context_mesh"}
RENAMED_ARGS = {"sp_axis": "sp", "dp_axis": "dp"}  # fast_state_specs


def _module_names():
    out = []
    for path in sorted(REF_ROOT.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts[-1] not in BY_DESIGN_MODULES:
            out.append(".".join(parts))
    return out


MODULES = _module_names()


def _tree(module_name):
    return ast.parse(Path(importlib.util.find_spec(module_name).origin)
                     .read_text())


def _defined(tree, kinds=(ast.FunctionDef, ast.ClassDef)):
    return [n.name for n in tree.body
            if isinstance(n, kinds) and not n.name.startswith("_")]


def _imported(tree):
    return [a.asname or a.name for n in tree.body
            if isinstance(n, ast.ImportFrom) for a in n.names]


def _port_name(module_name):
    return "lammps_le_torch" + module_name[len("lammps_le_tpu"):]


def test_the_walk_covers_the_package():
    assert len(MODULES) == len(list(REF_ROOT.rglob("*.py"))) - 1
    assert "lammps_le_tpu.fast.engine" in MODULES


@pytest.mark.parametrize("module_name", MODULES)
def test_names(module_name):
    tree = _tree(module_name)
    port = importlib.import_module(_port_name(module_name))
    missing = [n for n in _defined(tree)
               if n not in BY_DESIGN_NAMES and not hasattr(port, n)]
    origin = Path(importlib.util.find_spec(module_name).origin)
    if origin.name == "__init__.py":
        port_imports = set(_imported(_tree(port.__name__)))
        for n in _imported(tree):
            # a submodule that the reference's __init__ imports, the
            # port's imports too; any other name resolves
            sub = (origin.parent / f"{n}.py").exists() \
                or (origin.parent / n / "__init__.py").exists()
            if not (n in port_imports if sub else hasattr(port, n)):
                missing.append(n)
    assert not missing, f"{port.__name__} lacks {missing}"


def _positional(p):
    return p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)


def signature_drift(ref_fn, port_fn):
    """What keeps a reference call of ``ref_fn`` from meaning the same on
    ``port_fn`` (empty when nothing does)."""
    port = list(inspect.signature(port_fn).parameters.values())
    names = {p.name for p in port}
    want = []
    for p in inspect.signature(ref_fn).parameters.values():
        if p.name in BY_DESIGN_ARGS:
            if RENAMED_ARGS.get(p.name) in names:
                want.append(p.replace(name=RENAMED_ARGS[p.name]))
            continue
        want.append(p)
    drift = []
    head = [p.name for p in port[:len(want)]]
    if head != [p.name for p in want]:
        return [f"parameters {head} where the reference has "
                f"{[p.name for p in want]}"]
    for w, p in zip(want, port):
        if _positional(w) and not _positional(p):
            drift.append(f"{p.name} is keyword-only")
        if w.default is not w.empty and p.default is p.empty:
            drift.append(f"{p.name} has no default")
    for p in port[len(want):]:
        if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD) \
                and p.default is p.empty:
            drift.append(f"added {p.name} has no default")
    return drift


@pytest.mark.parametrize("module_name", MODULES)
def test_signatures(module_name):
    ref = importlib.import_module(module_name)
    port = importlib.import_module(_port_name(module_name))
    drift = {}
    for n in _defined(_tree(module_name), (ast.FunctionDef,)):
        if n in BY_DESIGN_NAMES or not hasattr(port, n):
            continue
        d = signature_drift(getattr(ref, n), getattr(port, n))
        if d:
            drift[n] = d
    assert not drift, f"{port.__name__}: {drift}"


def test_signature_drift_is_seen():
    """The parent's drifts, each found."""
    def run(sim, state, nsteps, groups=None, thermo_every=0,
            thermo_callback=None, boundary_every=0, boundary_callback=None):
        pass

    def to_fast(state, sim, kernel_fn=None, groups=None):
        pass

    def builder(system, fix, device):
        pass

    from lammps_le_tpu.fixes.ex_load import make_ex_load_update
    from lammps_le_tpu.integrate.verlet import run as ref_run

    assert signature_drift(ref_run, run)
    assert signature_drift(ref_engine.to_fast, to_fast)
    assert signature_drift(make_ex_load_update, builder)


# ---------------------------------------------------------------------------
# (c) fast_block_reason


def _system():
    return make_system()[0]


def _replace(**kw):
    return lambda s: dataclasses.replace(s, **kw)


def _pair(s):
    eps = np.ones((4, 4))
    eps[1, 1] = eps[1, 1] * 1.5
    return dataclasses.replace(s, pair=dataclasses.replace(s.pair,
                                                           epsilon=eps))


def _backbone(s):
    bts = np.asarray(s.backbone_type).copy()
    bts[bts >= 0] = 1  # the harmonic type
    return dataclasses.replace(s, backbone_type=bts)


def _ex_style(s):
    return dataclasses.replace(s, bonds=BondParams(
        style=np.array([s.bonds.style[0], BOND_NONE]), coeffs=s.bonds.coeffs))


def _grouped(k):
    def fixes(mod):
        fx = list(le_fixes(mod))
        fx[k] = dataclasses.replace(fx[k], group="chain")
        return tuple(fx)
    return fixes


def _base(mod):
    return (mod.NVE(), mod.Langevin(1.0, 1.0, 1.0))


def _with(*extra):
    return lambda mod: _base(mod) + tuple(e(mod) for e in extra)


def _sub_langevin(mod):
    return type("SubLangevin", (mod.Langevin,), {})(1.0, 1.0, 1.0)


# (case id, the system's change, the fixes) -- one per reference reason,
# then the three LE fixes with a group, two orders of checks, a Langevin
# subclass and the supported case
REASONS = [
    ("neighbor_mode", lambda s: s.with_neighbor(mode="verlet"), _base),
    ("per_type_pair", _pair, _base),
    ("masses", _replace(masses=np.array([1.0, 2.0, 1.0, 1.0])), _base),
    ("special_bonds", _replace(special_lj=(0.0, 0.5, 1.0)), _base),
    ("no_bonds", _replace(bonds=None), _base),
    ("angles", _replace(angles=AngleParams(
        style=np.array([ANGLE_HARMONIC]), coeffs=np.array([[3.0, 2.0]]))),
     _base),
    ("backbone", _backbone, _base),
    ("nve_group", None, lambda mod: (mod.NVE(group="chain"),)),
    ("langevin_tally", None,
     lambda mod: (mod.NVE(), mod.Langevin(1.0, 1.0, 1.0, tally=True))),
    ("langevin_gjf", None,
     lambda mod: (mod.NVE(), mod.Langevin(1.0, 1.0, 1.0, gjf="vfull"))),
    ("foreign_fix", None, _with(lambda mod: mod.Viscous(gamma=0.2))),
    ("extruder_bond_style", _ex_style, le_fixes),
    ("zero_nve", None, lambda mod: (mod.Langevin(1.0, 1.0, 1.0),)),
    ("two_langevin", None,
     _with(lambda mod: mod.Langevin(1.0, 1.0, 2.0, seed=3))),
    ("extrusion_group", None, _grouped(2)),
    ("ex_load_group", None, _grouped(3)),
    ("ex_unload_group", None, _grouped(4)),
    ("fix_before_ex_style", _ex_style,
     lambda mod: le_fixes(mod) + (mod.Viscous(gamma=0.2),)),
    ("ex_style_before_nve_count", _ex_style,
     lambda mod: le_fixes(mod)[1:]),
    ("langevin_subclass", None,
     lambda mod: (mod.NVE(), _sub_langevin(mod))),
    ("supported", None, le_fixes),
]


@pytest.mark.parametrize("change,fixes", [r[1:] for r in REASONS],
                         ids=[r[0] for r in REASONS])
def test_fast_block_reason(change, fixes):
    system = _system() if change is None else change(_system())
    rsim, sim = (S(system=system, dt=0.005, fixes=fixes(mod), ex_btype=2)
                 for S, mod in ((RefSimulation, jf), (Simulation, tf)))
    want = ref_engine.fast_block_reason(rsim)
    assert fast_block_reason(sim) == want
    if want is None:
        make_fast_segment(sim, device="cpu")
    else:
        with pytest.raises(NotImplementedError):
            make_fast_segment(sim, device="cpu")


def test_fast_block_reason_cases_cover_the_reference():
    """Every reason the reference can give: one a ``return`` of its
    source, the Langevin options' two."""
    got = set()
    for _, change, fixes in REASONS:
        system = _system() if change is None else change(_system())
        got.add(ref_engine.fast_block_reason(RefSimulation(
            system=system, dt=0.005, fixes=fixes(jf), ex_btype=2)))
    src = inspect.getsource(ref_engine.fast_block_reason)
    assert len(got) == src.count("return ") + 1 == 15


# ---------------------------------------------------------------------------
# (d) reference-style calls


def test_extruder_partner_reference_call():
    system, d = melt_arrays()
    want = np.asarray(jstate.extruder_partner(jax_state(d, jnp.float32),
                                              system.n))
    got = extruder_partner(state_from_arrays(d, "cpu"), system.n)
    assert (want >= 0).sum() == 12
    np.testing.assert_array_equal(want, got.numpy())


def test_to_fast_groups_positional():
    system, d = melt_arrays()
    sim = Simulation(system=system, dt=0.005, ex_btype=2, fixes=(
        tf.NVE(), tf.Langevin(1.0, 1.0, 1.0, group="chain")))
    groups = {"chain": np.arange(system.n) % 3 != 0}
    a = to_fast(state_from_arrays(d, "cpu"), sim, groups)
    b = to_fast(state_from_arrays(d, "cpu"), sim, groups=groups)
    assert a.lgm is not None
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name


RUN_STEPS = 12


def test_run_positional(monkeypatch):
    """``run(sim, state, nsteps, groups, thermo_every, thermo_callback,
    max_segment, boundary_every, boundary_callback)`` positionally on
    both: the same rows (f64, 1e-10), callback steps and final State."""
    from lammps_le_torch.integrate import run
    from lammps_le_tpu.integrate import verlet as ref_verlet

    # the reference's segment and setup compiled with LLVM's
    # optimisations off (the same results, less compile time)
    monkeypatch.setattr(ref_verlet, "jax", UnoptimisedJax())
    system = general_system("float64")
    d = general_start("float64")
    out = []
    for S, mod, fn, state in (
            (RefSimulation, jf, ref_verlet.run,
             jax_state(d, jnp.float64)),
            (Simulation, tf, run, state_from_arrays(d, "cpu"))):
        sim = S(system=system, dt=0.005, ex_btype=2, fixes=le_fixes(mod))
        rows, bounds = [], []
        st, ret = fn(sim, state, RUN_STEPS, None, 5,
                     lambda row, s: rows.append(row), 3, 4,
                     lambda s: bounds.append(int(s.step)))
        out.append((st, [tuple(float(v) for v in r) for r in ret], rows,
                    bounds))
    (rs, rrows, rcb, rb), (ts, trows, tcb, tb) = out
    b = int(d["step"])
    assert b % 20 == 0
    assert rb == tb == [b, b + 4, b + 8, b + 12]
    assert len(rrows) == len(trows) == len(rcb) == len(tcb) == 4
    assert [r[0] for r in trows] == [b, b + 5, b + 10, b + 12]
    np.testing.assert_allclose(np.array(trows), np.array(rrows), rtol=0,
                               atol=1e-10)
    for k in ("ex_left", "ex_right", "type", "img", "n_moves", "n_loads",
              "n_unloads", "step", "flags"):
        np.testing.assert_array_equal(np.asarray(getattr(rs, k)),
                                      getattr(ts, k).numpy(), err_msg=k)
    assert int(ts.n_moves) > 0
    for k in ("x", "v", "f"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(rs, k)), rtol=0,
                                   atol=1e-10, err_msg=k)
