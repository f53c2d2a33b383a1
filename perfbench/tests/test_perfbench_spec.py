"""BENCHMARK.json against the contract's characters and keys, and the
discovery of configurations, cells, metrics and phases by name."""

import json
import re
import sys

from perfbench import harness, spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_command():
    b = spec.benchmark()
    assert set(b) == KEYS
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len(b["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in b["command"])
    raw = (spec.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024


def test_names_units_and_lines():
    b = spec.benchmark()
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end":
                    text = e[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text, (e["name"], key)
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_every_entry_has_its_file():
    b = spec.benchmark()
    for c in b["configs"]:
        cfg = spec.config(c["name"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert cfg["name"] == c["name"]
    for w in b["workloads"]:
        work = spec.workload(w["name"])
        assert work["config"] == w["config"]
        assert work["traffic"] == w["traffic"]
        assert work["why"] == w["why"]
        assert set(work["limits"]) >= {"x_gap", "v_gap", "f_gap",
                                       "le_gap"}
    for m in b["per_layer"]:
        assert callable(spec.metric(m["name"]).read)
        assert spec.metric(m["name"]).read({}) is None


def test_every_cell_reports_setup_and_a_layer_metric():
    b = spec.benchmark()
    for w in b["workloads"]:
        ends = {m["name"] for m in spec.cell_metrics(b, w["name"], False)}
        assert "setup_s" in ends and len(ends) >= 2
        assert spec.cell_metrics(b, w["name"], True)


def test_phases_are_the_union_of_their_files():
    ph = spec.phases()
    assert "stencil_kernel" in ph["pair"]
    assert "newton_half_kernel" in ph["pair"]
    assert "kick_drift_halo_kernel" in ph["stream"]
    assert not ph["pair"] & ph["stream"]


def test_run_seconds_fit_a_check_of_24_cells():
    b = spec.benchmark()
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (b["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    for name in ("lammps_le_torch", "lammps_le_torch.fast", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lammps_le_tpu.fast.engine", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib", "lammps_le_tpu"]


def test_reference_imports_nothing_of_the_program():
    import ast

    for path in (spec.HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "lammps_le_torch", "lammps_le_tpu", "jax", "jaxlib",
                    "flax"), (path.name, n)


def test_the_harness_imports_nothing_of_jax():
    import ast

    for path in spec.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                top = node.module.split(".")[0]
            elif isinstance(node, ast.Import):
                top = node.names[0].name.split(".")[0]
            else:
                continue
            assert top not in ("jax", "jaxlib", "flax", "lammps_le_tpu"), \
                path


def test_workload_files_name_their_cell():
    for path in (spec.HERE / "workloads").glob("*.json"):
        work = json.loads(path.read_text())
        assert path.stem == work["name"]


def test_host_paced_rate_reads_the_window():
    read = spec.metric("host_paced_bead_steps_per_s").read
    assert read({"window": {"bead_steps": 8_000_000, "wall_s": 2.0}}) \
        == 4_000_000.0
    assert read({"window": {"bead_steps": 0, "wall_s": 2.0}}) is None
