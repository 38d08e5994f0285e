"""BENCHMARK.json and the files it names: the contract's character rules,
what each per-layer metric moves, and that nothing under portbench/
imports JAX or the JAX package, nor the reference the program."""

import ast
import json
import os
import re

import pytest

from portbench import check, harness

ROOT = harness.ROOT
BENCH = harness.load_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "neutral_tpu"}


def sources():
    for d, _, files in os.walk(harness.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for f in os.listdir(os.path.join(harness.HERE, "reference")):
        if f.endswith(".py"):
            got = imported(os.path.join(harness.HERE, "reference", f))
            assert got <= {"__future__", "json", "math", "dataclasses",
                           "numpy", "torch"}, (f, got)


def test_names_units_and_keys_keep_the_character_rules():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[key]]
        assert len(got) == len(set(got)), key
    assert len(json.dumps(BENCH)) < 64 * 1024
    for w in BENCH["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]


def test_every_cell_and_metric_has_its_files():
    for c in BENCH["configs"]:
        cfg = harness.load_json(ROOT, c["file"])
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in BENCH["workloads"]:
        cell = harness.find_cell(w["name"], BENCH)
        limits = check.load_limits(w["name"])
        assert limits["sample"] == "all" or limits["sample"] >= 1024
        assert set(limits) - {"sample"} == set(check.compared(limits))
        assert {"lanes_off_pct", "counts_z"} <= set(limits)
        assert len({"tally_z", "tally_gap"} & set(limits)) == 1
        assert w["chips"] == 1
        names = [m["name"] for m in cell["end_to_end"]]
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_each_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]


def test_every_configuration_has_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
