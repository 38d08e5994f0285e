"""A cell end to end at a tiny size on the CPU through the harness's
functions, the command's refusals without a card or with JAX loaded, and
a throwaway configuration, cell and metric found by name in a copy of the
benchmark with no file edited."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from portbench import check, harness

TINY = dict(nx=40, ny=40, nparticles=300)


@pytest.mark.parametrize("cell,trace", [("scatter.f32", False),
                                        ("scatter.f32", True),
                                        ("csp.f32", False)])
def test_a_cell_runs_end_to_end(cell, trace, capsys):
    over = {**TINY, "iterations": 3} if cell.startswith("csp") else TINY
    res = harness.run_cell(harness.find_cell(cell), 2**31 + 99, 0.5, trace,
                           device="cpu", config_override=over)
    assert res["correct"] is True
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {"events_per_s", "solve_s_p90", "setup_s"}
    if trace:
        want = {"solve_setup_ms", "begin_ms", "sweep_ms"}
        assert "breakdown" in res and "busy_s" in res["device"]
    assert want <= set(res["metrics"])
    assert list(res)[-1] == "check"
    assert set(res["check"]) == set(check.compared(
        check.load_limits(cell)))
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == res


@pytest.mark.parametrize("where", ["reader", "reference"])
@pytest.mark.parametrize("name", ["jax", "neutral_tpu"])
def test_no_result_once_jax_is_loaded_after_the_window(where, name,
                                                       monkeypatch, capsys):
    """A metric reader or the reference that loads JAX or the JAX package
    after the window has closed leaves the run with no result."""
    def plant():
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))

    if where == "reader":
        def load_reader(metric):
            def read(ctx):
                plant()
                return 1.0
            return read
        monkeypatch.setattr(harness, "load_reader", load_reader)
    else:
        judge = harness.judge

        def planted(*args, **kw):
            plant()
            return judge(*args, **kw)
        monkeypatch.setattr(harness, "judge", planted)
    with pytest.raises(SystemExit) as e:
        harness.run_cell(harness.find_cell("scatter.f32"), 2**31 + 5, 0.2,
                         False, device="cpu", config_override=TINY)
    assert e.value.code not in (0, None)
    io = capsys.readouterr()
    assert '"correct"' not in io.out
    assert name in io.err


def run_cli(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True, env=env,
                          timeout=300)


def test_the_command_fails_without_a_card():
    p = run_cli(harness.ROOT, "--workload", "scatter.f32", "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_the_command_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run_cli(tmp_path, "--workload", "scatter.f32", "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "portbench"
    cfg = json.load(open(pb / "configs" / "scatter.json"))
    cfg["nparticles"] = 1234
    json.dump(cfg, open(pb / "configs" / "throwaway.json", "w"))
    json.dump({**json.load(open(pb / "traffic" / "f64.json")),
               "transport": "sweep"}, open(pb / "traffic" / "odd.json", "w"))
    (pb / "metrics" / "solves_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.solves))\n")
    bench["configs"].append({"name": "throwaway", "source": "x",
                             "file": "portbench/configs/throwaway.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "throwaway.odd", "config": "throwaway",
                               "traffic": "odd", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "solves_seen", "unit": "solves",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "events_per_s",
                               "workloads": ["throwaway.odd"]})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    code = (
        "import sys; sys.path.insert(0, '.');"
        "from portbench import harness as h;"
        "c = h.find_cell('throwaway.odd');"
        "print(c['config']['nparticles'], c['traffic']['dtype'],"
        " c['traffic']['transport'], [m['name'] for m in c['per_layer']][-1],"
        " h.load_reader('solves_seen')(type('C', (), {'solves': [1, 2]})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split() == ["1234", "float64", "sweep", "solves_seen",
                                "2.0"]
