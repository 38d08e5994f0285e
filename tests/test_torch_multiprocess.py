"""Runs of the port over two processes on the CPU (the counterpart of
tests/test_multihost.py): 2 processes x 2 shards against the
single-process run of the same 4 shards.

The module's fixture starts two workers (tests/_torch_mh_worker.py),
which join a gloo process group on 127.0.0.1 and run every case of this
file, and two CLI processes; each test then reads what they wrote.  The
decomposition is the same in both runs and histories are keyed by pid, so
the two-process run must give the single-process run's per-step counts,
every shard's 14 fields bitwise and the tally bitwise, and the counts of
JAX's single-device run (as tests/test_torch_parallel.py holds the
single-process runs).  A hang fails at the workers' timeout of 120 s,
not at the tier's.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver
from neutral_tpu_torch.parallel import Spatial2DSimulation, distributed
from neutral_tpu_torch.particles import STATE_FIELDS

from test_torch_parallel import CLASSES, CPU4, cuts, make_cfg, run_jax

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT = 120
CLI = ["problems/stream.params", "--device", "cpu", "--nparticles", "300",
       "--mesh-scale", "125", "--shards", "4", "--decomposition",
       "spatial2d"]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv_of_rank) -> list:
    """Two Python processes, with arguments argv_of_rank(rank, port)."""
    port = free_port()
    # one thread each, as torchrun sets: the tier runs beside other tests
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, *argv_of_rank(r, port)], cwd=ROOT, env=env,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]


def finish(procs) -> list:
    """The processes' outputs, once each has exited 0 within TIMEOUT
    (all are killed when one does not)."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' output directory and stdouts, and the CLI's stdouts."""
    outdir = str(tmp_path_factory.mktemp("mh"))
    workers = spawn(lambda r, port: [
        os.path.join(HERE, "_torch_mh_worker.py"), str(r), "2", str(port),
        outdir])
    cli = spawn(lambda r, port: [
        "-m", "neutral_tpu_torch", *CLI, "--coordinator",
        f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(r)])
    return outdir, finish(workers), finish(cli)


def single(kind, decomposition):
    """The single-process run of the 4 shards: the simulation after two
    steps, and its per-step counts."""
    sim = CLASSES[decomposition](make_cfg(tt, kind), devices=CPU4,
                                 quiet=True)
    stats = [sim.step(t) for t in (1, 2)]
    return sim, [(m.nfacets, m.ncollisions, m.nprocessed) for m in stats]


@pytest.mark.parametrize("kind", ["scatter", "csp"])
@pytest.mark.parametrize("decomposition", list(CLASSES))
def test_two_processes_match_one(runs, decomposition, kind):
    """Counts per step, every shard's 14 fields and the tally bitwise
    equal to the single-process run; the counts equal JAX's; in the
    spatial modes lanes cross between the processes in both steps."""
    outdir = runs[0]
    sim, stats = single(kind, decomposition)
    parts = [np.load(os.path.join(outdir, f"{kind}_{decomposition}_{r}.npz"))
             for r in range(2)]
    assert parts[0]["stats"].tolist() == [list(s) for s in stats]
    assert parts[1]["stats"].tolist() == [list(s) for s in stats]
    for r, z in enumerate(parts):
        np.testing.assert_array_equal(z["tally"], sim.host_tally())
        for s in (2 * r, 2 * r + 1):
            for f in STATE_FIELDS:
                np.testing.assert_array_equal(
                    z[f"{s}_{f}"], getattr(sim.shards[s].state, f).numpy(),
                    err_msg=f"shard {s} {f}")
    split = (cuts(sim) if decomposition != "replicated"
             and sim.transport == "flight" else ((), ()))
    assert stats == run_jax(kind, *split)
    nexchanged = parts[0]["nexchanged"]
    if decomposition == "replicated":
        assert nexchanged.tolist() == [0, 0]
    else:
        assert parts[0]["exchange_phase"].all()
        assert (nexchanged > 0).all()
        assert (nexchanged <= parts[0]["nmigrated"]).all()


def test_checkpoint_of_two_processes_restores_in_one(runs, tmp_path):
    """Process 0's checkpoint of the csp-like run on 2D blocks after step 2
    holds bitwise what the single-process run's checkpoint holds, and
    restores into a single-process run whose step 3 has the counts of that
    run's own step 3 (the tally to 1e-12: a restore puts the lanes in pid
    order, so deposits add in another order)."""
    cfg = make_cfg(tt, "csp", niters=3)
    ref = Spatial2DSimulation(cfg, devices=CPU4, quiet=True)
    for t in (1, 2):
        ref.step(t)
    ref.checkpoint(str(tmp_path / "one.npz"), 2)
    two = os.path.join(runs[0], "csp_spatial2d.npz")
    with np.load(two) as a, np.load(tmp_path / "one.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    want = ref.step(3)
    sim = Spatial2DSimulation(cfg, devices=CPU4, quiet=True)
    assert sim.restore(two) == 2
    got = sim.step(3)
    assert ((got.nfacets, got.ncollisions, got.nprocessed)
            == (want.nfacets, want.ncollisions, want.nprocessed))
    np.testing.assert_allclose(sim.host_tally(), ref.host_tally(),
                               rtol=1e-12, atol=1e-300)


def test_visit_dump_of_two_processes(runs, tmp_path, monkeypatch):
    """Process 0 alone writes the VisIt files, byte-equal to the
    single-process run's; lanes crossed between processes in every
    step."""
    outdir = runs[0]
    monkeypatch.chdir(tmp_path)
    Spatial2DSimulation(make_cfg(tt, "stream", visit_dump=True),
                        devices=CPU4, quiet=True).run()
    names = sorted(os.listdir(tmp_path))
    assert "energy2.dat" in names and "density3.bov" in names
    assert sorted(os.listdir(os.path.join(outdir, "visit0"))) == names
    assert os.listdir(os.path.join(outdir, "visit1")) == []
    for name in names:
        with open(tmp_path / name, "rb") as a, \
                open(os.path.join(outdir, "visit0", name), "rb") as b:
            assert a.read() == b.read(), name
    assert (np.load(os.path.join(outdir, "visit_nexchanged_0.npy")) > 0).all()


def test_shards_must_split_evenly_over_processes(runs):
    """3 shards over 2 processes raise in both, before any state."""
    for out in runs[1]:
        assert "RAISED 3 shards cannot be split evenly over 2 processes" in out


def test_cli_over_two_processes(runs):
    """Process 0 prints the run, with `Distributed: 2 processes`, and the
    single-process CLI's tally; process 1 prints nothing of it."""
    out0, out1 = runs[2]
    assert "Distributed: 2 processes, 4 shards." in out0
    assert "Process group: gloo" in out0
    assert "Distributed" not in out1 and "Iteration" not in out1
    one = subprocess.run([sys.executable, "-m", "neutral_tpu_torch", *CLI],
                         cwd=ROOT, capture_output=True, text=True, check=True,
                         timeout=TIMEOUT).stdout
    tally = [line for line in out0.splitlines()
             if line.startswith("Final global_energy_tally")]
    assert tally and tally[0] in one
    counts = [line for line in one.splitlines()
              if line.startswith(("Facets", "Collisions", "Handled"))]
    assert counts == [line for line in out0.splitlines()
                      if line.startswith(("Facets", "Collisions", "Handled"))]
    assert "of them between processes" in out0


@pytest.mark.parametrize("argv,err", [
    (["--backend", "native", "--coordinator", "127.0.0.1:1",
      "--num-processes", "2", "--process-id", "0"],
     "--backend native does not support: --coordinator, --num-processes, "
     "--process-id"),
    (["--backend", "native", "--distributed"],
     "--backend native does not support: --distributed"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2"],
     "--coordinator requires --num-processes and --process-id"),
])
def test_cli_rejects_bad_process_flags(argv, err, capsys):
    with pytest.raises(SystemExit) as e:
        driver.main(["problems/scatter.params", "--device", "cpu", *argv])
    assert e.value.code == 2
    assert err in capsys.readouterr().err


@pytest.mark.parametrize("env", [{}, {"WORLD_SIZE": "1", "RANK": "0"}])
def test_initialise_without_environment_is_a_no_op(env, monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    distributed.initialise_distributed()
    assert not dist.is_initialized()
    assert (distributed.world(), distributed.rank()) == (1, 0)
    assert distributed.local_shards(4) == range(4)


def test_failed_rendezvous_exits_non_zero():
    """Process 1 of 2 with no process 0 to meet: the rendezvous raises at
    its timeout, and nothing carries on as a single process."""
    code = ("import datetime\n"
            "from neutral_tpu_torch.parallel import distributed\n"
            f"distributed.initialise_distributed('127.0.0.1:{free_port()}', "
            "2, 1, timeout=datetime.timedelta(seconds=3))\n"
            "print('CARRIED ON')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode != 0
    assert "CARRIED ON" not in r.stdout
