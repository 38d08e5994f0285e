"""Runs over several cards and processes: the process group's backend, the
placement of shards on cards, the step clock over every card, the
decomposed runs against the JAX package's own, and the collectives that
run on the cards under NCCL (here their gloo path, which stages on the
host).

The CPU has no card, so the placement and clock tests monkeypatch
PyTorch's card queries (`torch.cuda.device_count`, `is_available`,
`synchronize`) and the process group's size; the `cuda` cases need two
or more cards and skip here and on a machine with one:

    python -m pytest tests/test_torch_cards.py -q -m cuda --noconftest
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver
from neutral_tpu_torch.parallel import (ShardedSimulation,
                                        Spatial2DSimulation,
                                        SpatialSimulation, distributed,
                                        shard_devices)
from neutral_tpu_torch.profiler import Profile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TIMEOUT = 120
CPU4 = ["cpu"] * 4
CUDA = [torch.device("cuda", i) for i in range(8)]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- (a) the backend, and where each process's shards go ----------------------
# (visible cards per process by UUID, the run's card index) -> each
# process's cards, and the backend on CUDA.
ALL4 = ["A", "B", "C", "D"]
LAYOUTS = {
    "1 process, 4 cards": ([ALL4], None, [[0, 1, 2, 3]], "nccl"),
    "2 processes on 1 card": ([["A"], ["A"]], None, [[0], [0]], "gloo"),
    "4 processes on 1 card": ([["A"]] * 4, None, [[0]] * 4, "gloo"),
    "4x1: 4 processes on 4 cards": ([ALL4] * 4, None,
                                    [[0], [1], [2], [3]], "nccl"),
    "2x2: 2 processes on 4 cards": ([ALL4] * 2, None, [[0, 1], [2, 3]],
                                    "nccl"),
    "8 processes on 4 cards": ([ALL4] * 8, None,
                               [[0], [1], [2], [3]] * 2, "gloo"),
    "2x2 by CUDA_VISIBLE_DEVICES": ([["A", "B"], ["C", "D"]], None,
                                    [[0, 1], [0, 1]], "nccl"),
    "4x1 by CUDA_VISIBLE_DEVICES": ([["A"], ["B"], ["C"], ["D"]], None,
                                    [[0]] * 4, "nccl"),
    "2 processes named cuda:0 of 4": ([ALL4] * 2, 0, [[0], [0]], "gloo"),
    "2 processes named cuda:1 of their own": ([["A", "B"], ["C", "D"]], 1,
                                              [[1], [1]], "nccl"),
    "3 processes on 4 cards": ([ALL4] * 3, None, [[0], [1], [2, 3]],
                               "nccl"),
}


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_backend_rule(layout, device_type):
    """nccl only where the run is on CUDA and each process has cards of its
    own; gloo on the CPU and wherever processes share a card."""
    visible, index, want_cards, want = LAYOUTS[layout]
    cards = [distributed.place_cards(p, visible, index)
             for p in range(len(visible))]
    assert cards == want_cards
    ids = [[visible[p][i] for i in c] for p, c in enumerate(cards)]
    assert distributed.pick_backend(device_type, ids) == (
        want if device_type == "cuda" else "gloo")


def test_a_card_that_is_not_there_raises():
    """A run that names a card past what a process sees raises, as does a
    process that sees none."""
    with pytest.raises(ValueError, match="cuda:4"):
        distributed.place_cards(0, [ALL4], 4)
    with pytest.raises(ValueError, match="sees no card"):
        distributed.place_cards(1, [ALL4, []])


# -- (b) the step clock waits for every card --------------------------------------
@pytest.fixture
def synced(monkeypatch):
    """The devices torch.cuda.synchronize was called with, in order."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    return calls


@pytest.mark.parametrize("devices", [[CUDA[0]], CUDA[:2], CUDA[:4],
                                     [torch.device("cpu")]])
def test_profile_synchronises_every_card(synced, devices):
    """start and stop each wait for every CUDA device the profile holds,
    and for no other."""
    prof = Profile(list(devices))
    prof.start()
    prof.stop("step1")
    cuda = [d for d in devices if d.type == "cuda"]
    assert synced == cuda + cuda
    assert [e.name for e in prof.entries] == ["step1"]


def test_decomposed_clock_holds_its_shards_devices():
    """Simulation times its one device; a decomposed run the distinct
    devices of its shards."""
    cfg = family(tt, "scatter", nparticles=8)
    assert driver.Simulation(cfg, device="cpu",
                             quiet=True).profile.devices == [
        torch.device("cpu")]
    sim = Spatial2DSimulation(cfg, devices=CPU4, quiet=True)
    assert sim.profile.devices == [torch.device("cpu")]


# -- (c) shards on cards ---------------------------------------------------------
@pytest.fixture
def four_cards(monkeypatch):
    """PyTorch seeing four cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)


@pytest.mark.parametrize("n,device,want", [
    (4, "cuda", CUDA[:4]),
    (8, "cuda", CUDA[:4] * 2),
    (None, "cuda", CUDA[:4]),
    (2, "cuda", CUDA[:2]),
    (4, "cuda:2", [CUDA[2]] * 4),
    (3, "cuda:0", [CUDA[0]] * 3),
])
def test_shard_devices_on_four_cards(four_cards, n, device, want):
    """Shards take the cards in turn; an indexed card takes them all."""
    assert shard_devices(n, device) == want


@pytest.mark.parametrize("device", ["cuda:4", "cuda:7"])
def test_shards_on_a_missing_card_raise(four_cards, device):
    with pytest.raises(ValueError, match="sees 4 card"):
        shard_devices(4, device)


@pytest.mark.parametrize("cards,nshards,want", [
    ({0: [0], 1: [1], 2: [2], 3: [3]}, 4, CUDA[:4]),
    ({0: [0, 1], 1: [2, 3]}, 4, CUDA[:4]),
    ({0: [0, 1], 1: [2, 3]}, 8, [CUDA[i] for i in (0, 1, 0, 1, 2, 3, 2, 3)]),
    ({0: [0, 1], 1: [0, 1]}, 4, [CUDA[i] for i in (0, 1, 0, 1)]),
    ({0: [0], 1: [0]}, 4, [CUDA[0]] * 4),
])
@pytest.mark.parametrize("me", [0, 1])
def test_shards_over_processes_take_their_cards(monkeypatch, cards, nshards,
                                                want, me):
    """Over several processes each takes its contiguous block of shards,
    spread in turn over its own cards (as it numbers them); every process
    computes the same global list."""
    monkeypatch.setattr(distributed, "_layout", distributed.Layout(
        "nccl", "cuda", tuple(tuple(c) for c in cards.values())))
    monkeypatch.setattr(distributed, "world", lambda: len(cards))
    monkeypatch.setattr(distributed, "rank", lambda: me)
    assert distributed.shard_devices(nshards) == want
    assert shard_devices(nshards, "cuda") == want
    assert distributed.process_cards() == [CUDA[i] for i in cards[me]]
    assert distributed.comm_device() == CUDA[cards[me][0]]


def test_cpu_group_has_no_cards(monkeypatch):
    monkeypatch.setattr(distributed, "_layout", distributed.Layout())
    monkeypatch.setattr(distributed, "world", lambda: 2)
    assert distributed.comm_device() == torch.device("cpu")
    with pytest.raises(ValueError, match="without a CUDA device"):
        distributed.process_cards()


# -- (d) four CPU shards against JAX's decomposed simulations ---------------------
FAMILIES = {
    # tests/test_transport.py's 48^2 families at a few thousand particles
    "scatter": dict(problems=((1.0e4, 0, 0, 1, 1),), initial_energy=1.0e3,
                    niters=2, source=(0.2, 0.2, 0.6, 0.6)),
    "csp": dict(problems=((1.0e-30, 0, 0, 1, 1), (1.0e4, 0.4, 0.4, 0.2, 0.2)),
                initial_energy=1.0e4, niters=4, source=(0.1, 0.1, 0.2, 0.2)),
}


def family(pkg, kind, nparticles=2000):
    d = FAMILIES[kind]
    return pkg.SimConfig(
        nx=48, ny=48, width=1.0, height=1.0, dt=1e-7, niters=d["niters"],
        nparticles=nparticles, initial_energy=d["initial_energy"],
        source=pkg.SourceBox(*d["source"]),
        problems=tuple(pkg.ProblemRegion(*p) for p in d["problems"]),
        dtype="float64", tally_dtype="float64")


def counts(sim):
    return [(m.nfacets, m.ncollisions, m.nprocessed)
            for m in (sim.step(t) for t in range(1, sim.cfg.niters + 1))]


@pytest.mark.parametrize("kind", list(FAMILIES))
@pytest.mark.parametrize("decomposition", ["replicated", "spatial2d"])
def test_four_shards_match_jax_decomposition(decomposition, kind):
    """The port's four CPU shards against JAX's ShardedSimulation /
    Spatial2DSimulation over make_device_mesh(4) (the virtual CPU devices
    of tests/conftest.py), both on the sweep transport (JAX's engine on the
    CPU), in float64: per-step counts equal, the tally within 1e-12 of the
    largest cell and its sum within 1e-12."""
    import neutral_tpu as nt
    from neutral_tpu import parallel as jp

    jcls = {"replicated": jp.ShardedSimulation,
            "spatial2d": jp.Spatial2DSimulation}[decomposition]
    jsim = jcls(family(nt, kind), device_mesh=jp.make_device_mesh(4),
                quiet=True)
    want = counts(jsim)
    cls = {"replicated": ShardedSimulation,
           "spatial2d": Spatial2DSimulation}[decomposition]
    sim = cls(family(tt, kind), devices=CPU4, quiet=True)
    assert sim.transport == "sweep"
    assert counts(sim) == want
    got, ref = sim.host_tally(), np.asarray(jsim.host_tally(), np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    assert abs(got.sum() - ref.sum()) <= 1e-12 * abs(ref.sum())
    if decomposition == "spatial2d" and kind == "csp":
        assert sum(m.nmigrated for m in sim.step_metrics) > 0


# -- (e) the collectives over gloo in two processes -------------------------------
WORKER_CASES = ["gather_counters begin", "gather_counters chunk",
                "gather_counters flight chunk", "all_gather_arrays",
                "exchange one way", "exchange both ways",
                "exchange one way lanes", "exchange both ways lanes"]


@pytest.fixture(scope="module")
def worker_outputs():
    """Both processes' outputs of tests/_torch_cards_worker.py."""
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_cards_worker.py"),
         str(r), str(port)], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
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


@pytest.mark.parametrize("case", WORKER_CASES)
@pytest.mark.parametrize("process", [0, 1])
def test_collectives_match_the_host_staged_ones(worker_outputs, process,
                                                case):
    """The folded gather of counter rows, the all-gather of tensors and the
    exchange of packed buffers return bitwise what the host-staged
    functions they replaced return (and the lanes that were sent)."""
    out = worker_outputs[process]
    lanes = case.endswith("lanes")
    if lanes and "one way" in case and process == 0:
        assert f"OK {case}" not in out   # process 0 received nothing
        return
    assert f"OK {case}" in out.splitlines(), out


# -- (f) several cards -------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("decomposition", ["replicated", "spatial",
                                           "spatial2d"])
def test_decomposition_over_cards_matches_one_card(decomposition):
    """Four shards on cuda:0..3 (in turn over the cards there are) against
    one card, the scatter deck at 65,536 particles on the kernel engine:
    counts exact per step, the tally sum to 1e-5 (atomics), every card's
    launches counted, the step clock over every card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from neutral_tpu_torch import begin_kernel, census

    cfg = tt.load_config("problems/scatter.params").with_(
        nparticles=65536, expected_tally=None)
    single = driver.Simulation(cfg, device="cuda:0", quiet=True)
    devices = shard_devices(4, "cuda")
    cls = {"replicated": ShardedSimulation, "spatial": SpatialSimulation,
           "spatial2d": Spatial2DSimulation}[decomposition]
    sim = cls(cfg, devices=devices, quiet=True)
    assert sim.engine == single.engine == "kernel"
    assert sim.profile.devices == sorted(set(devices), key=str)
    census.sweep_chunk_kernel.cards.clear()
    begin_kernel.begin_timestep_kernel.cards.clear()
    assert counts(sim) == counts(single)
    a, b = sim.host_tally().sum(), single.host_tally().sum()
    assert abs(a - b) <= 1e-5 * abs(b)
    for d in set(devices):
        assert begin_kernel.begin_timestep_kernel.cards[d.index] > 0
        assert census.sweep_chunk_kernel.cards[d.index] > 0
