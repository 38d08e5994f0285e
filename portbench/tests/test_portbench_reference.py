"""The plain reference against the program at a tiny size on the CPU:
float64 lane for lane to rounding, float32 counts exactly."""

import numpy as np
import pytest
import torch

from neutral_tpu_torch import driver, rng
from neutral_tpu_torch.particles import merge_states
from portbench import check, harness
from portbench.reference import engine

SMALL = dict(nx=40, ny=40, nparticles=300)


def tiny(cell: str, **kw) -> dict:
    c = harness.find_cell(cell)
    return {**c["config"], **SMALL, **kw}


@pytest.mark.parametrize("counter,pid,key", [(0, 0, 0), (1, 7, 3),
                                             (5, 123456, 2**62 + 11),
                                             (9, 2**40 + 3, 2**63 + 5)])
def test_threefry_matches_the_published_cipher(counter, pid, key):
    w0, w1 = engine.threefry(torch.tensor([counter]), torch.tensor([pid]),
                             engine.key_tensor(key, "cpu"))
    want = rng.threefry2x64_py((counter, 0), (pid, key))
    got = tuple(int(w) & (2**64 - 1) for w in (w0.item(), w1.item()))
    assert got == want


def port_solve(config: dict, dtype: str, transport: str, keys: list):
    cfg = harness.sim_config(config, {"dtype": dtype, "tally_dtype": dtype})
    sim = driver.Simulation(cfg, device="cpu", transport=transport,
                            quiet=True)
    return sim, [sim.step(k) for k in keys]


@pytest.mark.parametrize("deck", ["scatter.f32", "csp.f32"])
@pytest.mark.parametrize("dtype,transport", [("float64", "sweep"),
                                             ("float64", "flight"),
                                             ("float32", "sweep"),
                                             ("float32", "flight")])
def test_reference_agrees_with_the_program(deck, dtype, transport):
    config = tiny(deck, iterations=3 if deck == "csp.f32" else 2)
    keys = [check.master_key(5, 0, s) for s in (1, 2, 3)][
        :config["iterations"]]
    sim, ms = port_solve(config, dtype, transport, keys)
    ref = engine.solve(engine.Deck.from_dict(config),
                       torch.arange(config["nparticles"]), keys)
    for s, m in enumerate(ms):
        assert (m.nprocessed, m.nfacets, m.ncollisions) == (
            int(ref.live[s].sum()), int(ref.facets[s].sum()),
            int(ref.collisions[s].sum()))
    st = merge_states(sim.states())
    lanes = ref.lanes.numpy()
    x = st["x"].astype(np.float64)
    if sim.coords() == "cell-local":
        x = x + st["cellx"] * (1.0 / config["nx"])
    assert np.array_equal(st["dead"], lanes["dead"])
    assert np.array_equal(st["cellx"], lanes["cellx"])
    assert np.array_equal(st["counter"].astype(np.int64), lanes["counter"])
    tol = check.TOLERANCES[dtype]
    assert np.allclose(st["energy"], lanes["energy"], rtol=tol["rel"] / 10,
                       atol=0)
    assert np.allclose(x, lanes["x"], rtol=0, atol=tol["pos"] / 10)
    tally = sim.host_tally().sum()
    assert tally == pytest.approx(float(ref.quadrant_tally.sum()),
                                  rel=check.TALLY_FLOOR[dtype])


@pytest.mark.parametrize("dtype,transport,gap", [("float64", "sweep", 1e-12),
                                                 ("float64", "flight", 1e-12),
                                                 ("float32", "flight", 1e-5)])
def test_the_whole_tally_agrees_cell_by_cell(dtype, transport, gap):
    config = tiny("csp.f32", iterations=3)
    keys = [check.master_key(11, 0, s) for s in (1, 2, 3)]
    sim, _ = port_solve(config, dtype, transport, keys)
    ref = engine.solve(engine.Deck.from_dict(config),
                       torch.arange(config["nparticles"]), keys, grid=True)
    want = ref.tally.numpy()
    assert want.sum() == pytest.approx(float(ref.quadrant_tally.sum()),
                                       rel=1e-12)
    got = np.abs(sim.host_tally() - want).sum() / np.abs(want).sum()
    assert got < gap


def test_the_working_set_shrinks_without_changing_a_lane(monkeypatch):
    """Gathering the working lanes into smaller sets, at every chance,
    gives every lane, count and tally the one working set gives."""
    config = tiny("csp.f32", iterations=3)
    deck = engine.Deck.from_dict(config)
    keys = [check.master_key(3, 0, s) for s in (1, 2, 3)]
    pid = torch.arange(config["nparticles"])
    whole = engine.solve(deck, pid, keys, grid=True)
    monkeypatch.setattr(engine.Census, "LEAST_SET", 0)
    monkeypatch.setattr(engine.Census, "CHECK_EVERY", 1)
    shrunk = engine.solve(deck, pid, keys, grid=True)
    a, b = whole.lanes.numpy(), shrunk.lanes.numpy()
    for f in a:
        assert np.array_equal(a[f], b[f]), f
    for f in ("live", "facets", "collisions", "unfinished"):
        assert torch.equal(getattr(whole, f), getattr(shrunk, f)), f
    assert torch.allclose(whole.quadrant_tally, shrunk.quadrant_tally,
                          rtol=1e-13, atol=0)
    assert torch.allclose(whole.tally, shrunk.tally, rtol=1e-13, atol=1e-300)


def test_departs_flags_each_field():
    n = 8
    base = {f: np.zeros(n) for f in check.FIELDS}
    base["energy"] = np.full(n, 5.0)
    base["weight"] = np.full(n, 0.5)
    other = {f: v.copy() for f, v in base.items()}
    other["energy"][1] *= 1 + 1e-3
    other["weight"][2] = 0.0
    other["x"][3] += 1e-3
    other["omega_y"][4] += 0.1
    other["dead"][5] = 1
    other["counter"][6] = 3
    other["energy"][7] *= 1 + 1e-6          # inside float32's tolerance
    got = check.departs(other, base, check.TOLERANCES["float32"], 1.0)
    assert got.tolist() == [False, True, True, True, True, True, True, False]
