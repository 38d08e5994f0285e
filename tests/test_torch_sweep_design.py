"""The sweep kernel's design pieces that the CPU can check.

csrc/sweep.cu runs persistent threads that take lanes from a work list,
reads the analytic cross-sections from a grid of (key, value) pairs
instead of dividing, and looks the cross-sections up once per collision.
The kernel itself runs only on a card; here its arithmetic and its host
rules are held to the plain versions:

- `grid_lookup`, a plain mirror of csrc/common.cuh `xs_lookup` (four grid
  entries loaded at once, the nudges picking from them), against
  `CrossSection.lookup` (analytic) bitwise in float32, and against
  neutral_tpu's analytic lookup in float64;
- `CrossSection.analytic_grid_in` against `_key_at`/`_val_at` and the
  generated table;
- `sweep_kernel.grid_blocks` (the persistent grid) and
  `sweep_kernel.thread_slot_use` (the share of thread slots that run
  events when lanes run one thread each in pid order).

The `cuda` case holds the redesigned kernel to the plain version on the
card at 1, 64 and 4096 events per launch, with the lists in the kernel's
order and reversed; it skips without a card:

    python -m pytest tests/test_torch_sweep_design.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver, transport
from neutral_tpu_torch.particles import STATE_FIELDS
from neutral_tpu_torch.sweep_kernel import (THREADS, SweepBuffers,
                                            grid_blocks, rect_arrays,
                                            sweep_chunk_plain, sweep_params,
                                            sweep_round, thread_slot_use)
from neutral_tpu_torch.xs import CrossSection, make_resonance_table, to_int

DECK = "problems/scatter.params"


def grid_lookup(energy: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """csrc/common.cuh xs_lookup in plain PyTorch: the closed-form first
    guess i0 (converted as the kernel's __float2int_rd converts: a NaN
    root below 1e-2 eV to 0), the grid's entries i0 - 1 .. i0 + 2, the two
    nudges picking from them, and the interpolation."""
    n = grid.shape[0]
    f32 = np.float32
    u = torch.sqrt(torch.sqrt((energy - float(f32(1.0e-2)))
                              * float(f32(1.0e-8))))
    i0 = (to_int(torch.floor(u * float(f32(n))), torch.int32) - 1).clamp(
        0, n - 2)
    gm = grid[(i0 - 1).clamp(min=0)]
    g0 = grid[i0]
    g1 = grid[i0 + 1]
    g2 = grid[(i0 + 2).clamp(max=n - 1)]
    down = energy < g0[:, 0]
    up = energy >= torch.where(down, g0[:, 0], g1[:, 0])
    idx = (i0 - down.to(torch.int32) + up.to(torch.int32)).clamp(0, n - 2)
    d = (idx - i0)[:, None]
    lo = torch.where(d < 0, gm, torch.where(d == 0, g0, g1))
    hi = torch.where(d < 0, g0, torch.where(d == 0, g1, g2))
    return lo[:, 1] + ((energy - lo[:, 0]) / (hi[:, 0] - lo[:, 0])) * (
        hi[:, 1] - lo[:, 1])


def energies() -> np.ndarray:
    """float32 energies: 100,000 log-uniform over [1e-2, 1e8] eV from
    default_rng(7); 1e-2 eV, 1 eV and 1 MeV; every grid key and its
    neighbours one ulp either side at 64 random indices; and energies
    below 1e-2 eV."""
    rng = np.random.default_rng(7)
    grid = CrossSection.resonance(dtype=torch.float32,
                                  analytic=True).analytic_grid_in(
                                      torch.float32).numpy()
    keys = grid[rng.choice(grid.shape[0], 64, replace=False), 0]
    return np.concatenate([
        np.exp(rng.uniform(np.log(1e-2), np.log(1e8), 100_000)),
        [1e-2, 1.0, 1e6],
        keys, np.nextafter(keys, np.float32(np.inf)),
        np.nextafter(keys, np.float32(-np.inf)),
        [0.0, 1e-3, 5e-3, 9.99e-3]]).astype(np.float32)


def test_grid_lookup_equals_analytic_lookup_bitwise():
    tab = CrossSection.resonance(dtype=torch.float32, analytic=True)
    e = torch.from_numpy(energies())
    got = grid_lookup(e, tab.analytic_grid_in(torch.float32))
    want = tab.lookup(e)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.isfinite(got[e >= 1.0]).all()


def test_grid_lookup_agrees_with_jax_float64():
    """Within 1e-6 of neutral_tpu's analytic lookup in float64 (the port's
    float32 against JAX's float64, ROADMAP's note on XLA's division) from
    0.1 eV to 10 MeV, where the decks' particles live (born at 1e3-1e6 eV,
    absorbed below 1 eV).  At the table's ends float32 cannot resolve its
    keys: they are 1e-10 eV apart near 1e-2 eV, where the float32 ulp is
    9e-10, and 13,000 eV apart near 1e8 eV, where it is 8 eV; there the
    bound is 5e-5.  Below 1e-2 eV the closed form takes the root of a
    negative number in either package, so those energies are left out."""
    import jax.numpy as jnp
    import neutral_tpu as nt

    tab = CrossSection.resonance(dtype=torch.float32, analytic=True)
    e = energies()
    e = e[e >= np.float32(1e-2)]
    got = grid_lookup(torch.from_numpy(e),
                      tab.analytic_grid_in(torch.float32)).double()
    ref = nt.CrossSection.resonance(dtype=jnp.float64, analytic=True)
    want = np.asarray(ref.lookup(jnp.asarray(e.astype(np.float64))))
    mid = (e >= 0.1) & (e <= 1e7)
    assert mid.sum() > 50_000
    np.testing.assert_allclose(got.numpy()[mid], want[mid], rtol=1e-6,
                               atol=0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=0.0)


def test_analytic_grid_equals_key_at_val_at():
    tab = CrossSection.resonance(dtype=torch.float32, analytic=True)
    grid = tab.analytic_grid_in(torch.float32)
    n = tab.nentries
    assert grid.shape == (n, 2) and grid.dtype == torch.float32
    assert grid.is_contiguous()
    assert tab.analytic_grid_in(torch.float32) is grid   # made once
    for itype in (torch.int32, torch.int64):
        i = torch.arange(n, dtype=itype)
        assert torch.equal(grid[:, 0], tab._key_at(i, torch.float32))
        assert torch.equal(grid[:, 1], tab._val_at(i, torch.float32))
    keys, values = make_resonance_table()
    # five float32 roundings of the closed form against one of float64's
    np.testing.assert_allclose(grid[:, 0].double().numpy(), keys, rtol=1e-6)
    np.testing.assert_allclose(grid[:, 1].double().numpy(), values,
                               rtol=1e-6)


@pytest.mark.parametrize("n_active", [1, 127, 128, 129, 270_336, 10**7])
@pytest.mark.parametrize("sms,blocks_per_sm", [(132, 9), (132, 6), (1, 1)])
def test_grid_blocks_cover_the_list_and_are_capped(n_active, sms,
                                                   blocks_per_sm):
    threads = THREADS
    b = grid_blocks(n_active, sms, blocks_per_sm)
    assert 1 <= b <= sms * blocks_per_sm
    # never more blocks than the list needs at one lane a thread ...
    assert (b - 1) * threads < n_active
    # ... and every lane a thread of its own when the card holds the list
    if n_active <= sms * blocks_per_sm * threads:
        assert b * threads >= n_active
    else:
        assert b == sms * blocks_per_sm


def test_grid_blocks_never_zero():
    assert grid_blocks(0, 132, 9) == 1
    assert grid_blocks(5, 132, 0) == 1


def test_thread_slot_use_by_hand():
    even = torch.tensor([1] * 32 + [2] * 32)
    assert thread_slot_use(even) == 1.0
    one_long = torch.tensor([1] * 31 + [33])
    assert thread_slot_use(one_long) == 64 / (32 * 33)
    # a last partial warp idles its missing slots
    assert thread_slot_use(torch.ones(33, dtype=torch.int64)) == 33 / 64
    assert thread_slot_use(torch.tensor([3, 1] * 16)) == 2 / 3


def test_thread_slot_use_of_plain_scatter_census():
    """4,096 lanes of the full scatter deck through one plain census: the
    draws each lane used (its counter's delta) in pid-order warps fill
    85-95% of the slots, as the kernel's old one-thread-per-lane layout
    did."""
    cfg = tt.load_config(DECK).with_(nparticles=4096, expected_tally=None)
    sim = driver.Simulation(cfg, device="cpu", quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    end, _, nc, _ = sweep_chunk_plain(
        start.clone(), torch.zeros_like(sim.tally), sim.geom, sim.cs_scatter,
        sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    draws = end.counter - start.counter
    assert int(draws.min()) > 0 and nc > 500 * 4096
    assert 0.85 < thread_slot_use(draws) < 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("max_events", [1, 64, 4096])
def test_persistent_sweep_matches_plain_on_card(max_events, reverse):
    """The kernel over its work lists, `max_events` events per lane per
    launch, equals the plain version bitwise in counts and all 14 fields;
    with `reverse`, every launch runs its list backwards (the first over
    the lanes n-1 .. 0), which reorders the lanes and changes nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tt.load_config(DECK).with_(nparticles=65536, expected_tally=None)
    sim = driver.Simulation(cfg, device="cuda", engine="plain", quiet=True)
    start = transport.begin_timestep(sim.state, sim.geom, sim.cs_scatter,
                                     cfg.dt, 1)
    args = (sim.geom, sim.cs_scatter, sim.cs_absorb, 1, 1.0 / cfg.nparticles)
    ks, kt = start.clone(), torch.zeros_like(sim.tally)
    regions = rect_arrays(sim.geom.regions, "cuda")   # alive while it runs
    params = sweep_params(ks, kt, regions, *args)
    b = SweepBuffers("cuda")
    n = start.n
    if reverse:
        b.lists = [torch.arange(n, dtype=torch.int32, device="cuda"),
                   torch.empty(n, dtype=torch.int32, device="cuda")]
        b.n_active = n
    launches = 0
    while True:
        if reverse:
            b.lists[0][:b.n_active] = b.lists[0][:b.n_active].flip(0)
        sweep_round(params, b, max_events)
        launches += 1
        working = int(b.counts[2])
        if working == 0:
            break
        b.n_active = working
    pt = torch.zeros_like(sim.tally)
    ps, pnf, pnc, _ = sweep_chunk_plain(start.clone(), pt, *args)
    assert tuple(b.counts[:2].tolist()) == (pnf, pnc)
    assert launches > 1 if max_events < 4096 else launches == 1
    for f in STATE_FIELDS:
        assert torch.equal(getattr(ks, f), getattr(ps, f)), f
    ksum, psum = float(kt.double().sum()), float(pt.double().sum())
    assert abs(ksum - psum) <= 1e-5 * abs(psum)
    assert 0.0 < b.slot_use() <= 1.0
