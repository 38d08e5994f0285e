"""Stored (non-quartic) cross-section tables in the port, against
neutral_tpu.

The kernels' table mode finds max{i : keys[i] <= E}, clipped to [0, n-2],
by a two-level search over the table's `xs.TableLayout`, then the
interpolation of xs.py; its plain version is the port's searchsorted
lookup (`CrossSection.lookup`; tests/test_torch_table_layout.py holds the
layout's search to it).  That lookup is
held here to `neutral_tpu.pallas_table.lookup_banded`, the TPU kernels'
table lookup, run in interpret mode as tests/test_pallas_table.py runs it
(index bitwise, value within an ulp), and table decks through the port's float64
plain sweep and flight transports to JAX's float64 XLA sweep and flight
engines.  The `cuda` tests hold both kernels' table mode to their plain
versions on the card, on the resampled resonance table and on
table_kernel's probe tables, with one table or a
second one for capture, and the lookup kernel alone against its plain
versions; they skip without one.  JAX is imported only inside the tests
that compare with it:

    python -m pytest tests/test_torch_table.py -q -m cuda --noconftest
"""

import shutil

import numpy as np
import pytest
import torch

import neutral_tpu_torch as tt
from neutral_tpu_torch import driver
from neutral_tpu_torch.table_kernel import (PROBE_TABLES, probe_energies,
                                            probe_table)
from neutral_tpu_torch.xs import resonance_log_table, write_cs_file

from test_torch_driver import kernel_matches_plain_on_card
from test_torch_flight import make_cfg


def _energies(band):
    """float32 energies over the table's span (and past both ends), or in
    one band of it, from a numpy seed."""
    rs = np.random.RandomState(1 if band == "full" else 2)
    if band == "full":
        e = 10.0 ** rs.uniform(-2.5, 8.5, size=(16, 128))
        e[0, :2] = (1e-4, 1e9)
    else:
        e = rs.uniform(1e3, 1e4, size=(8, 128))
    return e.astype(np.float32)


@pytest.mark.parametrize("band", ["full", "partial"])
def test_table_lookup_matches_lookup_banded(band):
    """Values against lookup_banded in interpret mode, over the whole
    table (every row in the band) and over an energy band: bitwise equal
    to JAX's XLA lookup (the same searchsorted index and interpolation),
    and within 1 ulp of lookup_banded.  The banded kernel resolves the
    same index (test below), but XLA on the CPU rounds its interpolation
    differently on about 1% of the lanes of the full band (ROADMAP
    Queue C)."""
    import jax.numpy as jnp
    import neutral_tpu as nt
    from neutral_tpu.pallas_table import build_layout, energy_band
    from test_pallas_table import _run_lookup_kernel, make_log_table

    keys, values = make_log_table()
    lay = build_layout(keys, values)
    e = _energies(band)
    if band == "full":
        rlo, rhi = 0, lay.nrows - 1
    else:
        rlo, rhi = (int(v) for v in energy_band(
            jnp.asarray(e), jnp.ones(e.shape, bool), lay.keys, k_events=4))
        assert rhi - rlo < lay.nrows - 1          # a band, not every row
    banded = np.asarray(_run_lookup_kernel(lay, e, rlo, rhi))
    xla = np.asarray(nt.CrossSection(
        jnp.asarray(keys, jnp.float32),
        jnp.asarray(values, jnp.float32)).lookup(jnp.asarray(e)))
    tab = tt.CrossSection(torch.tensor(keys, dtype=torch.float32),
                          torch.tensor(values, dtype=torch.float32))
    got = tab.lookup(torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), xla.view(np.uint32))
    ulp = np.spacing(np.abs(banded))
    assert (np.abs(got - banded) <= ulp).all()
    assert (got != banded).mean() < 0.02


def test_table_lookup_index_matches_jax():
    """The bracketing index bitwise: against JAX's searchsorted
    lookup_index on random energies, and against lookup_banded itself
    with values[i] = i, where an energy equal to keys[i] interpolates to
    exactly i (the clip at n-2 included)."""
    import jax.numpy as jnp
    import neutral_tpu as nt
    from neutral_tpu.pallas_table import build_layout
    from test_pallas_table import _run_lookup_kernel, make_log_table

    keys, _ = make_log_table()
    e = _energies("full")
    want = nt.CrossSection(jnp.asarray(keys, jnp.float32),
                           jnp.asarray(keys, jnp.float32)).lookup_index(
        jnp.asarray(e))
    tab = tt.CrossSection(torch.tensor(keys, dtype=torch.float32),
                          torch.tensor(keys, dtype=torch.float32))
    np.testing.assert_array_equal(
        tab.lookup_index(torch.from_numpy(e)).numpy(), np.asarray(want))

    n = len(keys)
    k32 = keys.astype(np.float32)
    lay = build_layout(k32, np.arange(n, dtype=np.float64))
    at_keys = np.resize(k32, (33, 128))          # every key, wrapped
    banded = np.asarray(_run_lookup_kernel(lay, at_keys, 0, lay.nrows - 1))
    got = tab.lookup_index(torch.from_numpy(at_keys)).numpy()
    # keys[n-1] clips to n-2 and interpolates to n-1 (fraction 1).
    last = at_keys == k32[-1]
    assert (got[last] == n - 2).all() and (banded[last] == n - 1).all()
    np.testing.assert_array_equal(got[~last], banded[~last].astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_quartic_index_equals_binary_search(dtype):
    """On the generated grid the quartic index (the plain version's) equals
    the search index (the kernels') for every energy from 1e-2 eV up: the
    kernels' table mode serves quartic tables too (fast_math 0 grid
    decks)."""
    tab = tt.CrossSection.resonance(dtype=dtype)
    rs = np.random.RandomState(5)
    k = tab.keys.double().numpy()
    e = torch.from_numpy(np.concatenate([
        10.0 ** rs.uniform(-2.0, 8.5, size=1_000_000), k,
        np.nextafter(k, 0.0), np.nextafter(k, np.inf), [1e-2]])).to(dtype)
    quartic = tab.lookup_index(e)
    tab.quartic = False
    np.testing.assert_array_equal(quartic.numpy(), tab.lookup_index(e).numpy())


def write_tables(dirpath, same_xs, log_table):
    """elastic_scatter.cs and capture.cs in `dirpath`: the same table
    twice, or (same_xs=False) a second table for capture."""
    keys, values = log_table()
    write_cs_file(str(dirpath / "elastic_scatter.cs"), keys, values)
    if same_xs:
        write_cs_file(str(dirpath / "capture.cs"), keys, values)
    else:
        k2, v2 = log_table(n=3001, seed=5)
        write_cs_file(str(dirpath / "capture.cs"), k2, 0.5 * v2)


def _runs(tmp_dir, same_xs, transport_name):
    """The split family with user tables, float64, on both packages."""
    import neutral_tpu as nt
    import neutral_tpu.driver as jdriver

    deck = f"{tmp_dir}/deck.params"
    cfg = make_cfg(tt, "split").with_(params_path=deck)
    sim = driver.Simulation(cfg, device="cpu", transport=transport_name,
                            quiet=True)
    assert not sim.cs_scatter.analytic and sim.geom.same_xs == same_xs
    t_stats = [(m.nfacets, m.ncollisions, m.nprocessed)
               for m in (sim.step(s) for s in range(1, cfg.niters + 1))]
    engine = {"sweep": "xla", "flight": "flight"}[transport_name]
    jsim = jdriver.Simulation(make_cfg(nt, "split").with_(
        params_path=deck, engine=engine), quiet=True)
    assert not jsim.cs_scatter.analytic
    j_stats = [(m.nfacets, m.ncollisions, m.nprocessed)
               for m in (jsim.step(s) for s in range(1, cfg.niters + 1))]
    return (sim.host_tally(), t_stats,
            np.asarray(jsim.tally, np.float64), j_stats)


@pytest.mark.parametrize("transport_name", ["sweep", "flight"])
@pytest.mark.parametrize("same_xs", [True, False])
def test_table_deck_matches_jax_f64(tmp_path, same_xs, transport_name):
    """A non-quartic table deck (tests/test_pallas_table.py's tables):
    float64 per-step counts exactly equal to JAX's XLA sweep or flight
    engine, tallies to 1e-12."""
    from test_pallas_table import make_log_table

    write_tables(tmp_path, same_xs, make_log_table)
    t_tally, t_stats, j_tally, j_stats = _runs(str(tmp_path), same_xs,
                                               transport_name)
    assert t_stats == j_stats
    assert sum(s[1] for s in t_stats) > 0
    np.testing.assert_allclose(t_tally.sum(), j_tally.sum(), rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["resonance", "n3", "n2049", "runs",
                                   "n131069"])
@pytest.mark.parametrize("same_xs", [True, False])
@pytest.mark.parametrize("deck", ["scatter", "split"])
def test_table_kernel_matches_plain_on_card(deck, same_xs, table, tmp_path):
    """The sweep kernel (scatter) and the flight kernel (split) in table
    mode against their plain versions at 65,536 particles, with the
    resampled resonance table or an adversarial one (3 entries; 2,049, S =
    2; runs of equal keys across the coarse entries; 131,069, S = 64), and
    a second table for capture (same_xs false: the absorb lookup, and both
    coarse indexes in shared memory)."""
    def log_table(n=30000, seed=None):
        if n != 30000:                          # the capture table
            keys, values = resonance_log_table(n)
            return keys, values
        keys, values = probe_table(table)
        return keys.astype(np.float64), values.astype(np.float64)

    write_tables(tmp_path, same_xs, log_table)
    shutil.copy(f"problems/{deck}.params", tmp_path / f"{deck}.params")
    cfg = tt.load_config(str(tmp_path / f"{deck}.params")).with_(
        nparticles=65536, expected_tally=None)
    sim, _ = kernel_matches_plain_on_card(cfg)
    assert not sim.cs_scatter.analytic and sim.geom.same_xs == same_xs


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROBE_TABLES)
def test_table_lookup_kernel_matches_plain_on_card(name):
    """The lookup kernel alone (csrc/table.cu, the device function of both
    kernels' table mode) on every probe table of table_kernel and its
    probe energies: indices bitwise the plain two-level search's
    and torch.searchsorted's, values bitwise TableLayout.lookup's and
    CrossSection.lookup's on the card."""
    from neutral_tpu_torch.table_kernel import table_lookup_kernel
    from neutral_tpu_torch.xs import CrossSection

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    keys, values = probe_table(name)
    tab = CrossSection(torch.from_numpy(keys).cuda(),
                       torch.from_numpy(values).cuda())
    lay = tab.table_layout
    e = torch.from_numpy(probe_energies(keys, 20_000)).cuda()
    launches = table_lookup_kernel.launches
    got, idx = table_lookup_kernel(lay, e, index=True)
    assert table_lookup_kernel.launches == launches + 1
    n = keys.shape[0]
    want = (torch.searchsorted(tab.keys, e, right=True) - 1).clamp(0, n - 2)
    assert torch.equal(idx.long(), want)
    assert torch.equal(idx.long(), lay.index(e))
    for plain in (lay.lookup(e), tab.lookup(e)):
        assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
