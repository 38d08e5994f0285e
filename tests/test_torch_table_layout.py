"""The stored-table layout of the CUDA kernels' table mode, on the CPU.

The sweep and flight kernels search a stored table in two levels
(csrc/common.cuh `table_lookup`): a coarse index of every S-th key in
shared memory, then the S keys of one group, then one packed interval
(keys[i], keys[i+1], values[i], values[i+1]).  `xs.TableLayout` is that
layout and `TableLayout.index`/`.lookup` the search in plain PyTorch.  Here
they are held to torch.searchsorted and `CrossSection.lookup` (bitwise), to
JAX's XLA lookup (bitwise in float32) and to `lookup_banded` in interpret
mode (index bitwise, values within 1 ulp, as tests/test_torch_table.py
holds `CrossSection.lookup`), on the 30,000-entry resampled resonance
table, on tables around every size at which the stride changes, on runs of
equal keys across the coarse index's entries, and on hypothesis-drawn
ascending tables at any stride; the tables and probe energies are
`table_kernel`'s, which chip_smoke.py holds the kernel to as well.  The
kernel itself runs on the card (tests/test_torch_table.py's `cuda` cases,
chip_smoke.py phase 9).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from neutral_tpu_torch.table_kernel import (PROBE_TABLES, probe_energies,
                                            probe_table, sized_table,
                                            table_lookup_kernel)
from neutral_tpu_torch.xs import (COARSE_KEYS, CrossSection, TableLayout,
                                  coarse_shift)

PROBES = 20_000          # log-uniform energies besides the edge cases

def layout_of(keys, values) -> tuple[CrossSection, TableLayout]:
    tab = CrossSection(torch.from_numpy(keys), torch.from_numpy(values))
    return tab, tab.table_layout


@pytest.mark.parametrize("name", PROBE_TABLES)
def test_two_level_index_is_searchsorted(name):
    """The two-level index is exactly torch.searchsorted(right=True) - 1
    clipped to [0, n-2], for every key, its neighbours, the ends, 0, +-inf
    and NaN; the layout holds the stride rule's coarse index."""
    keys, values = probe_table(name)
    tab, lay = layout_of(keys, values)
    n = keys.shape[0]
    assert lay.shift == coarse_shift(n)
    assert torch.equal(lay.coarse, lay.keys[::1 << lay.shift])
    assert lay.coarse.shape[0] <= COARSE_KEYS
    e = torch.from_numpy(probe_energies(keys, PROBES))
    want = (torch.searchsorted(tab.keys, e, right=True) - 1).clamp(0, n - 2)
    got = lay.index(e)
    assert torch.equal(got, want)
    assert torch.equal(got, tab.lookup_index(e))


@pytest.mark.parametrize("name", PROBE_TABLES)
def test_packed_values_equal_lookup_and_jax(name):
    """The packed-interval values equal CrossSection.lookup bitwise, and
    JAX's XLA neutral_tpu.xs.CrossSection.lookup bitwise in float32 (its
    searchsorted index and the same interpolation)."""
    import jax.numpy as jnp
    import neutral_tpu as nt

    keys, values = probe_table(name)
    tab, lay = layout_of(keys, values)
    e = probe_energies(keys, PROBES, seed=1)
    got = lay.lookup(torch.from_numpy(e)).numpy()
    plain = tab.lookup(torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), plain.view(np.uint32))
    xla = np.asarray(nt.CrossSection(jnp.asarray(keys), jnp.asarray(values))
                     .lookup(jnp.asarray(e)))
    np.testing.assert_array_equal(got.view(np.uint32), xla.view(np.uint32))
    packed = lay.intervals.numpy()
    np.testing.assert_array_equal(packed, np.stack(
        [keys[:-1], keys[1:], values[:-1], values[1:]], axis=1))


def test_layout_matches_lookup_banded():
    """Against neutral_tpu.pallas_table.lookup_banded in interpret mode on
    its own test table (4,097 entries: S = 4): the index bitwise (values[i]
    = i, so an energy at keys[i] interpolates to exactly i; the clip at
    n-2 included) and the values within 1 ulp over the whole table, as
    tests/test_torch_table.py holds CrossSection.lookup (XLA on the CPU
    rounds the banded interpolation differently on ~1% of the lanes)."""
    from neutral_tpu.pallas_table import build_layout
    from test_pallas_table import _run_lookup_kernel, make_log_table

    keys, values = make_log_table()
    k32, v32 = keys.astype(np.float32), values.astype(np.float32)
    _, lay = layout_of(k32, v32)
    assert lay.shift == 2
    rs = np.random.RandomState(1)
    e = (10.0 ** rs.uniform(-2.5, 8.5, size=(16, 128))).astype(np.float32)
    band = build_layout(keys, values)
    banded = np.asarray(_run_lookup_kernel(band, e, 0, band.nrows - 1))
    got = lay.lookup(torch.from_numpy(e)).numpy()
    assert (np.abs(got - banded) <= np.spacing(np.abs(banded))).all()
    assert (got != banded).mean() < 0.02

    n = keys.shape[0]
    at_keys = np.resize(k32, (33, 128))
    ilay = build_layout(k32, np.arange(n, dtype=np.float64))
    banded = np.asarray(_run_lookup_kernel(ilay, at_keys, 0, ilay.nrows - 1))
    idx = lay.index(torch.from_numpy(at_keys)).numpy()
    last = at_keys == k32[-1]
    assert (idx[last] == n - 2).all() and (banded[last] == n - 1).all()
    np.testing.assert_array_equal(idx[~last], banded[~last].astype(np.int64))


@given(n=st.integers(2, 6000), shift=st.integers(0, 9),
       seed=st.integers(0, 2**32 - 1), dup=st.floats(0.0, 0.9),
       scale=st.sampled_from([1e-30, 1.0, 1e30]))
@settings(max_examples=60, deadline=None)
def test_two_level_search_any_ascending_table(n, shift, seed, dup, scale):
    """Any ascending float32 table (with a share `dup` of equal
    neighbours, of either sign) at any stride 2**shift: the two-level
    index equals searchsorted's, and the values CrossSection.lookup's
    bitwise."""
    rng = np.random.default_rng(seed)
    steps = rng.exponential(1.0, n) * (rng.random(n) >= dup)
    keys = ((np.cumsum(steps) - steps.sum() / 3) * scale).astype(np.float32)
    keys = np.maximum.accumulate(keys)
    values = rng.normal(0.0, 1e3, n).astype(np.float32)
    tab = CrossSection(torch.from_numpy(keys), torch.from_numpy(values))
    kt = tab.keys
    lay = TableLayout(kt, TableLayout.build(kt, tab.values).intervals,
                      kt[::1 << shift].contiguous(), shift)
    e = torch.from_numpy(np.concatenate([
        probe_energies(keys, 0, seed),
        rng.uniform(keys[0] - 1.0, keys[-1] + 1.0, 500).astype(np.float32)]))
    assert torch.equal(lay.index(e), tab.lookup_index(e))
    np.testing.assert_array_equal(lay.lookup(e).numpy().view(np.uint32),
                                  tab.lookup(e).numpy().view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(2, 1 << 12), ((1 << 12) + 1, 1 << 24),
                                   ((1 << 24) + 1, 2**31 - 1)])
def test_stride_rule_keeps_coarse_within_budget(lo, hi):
    """For n from 2 to 2**31 - 1 (the largest table TableLayout.build
    takes): the coarse index has at most COARSE_KEYS entries, and S is the
    smallest power of two that does it (S = 16 for 30,000 entries, 1,875
    keys, 7.3 KiB).  The kernels' group bounds for every first-level count
    c fit their integer types: c S, the group's end before the clip to n,
    in unsigned 32 bits (it reaches 2**31 at the largest tables, past an
    int), and (c - 1) S + 1, its start, in a signed int."""
    rng = np.random.default_rng(lo)
    pows = [1 << k for k in range(1, 32)]
    ns = {n + d for n in pows for d in (-1, 0, 1)} | set(
        rng.integers(lo, hi + 1, 2000).tolist())
    for n in sorted(m for m in ns if lo <= m <= hi):
        s = 1 << coarse_shift(n)
        coarse = -(-n // s)
        assert coarse <= COARSE_KEYS, n
        assert s == 1 or -(-n // (s // 2)) > COARSE_KEYS, n
        assert coarse * s < 2**32 and (coarse - 1) * s + 1 < 2**31, n
    assert coarse_shift(30000) == 4 and -(-30000 // 16) == 1875
    assert coarse_shift(2**31 - 1) == 20 and COARSE_KEYS << 20 == 2**31


@pytest.mark.parametrize("case", ["descending", "nan", "short", "shape",
                                  "2d"])
def test_layout_refuses_tables_it_cannot_search(case):
    """A table that fails to lay out raises: keys that descend anywhere, a
    NaN key, fewer than 2 entries, keys and values of other shapes, and
    keys and values that are not 1-D."""
    keys, values = sized_table(100)
    if case == "descending":
        keys[50], keys[51] = keys[51], keys[50]
    elif case == "nan":
        keys[10] = np.nan
    elif case == "short":
        keys, values = keys[:1], values[:1]
    elif case == "shape":
        values = values[:-1]
    else:
        keys, values = keys.reshape(10, 10), values.reshape(10, 10)
    tab = CrossSection(torch.from_numpy(keys), torch.from_numpy(values))
    with pytest.raises(ValueError):
        tab.table_layout


def test_kernel_wrapper_on_cpu_raises():
    """The lookup kernel's wrapper launches or raises: on CPU tensors it
    raises and counts no launch (the plain versions are TableLayout.lookup
    and CrossSection.lookup, which the caller picks)."""
    _, lay = layout_of(*sized_table(300))
    launches = table_lookup_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        table_lookup_kernel(lay, torch.ones(8))
    assert table_lookup_kernel.launches == launches
