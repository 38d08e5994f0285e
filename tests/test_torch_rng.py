"""The port's Threefry-2x64 (neutral_tpu_torch.rng) against neutral_tpu.rng.

Every comparison is bitwise: the port carries each u64 word as two 32-bit
halves in int64 tensors and must reproduce the JAX package's streams
exactly, since histories are keyed by these draws.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neutral_tpu import rng as jrng
from neutral_tpu_torch import rng as trng

from test_rng import KAT

_M32 = 0xFFFFFFFF


def _words(h0, l0, h1, l1):
    return [((int(a) << 32) | int(b), (int(c) << 32) | int(d))
            for a, b, c, d in zip(h0.tolist(), l0.tolist(), h1.tolist(),
                                  l1.tolist())]


def test_threefry_matches_python_oracle_kat():
    halves = [torch.tensor([v >> 32 for v in vals], dtype=torch.int64)
              for vals in zip(*[k[0] for k in KAT])]
    los = [torch.tensor([v & _M32 for v in vals], dtype=torch.int64)
           for vals in zip(*[k[0] for k in KAT])]
    pk_hi, mk_hi, c_hi = halves
    pk_lo, mk_lo, c_lo = los
    out = trng.threefry2x64(c_hi, c_lo, 0, 0, pk_hi, pk_lo, mk_hi, mk_lo)
    got = _words(*out)
    for ((pk, mk, c), _), g in zip(KAT, got):
        assert g == jrng.threefry2x64_py((c, 0), (pk, mk))


@pytest.fixture(scope="module")
def triples():
    rs = np.random.RandomState(1234)
    n = 10_000
    pk = rs.randint(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    mk = rs.randint(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    cc = rs.randint(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    return pk, mk, cc


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def test_raw_draw_bitwise(triples):
    pk, mk, cc = triples
    want = [np.asarray(v).astype(np.int64)
            for v in jrng.raw_draw(jnp.asarray(pk), jnp.asarray(mk),
                                   jnp.asarray(cc))]
    got = trng.raw_draw(_t(pk), _t(mk), _t(cc))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("width", ["f32", "f64"])
def test_uniform2_bitwise(triples, width):
    pk, mk, cc = triples
    jfn = {"f32": jrng.uniform2_f32, "f64": jrng.uniform2_f64}[width]
    tfn = {"f32": trng.uniform2_f32, "f64": trng.uniform2_f64}[width]
    want = jfn(jnp.asarray(pk), jnp.asarray(mk), jnp.asarray(cc))
    got = tfn(_t(pk), _t(mk), _t(cc))
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy().view(np.uint8),
                                      w.view(np.uint8))


def test_python_int_keys_and_dispatch():
    pid = torch.arange(64, dtype=torch.int64)
    a = trng.uniform2(pid, 3, 9, torch.float64)
    for i in range(64):
        assert (float(a[0][i]), float(a[1][i])) == jrng.uniform2_py(i, 3, 9)
    b = trng.uniform2_scheme(pid, 3, 9, torch.float64, "pcg64si")
    for i in range(64):
        assert (float(b[0][i]), float(b[1][i])) == \
            jrng.uniform2_pcg_py(i, 3, 9)
    with pytest.raises(ValueError, match="unknown rng scheme"):
        trng.uniform2_scheme(pid, 1, 0, torch.float32, "mt19937")
