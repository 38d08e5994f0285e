"""Counter-based RNGs: Threefry-2x64 (20 rounds) and PCG64si on torch tensors.

Port of `neutral_tpu/rng.py`, bitwise equal to it.  Under the default
scheme, threefry, each particle history draws from an independent,
order-independent stream keyed by

    key     = (particle_id, master_key)       # master_key = timestep index
    counter = (draw_counter, 0)

the scheme of the reference mini-app (omp3/neutral.c:632-652, Random123's
threefry2x64 with 20 rounds).  Every draw is a pure function of
(pid, master_key, counter), so no `torch.Generator` and no RNG state exist
anywhere in the port: lanes can be processed in any order, on any device,
and reproduce the same histories.

Under `rng pcg64si` (the RNG contract of the reference's oacc and raja
backends) a pair draw seeds two fresh PCG64si generators with
seed = 1e15*master_key + 1e4*pid + 2*counter and seed + 1, and takes the
first output of each (see `uniform2_pcg_f64`).

PyTorch on the CPU has no uint64 add, shift or multiply and only partial
uint32 support, so each u64 word is carried as two 32-bit halves, each
held in an int64 tensor with values in [0, 2^32).  Adds carry explicitly
and every result is masked with `& 0xFFFFFFFF`; products are split into
16-bit limbs (`_mul32x32`), so no int64 operation can overflow.  The CUDA
kernels (csrc/common.cuh) use native `uint64_t` for both generators.
"""

from __future__ import annotations

import torch

# Threefry-2x64 rotation distances (public constants from the Threefish/
# Threefry specification).
_ROTATIONS = (16, 42, 12, 31, 16, 32, 24, 21)

# Skein key-schedule parity constant, split into (hi, lo) halves.
_PARITY_HI = 0x1BD11BDA
_PARITY_LO = 0xA9FC1A22

N_ROUNDS = 20
_M32 = 0xFFFFFFFF

# (0, 1) uniform mapping constants, as in the reference:
#   u = v * 2^-64 + 2^-65  — strictly inside (0, 1).
_FACTOR64 = 2.0 ** -64
_HALF_FACTOR64 = 2.0 ** -65
_FACTOR32_HI = 2.0 ** -32      # weight of the hi word in the f32 mapping
_HALF_FACTOR32 = 2.0 ** -33


def _add64(ahi, alo, bhi, blo):
    """(hi, lo) + (hi, lo) with carry, modulo 2^64."""
    lo = alo + blo
    hi = (ahi + bhi + (lo >> 32)) & _M32
    return hi, lo & _M32


def _rotl64(hi, lo, r: int):
    """Rotate a (hi, lo) word left by the static amount r (0 < r < 64)."""
    if r == 32:
        return lo, hi
    if r > 32:
        hi, lo = lo, hi
        r -= 32
    nhi = ((hi << r) & _M32) | (lo >> (32 - r))
    nlo = ((lo << r) & _M32) | (hi >> (32 - r))
    return nhi, nlo


def threefry2x64(ctr0_hi, ctr0_lo, ctr1_hi, ctr1_lo,
                 key0_hi, key0_lo, key1_hi, key1_lo,
                 rounds: int = N_ROUNDS):
    """Threefry-2x64 block cipher on 32-bit halves held in int64 tensors.

    Inputs broadcast against each other (tensors or Python ints in
    [0, 2^32)).  Returns the two output words as four int64 tensors
    (x0_hi, x0_lo, x1_hi, x1_lo), each in [0, 2^32).
    """
    ks = ((key0_hi, key0_lo), (key1_hi, key1_lo),
          (_PARITY_HI ^ key0_hi ^ key1_hi, _PARITY_LO ^ key0_lo ^ key1_lo))

    x0_hi, x0_lo = _add64(ctr0_hi, ctr0_lo, key0_hi, key0_lo)
    x1_hi, x1_lo = _add64(ctr1_hi, ctr1_lo, key1_hi, key1_lo)

    for r in range(rounds):
        x0_hi, x0_lo = _add64(x0_hi, x0_lo, x1_hi, x1_lo)
        x1_hi, x1_lo = _rotl64(x1_hi, x1_lo, _ROTATIONS[r % 8])
        x1_hi = x1_hi ^ x0_hi
        x1_lo = x1_lo ^ x0_lo
        if (r + 1) % 4 == 0:
            j = (r + 1) // 4
            a = ks[j % 3]
            b = ks[(j + 1) % 3]
            x0_hi, x0_lo = _add64(x0_hi, x0_lo, a[0], a[1])
            # The key word plus the round-number tweak j.
            x1_hi, x1_lo = _add64(x1_hi, x1_lo, b[0], b[1])
            x1_hi, x1_lo = _add64(x1_hi, x1_lo, 0, j)

    return x0_hi, x0_lo, x1_hi, x1_lo


def _split64(x, like: torch.Tensor):
    """(hi, lo) halves of an int64 tensor or a Python int, as int64 tensors
    on `like`'s device."""
    if isinstance(x, int):
        return (torch.tensor(x >> 32, dtype=torch.int64, device=like.device),
                torch.tensor(x & _M32, dtype=torch.int64, device=like.device))
    x = x.to(device=like.device, dtype=torch.int64)
    return x >> 32, x & _M32


def raw_draw(pkey, master_key, counter):
    """One Threefry-2x64 draw per lane: ctr = (counter, 0),
    key = (pkey, master_key).

    Each argument is an int64 tensor (values in [0, 2^63)) or a Python int
    in [0, 2^64); at least one must be a tensor.  Returns the two output
    words as four int64 tensors of 32-bit halves (v0_hi, v0_lo, v1_hi,
    v1_lo).
    """
    like = next(a for a in (pkey, counter, master_key)
                if isinstance(a, torch.Tensor))
    c_hi, c_lo = _split64(counter, like)
    p_hi, p_lo = _split64(pkey, like)
    m_hi, m_lo = _split64(master_key, like)
    return threefry2x64(c_hi, c_lo, 0, 0, p_hi, p_lo, m_hi, m_lo)


def _to_f64(hi, lo):
    """The reference's (double)u64 * 2^-64 + 2^-65, strictly inside (0, 1).

    hi * 2^32 and lo are exact in float64, so their sum is the single
    round-to-nearest conversion of the u64 word.
    """
    v = hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)
    return v * _FACTOR64 + _HALF_FACTOR64


def _to_f32(hi):
    """u = hi * 2^-32 + 2^-33 in float32, from the high word alone.

    `neutral_tpu` converts hi through two exact 16-bit halves because the
    TPU has only int32 -> float32 casts; their single rounded sum equals a
    direct round-to-nearest u32 -> f32 cast, which is what this does.
    """
    return hi.to(torch.float32) * _FACTOR32_HI + _HALF_FACTOR32


def uniform2_f64(pkey, master_key, counter):
    """Two float64 uniforms in (0, 1) per lane, bitwise equal to the
    reference's mapping of the two Threefry words."""
    v0h, v0l, v1h, v1l = raw_draw(pkey, master_key, counter)
    return _to_f64(v0h, v0l), _to_f64(v1h, v1l)


def uniform2_f32(pkey, master_key, counter):
    """Two float32 uniforms in (0, 1) per lane from the high words."""
    v0h, _, v1h, _ = raw_draw(pkey, master_key, counter)
    return _to_f32(v0h), _to_f32(v1h)


def uniform2(pkey, master_key, counter, dtype: torch.dtype):
    """Dtype-dispatching pair draw (threefry)."""
    if dtype == torch.float32:
        return uniform2_f32(pkey, master_key, counter)
    if dtype == torch.float64:
        return uniform2_f64(pkey, master_key, counter)
    raise ValueError(f"unsupported dtype {dtype}")


# ----------------------------------------------------------------------------
# PCG64si (pcg_oneseq_64_rxs_m_xs_64, M.E. O'Neill's public algorithm): the
# RNG scheme of the reference's oacc/raja backends, which seed a fresh
# generator per draw (oacc/neutral.c:710-719).
# ----------------------------------------------------------------------------

_PCG_MULT = 6364136223846793005
_PCG_INC = 1442695040888963407
_PCG_OUT_MULT = 12605985483714917081
_MASTER_KEY_OFF = 10 ** 15
_PARTICLE_KEY_OFF = 10 ** 4
_M16 = 0xFFFF


def _mul32x32(a, b):
    """Full 64-bit product of two 32-bit values as (hi, lo) halves.

    b is split into 16-bit limbs, so each partial product is below 2^48
    and no int64 operation overflows (JAX's `_mul32x32` splits both
    factors because its words are uint32).
    """
    p0 = a * (b & _M16)
    p1 = a * (b >> 16)
    lo = p0 + ((p1 & _M16) << 16)              # < 2^49
    return (p1 >> 16) + (lo >> 32), lo & _M32


def _mul32_lo(a, b):
    """(a * b) mod 2^32 through 16-bit limbs of b (no int64 overflow)."""
    return (a * (b & _M16) + (((a * (b >> 16)) & _M16) << 16)) & _M32


def _mul64_lo(ahi, alo, bhi, blo):
    """(a * b) mod 2^64 on (hi, lo) halves.  The cross terms alo*bhi and
    ahi*blo count only mod 2^32 (JAX lets them wrap in uint32)."""
    hi, lo = _mul32x32(alo, blo)
    hi = (hi + _mul32_lo(alo, bhi) + _mul32_lo(ahi, blo)) & _M32
    return hi, lo


def _shr64_dyn(hi, lo, r):
    """(hi, lo) >> r for per-lane shift amounts r in [1, 63]."""
    small = r < 32
    rs = torch.where(small, r, 31)             # shift of the r < 32 lanes
    rb = torch.where(small, 0, r - 32)         # shift of the r >= 32 lanes
    lo_small = (lo >> rs) | ((hi << (32 - rs)) & _M32)
    return (torch.where(small, hi >> rs, 0),
            torch.where(small, lo_small, hi >> rb))


def _pcg_out(hi, lo):
    """The rxs_m_xs_64 output permutation of a state."""
    shi, slo = _shr64_dyn(hi, lo, (hi >> 27) + 5)    # state >> (state>>59)+5
    whi, wlo = _mul64_lo(shi ^ hi, slo ^ lo,
                         _PCG_OUT_MULT >> 32, _PCG_OUT_MULT & _M32)
    # word ^ (word >> 43): the shifted word's hi half is 0.
    return whi, wlo ^ (whi >> 11)


def pcg64si_first(seed_hi, seed_lo):
    """First output of freshly seeded PCG64si generators:
    state = (INC + seed) * MULT + INC, then the output permutation."""
    hi, lo = _add64(_PCG_INC >> 32, _PCG_INC & _M32, seed_hi, seed_lo)
    hi, lo = _mul64_lo(hi, lo, _PCG_MULT >> 32, _PCG_MULT & _M32)
    hi, lo = _add64(hi, lo, _PCG_INC >> 32, _PCG_INC & _M32)
    return _pcg_out(hi, lo)


def pcg64si_raw(seed_hi, seed_lo):
    """First outputs of the generators seeded `seed` and `seed + 1`, as
    four halves (a_hi, a_lo, b_hi, b_lo): one pair draw."""
    a_hi, a_lo = pcg64si_first(seed_hi, seed_lo)
    s_hi, s_lo = _add64(seed_hi, seed_lo, 0, 1)
    b_hi, b_lo = pcg64si_first(s_hi, s_lo)
    return a_hi, a_lo, b_hi, b_lo


def _pcg_pair_seed(pkey, master_key, counter):
    """seed = 1e15*master_key + 1e4*pid + 2*counter mod 2^64, as halves.

    Arguments as for `raw_draw`.  Pair p of a history takes the
    reference's per-draw counters 2p and 2p+1.
    """
    like = next(a for a in (pkey, counter, master_key)
                if isinstance(a, torch.Tensor))
    p_hi, p_lo = _split64(pkey, like)
    m_hi, m_lo = _split64(master_key, like)
    c_hi, c_lo = _split64(counter, like)
    s_hi, s_lo = _mul64_lo(m_hi, m_lo, _MASTER_KEY_OFF >> 32,
                           _MASTER_KEY_OFF & _M32)
    k_hi, k_lo = _mul64_lo(p_hi, p_lo, 0, _PARTICLE_KEY_OFF)
    s_hi, s_lo = _add64(s_hi, s_lo, k_hi, k_lo)
    c2_hi = ((c_hi << 1) & _M32) | (c_lo >> 31)
    c2_lo = (c_lo << 1) & _M32
    return _add64(s_hi, s_lo, c2_hi, c2_lo)


def uniform2_pcg_f64(pkey, master_key, counter):
    """Two float64 uniforms per lane under pcg64si, bitwise equal to
    `neutral_tpu.rng.uniform2_pcg_f64`."""
    a_hi, a_lo, b_hi, b_lo = pcg64si_raw(
        *_pcg_pair_seed(pkey, master_key, counter))
    return _to_f64(a_hi, a_lo), _to_f64(b_hi, b_lo)


def uniform2_pcg_f32(pkey, master_key, counter):
    """Two float32 uniforms per lane under pcg64si, from the high words,
    bitwise equal to `neutral_tpu.rng.uniform2_pcg_f32`."""
    a_hi, _, b_hi, _ = pcg64si_raw(*_pcg_pair_seed(pkey, master_key, counter))
    return _to_f32(a_hi), _to_f32(b_hi)


def uniform2_scheme(pkey, master_key, counter, dtype: torch.dtype,
                    scheme: str):
    """Scheme- and dtype-dispatching pair draw."""
    if scheme == "threefry":
        return uniform2(pkey, master_key, counter, dtype)
    if scheme != "pcg64si":
        raise ValueError(f"unknown rng scheme {scheme!r}")
    if dtype == torch.float32:
        return uniform2_pcg_f32(pkey, master_key, counter)
    if dtype == torch.float64:
        return uniform2_pcg_f64(pkey, master_key, counter)
    raise ValueError(f"unsupported dtype {dtype}")


# ----------------------------------------------------------------------------
# The same draws on Python ints, for the sequential oracle (oracle.py) and
# the tests: a copy of `neutral_tpu/rng.py`'s pure-Python draws, which that
# module cannot lend without importing JAX.
# ----------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1
_PARITY64 = (_PARITY_HI << 32) | _PARITY_LO


def threefry2x64_py(ctr: tuple[int, int], key: tuple[int, int],
                    rounds: int = N_ROUNDS) -> tuple[int, int]:
    """Threefry-2x64 on Python ints (arbitrary precision, masked to 64
    bits)."""
    ks = [key[0] & _MASK64, key[1] & _MASK64, 0]
    ks[2] = (_PARITY64 ^ ks[0] ^ ks[1]) & _MASK64
    x0 = (ctr[0] + ks[0]) & _MASK64
    x1 = (ctr[1] + ks[1]) & _MASK64
    for r in range(rounds):
        x0 = (x0 + x1) & _MASK64
        rot = _ROTATIONS[r % 8]
        x1 = ((x1 << rot) | (x1 >> (64 - rot))) & _MASK64
        x1 ^= x0
        if (r + 1) % 4 == 0:
            j = (r + 1) // 4
            x0 = (x0 + ks[j % 3]) & _MASK64
            x1 = (x1 + ks[(j + 1) % 3] + j) & _MASK64
    return x0, x1


def uniform2_py(pkey: int, master_key: int, counter: int
                ) -> tuple[float, float]:
    """The threefry pair draw mapped to (0, 1) doubles, on Python floats."""
    v0, v1 = threefry2x64_py((counter, 0), (pkey, master_key))
    return (v0 * _FACTOR64 + _HALF_FACTOR64, v1 * _FACTOR64 + _HALF_FACTOR64)


def _pcg_out_py(state: int) -> int:
    word = (((state >> ((state >> 59) + 5)) ^ state) * _PCG_OUT_MULT) \
        & _MASK64
    return ((word >> 43) ^ word) & _MASK64


def pcg64si_py(seed: int) -> int:
    """First output of a freshly seeded PCG64si stream (Python ints)."""
    return _pcg_out_py(((_PCG_INC + seed) * _PCG_MULT + _PCG_INC) & _MASK64)


def pcg64si_pair_py(seed: int) -> tuple[int, int]:
    """First two outputs of a freshly seeded PCG64si stream."""
    s0 = ((_PCG_INC + seed) * _PCG_MULT + _PCG_INC) & _MASK64
    s1 = (s0 * _PCG_MULT + _PCG_INC) & _MASK64
    return _pcg_out_py(s0), _pcg_out_py(s1)


def uniform2_pcg_py(pkey: int, master_key: int, counter: int
                    ) -> tuple[float, float]:
    """The pcg64si pair draw on Python floats: pair p of a history seeds
    the per-draw counters 2p and 2p + 1 (see `uniform2_pcg_f64`)."""
    base = (_MASTER_KEY_OFF * master_key + _PARTICLE_KEY_OFF * pkey
            + 2 * counter) & _MASK64
    v0 = pcg64si_py(base)
    v1 = pcg64si_py((base + 1) & _MASK64)
    return (v0 * _FACTOR64 + _HALF_FACTOR64,
            v1 * _FACTOR64 + _HALF_FACTOR64)
