"""Counter-based RNG: Threefry-2x64 (20 rounds) on torch tensors.

Port of `neutral_tpu/rng.py`, bitwise equal to it.  Each particle history
draws from an independent, order-independent stream keyed by

    key     = (particle_id, master_key)       # master_key = timestep index
    counter = (draw_counter, 0)

the scheme of the reference mini-app (omp3/neutral.c:632-652, Random123's
threefry2x64 with 20 rounds).  Every draw is a pure function of
(pid, master_key, counter), so no `torch.Generator` and no RNG state exist
anywhere in the port: lanes can be processed in any order, on any device,
and reproduce the same histories.

PyTorch on the CPU has no uint64 add or shift and only partial uint32
support, so each u64 word is carried as two 32-bit halves, each held in an
int64 tensor with values in [0, 2^32).  Adds carry explicitly and every
result is masked with `& 0xFFFFFFFF`; no int64 operation can overflow.  The
CUDA kernel (csrc/sweep.cu) uses native `uint64_t` for the same cipher.
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


def uniform2_f64(pkey, master_key, counter):
    """Two float64 uniforms in (0, 1) per lane, bitwise equal to the
    reference's (double)u64 * 2^-64 + 2^-65.

    hi * 2^32 and lo are exact in float64, so their sum is the single
    round-to-nearest conversion of the u64 word.
    """
    v0h, v0l, v1h, v1l = raw_draw(pkey, master_key, counter)

    def conv(hi, lo):
        v = hi.to(torch.float64) * 4294967296.0 + lo.to(torch.float64)
        return v * _FACTOR64 + _HALF_FACTOR64

    return conv(v0h, v0l), conv(v1h, v1l)


def uniform2_f32(pkey, master_key, counter):
    """Two float32 uniforms in (0, 1) per lane from the high words:
    u = hi * 2^-32 + 2^-33.

    `neutral_tpu` converts hi through two exact 16-bit halves because the
    TPU has only int32 -> float32 casts; their single rounded sum equals a
    direct round-to-nearest u32 -> f32 cast, which is what this does.
    """
    v0h, _, v1h, _ = raw_draw(pkey, master_key, counter)

    def conv(hi):
        return hi.to(torch.float32) * _FACTOR32_HI + _HALF_FACTOR32

    return conv(v0h), conv(v1h)


def uniform2(pkey, master_key, counter, dtype: torch.dtype):
    """Dtype-dispatching pair draw."""
    if dtype == torch.float32:
        return uniform2_f32(pkey, master_key, counter)
    if dtype == torch.float64:
        return uniform2_f64(pkey, master_key, counter)
    raise ValueError(f"unsupported dtype {dtype}")


def uniform2_scheme(pkey, master_key, counter, dtype: torch.dtype,
                    scheme: str):
    """Scheme- and dtype-dispatching pair draw (threefry only so far)."""
    if scheme != "threefry":
        raise NotImplementedError(
            f"rng scheme {scheme!r} is not ported yet (ROADMAP: pcg64si)")
    return uniform2(pkey, master_key, counter, dtype)
