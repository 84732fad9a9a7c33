"""JAX's threefry draws in torch (frozen copy of the port's ``utils/prng``).

The stage-1 train step draws its crops and the motion encoder's sample from
JAX keys, so the reference reproduces the same draws from the same keys:
* ``prng_key(seed)`` is ``PRNGKey`` of a uint32 seed: the pair ``(0, seed)``.
* ``random_bits`` is ``jax.random.bits(key, shape, uint32)`` under
  ``jax_threefry_partitionable`` (the default of jax 0.9): the counters are
  the 64-bit iota over ``shape`` split into (hi, lo) words, and the bits are
  ``x1 ^ x2`` of threefry2x32 over them.
* ``uniform`` and ``normal`` follow ``jax.random.uniform`` (the mantissa
  trick) and ``jax.random.normal`` (``sqrt(2) * erfinv(u)`` over
  ``[nextafter(-1, 0), 1)``), with ``erfinv`` in the single-precision
  polynomial of Giles that XLA lowers ``erf_inv`` to.
* ``split``, ``fold_in`` and ``permutation`` derive keys and shuffles as
  ``jax.random`` does, so the port's ``init`` draws JAX's parameters from
  JAX's seed: ``split(key, n)`` hashes the counters ``(0, i)``, ``fold_in``
  the counter ``(0, data)``, and ``permutation`` sorts ``range(n)`` stably by
  the bits of ``split(key)[1]`` (one sort round, as JAX does up to n ~ 1600).

torch's uint32 support is thin, so a bulk draw hashes int32 tensors holding
the uint32 bits (int32 adds wrap as uint32 adds do) and returns int64
values in [0, 2**32).  Every function runs on the device of its input (or
``device``), as one batch of elementwise ops; JAX computes these draws in
XLA, not in a kernel, and so does the port.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011),
# single precision: the coefficients XLA's ErfInv uses for f32.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): ``(0, seed)``."""
    seed = int(seed)
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed {seed} is not a uint32; mask it with & 0xFFFFFFFF first")
    return 0, seed


def split(key, n: int = 2):
    """``jax.random.split(key, n)`` as a list of ``n`` keys."""
    return [threefry2x32(key, 0, i) for i in range(n)]


def fold_in(key, data: int):
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, int(data) & MASK)


def permutation(key, n: int, device="cpu"):
    """``jax.random.permutation(key, n)``: ``range(n)`` sorted stably by 32
    random bits each, in as many rounds as JAX takes; the port does one."""
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK))
    if rounds > 1:
        raise NotImplementedError(f"permutation of {n} takes {rounds} sort rounds; the port does one")
    idx = torch.arange(n, dtype=torch.int64, device=torch.device(device))
    if rounds == 0:
        return idx
    bits = random_bits(split(key)[1], (n,), device)
    return idx[torch.sort(bits, stable=True).indices]


def randint(key, shape, minval: int, maxval: int, device="cpu"):
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) as int64
    values: 32 random bits from each key of ``split(key)``, the high word
    times a multiplier plus the low word, modulo the span, in JAX's wrapping
    uint32 arithmetic.  A span of 0 or less gives ``minval``."""
    lo_lim, hi_lim = -2**31, 2**31 - 1
    if not (lo_lim <= minval <= hi_lim and lo_lim <= maxval <= hi_lim):
        raise ValueError(f"randint bounds {minval}, {maxval} are not int32")
    shape = tuple(shape)
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape, device), random_bits(k2, shape, device)
    span = maxval - minval if maxval > minval else 1
    # (2**16 mod span)**2 in uint32, mod span: 2**32 mod span up to a span
    # of 2**16; above it the square wraps to 0 and only the low word counts
    multiplier = ((2**16 % span) ** 2 & MASK) % span
    offset = ((((higher % span) * multiplier) & MASK) + lower % span) & MASK
    return minval + offset % span


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(key, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count words ``x1``, ``x2``
    under ``key = (k1, k2)``, every word a Python int in [0, 2**32) (the key
    derivations; bulk draws take :func:`_threefry2x32_i32`).  Returns the
    two output words."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def _i32(v):
    """uint32 words (an int, or an int64 tensor in [0, 2**32)) as int32 with the same bits."""
    if isinstance(v, torch.Tensor):
        return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)
    v &= MASK
    return v - 2**32 if v >= 2**31 else v


def _threefry2x32_i32(key, x1, x2):
    """``threefry2x32`` on int32 tensors holding the uint32 words: int32 adds
    wrap at 32 bits as uint32 adds do, and the right shift of a rotation is
    masked to a logical one.  Half the bytes of the int64 form, no masks
    after the adds, and in place: ~8x faster on the CPU."""
    k1, k2 = key
    ks = [_i32(k) for k in (k1, k2, k1 ^ k2 ^ _PARITY)]
    x1 = x1 + ks[0]   # new tensors (broadcast against the key words): the
    x2 = x2 + ks[1]   # updates below are in place on them
    high = torch.empty_like(x2)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 += x2
            torch.bitwise_right_shift(x2, 32 - r, out=high)
            high &= (1 << r) - 1
            x2 <<= r
            x2 |= high
            x2 ^= x1
        x1 += ks[(i + 1) % 3]
        x2 += ks[(i + 2) % 3] + _i32(i + 1)
    return x1, x2


def _counters(shape, device, start=0, stop=None):
    """The (hi, lo) words of the 64-bit iota over ``shape`` (its elements
    ``start:stop``), as int32."""
    n = math.prod(shape)
    stop = n if stop is None else stop
    if n <= 2**31:   # hi is 0 and lo the iota itself
        return (torch.zeros(stop - start, dtype=torch.int32, device=device),
                torch.arange(start, stop, dtype=torch.int32, device=device))
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    return _i32(idx >> 32), _i32(idx & MASK)


# On the CPU a large draw is hashed and mapped in slices of this many
# elements, so the 20 rounds' passes stay in cache (~2x faster); each element
# is hashed from its own counter, so the numbers are the same.
_CPU_SLICE = 1 << 16


def _sliced(key, shape, device, fn, dtype):
    """``fn(bits)`` of the draw over ``shape`` under the key words ``key``
    (Python ints), computed slice by slice on the CPU; None where the draw
    is not sliced (small, on a card, or per-seed key tensors)."""
    n = math.prod(shape)
    if device.type != "cpu" or n <= _CPU_SLICE or isinstance(key[0], torch.Tensor):
        return None
    out = torch.empty(n, dtype=dtype)
    for start in range(0, n, _CPU_SLICE):
        stop = min(n, start + _CPU_SLICE)
        b1, b2 = _threefry2x32_i32(key, *_counters(shape, device, start, stop))
        out[start:stop] = fn((b1 ^ b2).to(torch.int64) & MASK)
    return out.reshape(shape)


def _keys(seeds, device):
    """Per-seed key words as (N, 1) int64 tensors."""
    s = torch.as_tensor(np.asarray(seeds, np.int64).reshape(-1, 1), device=device)
    if bool(((s < 0) | (s > MASK)).any()):
        raise ValueError("seeds must lie in [0, 2**32); mask them with & 0xFFFFFFFF first")
    return torch.zeros_like(s), s


def _bits_for_keys(key, shape, device):
    hi, lo = _counters(shape, device)
    b1, b2 = _threefry2x32_i32(key, hi, lo)
    return (b1 ^ b2).to(torch.int64) & MASK


def random_bits(key, shape, device="cpu"):
    """``jax.random.bits(key, shape, jnp.uint32)`` as int64 values in [0, 2**32)."""
    shape, device = tuple(shape), torch.device(device)
    out = _sliced(key, shape, device, lambda bits: bits, torch.int64)
    return _bits_for_keys(key, shape, device).reshape(shape) if out is None else out


def _uniform_from_bits(bits, lo, hi):
    """``jax.random.uniform``'s map of 32 random bits to f32 in [lo, hi)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32, device=bits.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo_t, f * (hi_t - lo_t) + lo_t)


def uniform(key, shape, lo=0.0, hi=1.0, device="cpu"):
    """``jax.random.uniform(key, shape, float32, lo, hi)``."""
    shape, device = tuple(shape), torch.device(device)
    out = _sliced(key, shape, device, lambda bits: _uniform_from_bits(bits, lo, hi),
                  torch.float32)
    return _uniform_from_bits(random_bits(key, shape, device), lo, hi) if out is None else out


def erfinv(x):
    """XLA's f32 ``erf_inv``: Giles' polynomial, ``+-inf`` at ``+-1``."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def _normal_from_bits(bits):
    return _SQRT2 * erfinv(_uniform_from_bits(bits, _NORMAL_LO, 1.0))


def draws(requests, device="cpu"):
    """Several draws hashed in one threefry pass: each request is
    ``("normal", key, shape)`` or ``("uniform", key, shape, lo, hi)``, and
    the result the list of ``normal(key, shape)`` / ``uniform(key, shape, lo,
    hi)``, bitwise, with the key words per element and the normals mapped
    together: a few hundred launches fewer on the card per batch of draws."""
    device = torch.device(device)
    sizes = [math.prod(r[2]) for r in requests]
    if sum(sizes) > 2**31:
        raise ValueError("draws: more than 2**31 numbers in one pass")
    words = np.concatenate([np.stack([np.full(n, r[1][0]), np.full(n, r[1][1]), np.arange(n)])
                            for r, n in zip(requests, sizes)], axis=1)
    k1, k2, lo = torch.from_numpy(words.astype(np.int64)).to(device).unbind(0)
    b1, b2 = _threefry2x32_i32((k1, k2), torch.zeros_like(lo, dtype=torch.int32),
                               lo.to(torch.int32))
    parts = ((b1 ^ b2).to(torch.int64) & MASK).split(sizes)
    normal_ids = [i for i, r in enumerate(requests) if r[0] == "normal"]
    out = [None] * len(requests)
    if normal_ids:
        mapped = _normal_from_bits(torch.cat([parts[i] for i in normal_ids]))
        for i, t in zip(normal_ids, mapped.split([sizes[i] for i in normal_ids])):
            out[i] = t
    for i, r in enumerate(requests):
        if r[0] == "uniform":
            out[i] = _uniform_from_bits(parts[i], r[3], r[4])
        elif r[0] != "normal":
            raise ValueError(f"draws: unknown kind {r[0]!r}")
    return [t.reshape(tuple(r[2])) for t, r in zip(out, requests)]


def normal(key, shape, device="cpu"):
    """``jax.random.normal(key, shape)`` (float32)."""
    shape, device = tuple(shape), torch.device(device)
    out = _sliced(key, shape, device, _normal_from_bits, torch.float32)
    return _normal_from_bits(random_bits(key, shape, device)) if out is None else out


def normal_for_seeds(seeds, shape, device="cpu"):
    """``vmap(lambda s: jax.random.normal(PRNGKey(s), shape))(seeds)`` for
    uint32 ``seeds``: one (N, *shape) draw on ``device``, each row equal to
    ``normal(prng_key(seeds[i]), shape)``."""
    shape, device = tuple(shape), torch.device(device)
    bits = _bits_for_keys(_keys(seeds, device), shape, device)
    return _normal_from_bits(bits).reshape((-1,) + shape)
