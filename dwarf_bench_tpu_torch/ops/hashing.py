"""Hash functions of the reference's family, bit-exact with
``dwarf_bench_tpu/ops/hashing.py`` (common/dpcpp/hashfunctions.hpp:3-137,
common/dpcpp/slab_hash.hpp:60-64).

Torch's CPU uint32 has no ``>>``, ``<`` or ``%``, so the arithmetic runs on
the unsigned values in int64 lanes, masked to 32 bits after every multiply
and shift (an int64 product that wraps keeps its low 32 bits). The same
code runs on Python ints, which the cuckoo build's scalar chain walk uses.

A key argument is an int32 tensor of uint32 bit patterns, an int64 tensor,
or a Python int; only its low 32 bits count. The public functions return
int32 bit patterns for tensors (``wrap_i32``) and ints for ints; the
``*_u32`` forms return the unsigned values (int64 for tensors), for callers
that index with them.
"""

from __future__ import annotations

import torch

from .primitives import wrap_i32

M32 = 0xFFFFFFFF

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M5 = 5
_MIX = 0xE6546B64
_F1 = 0x85EBCA6B
_F2 = 0xC2B2AE35

POLYNOMIAL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43)
SLAB_HASH_PRIME = 4294967291  # largest 32-bit prime, classic slab-hash choice


def u32(v):
    """The unsigned 32-bit value of ``v``: int64 for a tensor, int for an
    int."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & M32
    return int(v) & M32


def _out(h, like):
    return wrap_i32(h) if isinstance(like, torch.Tensor) else h


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def _fmix32(h):
    """Murmur3 finalizer (hashfunctions.hpp:76-84)."""
    h = h ^ (h >> 16)
    h = (h * _F1) & M32
    h = h ^ (h >> 13)
    h = (h * _F2) & M32
    return h ^ (h >> 16)


def murmur3_32_u32(v, seed, size=None):
    """``murmur3_32`` as unsigned values (int64 for a tensor)."""
    k1 = (u32(v) * _C1) & M32
    k1 = _rotl32(k1, 15)
    k1 = (k1 * _C2) & M32
    h1 = (int(seed) & M32) ^ k1
    h1 = _rotl32(h1, 13)
    h1 = (h1 * _M5 + _MIX) & M32
    h1 = h1 ^ 4  # len
    h1 = _fmix32(h1)
    return h1 if size is None else h1 % int(size)


def murmur3_32(v, seed, size=None):
    """MurmurHash3_x86_32 of a 4-byte key, reduced mod ``size`` (the raw
    32-bit hash for ``size=None``). Bit-exact vs. the reference functor with
    len=4 (hashfunctions.hpp:64-137)."""
    return _out(murmur3_32_u32(v, seed, size), v)


def simple_hash(v, size):
    """SimpleHasher: ``v % size`` (hashfunctions.hpp:43-49)."""
    return _out(u32(v) % int(size), v)


def simple_hash_with_offset(v, size, offset):
    """SimpleHasherWithOffset: ``(v % size + offset % size) % size``
    (hashfunctions.hpp:51-62; the ctor pre-reduces the offset)."""
    size = int(size)
    off = (int(offset) & M32) % size
    return _out((u32(v) % size + off) % size, v)


def _wrap_i32(t):
    """int32 two's-complement wrap of an int64 tensor or an int."""
    return ((t + (1 << 31)) & M32) - (1 << 31)


def polynomial_hash(v, size, p):
    """PolynomialHasher: base-10 digit polynomial in prime ``p`` mod
    ``size`` (hashfunctions.hpp:3-31), with int32 two's-complement wrap on
    every product and sum.

    The steps are the JAX package's (hashing.py:81-98), whose int32 ``%``
    is floor division's remainder (``%`` on ints and tensors here), not
    C++'s truncating ``%``. Each step keeps the residue mod ``size`` either
    way and the last one maps it into [0, size), so the result is the C++
    one. JAX masks the steps past a key's last digit; they add 0 and leave
    ``res`` in [0, size), so they are no-ops here, and ``pow_p`` is the same
    for every key."""
    x = u32(v)
    size, p = int(size), int(p)
    res, pow_p = 0 * x, p
    for _ in range(10):  # uint32 has at most 10 decimal digits
        term = _wrap_i32(x % 10 * pow_p) % size
        res = _wrap_i32(res + term) % size
        pow_p = _wrap_i32(pow_p * p)
        x = x // 10
    return _out(_wrap_i32(res % size + size) % size, v)


def affine_hash(v, a, b, prime, num_buckets):
    """SlabHash DefaultHasher: ``((a*k + b) % p) % buckets`` in uint32
    (common/dpcpp/slab_hash.hpp:60-64)."""
    h = (u32(v) * int(a) + int(b)) & M32
    return _out(h % int(prime) % int(num_buckets), v)
