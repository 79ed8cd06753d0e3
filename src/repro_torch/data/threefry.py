"""Threefry-2x32 in integer tensor ops: the counter-based PRNG of ``jax.random``.

Reproduces, bit for bit, the functions of ``jax.random`` that the token
pipeline draws from, in JAX's default *partitionable* threefry mode:

  * :func:`prng_key` — ``PRNGKey(seed)``: the key ``(0, seed & 0xFFFFFFFF)``
    (without x64, JAX keeps the low 32 bits of the seed);
  * :func:`fold_in` — ``fold_in(key, data)``: the hash of ``(0, data)``
    under ``key``;
  * :func:`split` — ``split(key, n)``: key ``i`` is the hash of the 64-bit
    counter ``i`` split into ``(hi, lo)`` words;
  * :func:`uniform` — float32 ``uniform(key, shape)``: element ``i`` takes the
    two words of the hash of counter ``i``, XORs them, keeps the top 23 bits
    as a mantissa in ``[1, 2)`` and subtracts 1.

A key is a pair of ints in ``[0, 2**32)``.  The words are int64 tensors
masked to 32 bits after every add and shift (PyTorch's uint32 arithmetic is
thin), so the rounds are exact on any device.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

__all__ = ["fold_in", "hash_words", "prng_key", "random_bits", "split", "uniform"]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK32


def hash_words(key: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key``; int64 tensors holding uint32 values in, the same out."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def _one(key, hi: int, lo: int) -> tuple[int, int]:
    y0, y1 = hash_words(key, torch.tensor([hi], dtype=torch.int64), torch.tensor([lo], dtype=torch.int64))
    return int(y0[0]), int(y1[0])


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` (JAX without x64)."""
    return (0, int(seed) & _MASK32)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    return _one(key, 0, int(data) & _MASK32)


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)`` in partitionable mode."""
    y0, y1 = hash_words(key, torch.zeros(num, dtype=torch.int64), torch.arange(num, dtype=torch.int64))
    return [(int(a), int(b)) for a, b in zip(y0.tolist(), y1.tolist())]


def uniform(key: tuple[int, int], shape) -> torch.Tensor:
    """float32 ``jax.random.uniform(key, shape)`` in ``[0, 1)``, on the CPU."""
    n = int(np.prod(shape))
    i = torch.arange(n, dtype=torch.int64)
    y0, y1 = hash_words(key, i >> 32, i & _MASK32)
    bits = ((y0 ^ y1) >> 9) | 0x3F800000  # 23 mantissa bits under the exponent of 1.0
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(tuple(shape))


def _rotl32_(v: torch.Tensor, r: int, tmp: torch.Tensor) -> torch.Tensor:
    """``v`` rotated left by ``r`` in place, as uint32 bits held in int32
    (``>>`` of an int32 is arithmetic: the sign bits shifted in are masked off)."""
    torch.bitwise_right_shift(v, 32 - r, out=tmp)
    tmp.bitwise_and_((1 << r) - 1)
    return v.bitwise_left_shift_(r).bitwise_or_(tmp)


def _i32(v: int) -> int:
    """A uint32 value as the int32 of the same bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def random_bits(key: tuple[int, int], start: int, count: int, device=None) -> torch.Tensor:
    """The 32 random bits of elements ``[start, start + count)`` of a
    ``jax.random`` draw under ``key`` (partitionable threefry: element ``i``
    hashes the counter ``i`` and XORs the two words), as int32 on
    ``device``.  The same words as :func:`hash_words`, in int32 tensor ops
    that wrap (a quarter of the int64 version's traffic), so a big draw is
    cheap on the card."""
    i = torch.arange(start, start + count, dtype=torch.int64, device=device)
    x1 = (i & _MASK32).to(torch.int32)  # the low word's bits
    x0 = (i >> 32).to(torch.int32)
    del i
    k0, k1 = key
    ks = (_i32(k0), _i32(k1), _i32(k0 ^ k1 ^ _PARITY))
    x0.add_(ks[0])
    x1.add_(ks[1])
    tmp = torch.empty_like(x0)
    for r_i in range(5):
        for r in _ROTATIONS[r_i % 2]:
            x0.add_(x1)
            _rotl32_(x1, r, tmp).bitwise_xor_(x0)
        x0.add_(ks[(r_i + 1) % 3])
        x1.add_(_i32((ks[(r_i + 2) % 3] + r_i + 1) & _MASK32))
    return x0.bitwise_xor_(x1)
