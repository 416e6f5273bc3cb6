"""Threefry-2x32 keys and uniforms on torch tensors.

Stands in for exactly the ``jax.random`` calls of the quantized path
(``PRNGKey``, ``split``, ``uniform`` with the default threefry2x32 impl
and partitionable counters), so the stochastic rounding of
ops/quantize.py draws the same bits as the JAX package:

  * a key is a (2,) int64 tensor of two uint32 words ``[hi, lo]``; keys
    are tiny and stay on the host, the draws are made on any device;
  * ``split_on_device`` and ``uniform_on_device`` take the key as a
    tensor on the device of the draw and never read it on the host: the
    by-node key chain of the device loops lives in their carries and is
    split inside the captured split step (same bits as ``split`` /
    ``uniform``);
  * ``prng_key(seed)`` is ``[0, seed mod 2**32]`` (a 32-bit seed);
  * ``split(key, num)`` hashes the counters ``(0, i)``, i < num, and
    stacks each hash pair ``(b1, b2)`` as the i-th key;
  * ``fold_in(key, data)`` is the hash pair of the counter ``(0, data)``
    (so the ``data``-th key of a split, for a 32-bit ``data``): the
    data-parallel learner's per-rank draws;
  * ``uniform(key, n)`` hashes the counters ``(0, i)``, i < n, takes the
    bits ``b1 ^ b2``, keeps their top 23 as the mantissa of a float in
    [1, 2) and subtracts 1.

torch.uint32 has almost no operators, so every word is carried in int64
and masked with 0xFFFFFFFF after each add and shift.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block hash (20 rounds) of the counter words
    (x0, x1) under the key (k0, k1): two int64 tensors of uint32 words.
    The key words are host ints, or int64 tensors that broadcast against
    the counters (a device key)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _words(key: torch.Tensor):
    k = key.to(torch.int64) & _MASK
    return int(k[0]), int(k[1])


def _hash_iota(key: torch.Tensor, n: int, device=None):
    k0, k1 = _words(key)
    lo = torch.arange(n, dtype=torch.int64,
                      device=key.device if device is None else device)
    return threefry2x32(k0, k1, torch.zeros_like(lo), lo)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """(2,) int64 key of a 32-bit integer seed (jax.random.PRNGKey)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) int64 keys (jax.random.split)."""
    b1, b2 = _hash_iota(key, num)
    return torch.stack([b1, b2], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """(2,) int64 key of `key` and a 32-bit integer (jax.random.fold_in):
    the threefry hash of the counter (0, data)."""
    k0, k1 = _words(key)
    lo = torch.tensor([int(data) & _MASK], dtype=torch.int64)
    b1, b2 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return torch.cat([b1, b2]).to(key.device)


def uniform(key: torch.Tensor, n: int, device=None) -> torch.Tensor:
    """(n,) float32 uniforms in [0, 1) (jax.random.uniform), computed on
    `device` (default: the key's)."""
    b1, b2 = _hash_iota(key, n, device)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def split_on_device(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(num, 2) int64 keys (jax.random.split) of a (2,) int64 key, on the
    key's device, without reading it on the host."""
    k = key & _MASK
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=1)


def uniform_on_device(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) float32 uniforms in [0, 1) (jax.random.uniform) of (..., 2)
    int64 keys, one row of n per key, on the keys' device, without reading
    them on the host."""
    k = keys & _MASK
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(k[..., 0:1], k[..., 1:2], torch.zeros_like(lo), lo)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
