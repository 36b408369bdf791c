"""Seeded draws, bit for bit those of the JAX package's ``jax.random``.

The JAX package samples with ``jax.random`` (threefry2x32, with
``jax_threefry_partitionable`` on): StochasticGreedy and
LazierThanLazyGreedy draw one uniform vector per step
(``uniform(fold_in(key, i), (n,))``), and the streaming optimizers shuffle
their arrivals by one scalar uniform per index
(``uniform(fold_in(key, j))``).  This module computes the same draws with
int64 tensor ops on any device, each 32-bit word held in an int64 and
masked back to 32 bits after every add and shift:

- a key is a pair of 32-bit words; ``prng_key(seed)`` is ``(0, seed mod
  2**32)``, as ``PRNGKey`` builds it with 64-bit integers off, and seeds of
  2**63 or more raise ``OverflowError`` as there;
- ``fold_in(key, i)`` is ``threefry(key, (0, i))``;
- element e of a draw takes the bits ``b0 ^ b1`` of ``threefry(key, (0,
  e))``; a scalar draw is element 0;
- a uniform is ``((bits >> 9) | 0x3F800000)`` read as fp32, minus 1.

The draws do not depend on what an optimizer selects, so :func:`step_bits`
draws a block of steps at once, one pass of the ~150 elementwise ops over a
(T, n) grid.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# elements of one (T, n) block of draws: 32 MiB per int64 temporary
BLOCK_ELEMS = 1 << 22


def prng_key(seed: int) -> tuple[int, int]:
    """The key ``jax.random.PRNGKey(seed)`` builds (64-bit integers off):
    the high word is dropped, the low word kept."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit in a signed 64-bit integer")
    return (0, seed & _MASK)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors (or ints) holding 32-bit
    words; the four inputs broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def fold_in(key: tuple[int, int], data) -> tuple:
    """``jax.random.fold_in(key, data)``: an int gives a key of two ints, an
    int64 tensor of data gives two tensors of key words."""
    if isinstance(data, torch.Tensor):
        k0 = torch.full_like(data, key[0])
        return threefry2x32(k0, torch.full_like(data, key[1]), torch.zeros_like(data), data)
    k0, k1 = threefry2x32(
        torch.tensor(key[0], dtype=torch.int64),
        torch.tensor(key[1], dtype=torch.int64),
        torch.tensor(0, dtype=torch.int64),
        torch.tensor(int(data) & _MASK, dtype=torch.int64),
    )
    return (int(k0), int(k1))


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """fp32 uniforms in [0, 1) from 32-bit draws, as ``jax.random.uniform``
    forms them."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def random_bits(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """(n,) int64: the 32-bit draws of ``jax.random.uniform(key, (n,))``."""
    e = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(
        torch.tensor(key[0], dtype=torch.int64, device=device),
        torch.tensor(key[1], dtype=torch.int64, device=device),
        torch.zeros_like(e),
        e,
    )
    return b0 ^ b1


def uniform(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """(n,) fp32 ``jax.random.uniform(key, (n,))``."""
    return bits_to_uniform(random_bits(key, n, device))


def step_bits(key: tuple[int, int], steps: range, n: int, device) -> torch.Tensor:
    """(len(steps), n) int64: row t holds the draws of
    ``uniform(fold_in(key, steps[t]), (n,))``, all rows in one pass."""
    s = torch.tensor(list(steps), dtype=torch.int64, device=device)
    k0, k1 = fold_in(key, s)
    e = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(e), e)
    return b0 ^ b1


def fold_in_uniforms(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """(n,) fp32: entry j is the scalar ``uniform(fold_in(key, j))``."""
    k0, k1 = fold_in(key, torch.arange(n, dtype=torch.int64, device=device))
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(k0), torch.zeros_like(k0))
    return bits_to_uniform(b0 ^ b1)


def block_steps(n: int) -> int:
    """Steps per block of :func:`step_bits` for draws of width n: as many as
    keep one int64 temporary within :data:`BLOCK_ELEMS` elements."""
    return max(1, BLOCK_ELEMS // max(n, 1))
