"""JAX's threefry random bits in torch, bit for bit.

The tiled tracer draws its AA jitter with ``jax.random.uniform`` from
``jax.random.PRNGKey(seed)``, per tile after ``jax.random.fold_in``
(``mdapy_tpu/render/tracer_tiled.py:396-398, 511-525``).  Parity with AA on
needs the same bits, so this module repeats the JAX generator as the JAX
package runs it: the ``threefry2x32`` implementation with
``jax_threefry_partitionable`` on (the default of jax 0.5 and later), for
32-bit draws.  There

  * ``PRNGKey(seed)`` is the word pair (seed >> 32, seed & 0xFFFFFFFF);
  * ``fold_in(key, data)`` is threefry2x32 of the counter pair (0, data)
    under ``key``, both output words forming the new key;
  * the 32 random bits of element i of an output (i its row-major flat
    index) are the xor of the two words of threefry2x32 of the counter pair
    (i >> 32, i & 0xFFFFFFFF) under the key;
  * ``uniform`` keeps the top 23 bits as the mantissa of a float in [1, 2),
    subtracts 1, scales to [minval, maxval) and clamps below at minval.

The words are held as int64 tensors masked to 32 bits (torch's ``>>`` on
int32 is arithmetic), on the caller's device, and every function is
elementwise over its counters, so keys may carry leading batch dimensions
(one key per tile).  The exact AO tracer's hemisphere sampling (ROADMAP A6)
draws from the same generator.
"""

from __future__ import annotations

import torch

__all__ = ["prng_key", "fold_in", "random_bits", "uniform", "threefry2x32"]

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds: key words ``k0, k1`` and counter words
    ``x0, x1`` (int64 tensors or ints holding 32-bit values, broadcast
    together) -> the two output words."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & _M)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = ((x1 << r) & _M) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (2,) int64 words."""
    seed = int(seed) & _M
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``key`` (..., 2) and 32-bit ``data`` (an int
    or an int64 tensor broadcastable against ``key[..., 0]``) -> (..., 2)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M
    o0, o1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element as int64 in [0, 2**32): ``key`` (..., 2)
    gives an output of shape ``key.shape[:-1] + shape``, each key drawing
    its own ``shape`` block as ``jax.random.bits(key, shape)`` does."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    o0, o1 = threefry2x32(key[..., 0:1], key[..., 1:2], idx >> 32, idx & _M)
    return (o0 ^ o1).reshape(tuple(key.shape[:-1]) + tuple(shape))


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, (one_to_two - 1.0) * (hi - lo) + lo)
