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
  * ``split(key, n)`` is the stack of threefry2x32 of the counter pairs
    (0, i) under the key, i < n (the "foldlike" split: key i of a split is
    ``fold_in(key, i)``);
  * the 64 random bits of element i are the first word of the same pair,
    shifted up by 32, or the second;
  * ``uniform`` keeps the top 23 (float32) or 52 (float64) bits as the
    mantissa of a float in [1, 2), subtracts 1, scales to [minval, maxval)
    and clamps below at minval;
  * ``normal`` is sqrt(2) * erfinv(u), u uniform in (-1, 1) from the open
    interval's lower end nextafter(-1, 0) (``jax/_src/random.py:867``).
    ``torch.erfinv`` is not XLA's polynomial, so ``normal`` is not bit for
    bit: ``tests/test_torch_tracer.py`` holds it within the bound it states.
    A float32 draw takes erfinv in float64 and rounds it once, so that the
    card and the CPU draw the same floats (their float32 erfinv differ).

The words are held as int64 tensors masked to 32 bits (torch's ``>>`` on
int32 is arithmetic), on the caller's device, and every function is
elementwise over its counters, so keys may carry leading batch dimensions
(one key per tile).  The exact tracer (``tracer.py``) draws its AA jitter,
its AO hemisphere rays and its peels' keys from the same generator
(``mdapy_tpu/render/tracer.py:251-252, 292, 333-353``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["prng_key", "fold_in", "split", "random_bits", "uniform",
           "normal", "threefry2x32"]

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_NP = {torch.float32: np.float32, torch.float64: np.float64}


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


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for one key (2,) -> (num, 2)."""
    return fold_in(key[None, :], torch.arange(int(num), device=key.device))


def _words(key: torch.Tensor, shape):
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], idx >> 32, idx & _M)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element as int64 in [0, 2**32): ``key`` (..., 2)
    gives an output of shape ``key.shape[:-1] + shape``, each key drawing
    its own ``shape`` block as ``jax.random.bits(key, shape)`` does."""
    o0, o1 = _words(key, shape)
    return (o0 ^ o1).reshape(tuple(key.shape[:-1]) + tuple(shape))


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` for float32
    or float64."""
    lead = tuple(key.shape[:-1])
    if dtype == torch.float32:
        bits = random_bits(key, shape)
        floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        o0, o1 = _words(key, shape)
        # the top 52 of the 64 bits (o0 << 32 | o1), below the exponent of 1.0
        mant = (o0 << 20) | (o1 >> 12)
        floats = (mant | 0x3FF0000000000000).view(torch.float64)
        floats = floats.reshape(lead + tuple(shape))
    else:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, (floats - 1.0) * (hi - lo) + lo)


def normal(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: sqrt(2) erfinv(u), u
    uniform on [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.array(-1.0, _NP[dtype]), _NP[dtype](0.0)))
    u = uniform(key, shape, lo, 1.0, dtype)
    sqrt2 = torch.tensor(np.array(np.sqrt(2), _NP[dtype]), device=key.device)
    return sqrt2 * torch.erfinv(u.double()).to(dtype)
