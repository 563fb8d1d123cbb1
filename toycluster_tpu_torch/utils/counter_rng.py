"""Counter-based random numbers: Threefry-2x32 (20 rounds) in int64
tensor arithmetic.

JAX counterpart: none as such; the JAX package's sharded samplers
(``toycluster_tpu/parallel/stages.py``) fold each global lane id into a
``jax.random`` key.  A ``torch.Generator`` draws a sequence, so a lane's
numbers would depend on how many lanes came before it on its rank; here a
lane's numbers are a pure function of (key, stream, lane id), the same
at any world size and on any device.  The bits are not JAX's.

Every word is held in an int64 tensor and kept below 2^32 by masking,
so no operation overflows.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
# Threefry-2x32 rotation constants (Salmon et al. 2011, as in JAX)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0, x1):
    """The Threefry-2x32-20 block cipher of the counters (x0, x1) (int64
    tensors of 32-bit words) under the key (k0, k1); returns two int64
    tensors of 32-bit words."""
    ks = (k0 & _M32, k1 & _M32, (_PARITY ^ k0 ^ k1) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def uniforms(key: int, stream: int, ids, n: int):
    """(len(ids), n) float32 uniforms in [0, 1) for the lane ids ``ids``
    (int64, < 2^32): lane i's numbers depend only on (key, stream,
    ids[i]).  ``stream`` (< 2^24) separates the draws of one key (rounds,
    purposes)."""
    ids = ids.to(torch.int64)
    cols = []
    for j in range(-(-n // 2)):
        ctr = torch.full_like(ids, (stream << 8) | j)
        cols.extend(threefry2x32(key, key >> 32, ids & _M32, ctr))
    bits = torch.stack(cols[:n], dim=-1)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
