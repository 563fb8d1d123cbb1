"""Space-filling-curve keys.

JAX counterpart: ``toycluster_tpu/ops/keys.py``.  A 30-bit Hilbert key
(Skilling's transpose algorithm, branch-free over the particle axis) in
int32 bit operations, and a stable argsort, in place of the reference's
128-bit Peano-Hilbert keys and heapsort (peano.c:46-126, sort.c:185-195).
The key only drives the locality of the equal-count blocks
(ops/blocks.py); the neighbour search itself is exact through bounding
boxes, so 10 bits per dimension suffice.
"""

from __future__ import annotations

import torch

KEY_BITS = 10  # per dimension


def _expand_bits10(v):
    """Spread the low 10 bits of v over 30 bits (2-bit gaps)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _axes_to_transpose(x, y, z, bits):
    """Skilling 2004 AxestoTranspose, branch-free over lanes."""
    X = [x, y, z]
    q = 1 << (bits - 1)
    while q > 1:
        P = q - 1
        for i in range(3):
            cond = (X[i] & q) != 0
            # invert X[0] where the bit is set, else exchange the low
            # bits of X[0] and X[i]
            t = (X[0] ^ X[i]) & P
            X0_inv = X[0] ^ P
            X0_exc = X[0] ^ t
            Xi_exc = X[i] ^ t
            X[0] = torch.where(cond, X0_inv, X0_exc)
            if i != 0:
                X[i] = torch.where(cond, X[i], Xi_exc)
        q >>= 1
    # Gray encode
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    q = 1 << (bits - 1)
    while q > 1:
        t = torch.where((X[2] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    return [xi ^ t for xi in X]


def hilbert_keys(pos, boxsize, bits=KEY_BITS):
    """30-bit Hilbert key per particle for positions in [0, boxsize)^3."""
    scale = (1 << bits) / boxsize
    cell = torch.clamp((pos * scale).to(torch.int32), 0, (1 << bits) - 1)
    tx, ty, tz = _axes_to_transpose(cell[:, 0], cell[:, 1], cell[:, 2],
                                    bits)
    # transposed form -> interleaved key, X[0] most significant per triplet
    return ((_expand_bits10(tx) << 2) | (_expand_bits10(ty) << 1)
            | _expand_bits10(tz))


def hilbert_order(pos, boxsize):
    """Stable permutation sorting particles along the Hilbert curve (the
    Sort_Particles_By_Peano_Key analogue, peano.c:46)."""
    return torch.argsort(hilbert_keys(pos, boxsize), stable=True)
