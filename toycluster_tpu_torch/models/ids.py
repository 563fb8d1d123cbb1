"""Particle ID assignment (reference src/ids.c).

DM ids are sequential after the gas block; gas ids are strided with the
smallest divisor of Npart[0] that is >= 128 so an ID-based domain
decomposition stays balanced (ids.c:8-44).  Host-side, vectorised.

JAX counterpart: ``toycluster_tpu/models/ids.py``, host-side NumPy
without JAX, carried over unchanged so that both packages build
identical scenes.
"""

from __future__ import annotations

import numpy as np


def id_stride(n_gas: int) -> int:
    """Smallest divisor of n_gas >= 128 (ids.c:16-21).  The reference loop
    never terminates when n_gas < 128 has no such divisor; we fall back to
    stride n_gas (sequential ids) instead."""
    delta = 128
    while delta < n_gas and n_gas % delta:
        delta += 1
    return delta if n_gas % delta == 0 else n_gas


def make_ids(n_gas: int, n_total: int) -> np.ndarray:
    ids = np.empty(n_total, np.uint32)
    # DM: ipart+1 for ipart in [n_gas, n_total) (ids.c:12-14)
    ids[n_gas:] = np.arange(n_gas, n_total, dtype=np.uint32) + 1
    if n_gas:
        delta = id_stride(n_gas)
        # the reference's serial loop visits the id grid column-major:
        # id(k) = 1 + (k mod m) * delta + (k div m), m = n_gas/delta
        m = n_gas // delta
        k = np.arange(n_gas, dtype=np.uint32)
        ids[:n_gas] = 1 + (k % m) * delta + k // m
    return ids
