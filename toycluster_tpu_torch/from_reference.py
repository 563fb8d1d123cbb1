"""Carry state of the JAX package across to this one.

JAX counterpart: none (the JAX package's state is the input).  The JAX
package's ``Particles`` and ``HaloArrays`` are handed over as dicts of
NumPy arrays (e.g. ``{k: np.asarray(v) for k, v in
parts._asdict().items()}``), so both packages can be fed the same state,
as weights are carried across between frameworks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .particles import HaloArrays, Particles

# NumPy dtype of the JAX state -> NumPy dtype of the tensor
_DTYPES = {np.dtype(np.float64): np.float32, np.dtype(np.float32): np.float32,
           np.dtype(np.uint32): np.int64, np.dtype(np.int64): np.int64,
           np.dtype(np.int32): np.int32, np.dtype(np.bool_): np.bool_}


def scene_arrays_from_numpy(d: dict, device="cpu") -> dict:
    """Dict of NumPy arrays -> dict of tensors on ``device``: floats as
    float32, ids as int64, int32 and bool as they are."""
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        out[k] = torch.as_tensor(np.array(a, _DTYPES[a.dtype]),
                                 device=device)
    return out


def particles_from_numpy(d: dict, device="cpu") -> Particles:
    """The JAX package's Particles fields (as NumPy) -> Particles."""
    t = scene_arrays_from_numpy(d, device)
    return Particles(**{f.name: t[f.name] for f in dataclasses.fields(
        Particles)})


def halo_arrays_from_numpy(d: dict, device="cpu") -> HaloArrays:
    """The JAX package's HaloArrays fields (as NumPy) -> HaloArrays."""
    t = scene_arrays_from_numpy(d, device)
    return HaloArrays(**{f.name: t[f.name] for f in dataclasses.fields(
        HaloArrays)})
