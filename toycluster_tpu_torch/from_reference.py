"""Carry state of the JAX package across to this one.

JAX counterpart: none (the JAX package's state is the input).  The JAX
package's ``Particles``, ``HaloArrays`` and block-granular
``NeighbourState`` are handed over as dicts of NumPy arrays (e.g.
``{k: np.asarray(v) for k, v in parts._asdict().items()}``), and its
``Scene`` as its scalar fields and one dict a ``HaloModel``
(``dataclasses.asdict``), so both packages can be fed the same state, as
weights are carried across between frameworks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Config
from .cosmology import cosmology_from_config
from .models.tables import MassTable
from .particles import HaloArrays, Particles
from .scene import HaloModel, Scene
from .units import units_from_config
from .utils.splines import NaturalSpline

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


def _mass_table(d) -> MassTable | None:
    if d is None:
        return None

    def spline(k):
        return NaturalSpline(**{f: np.asarray(v, np.float64)
                                for f, v in d[k].items()})

    return MassTable(r=np.asarray(d["r"], np.float64),
                     m=np.asarray(d["m"], np.float64),
                     spline=spline("spline"), inv_spline=spline("inv_spline"),
                     r_clip=float(d["r_clip"]))


def scene_from_numpy(cfg: Config, fields: dict, halos) -> Scene:
    """The JAX package's Scene -> the port's: ``cfg`` the port's Config of
    the same run, ``fields`` the Scene's other fields (boxsize, particle
    masses and counts, ..., sub_first), ``halos`` one dict a HaloModel,
    its mass table and the table's splines nested as dicts of NumPy
    arrays (``dataclasses.asdict`` of the JAX HaloModel).  Units and
    cosmology are derived from ``cfg``."""
    cfg = cfg.validate()
    hs = []
    for h in halos:
        h = dict(h)
        h["d_com"] = tuple(float(x) for x in h["d_com"])
        h["bulk_vel"] = tuple(float(x) for x in h["bulk_vel"])
        h["mass_table"] = _mass_table(h["mass_table"])
        hs.append(HaloModel(**h))
    return Scene(config=cfg, units=units_from_config(cfg),
                 cosmo=cosmology_from_config(cfg), halos=tuple(hs), **fields)


def neighbour_state_from_numpy(index: dict, cand: dict, h_cap, *,
                               tail=None, sb=False, device="cpu"):
    """The JAX package's NeighbourState -> the port's: ``index`` and
    ``cand`` its BlockIndex and CandidateList fields as NumPy arrays (or
    scalars), ``h_cap`` (P,), ``tail`` its far-tail rows (ids (T,) with
    -1 padding rows, superblock lists (T, M_sb), counts (T,)) or None,
    ``sb`` whether the lists hold superblock ids.  Padding tail rows are
    kept, as the port pads them (id -1, list all -1, count 0)."""
    from .models.sph import NeighbourState
    from .ops.blocks import BlockIndex, CandidateList

    t = scene_arrays_from_numpy(index, device)
    bi = BlockIndex(**{f: t[f] for f in BlockIndex._fields})
    bi = bi._replace(order=bi.order.long())
    c = scene_arrays_from_numpy(
        {k: v for k, v in cand.items() if k in ("idx", "count", "sb_count")
         and v is not None}, device)
    cl = CandidateList(idx=c["idx"].contiguous(), count=c["count"],
                       overflow=int(cand["overflow"]),
                       sb_overflow=int(cand.get("sb_overflow", 0)),
                       sb_count=c.get("sb_count"))
    if tail is not None:
        tail = tuple(torch.as_tensor(np.array(x), device=device)
                     for x in tail)
    h = torch.as_tensor(np.asarray(h_cap, np.float32), device=device)
    return NeighbourState(index=bi, cand=cl, h_cap=h, tail=tail, sb=sb)
