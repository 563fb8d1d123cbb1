"""Sharded pipeline stages beyond the WVT loop: the stand-alone SPH
density, the SPH curl (B from the vector potential), the DM speeds and
velocities, the gas bulk velocities, the temperatures and the halo
position sampler, over the ranks of a ``Mesh`` (parallel/mesh.py).

JAX counterpart: ``toycluster_tpu/parallel/stages.py``.  The two pair
stages reuse the machinery of parallel/wvt_shard.py (Hilbert sort, equal
blocks, the box candidate sweep, the gathered sources): the density runs
``ops/class_pair.solve_density`` and the curl ``ops/stream_pair.
stream_curl``, both on block lists.  Collectives: ``all_gather`` for the
source fields (the reference's shared ``P[]``/``SphP[]``, sph.c:13-300)
and the results, ``pmax`` for the curl's |B| maximum (the normalisation
of magnetic_field.c:77-87 without the reference's unsynchronised fmax
race).

The elementwise stages and the samplers draw from counter-based numbers
(``utils/counter_rng``) keyed by (key, stream, global lane id) on lane
grids that do not depend on the world size, so their results are
bit-identical at any world size.  Each rank's share of a grid is a
multiple of _LANE_ALIGN lanes, so the CPU's vector loops split every
rank's lanes as they split the whole grid's.

Every function takes its inputs in full, alike on every rank, and
returns full results, equal on every rank.

Reference scope: sph.c:13-75 (stand-alone density), sph.c:216-300 (curl),
velocities.c:38-159 (velocities), temperature.c:8-44, positions.c:25-133.
"""

from __future__ import annotations

import math

import torch

from .. import constants as const
from ..models.sph import global_density_model, hard_h_cap
from ..ops.blocks import BLOCK
from ..ops.class_pair import solve_density
from ..ops.keys import hilbert_order
from ..ops.stream_pair import stream_curl
from ..utils.counter_rng import uniforms
from .mesh import Mesh
from .wvt_shard import (_XLA_SWEEPS, _blocks_t, _local_candidates, _unsort,
                        pad_for_mesh)

_CAP_FACTOR = 1.35
_LANE_QUANTUM = 512   # the world-size-independent lane grid of a round
_LANE_ALIGN = 64      # lanes of a rank's share are a multiple of this
_DIR_STREAM = 0x5EED  # the stream of the DM velocity directions
_UNSET = object()


def _sort_rows(mesh, pos, boxsize, extras=()):
    """Hilbert-sort: (this rank's rows of the sorted pos, the order, this
    rank's rows of each sorted extra)."""
    order = hilbert_order(pos, boxsize)
    return ([mesh.rows(pos[order]), order]
            + [mesh.rows(x[order]) for x in extras])


def _pad_rows(x, n, fill):
    """x padded with ``fill`` rows to n rows."""
    if x.shape[0] >= n:
        return x
    return torch.cat([x, torch.full((n - x.shape[0],) + tuple(x.shape[1:]),
                                    fill, dtype=x.dtype, device=x.device)])


def _lanes(mesh, n0):
    """Lanes of a grid of n0, padded so each rank's share is a multiple
    of _LANE_ALIGN."""
    q = _LANE_ALIGN * mesh.size
    return -(-n0 // q) * q


def _block_lists(mesh, pos_l, rad_l, rad_src, boxsize, max_cand):
    """Block candidate lists of this rank's receiver blocks over the
    gathered blocks, (cand, cnt), and the gathered sorted positions;
    raises on list overflow."""
    nbl = pos_l.shape[0] // BLOCK
    blocks_l = pos_l.reshape(nbl, BLOCK, 3)
    lo_l, hi_l = blocks_l.amin(dim=1), blocks_l.amax(dim=1)
    lo_all, hi_all = mesh.all_gather(lo_l), mesh.all_gather(hi_l)
    cand, overflow = _local_candidates(lo_l, hi_l, rad_l, lo_all, hi_all,
                                       mesh.all_gather(rad_src), boxsize,
                                       max_cand)
    if int(mesh.pmax(overflow)) > 0:
        raise RuntimeError(f"sharded candidate overflow past max_cand="
                           f"{max_cand}")
    return cand, (cand >= 0).sum(dim=1).to(torch.int32)


def sharded_density(mesh: Mesh, ha, pos_gas, hsml_prev=None, *, boxsize,
                    mpart, desnngb, kernel="wc6", max_cand=256,
                    cool_core=None):
    """Stand-alone SPH density and adaptive hsml over the mesh
    (sph.c:13-75 sharded).  Returns (rho, hsml, var_hsml_fac, wk_ngb) in
    the original order, of len(pos_gas)."""
    boxsize = float(boxsize)
    n0 = pos_gas.shape[0]
    pos, n_real = pad_for_mesh(pos_gas, mesh.size)
    n = pos.shape[0]
    if hsml_prev is None:
        hsml_prev = torch.zeros((n0,), dtype=torch.float32,
                                device=pos.device)
    hprev = _pad_rows(hsml_prev, n, 0.0)
    pos_l, order, hprev_l = _sort_rows(mesh, pos, boxsize, (hprev,))
    valid_l = mesh.rows(order < n_real)
    nbl = pos_l.shape[0] // BLOCK

    rho_model_l = global_density_model(pos_l, ha, boxsize, cool_core)
    h0_model_l = (desnngb * mpart / rho_model_l
                  / const.FOURPITHIRD) ** (1.0 / 3.0)
    h0_l = torch.where(hprev_l > 0, hprev_l, h0_model_l)
    cap_l = torch.clamp(torch.maximum(h0_l, h0_model_l) * _CAP_FACTOR,
                        max=hard_h_cap(boxsize, n_real))
    rad_l = cap_l.reshape(nbl, BLOCK).amax(dim=1)
    cand, _ = _block_lists(mesh, pos_l, rad_l, rad_l, boxsize, max_cand)
    nb_all = mesh.size * nbl
    pos_all_t = _blocks_t(mesh.all_gather(pos_l), nb_all).contiguous()
    valid_all = mesh.all_gather(valid_l).to(torch.float32).reshape(
        nb_all, 1, BLOCK)
    res = solve_density(
        pos_all_t, valid_all, cand, _blocks_t(pos_l, nbl).contiguous(),
        h0_l.reshape(nbl, BLOCK).contiguous(),
        cap_l.reshape(nbl, BLOCK).contiguous(), float(mpart), boxsize,
        kernel=kernel, desnngb=desnngb, n_sweeps=_XLA_SWEEPS)
    return tuple(_unsort(mesh.all_gather(x.reshape(-1)), order)[:n0]
                 for x in res[:4])


def sharded_curl(mesh: Mesh, pos_gas, hsml, rho, var_fac, apot, *, boxsize,
                 mpart, kernel="wc6", max_cand=256):
    """SPH curl of the vector potential over the mesh (sph.c:216-300
    sharded), through block-list ``stream_curl``.  Returns (bfld (n, 3)
    in the original order, bmax ()), bmax the global largest |B| the
    normalisation needs (magnetic_field.c:77-87)."""
    boxsize = float(boxsize)
    n0 = pos_gas.shape[0]
    pos, n_real = pad_for_mesh(pos_gas, mesh.size)
    n = pos.shape[0]
    # padded lanes are never sources (valid 0) and their rows are
    # dropped; rho 1 avoids a division by zero there
    pos_l, order, h_l, rho_l, vf_l, apot_l = _sort_rows(
        mesh, pos, boxsize, (_pad_rows(hsml, n, 0.0), _pad_rows(rho, n, 1.0),
                             _pad_rows(var_fac, n, 0.0),
                             _pad_rows(apot, n, 0.0)))
    valid_l = mesh.rows(order < n_real)
    nbl = pos_l.shape[0] // BLOCK
    rad_l = h_l.reshape(nbl, BLOCK).amax(dim=1)
    # the gather range is the receiver's own h (one-sided, tree.c:25)
    cand, cnt = _block_lists(mesh, pos_l, rad_l, torch.zeros_like(rad_l),
                             boxsize, max_cand)
    pos_t = _blocks_t(pos_l, nbl)
    ap_t = _blocks_t(apot_l, nbl)
    valid_b = valid_l.to(torch.float32).reshape(nbl, 1, BLOCK)
    src_l = torch.cat([pos_t, valid_b, ap_t, torch.zeros_like(valid_b)],
                      dim=1)
    wfac = torch.where(valid_l, -float(mpart) * vf_l / rho_l, 0.0)
    b = stream_curl(mesh.all_gather(src_l.contiguous()), cand, cnt,
                    pos_t.contiguous(), h_l.reshape(nbl, BLOCK).contiguous(),
                    wfac.reshape(nbl, BLOCK).contiguous(), ap_t.contiguous(),
                    float(mpart), boxsize, kernel=kernel,
                    sb_mode=False).reshape(-1, 3)
    b2 = torch.where(valid_l, (b * b).sum(dim=-1), 0.0)
    bmax = torch.sqrt(mesh.pmax(b2.max()))
    return _unsort(mesh.all_gather(b), order)[:n0], bmax


def _dirs_from_uniforms(u1, u2):
    """Isotropic unit vectors from two uniforms (positions.c:58-65)."""
    cos_t = 2.0 * u1 - 1.0
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * const.PI * u2
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def sharded_dm_speeds(mesh: Mesh, vt, r_dm, *, key: int):
    """DM speeds over the mesh for ONE halo's velocity tables ``vt``
    (models/velocities.build_velocity_tables): the inverse-CDF sampler
    of velocities.c:62-104's distribution, one uniform a particle from
    (key, stream 0, its global index), so the draw is bit-identical at
    any world size."""
    from ..models.eddington import RMIN
    from ..models.velocities import (VTAB_R, _invert_cdf_rows, potential,
                                     speed_cdf_table)
    n0 = r_dm.shape[0]
    r_pad = _pad_rows(r_dm, _lanes(mesh, n0), RMIN)
    r_lo = RMIN
    r_hi = max(float(r_pad.max()), r_lo * 2.0)
    cdf, ok_row = speed_cdf_table(vt, r_lo, r_hi)
    gid_l = mesh.rows(torch.arange(r_pad.shape[0], device=r_dm.device))
    r = torch.clamp(mesh.rows(r_pad), min=r_lo)
    x = torch.log(r / r_lo) / math.log(r_hi / r_lo) * (VTAB_R - 1)
    x = torch.clamp(x, 0.0, VTAB_R - 1 - 1e-4)
    row = x.to(torch.int64)
    frac = x - row
    row1 = torch.clamp(row + 1, max=VTAB_R - 1)
    uu = uniforms(key, 0, gid_l, 1)[:, 0]
    u_v = ((1.0 - frac) * _invert_cdf_rows(cdf, row, uu)
           + frac * _invert_cdf_rows(cdf, row1, uu))
    vmax = torch.sqrt(2.0 * potential(vt, r))
    v = torch.where(ok_row[row] | ok_row[row1], u_v * vmax,
                    torch.zeros_like(u_v))
    return mesh.all_gather(v)[:n0]


def sharded_dm_velocities(mesh: Mesh, vt, r_dm, *, key: int, bulk_vel):
    """Full DM velocity vectors of ONE halo over the mesh
    (velocities.c:62-117): ``sharded_dm_speeds``, isotropic directions
    from (key, _DIR_STREAM, global index), plus the halo's bulk
    velocity; bit-identical at any world size."""
    n0 = r_dm.shape[0]
    v = _pad_rows(sharded_dm_speeds(mesh, vt, r_dm, key=key),
                  _lanes(mesh, n0), 0.0)
    gid_l = mesh.rows(torch.arange(v.shape[0], device=v.device))
    u = uniforms(key, _DIR_STREAM, gid_l, 2)
    vel_l = mesh.rows(v)[:, None] * _dirs_from_uniforms(u[:, 0], u[:, 1])
    return mesh.all_gather(vel_l)[:n0] + torch.as_tensor(
        bulk_vel, dtype=torch.float32, device=v.device)


def sharded_gas_bulk(mesh: Mesh, pos_gas, gas_halo, bulk_stack, d_com,
                     sub_hh, *, sub_first, n_halos, boxhalf):
    """The gas bulk-velocity term over the mesh (velocities.c:119-151):
    each gas particle gets its halo's bulk velocity, tapered on subhalo
    gas by the WC2 weight of its distance from the subhalo's centre
    (models/velocities.gas_bulk_velocities); elementwise with the
    per-halo tables replicated, bit-identical at any world size."""
    from ..models.velocities import gas_bulk_velocities
    if d_com.shape[0] != n_halos:
        raise ValueError(f"d_com holds {d_com.shape[0]} halos, not "
                         f"{n_halos}")
    n0 = pos_gas.shape[0]
    n = _lanes(mesh, n0)
    dv_l = gas_bulk_velocities(
        mesh.rows(_pad_rows(pos_gas, n, 0.0)),
        mesh.rows(_pad_rows(gas_halo, n, 0)), bulk_stack, d_com, sub_hh,
        sub_first, boxhalf)
    return mesh.all_gather(dv_l)[:n0]


def sharded_temperature(mesh: Mesh, tables, d_com, pos_gas, gas_halo, *,
                        boxhalf):
    """Hydrostatic internal energy over the mesh (temperature.c:8-44):
    the elementwise evaluation of models/temperature against the
    stacked per-halo u(r) tables, replicated; no collective but the
    final gather, bit-identical at any world size."""
    from ..models.temperature import temperature_eval
    n0 = pos_gas.shape[0]
    n = _lanes(mesh, n0)
    u_l = temperature_eval(tables, d_com, boxhalf,
                           mesh.rows(_pad_rows(pos_gas, n, 0.0)),
                           mesh.rows(_pad_rows(gas_halo, n, -1)))
    return mesh.all_gather(u_l)[:n0]


def sharded_halo_sample(mesh: Mesh, ha, i, n, kind, *, boxsize, key: int,
                        sub_first=0, cool_core=_UNSET, p_floor=0.7,
                        max_rounds=64):
    """Position sampling of halo ``i`` over the mesh (positions.c:25-133
    sharded): each round draws a lane grid whose size depends only on
    the lanes still to fill (a multiple of _LANE_QUANTUM, padded for the
    ranks with rejected lanes), three uniforms a lane from (key, round,
    global lane id), accepts per lane, and keeps the first accepted lanes
    in global lane order, ranked through the all-gathered accepted
    counts.  The result is bit-identical at any world size, and its
    distribution is that of the sequential sampler (iid lanes, acceptance
    per lane, selection in draw order).  ``n`` (3,) positions about the
    halo's centre.

    ``cool_core`` must be given for kind="gas": the scene's (rho0_fac,
    rc_fac), or None without double-beta cool cores (the ownership test
    differs on cool-core configurations).

    The accepted lanes meet in a psum of per-rank scatter buffers: an
    O(n) replicated output, as for the one-shot IC stage in JAX."""
    from ..models.positions import halo_containing_dm, halo_containing_gas
    from ..ops.interp import SplineTable, spline_eval
    if kind not in ("dm", "gas"):
        raise ValueError(f"kind must be dm or gas, not {kind!r}")
    if kind == "gas" and cool_core is _UNSET:
        raise TypeError("sharded_halo_sample: cool_core is required for "
                        "kind='gas': pass the scene's (rho0_fac, rc_fac), "
                        "or None for configs without double_beta_cool_cores")
    if cool_core is _UNSET:
        cool_core = None
    dev = mesh.device
    out = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    got = 0
    for rnd in range(max_rounds):
        # the round's lane count on the world-size-independent grid ...
        m = -(-int((n - got) / p_floor * 1.1) // _LANE_QUANTUM) \
            * _LANE_QUANTUM
        # ... padded (never changed) for the ranks
        gid_l = mesh.rows(torch.arange(_lanes(mesh, m), device=dev))
        u = uniforms(key, rnd, gid_l, 3)
        dirs = _dirs_from_uniforms(u[:, 0], u[:, 1])
        if kind == "dm":
            sq = torch.sqrt(u[:, 2] * ha.mass_corr_fac[i])
            cand = dirs * (ha.a_hernq[i] * sq / (1.0 - sq))[:, None]
            ok = halo_containing_dm(cand + ha.d_com[i], ha, sub_first,
                                    boxsize) == i
        else:
            table = SplineTable(ha.minv_x[i], ha.minv_y[i], ha.minv_m2[i])
            cand = dirs * spline_eval(table, u[:, 2]
                                      * ha.mass_gas[i])[:, None]
            owner = halo_containing_gas(cand + ha.d_com[i], ha, boxsize,
                                        cool_core)
            ok = (owner == i) & (torch.abs(cand) <= boxsize / 2.0).all(
                dim=-1)
        # lanes past the model count are rejected, so they change no rank
        ok = ok & (gid_l < m)
        counts = mesh.all_gather(ok.sum()[None])
        rank_l = counts[:mesh.rank].sum() + torch.cumsum(ok, dim=0) - 1
        left = n - got
        tgt = torch.where(ok & (rank_l < left), rank_l, left)
        buf = torch.zeros((left + 1, 3), dtype=torch.float32, device=dev)
        buf.index_copy_(0, tgt, cand.to(torch.float32))
        out[got:] = mesh.psum(buf[:left])
        got = min(n, got + int(counts.sum()))  # one host sync a round
        if got >= n:
            return out
    raise RuntimeError(f"halo {i} under-filled after {max_rounds} rounds")
