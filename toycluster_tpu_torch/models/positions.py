"""Position sampling.

JAX counterpart: ``toycluster_tpu/models/positions.py``.  The reference's
per-particle rejection loops (positions.c:25-133) become oversampled
batch rejection: each round draws one batch of iid candidates from an
explicit ``torch.Generator``, tests acceptance per lane and keeps the
accepted lanes in draw order, so the kept prefix follows exactly the
reference's conditional distribution.  Positions are sampled around each
halo's centre; ``shift_origin`` moves them into the periodic box
(setup.c:427-500).
"""

from __future__ import annotations

import sys
import warnings

import numpy as np
import torch

from .. import constants as const
from ..ops.interp import SplineTable, spline_eval
from ..particles import HaloArrays, Particles, empty_particles, gas_density
from ..scene import Scene

MAX_REJECT_ROUNDS = 4096  # safety cap; the reference loops unboundedly


def uniform(gen, n):
    return torch.rand((n,), generator=gen, device=gen.device)


def sphere_dirs(gen, n):
    """Isotropic unit vectors via (theta, phi) draws (positions.c:58-65)."""
    cos_t = 2.0 * uniform(gen, n) - 1.0
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * const.PI * uniform(gen, n)
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], dim=-1)


def halo_containing_gas(pos_abs, ha: HaloArrays, boxsize, cool_core=None):
    """The halo owning a gas particle at absolute centred coordinates:
    the largest beta-model density among non-stripped halos with
    r < R_sample_gas (positions.c:363-385); -1 outside the box."""
    n = pos_abs.shape[0]
    best = torch.zeros((n,), dtype=torch.int32, device=pos_abs.device)
    rho_max = torch.zeros((n,), dtype=pos_abs.dtype, device=pos_abs.device)
    stripped = ha.is_stripped.tolist()
    for j in range(ha.n_halos):
        r = torch.linalg.vector_norm(pos_abs - ha.d_com[j], dim=-1)
        rho = gas_density(r, ha, j, cool_core)
        ok = (rho > rho_max) & (r < ha.r_sample_gas[j]) & (not stripped[j])
        best = torch.where(ok, torch.full_like(best, j), best)
        rho_max = torch.where(ok, rho, rho_max)
    oob = (pos_abs > boxsize).any(dim=-1)  # positions.c:337-338
    return torch.where(oob, torch.full_like(best, -1), best)


def halo_containing_dm(pos_abs, ha: HaloArrays, sub_first, boxsize):
    """DM ownership: halo 1 if within its sampling radius and x > 0, else
    the first subhalo whose sampling radius contains the point, else 0
    (positions.c:342-361); -1 outside the box."""
    n = pos_abs.shape[0]
    best = torch.zeros((n,), dtype=torch.int32, device=pos_abs.device)
    if ha.n_halos > 1 and sub_first > 1:
        r1 = torch.linalg.vector_norm(pos_abs - ha.d_com[1], dim=-1)
        best = torch.where((r1 < ha.r_sample_dm[1]) & (pos_abs[:, 0] > 0),
                           torch.full_like(best, 1), best)
    # the first matching subhalo wins: scan high to low
    for j in range(ha.n_halos - 1, max(sub_first, 0) - 1, -1):
        rj = torch.linalg.vector_norm(pos_abs - ha.d_com[j], dim=-1)
        best = torch.where(rj < ha.r_sample_dm[j], torch.full_like(best, j),
                           best)
    oob = (pos_abs > boxsize).any(dim=-1)
    return torch.where(oob, torch.full_like(best, -1), best)


def _rejection_fill(n, draw, p_est=0.92):
    """Draw rounds of ``draw(m) -> (cand (m, 3), ok (m,))`` until n lanes
    are accepted; round sizes follow the measured acceptance rate.
    Returns (pos (n, 3), n_filled)."""
    kept, filled = [], 0
    for _ in range(MAX_REJECT_ROUNDS):
        m = max(int((n - filled) / max(p_est, 0.01) * 1.08), 1024)
        cand, ok = draw(m)
        acc = cand[ok]
        p_est = max(acc.shape[0] / m, 0.01)
        acc = acc[:n - filled]
        kept.append(acc)
        filled += acc.shape[0]
        if filled >= n:
            break
    pos = torch.cat(kept)
    if filled < n:
        pos = torch.cat([pos, pos.new_zeros((n - filled, 3))])
    return pos, filled


def sample_halo_dm(gen, ha: HaloArrays, i: int, n: int, sub_first: int,
                   boxsize: float):
    """Hernquist inverse-CDF sampling with foreign-halo rejection
    (positions.c:48-88)."""
    a, qmax = float(ha.a_hernq[i]), float(ha.mass_corr_fac[i])

    def draw(m):
        dirs = sphere_dirs(gen, m)
        sq = torch.sqrt(uniform(gen, m) * qmax)
        cand = dirs * (a * sq / (1.0 - sq))[:, None]
        ok = halo_containing_dm(cand + ha.d_com[i], ha, sub_first,
                                boxsize) == i
        return cand, ok

    return _rejection_fill(n, draw)


def sample_halo_gas(gen, ha: HaloArrays, i: int, n: int, boxsize: float,
                    cool_core=None):
    """Beta-model sampling by inverting the tabulated M(<r), with
    foreign-halo and out-of-box rejection (positions.c:90-133)."""
    table = SplineTable(ha.minv_x[i], ha.minv_y[i], ha.minv_m2[i])
    mass_gas = float(ha.mass_gas[i])

    def draw(m):
        dirs = sphere_dirs(gen, m)
        r = spline_eval(table, uniform(gen, m) * mass_gas)
        cand = dirs * r[:, None]
        owner = halo_containing_gas(cand + ha.d_com[i], ha, boxsize,
                                    cool_core)
        inside = (torch.abs(cand) <= boxsize / 2.0).all(dim=-1)
        return cand, (owner == i) & inside

    return _rejection_fill(n, draw)


def make_positions(gen, scene: Scene, ha: HaloArrays) -> Particles:
    """Sample all halos; returns Particles with centred per-halo
    coordinates (gas first, then DM, both grouped by halo,
    setup.c:253-264)."""
    if scene.sub_first < scene.nhalos:
        raise NotImplementedError(
            "substructure sampling is not ported yet")
    cfg = scene.config
    dev = ha.d_com.device
    cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                 if cfg.double_beta_cool_cores else None)
    parts = empty_particles(scene.npart_gas, scene.npart_dm, dev)
    gas, gas_halo, dm, dm_halo = [], [], [], []
    for i, h in enumerate(scene.halos):
        for n, kind, chunks, halos in ((h.npart_gas, "gas", gas, gas_halo),
                                       (h.npart_dm, "dm", dm, dm_halo)):
            if not n:
                continue
            if kind == "gas":
                pos, filled = sample_halo_gas(gen, ha, i, n, scene.boxsize,
                                              cool_core)
            else:
                pos, filled = sample_halo_dm(gen, ha, i, n, scene.sub_first,
                                             scene.boxsize)
            if filled < n:
                warnings.warn(
                    f"halo {i} {kind} sampling under-filled after bounded "
                    f"rejection rounds: {n - filled} lanes left at the "
                    f"halo centre", RuntimeWarning, stacklevel=2)
            chunks.append(pos)
            halos.append(torch.full((n,), i, dtype=torch.int32, device=dev))
    pos = torch.cat(gas + dm) if gas + dm else parts.pos
    halo = torch.cat(gas_halo + dm_halo) if gas + dm else parts.halo
    return parts.replace(pos=pos, halo=halo)


def shift_origin(parts: Particles, ha: HaloArrays, boxsize: float
                 ) -> Particles:
    """Move halos to their CoM offsets, put the origin at the box corner
    and wrap periodically (setup.c:427-500).  The bulk velocities that
    the reference adds here are added by the velocity stage
    (velocities.add_bulk_velocities)."""
    pd = parts.pos + ha.d_com[parts.halo.long()] + boxsize / 2.0
    return parts.replace(pos=pd - torch.floor(pd / boxsize) * boxsize)


def reassign_gas_to_halos(parts: Particles, ha: HaloArrays, boxsize: float,
                          cool_core=None):
    """Post-relaxation halo membership and a stable re-sort of the gas
    block by halo id (positions.c:264-329).  Returns (particles, per-halo
    gas counts)."""
    n_gas = parts.n_gas
    owner = halo_containing_gas(parts.pos[:n_gas] - boxsize / 2.0, ha,
                                boxsize, cool_core)
    order = torch.argsort(owner, stable=True)
    counts = torch.bincount(torch.clamp(owner, min=0).long(),
                            minlength=ha.n_halos)

    def perm(arr):
        if arr.shape[0] == 0:
            return arr
        return torch.cat([arr[:n_gas][order], arr[n_gas:]])

    new = parts.replace(
        pos=perm(parts.pos), vel=perm(parts.vel), pid=perm(parts.pid),
        halo=torch.cat([owner[order], parts.halo[n_gas:]]),
        u=perm(parts.u), rho=perm(parts.rho), hsml=perm(parts.hsml),
        var_hsml_fac=perm(parts.var_hsml_fac),
        rho_model=perm(parts.rho_model), bfld=perm(parts.bfld),
        apot=perm(parts.apot))
    return new, counts


def _census_counts(pos, halo, n_gas, centers, r200s, sub_first):
    """Per-halo (inside-gas, inside-dm, own-gas, own-dm) counts
    (positions.c:152-207)."""
    is_gas = torch.arange(pos.shape[0], device=pos.device) < n_gas
    rows = []
    for i in range(centers.shape[0]):
        own = halo == i
        member = own | ((i == 0) & (sub_first >= 0) & (halo >= sub_first))
        r2 = ((pos - centers[i]) ** 2).sum(dim=-1)
        inside = member & (r2 < r200s[i] ** 2)
        rows.append(torch.stack([(inside & is_gas).sum(),
                                 (inside & ~is_gas).sum(),
                                 (own & is_gas).sum(), (own & ~is_gas).sum()]))
    return torch.stack(rows).cpu().numpy()


def show_mass_in_r200(scene, parts, *, log=None):
    """R200 mass census (positions.c:142-216, main.c:48,60): per host halo,
    its own particles (plus every subhalo's, for halo 0) inside its R200
    sphere, the gas/DM mass budget and the effective baryon fraction.
    Returns the per-halo records."""
    msph = scene.mpart_gas * scene.units.mass / const.MSOL2CGS
    mdm = scene.mpart_dm * scene.units.mass / const.MSOL2CGS
    n_show = (scene.nhalos if scene.config.report_subhalos
              else scene.sub_first)
    dev = parts.device
    centers = torch.as_tensor(
        np.array([scene.halos[i].d_com for i in range(n_show)], np.float64),
        dtype=torch.float32, device=dev) + scene.boxhalf
    r200s = torch.as_tensor(
        np.array([scene.halos[i].r200 for i in range(n_show)]),
        dtype=torch.float32, device=dev)
    has_subs = scene.sub_first < scene.nhalos
    counts = _census_counts(parts.pos, parts.halo, parts.n_gas, centers,
                            r200s, scene.sub_first if has_subs else -1)
    records = []
    for i in range(n_show):
        h = scene.halos[i]
        n_sph, n_dm, own_sph, own_dm = (int(c) for c in counts[i])
        m200 = n_sph * msph + n_dm * mdm
        ext_gas = (own_sph - n_sph) * msph
        ext_dm = (own_dm - n_dm) * mdm
        rec = dict(halo=i, r200=h.r200, gas_mass_r200=n_sph * msph,
                   dm_mass_r200=n_dm * mdm, total_mass_r200=m200,
                   ext_gas_mass=ext_gas, ext_dm_mass=ext_dm,
                   bf_eff_r200=(n_sph * msph / (n_dm * mdm)
                                if n_dm else 0.0))
        records.append(rec)
        print(f"\nSampling of Halo <{i}> (r200 = {h.r200:g} kpc):\n"
              f"   Gas Mass in R200    = {rec['gas_mass_r200']:g} Msol \n"
              f"   DM Mass in R200     = {rec['dm_mass_r200']:g} Msol \n"
              f"   Total Mass in R200  = {m200:g} Msol \n"
              f"   External Gas Mass   = {ext_gas:g} Msol \n"
              f"   External DM  Mass   = {ext_dm:g} Msol \n"
              f"   Total External Mass = {ext_gas + ext_dm:g} Msol \n"
              f"   Effective bf in r200= {rec['bf_eff_r200']:g} ",
              file=sys.stderr, flush=True)
    if log is not None:
        log("mass_census", halos=[
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in r.items()} for r in records])
    return records
