"""DM velocities from the Eddington distribution function and the halo
bulk velocities (reference velocities.c:38-159).

JAX counterpart: ``toycluster_tpu/models/velocities.py`` (the batched
all-halo sampler).  The f(E) and potential tables are built on the host
in float64 (models/eddington.py).  The reference rejection-samples
p(v) ~ v^2 f(psi(r) - v^2/2) per particle with up to 90,000 draws
(velocities.c:62-95); here the same distribution is drawn by inverting
its CDF, tabulated per halo on a log-r grid, one lookup per particle.
Rows whose f(E) integrates to zero give v = 0 (the reference's
fallback, velocities.c:94).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as const
from ..ops.interp import SplineTable, batched_spline_eval, spline_eval
from ..ops.kernels import wc2
from ..particles import HaloArrays, Particles
from ..scene import Scene
from .eddington import NTABLE, RMIN, build_distribution_function
from .positions import sphere_dirs, uniform

VTAB_V = 256   # speed nodes per CDF row
VTAB_R = 512   # radius rows per halo


class VelocityTables(NamedTuple):
    """One halo's f(E) and potential, or (H, ...) stacked."""
    fE: SplineTable
    psi_gas: SplineTable        # gas potential spline (zeros if no gas)
    has_gas: torch.Tensor
    psi_rmax: torch.Tensor      # point-mass continuation beyond r_max
    r_max: torch.Tensor
    a_hernq: torch.Tensor
    mass_dm: torch.Tensor
    G: torch.Tensor


def build_velocity_tables(scene: Scene, i: int, device) -> VelocityTables:
    h = scene.halos[i]
    df = build_distribution_function(
        mass_dm=h.mass_dm, a_hernq=h.a_hernq, G=scene.units.G,
        mass_table=h.mass_table, r_sample_gas=h.r_sample_gas,
        has_gas=h.npart_gas > 0)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64),
                               dtype=torch.float32, device=device)

    if df.psi.gas is not None:
        sp = df.psi.gas.spline
        psi_gas = SplineTable(t(sp.x), t(sp.y), t(sp.m2))
        psi_rmax, r_max = t(df.psi.gas.psi_rmax), t(df.psi.gas.r_max)
    else:
        z = t(np.zeros(NTABLE))
        psi_gas = SplineTable(t(np.linspace(0.0, 1.0, NTABLE)), z, z)
        psi_rmax, r_max = t(0.0), t(1.0)
    return VelocityTables(
        fE=SplineTable(t(df.spline.x), t(df.spline.y), t(df.spline.m2)),
        psi_gas=psi_gas,
        has_gas=torch.tensor(df.psi.gas is not None, device=device),
        psi_rmax=psi_rmax, r_max=r_max, a_hernq=t(h.a_hernq),
        mass_dm=t(h.mass_dm), G=t(scene.units.G))


def potential(vt: VelocityTables, r):
    """psi(r) = G M_dm/(r+a) + psi_gas(r) of one halo
    (velocities.c:323-331,437-447)."""
    psi = vt.G * vt.mass_dm / (r + vt.a_hernq)
    inside = spline_eval(vt.psi_gas, torch.minimum(r, vt.r_max))
    outside = vt.psi_rmax * vt.r_max / torch.maximum(r, vt.r_max)
    gas = torch.where(r < vt.r_max, inside, outside)
    return psi + torch.where(vt.has_gas, gas, torch.zeros_like(gas))


def _batched_potential(vt: VelocityTables, hid, r):
    """potential() with stacked tables and per-particle halo ids."""
    psi = vt.G[hid] * vt.mass_dm[hid] / (r + vt.a_hernq[hid])
    r_max = vt.r_max[hid]
    inside = batched_spline_eval(vt.psi_gas, hid, torch.minimum(r, r_max))
    outside = vt.psi_rmax[hid] * r_max / torch.maximum(r, r_max)
    gas = torch.where(r < r_max, inside, outside)
    return psi + torch.where(vt.has_gas[hid], gas, torch.zeros_like(gas))


def speed_cdf_table(vt: VelocityTables, r_lo: float, r_hi: float):
    """Speed CDFs of one halo on a log-r grid: per radius row, the
    cumulative trapezoid of v^2 f(psi - v^2/2) over VTAB_V speeds up to
    the escape speed.  Returns (cdf (R, V), ok_row (R,))."""
    dev = vt.a_hernq.device
    r = torch.logspace(np.log10(r_lo), np.log10(r_hi), VTAB_R,
                       dtype=torch.float32, device=dev)
    psi = potential(vt, r)
    vmax = torch.sqrt(2.0 * psi)
    u = torch.linspace(0.0, 1.0, VTAB_V, dtype=torch.float32, device=dev)
    v = vmax[:, None] * u[None, :]
    e = psi[:, None] - 0.5 * v * v                         # = -E_tot
    f = torch.clamp(spline_eval(vt.fE, e.reshape(-1)).reshape(e.shape),
                    min=0.0)
    integ = v * v * f
    seg = 0.5 * (integ[:, 1:] + integ[:, :-1])
    cdf = torch.cat([torch.zeros_like(vmax)[:, None],
                     torch.cumsum(seg, dim=1)], dim=1)
    norm = cdf[:, -1:]
    return cdf / torch.clamp(norm, min=1e-30), norm[:, 0] > 0


def _invert_cdf_rows(cdf, rows, uu):
    """v/vmax for uniform draws uu against per-row CDFs (bisection on the
    VTAB_V nodes, then linear interpolation)."""
    lo = torch.zeros_like(rows)
    hi = torch.full_like(rows, VTAB_V - 1)
    for _ in range(9):  # 2^9 > VTAB_V
        mid = (lo + hi) // 2
        go_hi = uu > cdf[rows, mid]
        lo = torch.where(go_hi, mid, lo)
        hi = torch.where(go_hi, hi, mid)
    lo = torch.clamp(lo, max=VTAB_V - 2)
    c0 = cdf[rows, lo]
    c1 = cdf[rows, lo + 1]
    frac = torch.clamp((uu - c0) / torch.clamp(c1 - c0, min=1e-30), 0.0, 1.0)
    return (lo + frac) / (VTAB_V - 1)


def _stack_tables(vts):
    def stack(*xs):
        if isinstance(xs[0], SplineTable):
            return SplineTable(*(torch.stack(p) for p in zip(*xs)))
        return torch.stack(xs)
    return VelocityTables(*(stack(*field) for field in zip(*vts)))


def sample_dm_velocities(gen, scene, ha, parts, bulk):
    """All-halo DM velocities: inverse-CDF speed from the particle's halo
    rows, bounded by the exact per-particle escape speed, an isotropic
    direction, plus the halo bulk velocity."""
    n_gas = scene.npart_gas
    n_halos = scene.nhalos
    dev = parts.device
    halo = parts.halo[n_gas:].long()
    d = parts.pos[n_gas:] - (ha.d_com + scene.boxhalf)[halo]
    r = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=RMIN)
    r_his = torch.zeros((n_halos,), dtype=torch.float32, device=dev)
    r_his = r_his.scatter_reduce(0, halo, r, reduce="amax")
    r_his = torch.clamp(r_his, min=RMIN * 2.0)

    vts = [build_velocity_tables(scene, i, dev) for i in range(n_halos)]
    tabs = [speed_cdf_table(vt, RMIN, float(rh))
            for vt, rh in zip(vts, r_his.tolist())]
    cdf = torch.cat([c for c, _ in tabs])          # (H * R, V)
    ok_row = torch.cat([ok for _, ok in tabs])
    vt = _stack_tables(vts)

    x = torch.log(r / RMIN) / torch.log(r_his[halo] / RMIN) * (VTAB_R - 1)
    x = torch.clamp(x, 0.0, VTAB_R - 1 - 1e-4)
    row = x.to(torch.int64)
    frac = x - row
    flat0 = halo * VTAB_R + row
    flat1 = halo * VTAB_R + torch.clamp(row + 1, max=VTAB_R - 1)
    uu = uniform(gen, r.shape[0])
    u_v = ((1.0 - frac) * _invert_cdf_rows(cdf, flat0, uu)
           + frac * _invert_cdf_rows(cdf, flat1, uu))
    vmax = torch.sqrt(2.0 * _batched_potential(vt, halo, r))
    v = torch.where(ok_row[flat0] | ok_row[flat1], u_v * vmax,
                    torch.zeros_like(u_v))
    return v[:, None] * sphere_dirs(gen, r.shape[0]) + bulk[halo]


def add_bulk_velocities(parts: Particles, ha: HaloArrays) -> Particles:
    """The Shift_Origin bulk-velocity add (setup.c:452-467), made at the
    velocity stage.  The reference adds BulkVel here AND in
    Make_velocities (gas: velocities.c:119-151; the DM copy is
    overwritten, velocities.c:100), so host gas ends at 2x BulkVel; both
    adds are kept, in the reference's order."""
    vel = parts.vel
    if vel.shape[0] != parts.n_total:
        vel = torch.zeros((parts.n_total, 3), dtype=torch.float32,
                          device=parts.device)
    return parts.replace(vel=vel + ha.bulk_vel[parts.halo.long()])


def slow_substructure_bulk_velocities(scene: Scene, host_df, rng) -> list:
    """SLOW_SUBSTRUCTURE: each subhalo orbits like a test particle of the
    host's f(E) (velocities.c:500-565), host float64; returns the
    per-halo bulk-velocity list with the subhalo entries replaced."""
    bulks = [np.asarray(h.bulk_vel, np.float64) for h in scene.halos]
    host = scene.halos[scene.config.sub_host]
    for i in range(scene.sub_first, scene.nhalos):
        h = scene.halos[i]
        d = np.asarray(h.d_com) - np.asarray(host.d_com)
        r = float(np.linalg.norm(d))
        psi = float(host_df.psi(max(r, RMIN)))
        vmax = (2 * psi) ** 0.5
        qmax = 4 * const.PI * vmax**2 / h.mtotal * float(host_df(psi))
        v = 0.0
        for _ in range(90_000):
            lower = qmax * rng.random()
            v = vmax * rng.random()
            e_tot = 0.5 * v * v - psi
            q = 4 * const.PI * v**2 / h.mtotal * float(host_df(-e_tot))
            if q >= lower:
                break
        v *= scene.config.zero_e_orbit_frac
        ct = 2 * rng.random() - 1
        ph = 2 * const.PI * rng.random()
        st = (max(0.0, 1 - ct * ct)) ** 0.5
        bulks[i] = v * np.array([st * np.cos(ph), st * np.sin(ph), ct])
    return bulks


def gas_bulk_velocities(pos_gas, gas_halo, bulk, d_com, sub_hh, sub_first,
                        boxhalf):
    """Gas bulk velocities (velocities.c:119-151): the halo's bulk
    velocity, on subhalo gas tapered by the WC2 weight at hh = 1.1
    R_sample_gas about the subhalo's centre (velocities.c:161-167)."""
    wk = torch.ones_like(pos_gas[:, 0])
    for i in range(sub_first, d_com.shape[0]):
        hh = sub_hh[i]
        norm = 21.0 / 2.0 / const.PI / hh ** 3
        r = torch.linalg.vector_norm(pos_gas - (d_com[i] + boxhalf), dim=-1)
        wk = torch.where(gas_halo == i, wc2(r, hh) / norm, wk)
    return bulk[gas_halo.long()] * wk[:, None]


def make_velocities(gen, scene: Scene, ha: HaloArrays, parts: Particles
                    ) -> Particles:
    """DM peculiar velocities per halo, then the bulk velocities (gas of
    subhalos tapered by a WC2 weight) (velocities.c:38-159).  Under
    SLOW_SUBSTRUCTURE the subhalo bulk velocities are replaced first;
    the Shift_Origin add before them keeps the setup's."""
    parts = add_bulk_velocities(parts, ha)
    vel = parts.vel
    n_gas = scene.npart_gas
    cfg = scene.config
    bulk = ha.bulk_vel
    if (cfg.substructure and cfg.slow_substructure
            and scene.nhalos > scene.sub_first
            and any(h.npart_dm for h in scene.halos)):
        h0 = scene.halos[0]
        host_df = build_distribution_function(
            mass_dm=h0.mass_dm, a_hernq=h0.a_hernq, G=scene.units.G,
            mass_table=h0.mass_table, r_sample_gas=h0.r_sample_gas,
            has_gas=h0.npart_gas > 0)
        bulks = slow_substructure_bulk_velocities(
            scene, host_df, np.random.default_rng(cfg.seed + 99))
        bulk = torch.as_tensor(np.array(bulks), dtype=torch.float32,
                               device=parts.device)
    if parts.n_total - n_gas:
        vel = torch.cat([vel[:n_gas],
                         sample_dm_velocities(gen, scene, ha, parts, bulk)])
    if n_gas:
        sub_hh = [h.r_sample_gas * 1.1 for h in scene.halos]
        vel = torch.cat([vel[:n_gas] + gas_bulk_velocities(
            parts.pos[:n_gas], parts.halo[:n_gas], bulk, ha.d_com,
            torch.as_tensor(sub_hh, dtype=torch.float32,
                            device=parts.device),
            scene.sub_first, scene.boxhalf), vel[n_gas:]])
    return parts.replace(vel=vel)
