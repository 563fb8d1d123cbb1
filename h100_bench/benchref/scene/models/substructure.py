"""Subhalo population (reference src/substructure.c, SUBSTRUCTURE flag).

Host-side construction (O(70) halos of scalar root-finds): subhalo masses
rejection-sampled from the Giocoli+ 2010 mass function down to
10*DESNNGB*(m_gas+m_dm); positions from the inverted Gao+ 2004 radial
number-density profile; per-subhalo NFW/Hernquist parameters by fixed-point
iteration of (sampling radius <-> tidal radius <-> c_nfw <-> rs); rejection
on overlap, density contrast and r < R200; Kepler-ish bulk velocities (or
host-f(E) orbits under SLOW_SUBSTRUCTURE, handled in models/velocities).

Subhalos are appended to the scene as independent HaloModels whose particle
budgets are subtracted from the host (substructure.c:378-408), so all
downstream device stages (sampling, WVT, B-field, temperatures) treat them
uniformly.

JAX counterpart: ``toycluster_tpu/models/substructure.py``, host-side
NumPy without JAX, carried over unchanged: with the same Config and seed
both packages draw from ``np.random.default_rng(seed)`` in the same order
and build the same scene.
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np

from .. import constants as const
from ..models import profiles
from ..models.tables import build_mass_table
from ..scene import HaloModel, Scene

MIN_DENSITY_CONTRAST = 3          # substructure.c:8
MAX_SUBHALOS = 70                 # substructure.c:127
ENERGY_ORBIT_FRACTION_SUBH = 0.3  # substructure.c:556


def subhalo_mass_fraction(cfg, host: HaloModel) -> float:
    """Giocoli+ 2010 (substructure.c:485-492)."""
    if cfg.third_halo_only:
        return host.mtotal200 / cfg.sub_first_mass
    return 0.22 * math.sqrt(1 + cfg.redshift)


def subhalo_mass_function(m, host_m200_dm, redshift, unit_mass):
    """dN/dm * m_host, Giocoli+ 2010 eq. 12 (substructure.c:470-482)."""
    cc, Am, alpha, beta = 1.0, 9.33e-4, -0.9, 12.2715
    m_sub = m * unit_mass / const.MSOL2CGS
    m_host = host_m200_dm * unit_mass / const.MSOL2CGS
    x = m_sub / m_host
    return m_host * math.sqrt(1 + redshift) * cc * Am \
        * m_sub ** alpha * math.exp(-beta * x ** 3)


def gao04_radius_fraction(q, c_nfw_host, rng_hi=1.0):
    """Invert the Gao+ 2004 cumulative subhalo number profile
    (1+ac) x^2.75 / (1 + ac x^2) = q by bisection (substructure.c:494-519).
    Returns x = r/R200."""
    ac = 0.244 * c_nfw_host
    left, right = 0.0, rng_hi
    for _ in range(64):
        x = 0.5 * (left + right)
        val = (1 + ac) * x ** 2.75 / (1 + ac * x ** 2)
        if val > q:
            right = x
        else:
            left = x
    return 0.5 * (left + right)


def nfw_mass(c_nfw, rs, r, *, overdensity, rho_crit0_code):
    """M_NFW(<r) with the z=0 critical density, faithful to the reference
    (substructure.c:542-552 computes rho_crit(z) but uses Rho_crit0)."""
    delta_s = overdensity / 3 * c_nfw ** 3 \
        / (math.log(1 + c_nfw) - c_nfw / (1 + c_nfw))
    rho_s = delta_s * rho_crit0_code
    return 4 * const.PI * rho_s * rs ** 3 \
        * (math.log((rs + r) / rs) - r / (rs + r))


def _bisect(f, left, right, tol=1e-3, maxit=200):
    """Root of f by bisection on the reference's |f| < tol criterion."""
    x = 0.5 * (left + right)
    for _ in range(maxit):
        x = left + 0.5 * (right - left)
        d = f(x)
        if abs(d) < tol:
            break
        if d > 0:
            right = x
        else:
            left = x
    return x


def setup_substructure(scene: Scene, seed: int = 140481) -> Scene:
    """The Setup_Substructure() pipeline stage (substructure.c:31-109)."""
    cfg = scene.config
    rng = np.random.default_rng(seed)
    host_idx = cfg.sub_host
    host = scene.halos[host_idx]
    units = scene.units
    cosmo = scene.cosmo
    sub_first = scene.sub_first

    overdensity = cosmo.overdensity_parameter()
    rho_crit0_code = cosmo.rho_crit0 / units.density
    grav_soft = scene.grav_softening
    bf = cosmo.baryon_fraction

    min_mass = 10 * cfg.desnngb * (scene.mpart_gas + scene.mpart_dm)
    frac = subhalo_mass_fraction(cfg, host)
    mass_limit = host.mass200_dm * frac
    max_sub_mass = frac * host.mass_dm / 10

    def mf(m):
        return subhalo_mass_function(m, host.mass200_dm, cfg.redshift,
                                     units.mass)

    qmax = mf(min_mass) / min_mass

    # --- masses (substructure.c:116-183) ---
    masses = []
    m_total = 0.0
    while m_total < mass_limit and len(masses) < MAX_SUBHALOS:
        m_dm = min_mass
        for _ in range(10000):
            m_dm = min_mass + rng.random() * (host.mass200_dm - min_mass)
            q = mf(m_dm) / m_dm
            lower = qmax * rng.random()
            if mass_limit - m_total < min_mass:
                m_dm = min_mass
                break
            if m_total + m_dm > 1.05 * mass_limit:
                continue
            if m_dm > max_sub_mass:
                continue
            if q >= lower:
                break
        else:
            m_dm = min_mass
        if cfg.add_third_subhalo and not masses:
            m_dm = cfg.sub_first_mass
        masses.append(m_dm)
        m_total += m_dm
        if cfg.third_halo_only:
            break

    # --- per-subhalo placement + properties (substructure.c:42-57) ---
    subs: list[HaloModel] = []
    host_com = np.array(host.d_com)

    for k, m_dm in enumerate(masses):
        idx = sub_first + k
        for attempt in range(200):
            # position from Gao+04 (substructure.c:189-220)
            if cfg.add_third_subhalo and k == 0:
                d_com = np.array(cfg.sub_first_pos)
            else:
                x = gao04_radius_fraction(rng.random(), host.c_nfw)
                r = host.r200 * x
                ct = 2 * rng.random() - 1
                ph = 2 * const.PI * rng.random()
                st = math.sqrt(max(0.0, 1 - ct * ct))
                d_com = host_com + r * np.array(
                    [st * math.cos(ph), st * math.sin(ph), ct])

            sub = _subhalo_properties(scene, idx, m_dm, d_com, host,
                                      overdensity, rho_crit0_code)

            if cfg.add_third_subhalo and k == 0:
                break
            if not _reject(sub, subs, host, scene, grav_soft):
                break
        subs.append(sub)

    # --- bulk velocities (substructure.c:554-604) ---
    if not cfg.slow_substructure:
        G = units.G
        for k, sub in enumerate(subs):
            if cfg.add_third_subhalo and k == 0:
                bulk = tuple(np.array(sub.bulk_vel)
                             + np.array(cfg.sub_first_vel))
                subs[k] = replace(sub, bulk_vel=bulk)
                continue
            d = np.array(sub.d_com) - host_com
            r = float(np.linalg.norm(d))
            plane = rng.random(3)
            plane /= np.linalg.norm(plane)
            impact = rng.random() * scene.halos[0].r200
            vdir = np.array(sub.d_com) - (host_com + impact * plane)
            vdir /= np.linalg.norm(vdir)
            v = ENERGY_ORBIT_FRACTION_SUBH * math.sqrt(
                2 * G * host.mtotal200 / r)
            subs[k] = replace(sub, bulk_vel=tuple(np.array(sub.bulk_vel)
                                                  - v * vdir))

    # --- particle numbers out of the host's budget (substructure.c:378) ---
    m_gas_p = scene.mpart_gas
    m_dm_p = scene.mpart_dm
    sub_ngas = sub_ndm = 0
    for k, sub in enumerate(subs):
        n_dm = round(sub.mass_dm / m_dm_p) if m_dm_p else 0
        n_gas = round(sub.mass_gas / m_gas_p) if m_gas_p else 0
        subs[k] = replace(sub, npart_gas=n_gas, npart_dm=n_dm)
        sub_ngas += n_gas
        sub_ndm += n_dm

    halos = list(scene.halos)
    halos[host_idx] = replace(host,
                              npart_gas=host.npart_gas - sub_ngas,
                              npart_dm=host.npart_dm - sub_ndm)
    halos.extend(subs)

    return replace(scene, halos=tuple(halos), sub_first=sub_first)


def _subhalo_properties(scene, idx, m_dm, d_com, host, overdensity,
                        rho_crit0_code) -> HaloModel:
    """set_subhalo_properties (substructure.c:278-375): fixed-point
    iteration of (sampling/tidal radius, concentration, NFW rs)."""
    cfg = scene.config
    units = scene.units
    halo0 = scene.halos[0]
    r_i = float(np.linalg.norm(np.asarray(d_com) - np.asarray(host.d_com)))
    r_i = max(r_i, 1e-3)

    a = host.a_hernq / 10.0
    r200 = host.r200
    c_nfw = rs = rsample = 0.0

    rho_host_at_ri = profiles.hernquist_density(r_i, halo0.mass_dm,
                                                halo0.a_hernq)

    for cnt in range(101):
        last_a = a

        # sampling radius: where the subhalo Hernquist density falls to the
        # local host density (substructure.c:434-456)
        def f_sample(r):
            return (profiles.hernquist_density(r, m_dm, a)
                    - rho_host_at_ri) / rho_host_at_ri
        r_samp = _bisect(lambda r: -f_sample(r), 1e-6, 10 * halo0.r200)

        # tidal radius, Tormen+ 98 (substructure.c:458-468)
        ah = host.a_hernq
        fac = (2 * r_i ** 2 / (ah + r_i) ** 2
               * (1 - ah * r_i ** 2 / (r_i + ah) ** 3))
        r_tidal = r_i * (m_dm / (host.mass200_dm * fac)) ** (1.0 / 3.0)

        rsample = max(r_samp, r_tidal)
        rsample = min(rsample, r200 * 0.5)

        # Pieri+ 2009 concentration (setup.c:529-547)
        d_vir = r_i / scene.halos[0].r200
        c_nfw = profiles.concentration_pieri09(m_dm * units.mass, d_vir,
                                               cfg.redshift)

        # NFW rs such that M_NFW(<rsample) = m_dm (substructure.c:521-540)
        def f_rs(rs_try):
            return nfw_mass(c_nfw, rs_try, rsample,
                            overdensity=overdensity,
                            rho_crit0_code=rho_crit0_code) - m_dm
        rs = _bisect(f_rs, 1e-6, 10 * halo0.r_sample_gas,
                     tol=1e-3 * max(m_dm, 1.0))

        a = profiles.hernquist_a_from_nfw(rs, c_nfw)
        r200 = rs * c_nfw
        if cfg.add_third_subhalo and idx == scene.sub_first:
            rsample = r200
        if abs((last_a - a) / a) < 1e-4:
            break

    rcut = 0.6 * rsample
    mass200_dm = nfw_mass(c_nfw, rs, r200, overdensity=overdensity,
                          rho_crit0_code=rho_crit0_code)
    bf = scene.cosmo.baryon_fraction
    mass200_gas = mass200_dm / (1 / bf - 1) if bf else 0.0
    mass_corr_fac = 1.0 / (1 + 2 * a / r200 + (a / r200) ** 2)

    beta = 2.0 / 3.0  # implicitly assumed (substructure.c:348)
    have_cuspy = bool(cfg.cuspy & (1 << idx))
    rcore = profiles.gas_core_radius(rs, have_cuspy,
                                     cfg.double_beta_cool_cores)
    rho0 = (mass200_gas / (4 * const.PI * rcore ** 3)
            / (r200 / rcore - math.atan(r200 / rcore))) if bf else 0.0

    is_stripped = False  # r_strip = 0 (substructure.c:325) -> never strips
    mass_gas = 0.0
    table = None
    if bf and rho0 > 0:
        table = build_mass_table(rho0, beta, rcore, rcut, have_cuspy,
                                 rsample)
        mass_gas = float(table.mass(rsample))

    return HaloModel(
        index=idx, mtotal200=mass200_gas + mass200_dm,
        mass200_gas=mass200_gas, mass200_dm=mass200_dm, c_nfw=c_nfw,
        rs=rs, r200=r200, a_hernq=a, rho0=rho0, beta=beta, rcore=rcore,
        rcut=rcut, r_sample_gas=rsample, r_sample_dm=rsample,
        have_cuspy=have_cuspy, is_stripped=is_stripped,
        mass_corr_fac=mass_corr_fac, mass_gas=mass_gas, mass_dm=m_dm,
        mtotal=mass_gas + m_dm, d_com=tuple(np.asarray(d_com, float)),
        bulk_vel=(0.0, 0.0, 0.0), mass_table=table)


def _reject(sub: HaloModel, placed, host, scene, grav_soft) -> bool:
    """Overlap / density-contrast / containment rejection
    (substructure.c:228-270)."""
    for other in placed:
        d = np.array(sub.d_com) - np.array(other.d_com)
        size = sub.r_sample_gas + other.r_sample_gas
        if (d @ d) < size * size:
            return True
    halo0 = scene.halos[0]
    d = np.array(sub.d_com) - np.array(host.d_com)
    r = float(np.linalg.norm(d))
    rho_host = profiles.hernquist_density(r, halo0.mass_dm, halo0.a_hernq)
    rho_sub = profiles.hernquist_density(3 * grav_soft, sub.mass_dm,
                                         sub.a_hernq)
    if rho_sub < rho_host * MIN_DENSITY_CONTRAST:
        return True
    if r > host.r200:
        return True
    return False
