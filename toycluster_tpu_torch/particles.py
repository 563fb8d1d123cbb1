"""Particle state as tensors (struct of arrays).

JAX counterpart: ``toycluster_tpu/particles.py``.  The reference's AoS
arrays ``P[]``/``SphP[]`` (globals.h:161-180) become one small dataclass
of tensors; per-halo slices become the ``halo`` membership array.  Layout
as in the reference: gas first ([0, npart_gas)), DM after, each grouped
by halo.  ``vel``, ``bfld`` and ``apot`` stay empty (0 rows) until the
stage that fills them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .scene import Scene


@dataclass
class Particles:
    """All particles. Gas first, then DM (the snapshot block order)."""
    pos: torch.Tensor           # (N, 3) f32, box coords after shift_origin
    vel: torch.Tensor           # (N, 3) f32, or (0, 3) before velocities
    pid: torch.Tensor           # (N,) int64 particle ids
    halo: torch.Tensor          # (N,) int32 halo membership
    # gas-only fields, (Ngas,) / (Ngas, 3)
    u: torch.Tensor
    rho: torch.Tensor
    hsml: torch.Tensor
    var_hsml_fac: torch.Tensor
    rho_model: torch.Tensor
    bfld: torch.Tensor          # (Ngas, 3), or (0, 3) before the B field
    apot: torch.Tensor

    @property
    def n_total(self) -> int:
        return self.pos.shape[0]

    @property
    def n_gas(self) -> int:
        return self.u.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def replace(self, **kw) -> "Particles":
        return dataclasses.replace(self, **kw)


def empty_particles(n_gas: int, n_dm: int, device) -> Particles:
    n = n_gas + n_dm
    f32 = dict(dtype=torch.float32, device=device)
    return Particles(
        pos=torch.zeros((n, 3), **f32), vel=torch.zeros((0, 3), **f32),
        pid=torch.zeros((n,), dtype=torch.int64, device=device),
        halo=torch.zeros((n,), dtype=torch.int32, device=device),
        u=torch.zeros((n_gas,), **f32), rho=torch.zeros((n_gas,), **f32),
        hsml=torch.zeros((n_gas,), **f32),
        var_hsml_fac=torch.zeros((n_gas,), **f32),
        rho_model=torch.zeros((n_gas,), **f32),
        bfld=torch.zeros((0, 3), **f32), apot=torch.zeros((0, 3), **f32))


@dataclass
class HaloArrays:
    """Per-halo model parameters stacked as (H, ...) float32 tensors (the
    device twin of ``struct HaloProperties``, globals.h:132-159)."""
    d_com: torch.Tensor          # (H, 3)
    bulk_vel: torch.Tensor       # (H, 3)
    r_sample_gas: torch.Tensor   # (H,)
    r_sample_dm: torch.Tensor
    r200: torch.Tensor
    rcut: torch.Tensor
    rho0: torch.Tensor
    beta: torch.Tensor
    rcore: torch.Tensor
    have_cuspy: torch.Tensor     # (H,) f32 0/1
    is_stripped: torch.Tensor    # (H,) bool
    a_hernq: torch.Tensor
    mass_corr_fac: torch.Tensor
    mass_gas: torch.Tensor
    mass_dm: torch.Tensor
    # inverse cumulative gas-mass splines r(M), stacked knots (H, K)
    minv_x: torch.Tensor
    minv_y: torch.Tensor
    minv_m2: torch.Tensor

    @property
    def n_halos(self) -> int:
        return self.d_com.shape[0]


def halo_arrays_from_scene(scene: Scene, device) -> HaloArrays:
    hs = scene.halos
    H = len(hs)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64),
                               dtype=torch.float32, device=device)

    def stack(fn):
        return t([fn(h) for h in hs])

    ntab = max((h.mass_table.r.shape[0] for h in hs
                if h.mass_table is not None), default=2)
    minv = np.zeros((3, H, ntab))
    for i, h in enumerate(hs):
        if h.mass_table is not None:
            sp = h.mass_table.inv_spline
            minv[0, i], minv[1, i], minv[2, i] = sp.x, sp.y, sp.m2
        else:
            minv[0, i] = np.arange(ntab)  # degenerate but monotone
    return HaloArrays(
        d_com=stack(lambda h: h.d_com),
        bulk_vel=stack(lambda h: h.bulk_vel),
        r_sample_gas=stack(lambda h: h.r_sample_gas),
        r_sample_dm=stack(lambda h: h.r_sample_dm),
        r200=stack(lambda h: h.r200), rcut=stack(lambda h: h.rcut),
        rho0=stack(lambda h: h.rho0), beta=stack(lambda h: h.beta),
        rcore=stack(lambda h: max(h.rcore, 1e-30)),
        have_cuspy=stack(lambda h: 1.0 if h.have_cuspy else 0.0),
        is_stripped=torch.tensor([h.is_stripped for h in hs],
                                 dtype=torch.bool, device=device),
        a_hernq=stack(lambda h: h.a_hernq),
        mass_corr_fac=stack(lambda h: h.mass_corr_fac),
        mass_gas=stack(lambda h: h.mass_gas),
        mass_dm=stack(lambda h: h.mass_dm),
        minv_x=t(minv[0]), minv_y=t(minv[1]), minv_m2=t(minv[2]))


def gas_density(r, ha: HaloArrays, j: int, cool_core=None, beta=None):
    """Beta-model gas density of halo j at radius r (Gas_density_profile,
    setup.c:598-615).  A static ``beta`` of 2/3 takes the closed form
    1/(1+x^2) instead of a per-particle pow."""
    taper = 1.0 + (r / ha.rcut[j]) ** 4
    x2 = 1.0 + (r / ha.rcore[j]) ** 2
    if beta is not None and abs(beta - 2.0 / 3.0) < 1e-12:
        xp = 1.0 / x2
    elif beta is not None:
        xp = x2 ** (-1.5 * float(beta))
    else:
        xp = x2 ** (-1.5 * ha.beta[j])
    rho = ha.rho0[j] * xp / taper
    if cool_core is not None:
        rho0_fac, rc_fac = cool_core
        rho_cc = (ha.rho0[j] * rho0_fac
                  / (1.0 + (r / (ha.rcore[j] / rc_fac)) ** 2) / taper)
        rho = rho + ha.have_cuspy[j] * rho_cc
    return rho
