"""Concordance cosmology (reference src/cosmo.c).

The reference hardcodes h=0.7, Omega_M=0.3, Omega_L=0.7 (cosmo.c:11-14);
the baryon fraction comes from the parameter file.  All quantities cgs
unless noted.

JAX counterpart: ``toycluster_tpu/cosmology.py``, host-side NumPy
without JAX, carried over unchanged so that both packages build
identical scenes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from . import constants as const

# Pierpaoli+ 2001 Table 1 coefficients (cosmo.c:71-76)
_CIJ = (
    (546.67, -137.82, 94.083, -204.68, 111.51),
    (-1745.6, 627.22, -1175.2, 2445.7, -1341.7),
    (3928.8, -1519.3, 4015.8, -8415.3, 4642.1),
    (-4384.8, 1748.7, -5362.1, 11257.0, -6218.2),
    (1842.3, -765.53, 2507.7, -5210.7, 2867.5),
)


@dataclass(frozen=True)
class Cosmology:
    baryon_fraction: float = 0.17
    h_100: float = 0.7        # cosmo.c:11
    omega_m: float = 0.3      # cosmo.c:12
    omega_l: float = 0.7      # cosmo.c:13

    @property
    def omega_0(self) -> float:
        return self.omega_m + self.omega_l

    @property
    def h0_cgs(self) -> float:  # cosmo.c:18
        return 100.0 * self.h_100 * 1e5 / 1000.0 / const.KPC2CGS

    @property
    def rho_crit0(self) -> float:  # cosmo.c:20
        return 3.0 / 8.0 / const.PI / const.GRAV * self.h0_cgs**2

    def Ez(self, z: float) -> float:  # cosmo.c:64-68
        return math.sqrt(self.omega_l + (1 - self.omega_0) * (1 + z) ** 2
                         + self.omega_m * (1 + z) ** 3)

    def hubble_parameter(self, z: float) -> float:  # cosmo.c:58-61
        return self.h0_cgs * self.Ez(z)

    def critical_density(self, z: float) -> float:  # cosmo.c:43-46
        return 3 * self.hubble_parameter(z) ** 2 / (8 * const.PI * const.GRAV)

    def omega_m_z(self, z: float) -> float:  # cosmo.c:38-41
        return self.omega_m * (1 + z) ** 3 / self.Ez(z) ** 2

    def overdensity_parameter(self) -> float:
        """Delta(z) polynomial fit, Pierpaoli+ 01 / Boehringer+ 12
        (cosmo.c:78-90).  Note the reference evaluates it at z=0 parameters
        (Omega_M, Omega_L constant), so Delta is z-independent here too."""
        x = self.omega_m - 0.2
        y = self.omega_l
        result = 0.0
        for i in range(5):
            for j in range(5):
                result += _CIJ[i][j] * x**i * y**j
        return self.omega_m * result

    def a2t_cgs(self, a: float) -> float:  # cosmo.c:93-102
        h0 = 100.0 * 1e5 / const.KPC2CGS / 1000.0 * self.h_100
        return (2.0 / 3.0 / (math.sqrt(self.omega_m) * h0)
                * math.asinh((a * (self.omega_l / self.omega_m) ** (1.0 / 3.0))
                             ** 1.5))

    def t2a_cgs(self, t: float) -> float:  # cosmo.c:104-113
        h0 = 100.0 * 1e5 / const.KPC2CGS / 1000.0 * self.h_100
        return ((self.omega_m / self.omega_l) ** (1.0 / 3.0)
                * math.sinh(1.5 * math.sqrt(self.omega_l) * h0 * t)
                ** (2.0 / 3.0))


def cosmology_from_config(cfg) -> Cosmology:
    return Cosmology(baryon_fraction=cfg.baryon_fraction)
