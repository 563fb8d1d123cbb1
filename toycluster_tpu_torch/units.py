"""Code unit system (reference src/unit.c).

Derived units and temperature conversions, pure functions of the three
base units given in the parameter file.

JAX counterpart: ``toycluster_tpu/units.py``, host-side NumPy
without JAX, carried over unchanged so that both packages build
identical scenes.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import constants as const


@dataclass(frozen=True)
class Units:
    length: float   # cm
    mass: float     # g
    vel: float      # cm/s

    @property
    def time(self) -> float:          # unit.c:5
        return self.length / self.vel

    @property
    def energy(self) -> float:        # unit.c:6
        return self.mass * self.vel * self.vel

    @property
    def density(self) -> float:       # unit.c:7
        return self.mass / self.length**3

    @property
    def G(self) -> float:
        """Newton's constant in code units (setup.c:27, velocities.c:44)."""
        return (const.GRAV / self.length**3 * self.mass * self.time**2)

    def u2t(self, u: float) -> float:  # unit.c:22-26
        return ((const.ADIABATIC_INDEX - 1) * u * self.vel**2
                * const.M_PROTON * const.MEAN_MOL_WEIGHT / const.K_BOLTZMANN)

    def t2u(self, temp: float) -> float:  # unit.c:27-31
        return temp / ((const.ADIABATIC_INDEX - 1) * self.vel**2
                       * const.M_PROTON * const.MEAN_MOL_WEIGHT
                       / const.K_BOLTZMANN)

    def density_cgs(self, rho: float) -> float:  # unit.c:33-36
        return rho * self.mass / self.length**3


def units_from_config(cfg) -> Units:
    return Units(length=cfg.unit_length_cm, mass=cfg.unit_mass_g,
                 vel=cfg.unit_vel_cgs)
