"""Physical and mathematical constants (cgs).

Values mirror the constants the reference pulls from GSL and its own macros
(the reference's src/globals.h:59-85) so that derived quantities (units,
temperatures, baryon fractions) agree to the last digit.

JAX counterpart: ``toycluster_tpu/constants.py``, host-side NumPy
without JAX, carried over unchanged so that both packages build
identical scenes.
"""

import math

# mathematical constants (globals.h:59-63)
PI = math.pi
SQRT2 = math.sqrt(2.0)
SQRT3 = 1.73205080756887719
FOURPITHIRD = 4.18879032135009765

# physical constants, cgs (GSL CGSM values; globals.h:65-70)
C_LIGHT = 2.99792458e10          # GSL_CONST_CGSM_SPEED_OF_LIGHT
K_BOLTZMANN = 1.3806504e-16      # GSL_CONST_CGSM_BOLTZMANN
M_PROTON = 1.67262164e-24        # GSL_CONST_CGSM_MASS_PROTON
M_ELECTRON = 9.10938188e-28      # GSL_CONST_CGSM_MASS_ELECTRON
GRAV = 6.673e-8                  # GSL_CONST_CGSM_GRAVITATIONAL_CONSTANT

# unit conversions (globals.h:72-76)
MSOL2CGS = 1.98892e33
KPC2CGS = 3.08568025e21
K2EV = 1.5 * 8.617343e-5
DEG2RAD = PI / 180.0

# chemistry (globals.h:78-85)
H_FRAC = 0.76
HE_FRAC = 1.0 - H_FRAC
U_MOL = 4.0 / (5.0 * H_FRAC + 3.0)
N2NE = (H_FRAC + 0.5 * HE_FRAC) / (2.0 * H_FRAC + 0.75 * HE_FRAC)
Y_HELIUM = HE_FRAC / (4.0 * H_FRAC)
MEAN_MOL_WEIGHT = (1.0 + 4.0 * Y_HELIUM) / (1.0 + 3.0 * Y_HELIUM + 1.0)
ADIABATIC_INDEX = 5.0 / 3.0

# code parameters (globals.h:31-57)
R200_TO_RMAX_RATIO = 3.75
MAXHALOS = 4096
ZERO_ENERGY_ORBIT_FRACTION_SUB = 1.0

# SPH neighbour contract (globals.h:40-52): WC6 default / M4 cubic spline
DESNNGB_WC6 = 295
DESNNGB_M4 = 50
NNGBDEV = 0.05


def desnngb(kernel: str) -> int:
    """Kernel-weighted neighbour-number target (globals.h:42-49)."""
    return DESNNGB_M4 if kernel == "m4" else DESNNGB_WC6
