"""The WVT loop's model density: at every gas lane, the max over the
gas-bearing halos of each halo's beta-model gas density
(wvt_relax.c:227-256).

A CUDA tensor launches the hand-written kernel of
``csrc/density_model.cu`` once for all halos and counts the launch in
``density_model.launches``; a CPU tensor runs the plain PyTorch version
beside it (``_density_model_reference``), a loop over the halos of some
13 ops over all lanes each.  Any other device raises.  The kernel repeats
the plain version's float32 ops with PyTorch's CUDA roundings, so on the
card the two agree to the bit wherever PyTorch evaluates the power with
``powf``: PyTorch's pow special-cases a few scalar exponents (among those
a static beta gives, -0.5 and -2: betas of 1/3 and 4/3), and there the
kernel's ``powf`` may differ in the last bits.

The kernel reads the halos from a packed table (``model_table``), built on
the device with the plain version's own ops for the terms that come from
Python floats.  A caller that evaluates the model often (the WVT loop)
builds it once and passes it as ``table=``; without it each call builds
its own.

JAX counterpart: ``global_density_model`` (toycluster_tpu/models/sph.py),
a ``lax.fori_loop`` over the halos.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..particles import HaloArrays, gas_density
from .cuda_build import _check, _launch

# the table's columns, in the kernel's order: the centre (d_com + box/2),
# rcut, rcore, rho0, the exponent -1.5 beta, the cool-core bit, and the
# cool core's rho0 * rho0_fac and rcore / rc_fac
COLUMNS = ("cx", "cy", "cz", "rcut", "rcore", "rho0", "expo", "cuspy",
           "rho_cc", "rc_cc")


class ModelTable(NamedTuple):
    """The packed halos of one model density: ``tab`` (H, len(COLUMNS))
    float32 on the halos' device; ``recip``: the static beta is 2/3 (the
    closed form 1/x2); ``cool``: with the cool-core term; ``key``: the
    (halos, cool_core, beta, boxsize) it was built from."""
    tab: torch.Tensor
    recip: bool
    cool: bool
    key: tuple


def gas_halos(ha: HaloArrays):
    """Indices of the halos with gas (a host read of their masses)."""
    return tuple(j for j, m in enumerate(ha.mass_gas.tolist()) if m > 0)


def model_table(ha: HaloArrays, boxsize, halos, cool_core=None,
                beta=None) -> ModelTable:
    """The table of the halos ``halos`` (indices) for the kernel, made
    with the plain version's ops: ``d_com + boxsize / 2``, ``-1.5 *
    beta`` (a static beta's exponent: the Python float's, rounded to
    float32, as PyTorch's pow rounds it), ``rho0 * rho0_fac`` and
    ``rcore / rc_fac``.  Queues work and reads nothing back."""
    dev = ha.d_com.device
    halos = tuple(int(j) for j in halos)
    idx = torch.tensor(halos, dtype=torch.long, device=dev)
    c = ha.d_com[idx] + boxsize / 2.0
    zero = torch.zeros(len(halos), dtype=torch.float32, device=dev)
    # a static beta of 2/3 takes the closed form 1/x2 (``gas_density``)
    recip = beta is not None and abs(beta - 2.0 / 3.0) < 1e-12
    if beta is None:
        expo = -1.5 * ha.beta[idx]
    elif recip:
        expo = zero
    else:
        expo = torch.full_like(zero, -1.5 * float(beta))
    if cool_core is None:
        cuspy = rho_cc = rc_cc = zero
    else:
        rho0_fac, rc_fac = cool_core
        cuspy = ha.have_cuspy[idx]
        rho_cc = ha.rho0[idx] * rho0_fac
        rc_cc = ha.rcore[idx] / rc_fac
    tab = torch.stack([c[:, 0], c[:, 1], c[:, 2], ha.rcut[idx],
                       ha.rcore[idx], ha.rho0[idx], expo, cuspy, rho_cc,
                       rc_cc], dim=1).contiguous()
    return ModelTable(tab, recip, cool_core is not None,
                      (halos, cool_core, beta, float(boxsize)))


def _density_model_reference(pos_box, ha, boxsize, cool_core, beta, halos):
    """The plain version: the max over ``halos`` of ``gas_density`` at
    each lane's distance from the halo's centre, a halo at a time."""
    boxhalf = boxsize / 2.0
    rho = torch.zeros_like(pos_box[..., 0])
    for j in halos:
        r = torch.linalg.vector_norm(pos_box - (ha.d_com[j] + boxhalf),
                                     dim=-1)
        rho = torch.maximum(rho, gas_density(r, ha, j, cool_core, beta=beta))
    return rho


def density_model(pos_box, ha: HaloArrays, boxsize, cool_core=None,
                  beta=None, halos=None, table=None):
    """(N,) float32 model density at the (N, 3) float32 contiguous box
    positions ``pos_box``, on the device of the halo arrays ``ha``.
    ``cool_core``: (rho0_fac, rc_fac) or None; ``beta``: every gas halo's
    static beta or None (each halo's own); ``halos``: the gas halos'
    indices (``gas_halos(ha)``, a host read, by default, or the
    ``table``'s); ``table``: ``model_table`` of the same arguments."""
    dev = pos_box.device
    n = pos_box.shape[0] if pos_box.dim() else 0
    _check("pos_box", pos_box, torch.float32, (n, 3), dev)
    _check("ha.d_com", ha.d_com, torch.float32, (ha.n_halos, 3), dev)
    if halos is None:
        halos = gas_halos(ha) if table is None else table.key[0]
    halos = tuple(int(j) for j in halos)
    if table is not None and table.key != (halos, cool_core, beta,
                                           float(boxsize)):
        raise ValueError(f"table built for {table.key}, not for "
                         f"{(halos, cool_core, beta, float(boxsize))}")
    if dev.type == "cpu":
        return _density_model_reference(pos_box, ha, boxsize, cool_core,
                                        beta, halos)
    if dev.type != "cuda":
        raise ValueError(f"no density-model kernel for device {dev}")
    if table is None:
        table = model_table(ha, boxsize, halos, cool_core, beta)
    _check("table", table.tab, torch.float32, (len(halos), len(COLUMNS)),
           dev)
    rho = torch.empty((n,), dtype=torch.float32, device=dev)
    _launch("density_model", [pos_box, table.tab, rho, n, len(halos),
                              int(table.recip), int(table.cool)])
    density_model.launches += 1
    return rho


density_model.launches = 0
