"""Magnetic field from a density-scaled vector potential (reference
magnetic_field.c, Bonafede+ 2010).

JAX counterpart: ``toycluster_tpu/models/bfield.py``.  A_i = max over
gas halos of (rho_model/rho0)^eta, the same in all three components
(magnetic_field.c:33-69); B = rot(A) by the SPH curl over the candidate
lists of either engine (``stream_curl``, sph.c:216-300);
then a global normalisation to Bfld_Norm with per-particle caps (18 uG
main halos, 2 uG subhalos, magnetic_field.c:71-131).  A failure of the
curl raises: there is no fallback path.
"""

from __future__ import annotations

import torch

from ..ops import blocks as blk
from ..ops.stream_pair import (pack_curl_sources, padded_cluster,
                               stream_curl)
from ..particles import HaloArrays, Particles, gas_density
from ..scene import Scene
from . import positions as pos_mod
from . import sph as sph_mod

BMAX = 18e-6       # magnetic_field.c:4
BMAX_SUB = 2e-6    # magnetic_field.c:113-114


def set_vector_potential(scene: Scene, ha: HaloArrays, parts: Particles
                         ) -> Particles:
    cfg = scene.config
    n_gas = parts.n_gas
    cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                 if cfg.double_beta_cool_cores else None)
    pos = parts.pos[:n_gas]
    a_max = torch.zeros((n_gas,), dtype=torch.float32, device=pos.device)
    mass_gas = ha.mass_gas.tolist()
    for j in range(ha.n_halos):
        if mass_gas[j] <= 0:
            continue
        r = torch.linalg.vector_norm(pos - (ha.d_com[j] + scene.boxhalf),
                                     dim=-1)
        a_j = (gas_density(r, ha, j, cool_core) / ha.rho0[j]) \
            ** float(cfg.bfld_eta)
        a_max = torch.maximum(a_max, a_j)
    return parts.replace(apot=a_max[:, None].expand(-1, 3).contiguous())


def normalise_field(scene: Scene, ha: HaloArrays, bfld, pos_gas):
    """Scale so max|B| sqrt(3) -> Bfld_Norm, then cap.  The reference caps
    by the DM ownership rule (it passes the particle index as the type
    argument, magnetic_field.c:109); that branch is applied uniformly."""
    max_b = torch.sqrt((bfld ** 2).sum(dim=-1).max())
    bfld = bfld * (scene.config.bfld_norm / max_b / 3.0 ** 0.5)
    owner = pos_mod.halo_containing_dm(pos_gas - scene.boxhalf, ha,
                                       scene.sub_first, scene.boxsize)
    bmax = torch.where(owner > 1, torch.full_like(bfld[:, 0], BMAX_SUB),
                       torch.full_like(bfld[:, 0], BMAX))
    b2 = (bfld ** 2).sum(dim=-1)
    scale = torch.where(b2 > bmax * bmax,
                        bmax / torch.sqrt(torch.clamp(b2, min=1e-45)),
                        torch.ones_like(b2))
    return bfld * scale[:, None]


def _curl_inputs(scene, parts, bi):
    """The curl's (nb, 8, 128) sources, receivers in block layout and
    per-lane rows, in the sorted order of ``bi``, and on the card the
    kernel's source records and chunk table, packed once for every call
    (the CPU path reads none)."""
    n_gas = parts.n_gas
    nb = bi.n_blocks

    def pad(x):
        return sph_mod.pad_sorted(x, bi.order, bi.n_padded)

    h_s = pad(parts.hsml[:n_gas])
    rho_s = pad(parts.rho[:n_gas])
    vf_s = pad(parts.var_hsml_fac[:n_gas])
    apot_s = pad(parts.apot[:n_gas])
    pos_t = bi.pos.reshape(nb, blk.BLOCK, 3).transpose(1, 2).contiguous()
    valid_b = bi.valid.to(torch.float32).reshape(nb, 1, blk.BLOCK)
    ap_t = apot_s.reshape(nb, blk.BLOCK, 3).transpose(1, 2).contiguous()
    src8 = torch.cat([pos_t, valid_b, ap_t,
                      torch.zeros_like(valid_b)], dim=1).contiguous()
    wfac = torch.where(bi.valid, -float(scene.mpart_gas) * vf_s / rho_s,
                       torch.zeros_like(rho_s)).reshape(nb, blk.BLOCK)
    packed = (pack_curl_sources(src8, float(scene.boxsize))
              if src8.is_cuda else None)
    return src8, pos_t, h_s.reshape(nb, blk.BLOCK), wfac, ap_t, packed


def sph_curl(scene, parts, state: sph_mod.NeighbourState):
    """SPH curl of parts.apot through the state's lists: one
    ``stream_curl`` over every row's superblock list (the stream
    engine), or one block-list ``stream_curl`` per count class and one
    in superblock mode over the far-tail rows (the count-class engine)."""
    n_gas = parts.n_gas
    bi = state.index
    src8, pos_t, h_b, wfac, ap_t, packed = _curl_inputs(scene, parts, bi)

    def curl(ids, rows, cnt, sb_mode):
        # the count classes and the far tail run on padded rows
        idc = slice(None) if ids is None else torch.clamp(ids, min=0).long()
        cluster = None if ids is None else padded_cluster(rows, sb_mode)
        return (stream_curl(src8, rows, cnt, pos_t[idc], h_b[idc],
                            wfac[idc], ap_t[idc], float(scene.mpart_gas),
                            float(scene.boxsize),
                            kernel=scene.config.sph_kernel,
                            sb_mode=sb_mode, cluster=cluster,
                            packed=packed),)

    if state.sb:
        (out,) = curl(None, state.cand.idx, state.cand.count, True)
    else:
        (out,) = sph_mod.run_classed(
            state, lambda ids, rows, cnt, m: curl(ids, rows, cnt, False),
            lambda ids, sb_rows, sb_cnt: curl(ids, sb_rows, sb_cnt, True))
    bfld = torch.zeros((n_gas, 3), dtype=torch.float32, device=out.device)
    bfld[bi.order] = out.reshape(-1, 3)[:n_gas]
    return bfld


def make_magnetic_field(scene: Scene, ha: HaloArrays, parts: Particles,
                        state: sph_mod.NeighbourState | None = None, *,
                        engine: str = "stream") -> Particles:
    """The B-field stage (magnetic_field.c:12-26) on ``engine``.  Needs
    solved rho/hsml; ``state`` reuses the density stage's structure
    (built by the same engine), else a gather-range structure is built
    at the final positions."""
    sph_mod.check_engine(engine)
    n_gas = parts.n_gas
    if n_gas == 0:
        return parts
    parts = set_vector_potential(scene, ha, parts)
    if state is None:
        build = (sph_mod.build_neighbours if engine == "stream"
                 else sph_mod.build_neighbours_blocks)
        state = build(parts.pos[:n_gas], parts.hsml[:n_gas], scene.boxsize)
    elif state.sb != (engine == "stream"):
        raise ValueError(f"the neighbour state was not built by the "
                         f"{engine} engine")
    bfld = sph_curl(scene, parts, state)
    bfld = normalise_field(scene, ha, bfld, parts.pos[:n_gas])
    return parts.replace(bfld=bfld)
