"""Whether the last IC of the window is correct, against the plain
reference (``benchref``).

The judge reads the program's finished particle set only to judge it.
From the par it works out the scene again itself (``benchref.scene``:
box, gas particle mass, halos), and on a sample of gas lanes drawn from
the seed it computes, over every gas particle as a source, in float64:

* ``rho_rel``: the largest relative gap between the program's density
  and the direct sum at the program's positions and smoothing lengths
  (the engine's density kernels);
* ``ngb_miss``: the share of lanes whose kernel-weighted neighbour count
  at the program's smoothing lengths lies more than 0.06 from DESNNGB
  (the smoothing-length solve; the program's contract keeps 99.9% of the
  lanes within 0.05, and 0.01 is room for its float32 sums);
* ``relax_mad``: the median absolute deviation of rho / rho_model
  about its median, with the reference's density and its own model
  density: the scatter that the WVT relaxation removes;
* ``relax_err``: the median of |rho / (k rho_model) - 1|, k the gas's
  mass over the model's mass in the box (``mass_budget``): the level of
  the relaxed density against the model's;
* ``bfld_rel``: the largest gap between the program's magnetic field and
  the reference's SPH curl of its own vector potential, scaled by one
  factor fitted over the sampled lanes, as a share of the curl's rms
  (the curl kernel), over the lanes that no cap can have touched;
* ``bfld_norm``: that factor against the normalisation max |B| sqrt(3)
  = Bfld_Norm, with the reference's largest curl over the gas lanes
  where its analytic curl is largest (the field's normalisation);
* ``u_rel``: the largest relative gap between the program's internal
  energy and the reference's hydrostatic u(r) of the lane's owner halo
  (``benchref.hydro``; the temperatures' tables);
* ``vdisp_rel``: the largest relative gap between the mean square of
  the DM's y and z velocities, about each halo's mean, and two thirds
  of the reference's Jeans <v^2>, over radial bins of equal counts
  (the velocities' f(E) tables);
* ``count_gap``: the particles of each kind and of each halo's DM that
  the program made, against the scene's counts, the non-finite values of
  every field, and the gas lanes whose field passes its cap (exact:
  limit 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchref import hydro
from benchref import sph as ref

BMAX = 18e-6        # the field caps (magnetic_field.c:4, 113-114)
BMAX_SUB = 2e-6
NGB_MARGIN = 0.06
NORM_CANDIDATES = 1024
BUDGET_GRID = 256
VDISP_BINS = 16


def scene_facts(scene):
    """The plain numbers of a reference scene that the judge needs."""
    cfg = scene.config

    def halo(h):
        return dict(center=tuple(float(x) for x in h.d_com), rho0=h.rho0,
                    rcore=h.rcore, rcut=h.rcut, beta=h.beta,
                    cuspy=bool(h.have_cuspy), r_sample_gas=h.r_sample_gas,
                    stripped=bool(h.is_stripped), mass_dm=h.mass_dm,
                    a_hernq=h.a_hernq, has_gas=h.npart_gas > 0,
                    npart_dm=int(h.npart_dm))

    return dict(boxsize=float(scene.boxsize), mpart=float(scene.mpart_gas),
                npart_gas=int(scene.npart_gas), npart_dm=int(scene.npart_dm),
                desnngb=int(cfg.desnngb), kernel=cfg.sph_kernel,
                eta=float(cfg.bfld_eta), bfld=bool(cfg.bfld_norm),
                bfld_norm=float(cfg.bfld_norm), G=float(scene.units.G),
                no_rcut_in_t=bool(cfg.no_rcut_in_t),
                cool_core=((cfg.rho0_fac, cfg.rc_fac)
                           if cfg.double_beta_cool_cores else None),
                halos=[halo(h) for h in scene.halos if h.mass_gas > 0],
                all_halos=[halo(h) for h in scene.halos])


def sample_lanes(n_gas, n, seed):
    """``n`` distinct gas lanes drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed % (2**63))
    return torch.randperm(n_gas, generator=gen)[:min(n, n_gas)]


def _blocks(n, size):
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


class _Slabs:
    """The gas sorted by x: the sources that can lie within ``reach`` of
    a block of lanes are those of the x-slab around it (periodic), so
    each block sums over its slab and not over the whole box.  Every
    pair within reach is in the slab: the sums are the same."""

    def __init__(self, src, boxsize):
        self.x, order = torch.sort(src[:, 0].contiguous())
        self.src, self.box = src[order], boxsize

    def near(self, pos_q, reach):
        lo = float(pos_q[:, 0].min()) - reach
        hi = float(pos_q[:, 0].max()) + reach
        if hi - lo >= self.box:
            return self.src
        spans = [(max(lo, 0.0), min(hi, self.box))]
        if lo < 0:
            spans.append((lo + self.box, self.box))
        if hi > self.box:
            spans.append((0.0, hi - self.box))
        parts = []
        for a, b in spans:
            i = int(torch.searchsorted(self.x, a))
            j = int(torch.searchsorted(self.x, b, right=True))
            parts.append(self.src[i:j])
        return torch.cat(parts) if len(parts) > 1 else parts[0]


def judge(out, facts, seed, lanes, device, *, block=128, control=None,
          vbin=100_000):
    """The judged numbers of a finished set ``out`` (a dict of host
    tensors: pos, vel, u, rho, hsml, bfld, halo; gas first).  Returns
    {name: value}.  ``vbin``: the fewest DM particles of a radial bin.

    ``control``, a dtype below float64, runs the precision control: at
    the sampled lanes the reference takes the program's place, computed
    in that dtype: the smoothing lengths handed on in it, the density
    and the curl summed in it, u(r) read at radii in it and rounded to
    it, <v^2>(r) integrated in it; the judge then reads those as it reads
    the program's."""
    n_gas = out["rho"].shape[0]
    res = {"count_gap": float(_count_gap(out, facts, n_gas))}
    if n_gas == 0:
        return res
    f64 = torch.float64
    box = facts["boxsize"]
    src = out["pos"][:n_gas].to(device=device, dtype=f64)
    idx = sample_lanes(n_gas, lanes, seed)
    # lanes in x order, so that a block of them has a narrow slab
    idx = idx[torch.argsort(out["pos"][idx, 0])]
    pos_q = src[idx.to(device)]
    slabs = _Slabs(src, box)
    h_q = out["hsml"][idx].to(device=device, dtype=f64)
    rho_p = out["rho"][idx].to(device=device, dtype=f64)
    b_p = out["bfld"][idx].to(device=device, dtype=f64) if facts["bfld"] \
        else None
    pos_np = out["pos"][idx].double().numpy()
    u_p = out["u"][idx].double().numpy()
    if control is not None:
        h_q, rho_p, b_p = _control(facts, slabs, pos_q, h_q, b_p, control,
                                   block)
        u_p = _energy(facts, pos_np, control)[0]
    rho_r, wk_r, vf_r = _density(facts, slabs, pos_q, h_q, block)
    res["rho_rel"] = float((torch.abs(rho_p - rho_r) / rho_r).max())
    res["ngb_miss"] = float((torch.abs(wk_r - facts["desnngb"])
                             > NGB_MARGIN).double().mean())
    ratio = rho_r / ref.model_density(pos_q, facts["halos"], box,
                                      facts["cool_core"])
    res["relax_mad"] = float(torch.abs(ratio - ratio.median()).median())
    budget = n_gas * facts["mpart"] / mass_budget(facts, device)
    res["relax_err"] = float(torch.abs(ratio / budget - 1.0).median())
    if b_p is not None:
        c = _curl(facts, slabs, pos_q, h_q, rho_r, vf_r, block)
        res["bfld_rel"], scale = _bfld_rel(b_p, c)
        res["bfld_norm"] = _bfld_norm(facts, slabs, src, out, scale, block)
    res["u_rel"] = _u_rel(facts, pos_np, u_p)
    vd = _vdisp_rel(facts, out, n_gas, vbin, control)
    if vd is not None:
        res["vdisp_rel"] = vd
    return res


def _count_gap(out, facts, n_gas):
    """The particles of each kind and each halo's DM against the scene's
    counts, the non-finite values, and the gas lanes past the field's
    largest cap."""
    n_total = out["pos"].shape[0]
    nonfinite = sum(int((~torch.isfinite(v.double())).sum())
                    for v in out.values() if v.numel())
    halo_dm = out["halo"][n_gas:].long()
    per_halo = torch.bincount(halo_dm.clamp(min=0),
                              minlength=len(facts["all_halos"]))
    gap = (abs(n_gas - facts["npart_gas"])
           + abs(n_total - n_gas - facts["npart_dm"]) + nonfinite
           + int((halo_dm < 0).sum())
           + sum(abs(int(c) - h["npart_dm"]) for c, h in
                 zip(per_halo.tolist(), facts["all_halos"])))
    if facts["bfld"] and n_gas:
        gap += int((torch.linalg.vector_norm(out["bfld"].double(), dim=-1)
                    > BMAX * (1 + 1e-5)).sum())
    return gap


def _density(facts, slabs, pos_q, h_q, block, acc=None):
    """The reference's (rho, wkNgb, grad-h factor) at the lanes."""
    outs = [torch.empty_like(h_q) for _ in range(3)]
    for b in _blocks(len(pos_q), block):
        near = slabs.near(pos_q[b], float(h_q[b].max()))
        vals = ref.density(pos_q[b], h_q[b], near, facts["boxsize"],
                           facts["mpart"], facts["desnngb"], facts["kernel"],
                           acc=acc)
        for o, v in zip(outs, vals):
            o[b] = v.to(h_q.dtype)
    return outs


_BUDGETS = {}


def mass_budget(facts, device, n=BUDGET_GRID):
    """The model density's mass in the box: the midpoint rule on an
    ``n``^3 grid, in float64, a plane at a time (kept for the next call
    on the same scene)."""
    key = repr((facts["boxsize"], facts["halos"], facts["cool_core"],
                str(device), n))
    if key not in _BUDGETS:
        _BUDGETS[key] = _grid_mass(facts, device, n)
    return _BUDGETS[key]


def _grid_mass(facts, device, n):
    box = facts["boxsize"]
    axis = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) \
        * (box / n)
    yz = torch.stack(torch.meshgrid(axis, axis, indexing="ij"),
                     -1).reshape(-1, 2)
    total = 0.0
    for x in axis.tolist():
        pos = torch.cat([torch.full_like(yz[:, :1], x), yz], 1)
        total += float(ref.model_density(pos, facts["halos"], box,
                                         facts["cool_core"]).sum())
    return total * (box / n) ** 3


def _rounded(x, dtype):
    return torch.as_tensor(x).to(dtype).double().numpy()


def _energy(facts, pos, dtype=None):
    """(u, u of the runner-up halo, near tie) of the reference at box
    positions ``pos`` (numpy (n, 3)); radii and u rounded to ``dtype``
    where given."""
    box = facts["boxsize"]
    owner, second, rho_b, rho_s = hydro.gas_owner(
        pos, facts["all_halos"], box, facts["cool_core"])

    def u_of(ids):
        u = np.zeros(len(pos))
        for j in np.unique(ids[ids >= 0]):
            h = facts["all_halos"][j]
            at = ids == j
            r = np.linalg.norm(pos[at] - (np.asarray(h["center"])
                                          + 0.5 * box), axis=-1)
            if dtype is not None:
                r = _rounded(r, dtype)
            u[at] = hydro.internal_energy(
                h, r, boxsize=box, G=facts["G"],
                cool_core=facts["cool_core"],
                no_rcut_in_t=facts["no_rcut_in_t"])
        return _rounded(u, dtype) if dtype is not None else u

    tie = (rho_s > 0) & (rho_s >= rho_b * (1 - 1e-5))
    return u_of(owner), u_of(np.where(tie, second, -1)), tie


def _u_rel(facts, pos, u_p):
    """The largest relative gap of u over the lanes; a lane whose owner
    is a near tie in float64 may take either halo's u."""
    u_r, u_alt, tie = _energy(facts, pos)

    def gap(u):
        with np.errstate(divide="ignore", invalid="ignore"):
            g = np.abs(u_p - u) / np.abs(u)
        return np.where(u == 0, np.where(u_p == 0, 0.0, np.inf), g)

    g = gap(u_r)
    g = np.where(tie, np.minimum(g, gap(u_alt)), g)
    return float(g.max())


def _vdisp_rel(facts, out, n_gas, vbin, control=None):
    """The largest gap of the DM's mean square y, z speed about each
    halo's mean against two thirds of the reference's <v^2>, over radial
    bins of equal counts, ``vbin`` particles or more a bin (up to
    VDISP_BINS a halo); None where no halo has that many.  The control
    reads the reference's <v^2> integrated in its dtype."""
    box = facts["boxsize"]
    pos = out["pos"][n_gas:].double().numpy()
    vel = out["vel"][n_gas:, 1:].double().numpy()
    halo = out["halo"][n_gas:].long().numpy()
    worst = None
    for j, h in enumerate(facts["all_halos"]):
        at = np.flatnonzero(halo == j)
        nbins = min(VDISP_BINS, len(at) // vbin)
        if nbins == 0:
            continue
        r = np.linalg.norm(pos[at] - (np.asarray(h["center"]) + 0.5 * box),
                           axis=-1)
        v = vel[at] - vel[at].mean(0)
        got = (v * v).sum(-1)
        want = hydro.dm_mean_square_speed(h, r, G=facts["G"],
                                          cool_core=facts["cool_core"])
        if control is not None:
            got = 2.0 / 3.0 * hydro.dm_mean_square_speed(
                h, r, G=facts["G"], cool_core=facts["cool_core"],
                acc=control)
        for b in np.array_split(np.argsort(r), nbins):
            gap = float(abs(got[b].mean() / (2.0 / 3.0 * want[b].mean())
                            - 1.0))
            worst = gap if worst is None else max(worst, gap)
    return worst


def _analytic_curl(facts, pos, eps=1e-2):
    """|curl (A, A, A)| of the model's vector potential at ``pos``, by
    central differences."""
    def a(p):
        return ref.vector_potential(p, facts["halos"], facts["boxsize"],
                                    facts["eta"], facts["cool_core"])

    g = []
    for k in range(3):
        d = torch.zeros(3, dtype=pos.dtype, device=pos.device)
        d[k] = eps
        g.append((a(pos + d) - a(pos - d)) / (2 * eps))
    gx, gy, gz = g
    return torch.sqrt((gy - gz) ** 2 + (gz - gx) ** 2 + (gx - gy) ** 2)


def _bfld_norm(facts, slabs, src, out, scale, block, k=NORM_CANDIDATES):
    """|M_program / M_reference - 1|: M_program = Bfld_Norm / (sqrt(3)
    scale) is the largest curl that the fitted scale implies, and
    M_reference the reference's largest curl over the candidate lanes:
    the ``k`` of the largest field, the ``k`` of the largest analytic
    curl, and the ``k`` of the largest analytic curl among the lanes at
    the subhalo cap (where the program's field hides its curl)."""
    if not scale > 0:
        return math.inf
    n = src.shape[0]
    dev = src.device
    mag = torch.cat([_analytic_curl(facts, src[b])
                     for b in _blocks(n, 1 << 20)])
    bmag = torch.linalg.vector_norm(out["bfld"].double(), dim=-1).to(dev)
    capped = torch.abs(bmag / BMAX_SUB - 1.0) < 1e-4
    k = min(k, n)
    picks = [torch.topk(bmag, k).indices, torch.topk(mag, k).indices]
    if bool(capped.any()):
        at = torch.nonzero(capped).squeeze(1)
        picks.append(at[torch.topk(mag[at], min(k, len(at))).indices])
    top = torch.unique(torch.cat(picks))
    top = top[torch.argsort(src[top, 0])]
    pos_c = src[top]
    h_c = out["hsml"][top.cpu()].to(device=dev, dtype=src.dtype)
    rho, _, vf = _density(facts, slabs, pos_c, h_c, block)
    c = _curl(facts, slabs, pos_c, h_c, rho, vf, block)
    m_ref = float(torch.linalg.vector_norm(c, dim=-1).max())
    m_prog = facts["bfld_norm"] / (math.sqrt(3.0) * scale)
    return abs(m_prog / m_ref - 1.0)


def _curl(facts, slabs, pos_q, h_q, rho_q, vf_q, block, acc=None):
    """The reference's SPH curl of its own vector potential at the
    sampled lanes."""
    box = facts["boxsize"]

    def potential(pos):
        return ref.vector_potential(pos, facts["halos"], box, facts["eta"],
                                    facts["cool_core"])

    a_q = potential(pos_q)
    c = torch.empty((len(pos_q), 3), dtype=acc or pos_q.dtype,
                    device=pos_q.device)
    for b in _blocks(len(pos_q), block):
        near = slabs.near(pos_q[b], float(h_q[b].max()))
        c[b] = ref.curl(pos_q[b], h_q[b], rho_q[b], vf_q[b], a_q[b], near,
                        potential(near), box, facts["mpart"],
                        facts["kernel"], acc=acc)
    return c.to(pos_q.dtype)


def _control(facts, slabs, pos_q, h_q, b_p, dtype, block):
    """(h, rho, B) of the precision control at the sampled lanes."""
    h_c = h_q.to(dtype).to(h_q.dtype)
    rho_c, vf_c = torch.empty_like(h_q), torch.empty_like(h_q)
    for b in _blocks(len(pos_q), block):
        near = slabs.near(pos_q[b], float(h_c[b].max()))
        rho, _, vf = ref.density(pos_q[b], h_c[b], near, facts["boxsize"],
                                 facts["mpart"], facts["desnngb"],
                                 facts["kernel"], acc=dtype)
        rho_c[b], vf_c[b] = rho.to(h_q.dtype), vf.to(h_q.dtype)
    if b_p is not None:
        c = _curl(facts, slabs, pos_q, h_c, rho_c, vf_c, block, acc=dtype)
        # in the program's units: the scale of its field
        norm = torch.linalg.vector_norm
        b_p = c * torch.median(norm(b_p, dim=-1) / norm(c, dim=-1).clamp(
            min=1e-300))
    return h_c, rho_c, b_p


def _bfld_rel(b_p, c):
    """(the field's largest gap from the fitted curl over the rms, the
    fitted scale) over the lanes under the smallest cap."""
    cc = (c * c).sum(-1)
    free = (torch.linalg.vector_norm(b_p, dim=-1) < 0.99 * BMAX_SUB) & (cc > 0)
    if not bool(free.any()):
        return math.inf, math.nan
    b_p, c, cc = b_p[free], c[free], cc[free]
    scale = torch.median((b_p * c).sum(-1) / cc)
    fit = scale * c
    rms = torch.sqrt((fit * fit).sum(-1).mean())
    return (float(torch.linalg.vector_norm(b_p - fit, dim=-1).max() / rms),
            float(scale))


def verdict(values, limits):
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number without a limit, or a limit without a number, is
    not correct."""
    checks = {k: {"value": values.get(k), "limit": limits[k]}
              for k in limits}
    ok = all(v["value"] is not None and math.isfinite(v["value"])
             and v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
