"""The member test and the dropped wrap of the port's solve_density and
wvt_displacement kernels, in their plain form (ops/class_pair.py:
density_keep, displacement_keep; ops/stream_pair.py: interior_rows), on
the synthetic cusp of ops/cusp.py with block lists and superblock lists:
conservative against brute force, exact zeros from every dropped block,
no wrap needed on the flagged rows, and the kept blocks against the JAX
package's chunk cross test (superblock lists) and a float64 evaluation of
the same hull gaps (both list modes).  The CUDA kernels' own test is held
against these functions on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import pytest
import torch

from test_torch_stream_skip import _fields
from toycluster_tpu.ops import pallas_pair as pp
from toycluster_tpu_torch.models.sph import expand_tail_rows
from toycluster_tpu_torch.ops import class_pair as cp
from toycluster_tpu_torch.ops import cusp
from toycluster_tpu_torch.ops import stream_pair as sp

torch.set_num_threads(2)

N = 6000                       # 47 blocks: the test drops some
BOX = cusp.BOX
QUANTUM = BOX / 2 ** 22        # the TPU's position quantum
EDGE = 0.0                     # the cusp across the periodic edge
MODES = pytest.mark.parametrize("mode", ["block", "sb"])
KERNELS = pytest.mark.parametrize("kernel", ["wc6", "m4"])
CENTRES = pytest.mark.parametrize("centre", [BOX / 2, EDGE])
# outskirts across the edge, most rows inside the box
NEAR_EDGE = pytest.mark.parametrize("centre", [BOX / 2, 100.0])


def _keeps(c, sb_mode):
    """(density kept, displacement kept, listed), each (S, E) bool."""
    dens, ok = cp.density_keep(c["pos_t"], c["valid_t"], c["cand"],
                               c["pos_t"], c["cap"], BOX, sb_mode=sb_mode)
    disp, ok2 = cp.displacement_keep(
        c["pos_t"], c["valid_t"], c["h_b3"], c["cand"], c["pos_t"], c["hm"],
        BOX, sb_mode=sb_mode)
    assert torch.equal(ok, ok2)
    assert not bool((dens & ~ok).any()) and not bool((disp & ~ok).any())
    return dens, disp, ok


@MODES
@KERNELS
@CENTRES
def test_member_test_is_conservative(mode, kernel, centre):
    """Brute force over every listed block: a block the density test
    drops holds no valid source within cap_i of any receiver lane, one the
    displacement test drops none with 0 < r < 0.5 (h_i + h_j) box -- also
    where the cusp lies across the periodic edge; and the tests do drop
    blocks."""
    sb_mode = mode == "sb"
    c = cusp.class_inputs(kernel, N, sb_mode, centre=centre)
    dens, disp, ok = _keeps(c, sb_mode)
    nb = c["pos_t"].shape[0]
    e, _ = sp.list_entries(c["cand"], nb, sb_mode)
    pos64, xi64 = c["pos_t"].double(), c["pos_t"].double()
    vj_all = c["valid_t"][:, 0] > 0.5
    hj_all = c["h_b3"][:, 0].double()
    for s in range(c["cand"].shape[0]):
        xs = pos64[e[s]]                                    # (E, 3, 128)
        d = xi64[s][None, :, :, None] - xs[:, :, None, :]
        d = d - BOX * torch.round(d / BOX)
        r = torch.sqrt((d * d).sum(1))                      # (E, 128, 128)
        vj = vj_all[e[s]][:, None, :]
        in_d = (r < c["cap"][s].double()[None, :, None]) & vj
        hbar = 0.5 * (c["hm"][s].double()[None, :, None]
                      + hj_all[e[s]][:, None, :]) * BOX
        in_x = (r < hbar) & (r > 0) & vj
        need_d = in_d.flatten(1).any(1) & ok[s]
        need_x = in_x.flatten(1).any(1) & ok[s]
        assert not bool((need_d & ~dens[s]).any()), f"row {s} density"
        assert not bool((need_x & ~disp[s]).any()), f"row {s} displacement"
    assert int(disp.sum()) < int(ok.sum())
    if sb_mode:
        assert int(dens.sum()) < int(ok.sum())


def _pruned_lists(c, sb_mode, keep, ok):
    """Block lists (superblock lists expanded) with every listed entry,
    and with the dropped ones emptied.  The last listed entry of a row
    stays, so that both runs gather the same shapes and so sum in the
    same tree."""
    nb = c["pos_t"].shape[0]
    full = expand_tail_rows(c["cand"], nb) if sb_mode else c["cand"]
    col = torch.arange(1, ok.shape[1] + 1)
    last = (ok * col).amax(dim=1, keepdim=True) == col[None]
    pruned = torch.where(keep | (last & ok), full, torch.full_like(full, -1))
    return full.contiguous(), pruned.contiguous()


@MODES
@KERNELS
@CENTRES
def test_dropped_blocks_add_exact_zeros(mode, kernel, centre):
    """The plain operators over the lists without the dropped blocks
    return the bits of the unpruned lists."""
    sb_mode = mode == "sb"
    c = cusp.class_inputs(kernel, N, sb_mode, centre=centre)
    dens, disp, ok = _keeps(c, sb_mode)
    kw = dict(kernel=kernel, sb_mode=False)
    full, pruned = _pruned_lists(c, sb_mode, dens, ok)
    if sb_mode:
        assert int((pruned >= 0).sum()) < int((full >= 0).sum())
    args = (c["pos_t"], c["h0"], c["cap"], 1.0, BOX)
    a, b = (cp._solve_density_reference(
        c["pos_t"], c["valid_t"], lst, *args, desnngb=c["desnngb"],
        n_sweeps=3, **kw) for lst in (full, pruned))
    assert torch.equal(a, b)
    full, pruned = _pruned_lists(c, sb_mode, disp, ok)
    assert int((pruned >= 0).sum()) < int((full >= 0).sum())
    a, b = (cp._wvt_displacement_reference(
        c["pos_t"], c["valid_t"], c["h_b3"], lst, c["pos_t"], c["hm"], 1.0,
        BOX, **kw) for lst in (full, pruned))
    assert torch.equal(a, b)
    assert float(a.abs().max()) > 0


@MODES
@NEAR_EDGE
def test_interior_rows_need_no_wrap(mode, centre):
    """On the rows interior_rows flags at the density range (largest cap)
    and at the displacement range, every listed pair in range lies less
    than half a box away on every axis before the wrap, so the wrap is
    the identity there; with the cusp's outskirts across the edge some
    rows are not flagged."""
    sb_mode = mode == "sb"
    c = cusp.class_inputs("wc6", N, sb_mode, centre=centre)
    xi, nb = c["pos_t"], c["pos_t"].shape[0]
    e, ok = sp.list_entries(c["cand"], nb, sb_mode)
    hj_all = c["h_b3"][:, 0]
    r_dens = c["cap"].amax(dim=1)
    r_disp = 0.5 * (c["hm"].amax(dim=1) + hj_all.max()) * BOX
    for r_pair, disp in ((r_dens, False), (r_disp, True)):
        flag = sp.interior_rows(xi, r_pair, BOX)
        assert int(flag.sum()) > 0
        if centre != BOX / 2:
            assert int(flag.sum()) < nb
        for s in torch.nonzero(flag)[:, 0].tolist():
            xs = c["pos_t"][e[s][ok[s]]]
            raw = xi[s][None, :, :, None] - xs[:, :, None, :]
            wrapped = raw - BOX * torch.round(raw * (1.0 / BOX))
            r2 = (wrapped * wrapped).sum(1)
            if disp:
                rng = 0.5 * (c["hm"][s][None, :, None]
                             + hj_all[e[s][ok[s]]][:, None, :]) * BOX
            else:
                rng = c["cap"][s][None, :, None]
            near = (r2 < rng * rng)[:, None].expand_as(raw)
            assert bool((raw[near].abs() < 0.5 * BOX).all())
            assert torch.equal(raw[near], wrapped[near])
            assert bool(((raw * raw).sum(1) >= r2).all())


def _hull_gaps(c, sb_mode):
    """Float64 hull gaps (S, E, 8, 8) of receiver chunk x member chunk,
    and the member chunks' largest valid h (S, E, 1, 8)."""
    nb = c["pos_t"].shape[0]
    w = torch.where(c["valid_t"][:, 0] > 0.5, c["h_b3"][:, 0],
                    torch.zeros_like(c["hm"]))
    tab = sp.build_chunk_tab(c["pos_t"], w, BOX).double().reshape(nb, 8, 8)
    e, _ = sp.list_entries(c["cand"], nb, sb_mode)
    ci = tab[:, None, :, None, :]
    cj = tab[e][:, :, None, :, :]
    d = ci[..., :3] - cj[..., :3]
    d = d - BOX * torch.round(d / BOX)
    gap = torch.clamp(d.abs() - (ci[..., 3:6] + cj[..., 3:6]), min=0.0)
    return torch.sqrt((gap * gap).sum(-1)), cj[..., 6]


@MODES
@KERNELS
def test_kept_blocks_match_float64_and_jax(mode, kernel):
    """The kept blocks equal a float64 evaluation of the same hull test,
    except where the deciding gap lies within two quanta of its threshold
    (the float32 test inflates its thresholds by as much); on superblock
    lists they also equal the fields of the JAX package's
    stream_skip_bits (chunk cross test), with the same exception."""
    sb_mode = mode == "sb"
    c = cusp.class_inputs(kernel, N, sb_mode)
    dens, disp, ok = _keeps(c, sb_mode)
    S = c["cand"].shape[0]
    gd, hj8 = _hull_gaps(c, sb_mode)
    near = 2 * QUANTUM
    thr_d = c["cap"].double().reshape(S, 8, -1).amax(2)[:, None, :, None]
    thr_x = 0.5 * (c["hm"].double().reshape(S, 8, -1).amax(2)[
        :, None, :, None] + hj8) * BOX
    margins = []
    for keep, thr in ((dens, thr_d), (disp, thr_x)):
        exact = (gd <= thr).flatten(2).any(2) & ok
        margin = (gd - thr).abs().flatten(2).amin(2)
        margins.append(margin)
        bad = (keep != exact) & ~(margin <= near)
        assert not bool(bad.any()), f"{int(bad.sum())} blocks"
        assert abs(int(keep.sum()) - int(exact.sum())) <= int(
            (margin <= near).sum())
    if not sb_mode:
        return
    pos_t, hm_src = c["pos_t"], c["hm_blocks"][:, 0]
    ctab_j = pp.build_chunk_tab(jnp.asarray(pos_t.numpy()),
                                jnp.asarray(hm_src.numpy()))
    nb = pos_t.shape[0]
    bits_j, _ = pp.stream_skip_bits(
        jnp.asarray(pos_t.amin(dim=2).numpy()),
        jnp.asarray(pos_t.amax(dim=2).numpy()),
        jnp.asarray(hm_src.amax(dim=1).numpy()),
        jnp.arange(nb, dtype=jnp.int32), jnp.asarray(c["cand"].numpy()),
        jnp.asarray(c["cap"].numpy()), jnp.asarray(c["hm"].numpy()), BOX,
        sb=True, chunk_tab=ctab_j)
    fj = _fields(bits_j, c["cand"].shape[1] * 8)
    bad_d = (((fj & 1) == 0) != dens) & ~(margins[0] <= near)
    bad_x = (((fj & 2) != 0) != disp) & ~(margins[1] <= near)
    assert not bool(bad_d.any()), f"{int(bad_d.sum())} density fields"
    assert not bool(bad_x.any()), f"{int(bad_x.sum())} displacement fields"


@MODES
def test_cpu_stats_and_options(mode):
    """On the CPU the wrappers run the plain versions whatever prune,
    hoist and cluster say, count no launch, and fill stats with the plain
    sweeps and the oracle's kept and listed blocks."""
    sb_mode = mode == "sb"
    c = cusp.class_inputs("m4", 1500, sb_mode)
    S = c["cand"].shape[0]
    kw = dict(kernel="m4", sb_mode=sb_mode)
    args = (c["pos_t"], c["valid_t"], c["cand"], c["pos_t"], c["h0"],
            c["cap"], 1.0, BOX)
    before = (cp.solve_density.launches, cp.wvt_displacement.launches)
    st = torch.zeros((S, 4), dtype=torch.int32)
    base = cp.solve_density(*args, desnngb=c["desnngb"], **kw)
    opt = cp.solve_density(*args, desnngb=c["desnngb"], **kw, prune=False,
                           hoist=False, cluster=8, stats=st)
    for a, b in zip(base, opt):
        assert torch.equal(a, b)
    dens, disp, ok = _keeps(c, sb_mode)
    assert bool((st[:, 0] >= 1).all())
    assert bool((st[:, 0] <= cp.SOLVE_SWEEPS).all())
    assert torch.equal(st[:, 1].long(), dens.sum(dim=1))
    assert torch.equal(st[:, 2].long(), ok.sum(dim=1))
    assert torch.equal(st[:, 3], st[:, 0] * st[:, 1])
    dargs = (c["pos_t"], c["valid_t"], c["h_b3"], c["cand"], c["pos_t"],
             c["hm"], 1.0, BOX)
    sd = torch.zeros((S, 4), dtype=torch.int32)
    assert torch.equal(cp.wvt_displacement(*dargs, **kw),
                       cp.wvt_displacement(*dargs, **kw, prune=False,
                                           cluster=1, stats=sd))
    assert bool((sd[:, 0] == 1).all())
    assert torch.equal(sd[:, 1].long(), disp.sum(dim=1))
    assert torch.equal(sd[:, 3], sd[:, 1])
    assert (cp.solve_density.launches,
            cp.wvt_displacement.launches) == before


def test_pack_sources_loses_no_valid_lane():
    """The packed records: w is the validity for the density (a source
    takes part where w > 0); for the displacement h on valid lanes -- also
    an h of 0 -- and -1 elsewhere (a source takes part where w >= 0)."""
    c = cusp.class_inputs("wc6", 1500, False)
    nb = c["pos_t"].shape[0]
    valid = c["valid_t"][:, 0] > 0.5
    assert not bool(valid.all())
    p = cp.pack_sources(c["pos_t"], c["valid_t"], None, BOX)
    assert p.src.shape == (nb, 128, 4) and p.ctab.shape == (nb, 64)
    assert torch.equal(p.src[:, :, :3], c["pos_t"].transpose(1, 2))
    assert torch.equal(p.src[:, :, 3] > 0, valid)
    h = c["h_b3"].clone()
    h[0, 0, :5] = 0.0
    p = cp.pack_sources(c["pos_t"], c["valid_t"], h, BOX)
    assert torch.equal(p.src[:, :, 3] >= 0, valid)
    assert torch.equal(p.src[:, :, 3][valid], h[:, 0][valid])
    assert float(p.w_max) == float(h[:, 0][valid].max())


def test_cluster_size_rule():
    """Rows are split while the call is short of CTAs and shares stay
    long; a list no cluster can hold raises instead of being cut."""
    assert cp._cluster_size(131, 3912, None) == 8
    assert cp._cluster_size(5000, 3912, None) == 1
    assert cp._cluster_size(100, 40, None) == 1
    assert cp._cluster_size(1, 2 * cp.MAX_SHARE, None) >= 2
    assert cp._cluster_size(7, 100, 3) == 3
    with pytest.raises(ValueError, match="exceeds"):
        cp._cluster_size(1, cp.MAX_CLUSTER * cp.MAX_SHARE + 1, None)
    with pytest.raises(ValueError, match="exceeds"):
        cp._cluster_size(1, cp.MAX_SHARE + 1, 1)
    with pytest.raises(ValueError, match="cluster must be"):
        cp._cluster_size(1, 10, 16)
