"""The member tests of the port's fused_wvt and stream_curl kernels in
their plain form (ops/class_pair.py: fused_keep; ops/stream_pair.py:
curl_keep), on the synthetic cusp of ops/cusp.py with block lists and
superblock lists: conservative against brute force over pairs in float64,
exact zeros from every dropped block, the kept blocks against a float64
evaluation of the same hull gaps (both list modes) and against the JAX
package's chunk cross test (stream_skip_bits, superblock lists; for the
curl at its own range, as toycluster_tpu/models/bfield.py calls it), the
kept blocks a subset of what the caller's block-box bounds keep
(class_pair.fused_bounds), the verdict per warp tile (no pair in range
in a tile that a warp skips), the cnt masking, the packed source records
and the plain versions' stats.  The CUDA kernels' own tests are held against
these functions on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import pytest
import torch

from test_torch_stream_skip import _fields, _listed
from toycluster_tpu.ops import pallas_pair as pp
from toycluster_tpu_torch.models.sph import expand_tail_rows
from toycluster_tpu_torch.ops import class_pair as cp
from toycluster_tpu_torch.ops import cusp
from toycluster_tpu_torch.ops import stream_pair as sp

torch.set_num_threads(2)

N = 6000                       # 47 blocks: the tests drop some
BOX = cusp.BOX
QUANTUM = BOX / 2 ** 22        # the TPU's position quantum
MODES = pytest.mark.parametrize("mode", ["block", "sb"])
KERNELS = pytest.mark.parametrize("kernel", ["wc6", "m4"])
OPS = pytest.mark.parametrize("op", ["fused", "curl"])


def _inputs(op, kernel, sb_mode, n=N):
    """What both member tests read, as a dict: pos (nb, 3, 128), w (nb,
    128) the validity row (hm for fused_wvt, valid for the curl), cand,
    cnt, rng (S, 128) the density range per lane (cap / hsml), hm (S, 128)
    or None, and the operator's own arrays."""
    if op == "fused":
        c = cusp.class_inputs(kernel, n, sb_mode)
        return dict(c, pos=c["pos_t"], w=c["hm_blocks"][:, 0], rng=c["cap"])
    args, kw, valid = cusp.curl_inputs(kernel, n, sb_mode=sb_mode)
    return dict(args=args, kw=kw, valid=valid, pos=args[3], w=args[0][:, 3],
                cand=args[1], cnt=args[2], rng=args[4], hm=None)


def _keeps(op, c, sb_mode, **kw):
    """(density kept, displacement kept or None, listed)."""
    if op == "fused":
        return cp.fused_keep(c["pos"], c["hm_blocks"], c["cand"], c["cnt"],
                             c["pos"], c["cap"], c["hm"], BOX,
                             sb_mode=sb_mode, **kw)
    kept, ok = sp.curl_keep(c["args"][0], c["cand"], c["cnt"], c["pos"],
                            c["rng"], BOX, sb_mode=sb_mode, **kw)
    return kept, None, ok


@OPS
@MODES
@KERNELS
def test_member_test_is_conservative(op, mode, kernel):
    """Brute force over every pair of every listed block, in float64: no
    source that takes part (hm > 0, valid > 0) lies within the density
    range (cap_i; the curl: hsml_i) of any receiver lane in a block the
    density test drops, none with 0 < r < 0.5 (hm_i + hm_j) box in one the
    displacement test drops; and the tests do drop blocks."""
    sb_mode = mode == "sb"
    c = _inputs(op, kernel, sb_mode)
    dens, disp, ok = _keeps(op, c, sb_mode)
    assert not bool((dens & ~ok).any())
    nb = c["pos"].shape[0]
    e, ok_l = sp._listed_members(c["cand"], c["cnt"], nb, sb_mode)
    assert torch.equal(ok, ok_l)
    pos64 = c["pos"].double()
    for s in range(c["cand"].shape[0]):
        d = pos64[s][None, :, :, None] - pos64[e[s]][:, :, None, :]
        d = d - BOX * torch.round(d / BOX)
        r = torch.sqrt((d * d).sum(1))                      # (E, 128, 128)
        takes_part = (c["w"][e[s]] > 0)[:, None, :]
        in_d = (r < c["rng"][s].double()[None, :, None]) & takes_part
        need_d = in_d.flatten(1).any(1) & ok[s]
        assert not bool((need_d & ~dens[s]).any()), f"row {s} density"
        if disp is not None:
            hbar = 0.5 * (c["hm"][s].double()[None, :, None]
                          + c["w"][e[s]].double()[:, None, :]) * BOX
            in_x = (r < hbar) & (r > 0) & takes_part
            need_x = in_x.flatten(1).any(1) & ok[s]
            assert not bool((need_x & ~disp[s]).any()), f"row {s} disp"
    if disp is not None:
        assert int(disp.sum()) < int(ok.sum())
    if sb_mode or op == "curl":
        assert int(dens.sum()) < int(ok.sum())


def _tile_any(in_range):
    """(E, 16) from (E, 128 receivers, 128 sources): whether a pair of the
    32 lanes and 32 sources of warp w = 4 (source quarter) + (lane
    quarter) holds."""
    E = in_range.shape[0]
    t = in_range.reshape(E, 4, 32, 4, 32).any(dim=4).any(dim=2)  # (E, q, p)
    return t.transpose(1, 2).reshape(E, 16)


@OPS
@MODES
@KERNELS
def test_warp_tiles_are_conservative(op, mode, kernel):
    """The verdict per warp tile: a block is kept where one of its 16
    tiles is; brute force over pairs in float64 finds no pair in range
    among the 32 receiver lanes and 32 sources of a tile that its warp
    skips, for either consumer; and the tiles drop pairs that the block
    verdict keeps."""
    sb_mode = mode == "sb"
    c = _inputs(op, kernel, sb_mode, n=3000)
    dens, disp, ok = _keeps(op, c, sb_mode)
    dens_t, disp_t, ok_t = _keeps(op, c, sb_mode, tiles=True)
    assert torch.equal(ok, ok_t)
    assert dens_t.shape == dens.shape + (16,)
    assert torch.equal(dens_t.any(dim=2), dens)
    assert int(dens_t.sum()) < 16 * int(dens.sum())
    if disp is not None:
        assert torch.equal(disp_t.any(dim=2), disp)
        assert int(disp_t.sum()) < 16 * int(disp.sum())
    e, _ = sp._listed_members(c["cand"], c["cnt"], c["pos"].shape[0],
                              sb_mode)
    pos64 = c["pos"].double()
    for s in range(c["cand"].shape[0]):
        d = pos64[s][None, :, :, None] - pos64[e[s]][:, :, None, :]
        d = d - BOX * torch.round(d / BOX)
        r = torch.sqrt((d * d).sum(1))                      # (E, 128, 128)
        takes_part = (c["w"][e[s]] > 0)[:, None, :]
        in_d = (r < c["rng"][s].double()[None, :, None]) & takes_part
        need = _tile_any(in_d) & ok[s][:, None]
        assert not bool((need & ~dens_t[s]).any()), f"row {s} density"
        if disp is not None:
            hbar = 0.5 * (c["hm"][s].double()[None, :, None]
                          + c["w"][e[s]].double()[:, None, :]) * BOX
            need = _tile_any((r < hbar) & (r > 0) & takes_part) \
                & ok[s][:, None]
            assert not bool((need & ~disp_t[s]).any()), f"row {s} disp"


def _margins(c, sb_mode):
    """Float64 hull gaps of receiver chunk x member chunk against their
    thresholds: per (row, entry) whether some chunk pair lies within the
    density range / the displacement range, and the smallest |gap -
    threshold| of each."""
    nb, S = c["pos"].shape[0], c["cand"].shape[0]
    tab = sp.build_chunk_tab(c["pos"], c["w"], BOX).double().reshape(nb, 8, 8)
    e, _ = sp._listed_members(c["cand"], c["cnt"], nb, sb_mode)
    ci = tab[:, None, :, None, :]
    cj = tab[e][:, :, None, :, :]
    d = ci[..., :3] - cj[..., :3]
    d = d - BOX * torch.round(d / BOX)
    gap = torch.clamp(d.abs() - (ci[..., 3:6] + cj[..., 3:6]), min=0.0)
    gd = torch.sqrt((gap * gap).sum(-1))                    # (S, E, 8, 8)
    thr = [c["rng"].double().reshape(S, 8, -1).amax(2)[:, None, :, None]]
    if c["hm"] is not None:
        thr.append(0.5 * (c["hm"].double().reshape(S, 8, -1).amax(2)[
            :, None, :, None] + cj[..., 6]) * BOX)
    return [((gd <= t).flatten(2).any(2), (gd - t).abs().flatten(2).amin(2))
            for t in thr]


@OPS
@MODES
@KERNELS
def test_kept_blocks_match_float64_and_jax(op, mode, kernel):
    """The kept blocks equal a float64 evaluation of the same hull test,
    except where the deciding gap lies within two quanta of its threshold
    (the float32 test inflates its thresholds by as much); on superblock
    lists they also equal the fields of the JAX package's stream_skip_bits
    with the chunk cross test -- for the curl called as the JAX curl calls
    it: the receivers' hsml as caps, no displacement."""
    sb_mode = mode == "sb"
    c = _inputs(op, kernel, sb_mode)
    dens, disp, ok = _keeps(op, c, sb_mode)
    near = 2 * QUANTUM
    margins = _margins(c, sb_mode)
    for keep, (exact, margin) in zip((dens, disp), margins):
        bad = (keep != (exact & ok)) & ~(margin <= near)
        assert not bool(bad.any()), f"{int(bad.sum())} blocks"
    if not sb_mode:
        return
    pos, nb = c["pos"], c["pos"].shape[0]
    listed = _listed(c["cand"], c["cnt"])
    ctab_j = pp.build_chunk_tab(jnp.asarray(pos.numpy()),
                                jnp.asarray(c["w"].numpy()))
    with_disp = c["hm"] is not None
    bits_j, _ = pp.stream_skip_bits(
        jnp.asarray(pos.amin(dim=2).numpy()),
        jnp.asarray(pos.amax(dim=2).numpy()),
        jnp.asarray(c["w"].amax(dim=1).numpy()) if with_disp else None,
        jnp.arange(nb, dtype=jnp.int32), jnp.asarray(listed.numpy()),
        jnp.asarray(c["rng"].numpy()),
        jnp.asarray(c["hm"].numpy()) if with_disp else None, BOX, sb=True,
        chunk_tab=ctab_j)
    fj = _fields(bits_j, c["cand"].shape[1] * 8)
    bad_d = (((fj & 1) == 0) != dens) & ~(margins[0][1] <= near)
    assert not bool(bad_d.any()), f"{int(bad_d.sum())} density fields"
    if with_disp:
        bad_x = (((fj & 2) != 0) != disp) & ~(margins[1][1] <= near)
        assert not bool(bad_x.any()), f"{int(bad_x.sum())} disp fields"
    else:
        assert not bool((fj & 2).any())


@MODES
@KERNELS
def test_chunk_test_keeps_a_subset_of_the_bounds(mode, kernel):
    """Chunk hulls lie inside block boxes and a chunk's cap is at most the
    row's, so what fused_keep keeps is kept by the block-box bounds of
    class_pair.fused_bounds too, up to the test's inflation of 2^-21 box;
    the chunk test is the tighter one, and ANDing the bounds into it
    changes nothing but at that edge."""
    sb_mode = mode == "sb"
    c = _inputs("fused", kernel, sb_mode)
    dens, disp, ok = _keeps("fused", c, sb_mode)
    cap_max = c["cap"].amax(dim=1)[:, None]
    by_gdist = ok & (c["gdist"] <= cap_max)
    by_dkeep = ok & c["dkeep"]
    slack = 4 * sp._INFL * BOX
    out_d = dens & ~by_gdist
    assert bool((c["gdist"][out_d] <= (cap_max + slack).expand_as(
        dens)[out_d]).all())
    reach = 0.5 * (c["hm"].amax(dim=1)[:, None]
                   + c["w"].amax(dim=1)[sp._listed_members(
                       c["cand"], c["cnt"], c["pos"].shape[0],
                       sb_mode)[0]]) * BOX
    out_x = disp & ~by_dkeep
    assert bool((c["gdist"][out_x] <= (reach + slack)[out_x]).all())
    assert int(out_d.sum()) + int(out_x.sum()) <= 2
    assert int(dens.sum()) <= int(by_gdist.sum()) + int(out_d.sum())
    assert int(disp.sum()) < int(by_dkeep.sum())
    both_d, both_x, _ = _keeps("fused", c, sb_mode, gdist=c["gdist"],
                               dkeep=c["dkeep"])
    assert torch.equal(both_d, dens & by_gdist)
    assert torch.equal(both_x, disp & by_dkeep)


@OPS
@MODES
@KERNELS
def test_dropped_blocks_add_exact_zeros(op, mode, kernel):
    """The plain operators without the dropped blocks return the bits of
    the full lists: fused_wvt with the oracle's keeps handed in as its
    bounds (which mask the pairs of the blocks they drop), the curl over
    lists with the dropped entries emptied."""
    sb_mode = mode == "sb"
    c = _inputs(op, kernel, sb_mode, n=3000)
    dens, disp, ok = _keeps(op, c, sb_mode)
    assert int(dens.sum()) < int(ok.sum()) or op == "fused"
    if op == "fused":
        args = (c["pos"], c["hm_blocks"], c["cand"], c["cnt"], c["pos"],
                c["h0"], c["cap"], c["hm"], 1.0, BOX)
        kw = dict(kernel=kernel, desnngb=c["desnngb"], n_sweeps=3,
                  sb_mode=sb_mode)
        inf = torch.full(dens.shape, float("inf"))
        full = cp.fused_wvt(*args, **kw)
        pruned = cp.fused_wvt(
            *args, **kw, gdist=torch.where(dens, torch.zeros_like(inf), inf),
            dkeep=disp)
        assert int(disp.sum()) < int(ok.sum())
        for a, b in zip(full, pruned):
            assert torch.equal(a, b)
        assert float(full[5].abs().max()) > 0
        return
    # superblock lists run expanded to their member blocks
    args = c["args"]
    cand = _listed(c["cand"], c["cnt"])
    if sb_mode:
        cand = expand_tail_rows(cand, args[0].shape[0])
    cnt = torch.full_like(c["cnt"], cand.shape[1])
    # the last listed entry of a row stays, so that both runs gather the
    # same shapes and so sum in the same tree
    col = torch.arange(1, cand.shape[1] + 1)
    last = (ok * col).amax(dim=1, keepdim=True) == col[None]
    pruned = torch.where(dens | (last & ok), cand, torch.full_like(cand, -1))
    assert int((pruned >= 0).sum()) < int((cand >= 0).sum())
    a, b = (sp.stream_curl(args[0], lst.contiguous(), cnt, *args[3:],
                           kernel=kernel) for lst in (cand, pruned))
    assert torch.equal(a, b)
    assert float(a.abs().max()) > 0


@OPS
@MODES
def test_cnt_masks_entries(op, mode):
    """Entries at or beyond cnt are neither listed nor kept, a row with
    cnt <= 0 lists nothing, and a cnt beyond the width reads the whole
    row; the keeps of a shortened row are those of the same row with the
    entries emptied."""
    sb_mode = mode == "sb"
    c = _inputs(op, "m4", sb_mode, n=3000)
    S, M = c["cand"].shape
    fan = 8 if sb_mode else 1
    _, _, ok_full = _keeps(op, c, sb_mode)
    cnt = torch.clamp(c["cnt"] // 2, min=1).to(torch.int32)
    cnt[0] = 0
    cnt[1] = -3
    cnt[2] = M + 5
    short = dict(c, cnt=cnt)
    if op == "curl":
        short["args"] = c["args"][:2] + (cnt,) + c["args"][3:]
    dens, disp, ok = _keeps(op, short, sb_mode)
    slot = torch.arange(M * fan)[None] // fan
    assert not bool((ok & (slot >= cnt[:, None])).any())
    assert not bool(ok[:2].any()) and not bool(dens[:2].any())
    assert torch.equal(ok[2], ok_full[2] | ok[2])
    assert int(ok.sum()) < int(ok_full.sum())
    emptied = dict(short, cand=_listed(c["cand"], torch.clamp(cnt, max=M)),
                   cnt=torch.full_like(cnt, M))
    if op == "curl":
        emptied["args"] = (c["args"][0], emptied["cand"], emptied["cnt"]) \
            + c["args"][3:]
    dens_e, disp_e, ok_e = _keeps(op, emptied, sb_mode)
    assert torch.equal(dens, dens_e) and torch.equal(ok, ok_e)
    if disp is not None:
        assert torch.equal(disp, disp_e)
        assert not bool((disp & ~ok).any())


@MODES
@KERNELS
def test_fused_cpu_stats_and_options(mode, kernel):
    """On the CPU fused_wvt runs the plain version whatever prune, hoist
    and packed say, counts no launch, and fills stats with the plain
    sweeps, the oracle's kept (either consumer) and listed blocks, and the
    density blocks and warp tiles kept x sweeps; rows with cnt = 0 report
    zeros."""
    sb_mode = mode == "sb"
    c = _inputs("fused", kernel, sb_mode, n=1500)
    S = c["cand"].shape[0]
    cnt = c["cnt"].clone()
    cnt[0] = 0
    args = (c["pos"], c["hm_blocks"], c["cand"], cnt, c["pos"], c["h0"],
            c["cap"], c["hm"], 1.0, BOX)
    kw = dict(kernel=kernel, desnngb=c["desnngb"], sb_mode=sb_mode)
    before = cp.fused_wvt.launches
    st = torch.zeros((S, 5), dtype=torch.int32)
    base = cp.fused_wvt(*args, **kw)
    opt = cp.fused_wvt(*args, **kw, prune=False, hoist=False, stats=st,
                       packed=cp.pack_fused_sources(c["pos"], c["hm_blocks"],
                                                    BOX))
    for a, b in zip(base, opt):
        assert torch.equal(a, b)
    assert cp.fused_wvt.launches == before
    dens, disp, ok = _keeps("fused", dict(c, cnt=cnt), sb_mode)
    assert bool((st[0] == 0).all())
    assert bool((st[1:, 0] >= 1).all())
    assert bool((st[:, 0] <= cp.FUSED_SWEEPS).all())
    assert torch.equal(st[:, 1].long(), (dens | disp).sum(dim=1))
    assert torch.equal(st[:, 2].long(), ok.sum(dim=1))
    assert torch.equal(st[:, 3].long(), st[:, 0] * dens.sum(dim=1))
    dens_t, _, _ = _keeps("fused", dict(c, cnt=cnt), sb_mode, tiles=True)
    assert torch.equal(st[:, 4].long(), st[:, 0] * dens_t.sum(dim=(1, 2)))
    assert int(st[:, 4].sum()) < 16 * int(st[:, 3].sum())
    sd = torch.zeros((S, 5), dtype=torch.int32)
    cp.fused_wvt(*args, **kw, do_disp=False, stats=sd)
    assert torch.equal(sd[:, 1].long(), dens.sum(dim=1))
    with pytest.raises(ValueError, match="n_sweeps"):
        cp.fused_wvt(*args, **kw, n_sweeps=0)
    with pytest.raises(ValueError, match="stats"):
        cp.fused_wvt(*args, **kw, stats=torch.zeros((S, 4),
                                                    dtype=torch.int32))


@MODES
@KERNELS
def test_curl_cpu_stats_and_options(mode, kernel):
    """On the CPU stream_curl runs the plain version whatever prune,
    hoist, cluster and packed say, counts no launch, and fills stats with
    1, the oracle's kept and listed blocks, the kept blocks again and the
    oracle's warp tiles."""
    sb_mode = mode == "sb"
    c = _inputs("curl", kernel, sb_mode, n=1500)
    args, kw = c["args"], c["kw"]
    S = c["cand"].shape[0]
    before = sp.stream_curl.launches
    st = torch.zeros((S, 5), dtype=torch.int32)
    base = sp.stream_curl(*args, **kw)
    opt = sp.stream_curl(*args, **kw, prune=False, hoist=False, cluster=8,
                         stats=st,
                         packed=sp.pack_curl_sources(args[0], BOX))
    assert torch.equal(base, opt)
    assert sp.stream_curl.launches == before
    kept, _, ok = _keeps("curl", c, sb_mode)
    assert bool((st[:, 0] == 1).all())
    assert torch.equal(st[:, 1].long(), kept.sum(dim=1))
    assert torch.equal(st[:, 2].long(), ok.sum(dim=1))
    assert torch.equal(st[:, 3], st[:, 1])
    tiles, _, _ = _keeps("curl", c, sb_mode, tiles=True)
    assert torch.equal(st[:, 4].long(), tiles.sum(dim=(1, 2)))
    assert 0 < int(st[:, 4].sum()) < 16 * int(st[:, 1].sum())


def test_packed_records():
    """The records the two kernels read.  fused_wvt: (x, y, z, hm), hm
    being range and validity at once -- a valid source keeps its hm however
    small, an invalid one is 0 exactly -- with the chunk table of the
    displacement's pack (hm is h on the valid lanes).  stream_curl: per
    block 128 (x, y, z, valid) records, then 128 (A0, A1, A2, pad)."""
    c = cusp.class_inputs("wc6", 1500, False)
    nb = c["pos_t"].shape[0]
    valid = c["valid_t"][:, 0] > 0.5
    assert not bool(valid.all())
    hm = c["hm_blocks"].clone()
    hm[0, 0, :5] = 1e-30
    p = cp.pack_fused_sources(c["pos_t"], hm, BOX)
    assert p.src.shape == (nb, 128, 4) and p.ctab.shape == (nb, 64)
    assert p.src.is_contiguous()
    assert torch.equal(p.src[:, :, :3], c["pos_t"].transpose(1, 2))
    assert torch.equal(p.src[:, :, 3], hm[:, 0])
    assert torch.equal(p.src[:, :, 3] > 0, valid)
    assert bool((p.src[:, :, 3][~valid] == 0).all())
    assert float(p.w_max) == float(hm.max())
    disp = cp.pack_sources(c["pos_t"], c["valid_t"], c["h_b3"], BOX)
    own = cp.pack_fused_sources(c["pos_t"], c["hm_blocks"], BOX)
    assert torch.equal(own.ctab, disp.ctab)
    shared = cp.pack_fused_sources(c["pos_t"], c["hm_blocks"], BOX,
                                   ctab=disp.ctab)
    assert shared.ctab is disp.ctab and torch.equal(shared.src, own.src)
    args, _, _ = cusp.curl_inputs("wc6", 1500)
    src8 = args[0]
    q = sp.pack_curl_sources(src8, BOX)
    assert q.src.shape == (nb, 256, 4) and q.src.is_contiguous()
    assert torch.equal(q.src[:, :128], src8[:, :4].transpose(1, 2))
    assert torch.equal(q.src[:, 128:], src8[:, 4:].transpose(1, 2))
    assert torch.equal(q.ctab, sp.build_chunk_tab(src8[:, :3], src8[:, 3],
                                                  BOX))
