"""Tests that need an NVIDIA GPU: each hand-written CUDA kernel against
its plain PyTorch version on the same inputs, with the tolerances of the
CPU tests, the kernels' options against each other to the bit, and the
CLI main path on ``device=cuda`` at a small size.

The file imports no JAX, so it runs on a machine without it.
tests/conftest.py configures JAX, hence ``--noconftest``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Without a card every test here skips.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from toycluster_tpu_torch.ops import class_pair as cp
from toycluster_tpu_torch.ops import cusp
from toycluster_tpu_torch.ops import stream_pair as sp

pytestmark = pytest.mark.cuda

N = 20000
_PAR = (Path(__file__).resolve().parents[1] / "toycluster_tpu_torch" / "data"
        / "cluster.par")


@pytest.fixture
def dev():
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("do_disp", [True, False])
def test_stream_wvt_kernel_matches_plain(dev, kernel, do_disp):
    args, kw, valid = cusp.wvt_inputs(kernel, do_disp, N, device=dev)
    before = sp.stream_wvt.launches
    got = sp.stream_wvt(*args, **kw)
    torch.cuda.synchronize()
    assert sp.stream_wvt.launches == before + 1
    ref = sp._stream_wvt_reference(*args, n_sweeps=sp.N_SWEEPS, **kw)
    _wvt_close(got, ref, valid, kw["desnngb"])
    if do_disp:
        _disp_close(got[5], ref[5], valid)
    else:
        assert got[5] is None


def _wvt_close(got, ref, valid, desnngb):
    """h/rho rtol 2e-3 on > 98% of the lanes done in both, done counts
    within 3%; a speculatively accepted lane is extrapolated, not
    re-measured: the kernel may deviate from the contract window as far
    as the plain version does on the same lanes, and no farther."""
    g_rho, g_h, _, g_wk, g_done, _ = got
    r_rho, r_h, _, r_wk, r_done, _ = ref
    both = valid & g_done & r_done
    assert int(both.sum()) >= 0.97 * int((valid & r_done).sum())
    ok = (torch.isclose(g_h[both], r_h[both], rtol=2e-3, atol=0)
          & torch.isclose(g_rho[both], r_rho[both], rtol=2e-3, atol=0))
    assert float(ok.float().mean()) > 0.98
    dev_plain = float((r_wk[both] - desnngb).abs().max())
    assert float((g_wk[both] - desnngb).abs().max()) \
        < max(0.05, dev_plain) + 1e-3


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("do_disp", [True, False])
@pytest.mark.parametrize("hoist", [True, False])
def test_stream_wvt_pruning_is_bit_identical(dev, kernel, do_disp, hoist):
    """Pruned and unpruned kernel runs agree to the bit in the same wrap
    mode, and the pruned run streams fewer members than are listed."""
    args, kw, _ = cusp.wvt_inputs(kernel, do_disp, N, device=dev)
    S = args[1].shape[0]
    st = torch.zeros((S, 4), dtype=torch.int32, device=dev)
    su = torch.zeros_like(st)
    got = sp.stream_wvt(*args, **kw, hoist=hoist, stats=st)
    full = sp.stream_wvt(*args, **kw, hoist=hoist, prune=False, stats=su)
    torch.cuda.synchronize()
    for a, b in zip(got, full):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(su[:, 1], su[:, 3])
    assert int(st[:, 1].sum()) < int(st[:, 3].sum())
    assert bool((st[:, 0] >= 1).all())
    assert bool((st[:, 0] <= sp.N_SWEEPS).all())


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
def test_stream_wvt_wrap_modes_match_plain(dev, kernel):
    """A cusp whose outskirts lie across the periodic edge (centred at
    0.1 box), with every third row forced to wrap (a cap of half the
    box, a reach no row holds inside it): the flagged rows skip the wrap,
    the others wrap per pair; both match the plain version, and the same
    run with the wrap on every row to the bit."""
    args, kw, valid = cusp.wvt_inputs(kernel, True, N, device=dev,
                                      centre=100.0)
    args = list(args)
    cap = args[5].clone()
    cap[::3] = 0.5 * cusp.BOX
    args[5] = cap
    _, _, flag = sp.prune_tables(args[0], args[3], cap, args[6], cusp.BOX)
    assert not bool(flag[::3].any()) and int(flag.sum()) > 0
    got = sp.stream_wvt(*args, **kw)
    wrapped = sp.stream_wvt(*args, **kw, hoist=False)
    torch.cuda.synchronize()
    for a, b in zip(got, wrapped):
        assert torch.equal(a, b)
    ref = sp._stream_wvt_reference(*args, n_sweeps=sp.N_SWEEPS, **kw)
    _wvt_close(got, ref, valid, kw["desnngb"])
    _disp_close(got[5], ref[5], valid)


@pytest.mark.parametrize("do_disp", [True, False])
def test_stream_wvt_kept_counts_match_skip_bits(dev, do_disp):
    """Row by row, the members the kernel keeps equal the popcounts of
    the port's stream_skip_bits words on the same inputs."""
    args, kw, _ = cusp.wvt_inputs("wc6", do_disp, N, device=dev)
    src, cand, cnt, pos_t, _, cap, hm = args[:7]
    S, nb = cand.shape[0], src.shape[0]
    st = torch.zeros((S, 4), dtype=torch.int32, device=dev)
    sp.stream_wvt(*args, **kw, stats=st)
    slot = torch.arange(cand.shape[1], device=dev)
    listed = torch.where(slot[None] < cnt[:, None], cand,
                         torch.full_like(cand, -1))
    bits, _ = sp.stream_skip_bits(
        pos_t.amin(dim=2), pos_t.amax(dim=2),
        src[:, 3].amax(dim=1) if do_disp else None,
        torch.arange(nb, device=dev), listed, cap, hm if do_disp else None,
        cusp.BOX, sp.build_chunk_tab(pos_t, src[:, 3], cusp.BOX))
    f = ((bits.long() & 0xFFFFFFFF)[:, :, None]
         >> (torch.arange(16, device=dev) * 2)) & 3
    f = f.reshape(S, -1)
    dens = (f & 1) == 0
    torch.cuda.synchronize()
    assert torch.equal(st[:, 2].long(), dens.sum(dim=1))
    assert torch.equal(st[:, 1].long(), (dens | ((f & 2) != 0)).sum(dim=1))
    _, ok = sp.list_entries(listed, nb, True)
    assert torch.equal(st[:, 3].long(), ok.sum(dim=1))


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("sb_mode", [True, False])
def test_stream_curl_kernel_matches_plain(dev, kernel, sb_mode):
    cargs, kw, valid = cusp.curl_inputs(kernel, N, device=dev,
                                        sb_mode=sb_mode)
    before = sp.stream_curl.launches
    got = sp.stream_curl(*cargs, **kw)
    torch.cuda.synchronize()
    assert sp.stream_curl.launches == before + 1
    ref = sp._stream_curl_reference(*cargs, **kw)
    a, b = ref[valid], got[valid]
    scale = float(a.abs().max())
    assert scale > 0
    torch.testing.assert_close(b, a, rtol=5e-4, atol=2e-5 * scale)


def _density_close(got, ref, valid, desnngb):
    """h/rho rtol 2e-3 on > 98% of the lanes done in both (lanes on a
    wkNgb plateau move along it with any change of summation order),
    |wkNgb - DESNNGB| < 0.05 + 1e-3 there, done counts within 3%."""
    both = valid & got[4] & ref[4]
    assert int(both.sum()) >= 0.97 * int((valid & ref[4]).sum())
    ok = (torch.isclose(got[1][both], ref[1][both], rtol=2e-3, atol=0)
          & torch.isclose(got[0][both], ref[0][both], rtol=2e-3, atol=0))
    assert float(ok.float().mean()) > 0.98
    assert float((got[3][both] - desnngb).abs().max()) < 0.05 + 1e-3


def _disp_close(got, ref, valid):
    a, b = ref[valid], got[valid]
    torch.testing.assert_close(b, a, rtol=2e-4,
                               atol=1e-6 * float(a.abs().max()))


def _class_args(c):
    """(solve_density args, wvt_displacement args) of cusp.class_inputs."""
    return ((c["pos_t"], c["valid_t"], c["cand"], c["pos_t"], c["h0"],
             c["cap"], 1.0, cusp.BOX),
            (c["pos_t"], c["valid_t"], c["h_b3"], c["cand"], c["pos_t"],
             c["hm"], 1.0, cusp.BOX))


def _solve_ref(args, kw):
    ref = cp._solve_density_reference(*args, n_sweeps=cp.SOLVE_SWEEPS, **kw)
    return (ref[..., 0], ref[..., 1], None, ref[..., 3], ref[..., 4] > 0.5)


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("sb_mode", [False, True])
@pytest.mark.parametrize("centre", [cusp.BOX / 2, 0.0])
def test_class_kernels_match_plain(dev, kernel, sb_mode, centre):
    """solve_density, wvt_displacement and fused_wvt (with and without
    the bounds, bit-identical) against their plain versions, the cusp in
    the box centre and across the periodic edge."""
    c = cusp.class_inputs(kernel, N, sb_mode, device=dev, centre=centre)
    des, v = c["desnngb"], c["valid"]
    kw = dict(kernel=kernel, desnngb=des, sb_mode=sb_mode)
    before = (cp.solve_density.launches, cp.wvt_displacement.launches,
              cp.fused_wvt.launches)
    args, dargs = _class_args(c)
    _density_close(cp.solve_density(*args, **kw), _solve_ref(args, kw), v,
                   des)
    _disp_close(cp.wvt_displacement(*dargs, kernel=kernel, sb_mode=sb_mode),
                cp._wvt_displacement_reference(*dargs, kernel=kernel,
                                               sb_mode=sb_mode), v)
    fargs = (c["pos_t"], c["hm_blocks"], c["cand"], c["cnt"], c["pos_t"],
             c["h0"], c["cap"], c["hm"], 1.0, cusp.BOX)
    got = cp.fused_wvt(*fargs, **kw)
    bounded = cp.fused_wvt(*fargs, **kw, gdist=c["gdist"], dkeep=c["dkeep"])
    torch.cuda.synchronize()
    for a, b in zip(got, bounded):
        assert torch.equal(a, b)
    ref = cp._fused_wvt_reference(*fargs, n_sweeps=cp.FUSED_SWEEPS,
                                  do_disp=True, gdist=None, dkeep=None, **kw)
    _density_close(got, (ref[..., 0], ref[..., 1], None, ref[..., 3],
                         ref[..., 4] > 0.5), v, des)
    _disp_close(got[5], ref[..., 5:8], v)
    assert (cp.solve_density.launches, cp.wvt_displacement.launches,
            cp.fused_wvt.launches) == tuple(n + k for n, k in
                                            zip(before, (1, 1, 2)))


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("sb_mode", [False, True])
@pytest.mark.parametrize("cluster", [1, 8])
def test_class_pruning_is_bit_identical(dev, kernel, sb_mode, cluster):
    """Pruned and unpruned, wrapped and unwrapped runs of solve_density
    and wvt_displacement agree to the bit at a given cluster size (the
    cusp's outskirts lie across the edge: some rows wrap, most do not);
    the blocks the kernels keep are the plain oracles', row by row."""
    c = cusp.class_inputs(kernel, N, sb_mode, device=dev, centre=100.0)
    S = c["cand"].shape[0]
    args, dargs = _class_args(c)
    kw = dict(kernel=kernel, sb_mode=sb_mode, cluster=cluster)
    st, su, sd = (torch.zeros((S, 4), dtype=torch.int32, device=dev)
                  for _ in range(3))
    flag = sp.interior_rows(c["pos_t"], c["cap"].amax(dim=1), cusp.BOX)
    assert 0 < int(flag.sum()) < S
    got = cp.solve_density(*args, desnngb=c["desnngb"], **kw, stats=st)
    for off in (dict(prune=False, stats=su), dict(hoist=False),
                dict(prune=False, hoist=False)):
        full = cp.solve_density(*args, desnngb=c["desnngb"], **kw, **off)
        for a, b in zip(got, full):
            assert torch.equal(a, b)
    keep, ok = cp.density_keep(c["pos_t"], c["valid_t"], c["cand"],
                               c["pos_t"], c["cap"], cusp.BOX,
                               sb_mode=sb_mode)
    torch.cuda.synchronize()
    assert torch.equal(st[:, 1].long(), keep.sum(dim=1))
    assert torch.equal(st[:, 2].long(), ok.sum(dim=1))
    assert torch.equal(su[:, 1], su[:, 2]) and torch.equal(su[:, 2], st[:, 2])
    assert torch.equal(su[:, 0], st[:, 0])
    assert bool((st[:, 0] >= 1).all())
    assert bool((st[:, 0] <= cp.SOLVE_SWEEPS).all())
    if sb_mode:
        assert int(st[:, 1].sum()) < int(st[:, 2].sum())
    # each sweep walks the kept blocks within its own ranges
    assert torch.equal(su[:, 3], su[:, 0] * su[:, 1])
    assert bool((st[:, 3] <= st[:, 0] * st[:, 1]).all())
    assert 0 < int(st[:, 3].sum()) < int((st[:, 0] * st[:, 1]).sum())
    got = cp.wvt_displacement(*dargs, **kw, stats=sd)
    for off in (dict(prune=False), dict(hoist=False)):
        assert torch.equal(got, cp.wvt_displacement(*dargs, **kw, **off))
    keep, ok = cp.displacement_keep(
        c["pos_t"], c["valid_t"], c["h_b3"], c["cand"], c["pos_t"], c["hm"],
        cusp.BOX, sb_mode=sb_mode)
    torch.cuda.synchronize()
    assert torch.equal(sd[:, 1].long(), keep.sum(dim=1))
    assert torch.equal(sd[:, 2].long(), ok.sum(dim=1))
    assert torch.equal(sd[:, 3], sd[:, 1]) and bool((sd[:, 0] == 1).all())
    assert int(sd[:, 1].sum()) < int(sd[:, 2].sum())


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("sb_mode", [False, True])
def test_class_cluster_sizes_agree(dev, kernel, sb_mode):
    """A row on one CTA and split over clusters of 2, 3 and 8 CTAs: every
    size matches the plain version, and a second run repeats the bits."""
    c = cusp.class_inputs(kernel, N, sb_mode, device=dev)
    des, v = c["desnngb"], c["valid"]
    args, dargs = _class_args(c)
    kw = dict(kernel=kernel, sb_mode=sb_mode)
    ref = _solve_ref(args, dict(kw, desnngb=des))
    dref = cp._wvt_displacement_reference(*dargs, **kw)
    one = cp.solve_density(*args, desnngb=des, **kw, cluster=1)
    for cluster in (1, 2, 3, 8):
        got = cp.solve_density(*args, desnngb=des, **kw, cluster=cluster)
        again = cp.solve_density(*args, desnngb=des, **kw, cluster=cluster)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        _density_close(got, ref, v, des)
        _density_close(got, one, v, des)
        d = cp.wvt_displacement(*dargs, **kw, cluster=cluster)
        assert torch.equal(d, cp.wvt_displacement(*dargs, **kw,
                                                  cluster=cluster))
        _disp_close(d, dref, v)


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("cluster", [1, 8])
def test_superblock_rows_match_expanded_rows(dev, kernel, cluster):
    """Superblock rows against the same rows expanded to block ids
    (-1 for members past nb, anywhere in a row): the same blocks at the
    same list positions, so the same bits."""
    from toycluster_tpu_torch.models.sph import expand_tail_rows
    c = cusp.class_inputs(kernel, N, True, device=dev)
    nb = c["pos_t"].shape[0]
    assert nb % 8 != 0
    args, dargs = _class_args(c)
    rows = expand_tail_rows(c["cand"], nb).contiguous()
    assert bool((rows[:, :-1] < 0).any())
    eargs = args[:2] + (rows,) + args[3:]
    edargs = dargs[:3] + (rows,) + dargs[4:]
    kw = dict(kernel=kernel, cluster=cluster)
    for a, b in zip(
            cp.solve_density(*args, desnngb=c["desnngb"], sb_mode=True, **kw),
            cp.solve_density(*eargs, desnngb=c["desnngb"], **kw)):
        assert torch.equal(a, b)
    assert torch.equal(cp.wvt_displacement(*dargs, sb_mode=True, **kw),
                       cp.wvt_displacement(*edargs, **kw))


@pytest.mark.parametrize("sb_mode", [False, True])
@pytest.mark.parametrize("cluster", [1, 8])
def test_empty_rows(dev, sb_mode, cluster):
    """A row of only -1 entries: no pair, so no displacement, no density
    but the self-correction, and h grown to the cap as in the plain
    version; its neighbours are not disturbed."""
    c = cusp.class_inputs("wc6", N, sb_mode, device=dev)
    cand = c["cand"].clone()
    cand[1] = -1
    args, dargs = _class_args(c)
    args = args[:2] + (cand,) + args[3:]
    dargs = dargs[:3] + (cand,) + dargs[4:]
    kw = dict(kernel="wc6", sb_mode=sb_mode)
    st = torch.zeros((cand.shape[0], 4), dtype=torch.int32, device=dev)
    got = cp.solve_density(*args, desnngb=c["desnngb"], **kw,
                           cluster=cluster, stats=st)
    ref = _solve_ref(args, dict(kw, desnngb=c["desnngb"]))
    assert int(st[1, 1]) == 0 and int(st[1, 2]) == 0
    assert not bool(got[4][1].any())
    torch.testing.assert_close(got[1][1], ref[1][1], rtol=1e-5, atol=0)
    torch.testing.assert_close(got[0][1], ref[0][1], rtol=1e-4, atol=0)
    _density_close(got, ref, c["valid"], c["desnngb"])
    d = cp.wvt_displacement(*dargs, **kw, cluster=cluster)
    assert bool((d[1] == 0).all()) and bool((d[0] != 0).any())


def _fused_args(c):
    return (c["pos_t"], c["hm_blocks"], c["cand"], c["cnt"], c["pos_t"],
            c["h0"], c["cap"], c["hm"], 1.0, cusp.BOX)


def _fused_raw(args, kw, **debug):
    """The fused_wvt kernel through the wrapper's launch function, with
    the C entry point's debug bits."""
    full = dict(dict(n_sweeps=cp.FUSED_SWEEPS, do_disp=True, gdist=None,
                     dkeep=None, prune=True, hoist=True, stats=None,
                     packed=None), **kw)
    return cp._fused_wvt_cuda(*args, **full, **debug)


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("sb_mode", [False, True])
@pytest.mark.parametrize("do_disp", [True, False])
def test_fused_options_are_bit_identical(dev, kernel, sb_mode, do_disp):
    """fused_wvt with and without pruning and the dropped wrap, with and
    without the frozen-lane skip and the warp tiles: the same bits, on a
    cusp whose outskirts lie across the edge; a second run repeats them;
    the blocks the kernel keeps are the plain oracle's, row by row, and
    so are the density tiles of a single sweep at h = cap."""
    c = cusp.class_inputs(kernel, N, sb_mode, device=dev, centre=100.0)
    S = c["cand"].shape[0]
    args = _fused_args(c)
    kw = dict(kernel=kernel, desnngb=c["desnngb"], sb_mode=sb_mode,
              do_disp=do_disp)
    st, su, s1 = (torch.zeros((S, 5), dtype=torch.int32, device=dev)
                  for _ in range(3))
    got = cp.fused_wvt(*args, **kw, stats=st)
    for off in (dict(prune=False, stats=su), dict(hoist=False),
                dict(prune=False, hoist=False), dict()):
        for a, b in zip(got, cp.fused_wvt(*args, **kw, **off)):
            assert torch.equal(a, b)
    base = _fused_raw(args, kw)
    assert torch.equal(base[..., 1], got[1])
    assert torch.equal(base[..., 5:8], got[5])
    if not do_disp:
        assert bool((got[5] == 0).all())
    for debug in (1, 2, 3):
        assert torch.equal(base, _fused_raw(args, kw, debug=debug)), debug
    dens_t, disp_t, ok = cp.fused_keep(
        c["pos_t"], c["hm_blocks"], c["cand"], c["cnt"], c["pos_t"],
        c["cap"], c["hm"], cusp.BOX, sb_mode=sb_mode, do_disp=do_disp,
        tiles=True)
    dens, disp = dens_t.any(dim=2), disp_t.any(dim=2)
    # one sweep at h = cap walks the tiles the oracle keeps at the caps
    cp.fused_wvt(*args[:5], c["cap"], *args[6:], **kw, n_sweeps=1, stats=s1)
    torch.cuda.synchronize()
    assert torch.equal(s1[:, 3].long(), dens.sum(dim=1))
    assert torch.equal(s1[:, 4].long(), dens_t.sum(dim=(1, 2)))
    assert int(s1[:, 4].sum()) < 16 * int(s1[:, 3].sum())
    assert torch.equal(st[:, 1].long(), (dens | disp).sum(dim=1))
    assert torch.equal(st[:, 2].long(), ok.sum(dim=1))
    assert torch.equal(su[:, 1], su[:, 2]) and torch.equal(su[:, 2], st[:, 2])
    assert torch.equal(su[:, 0], st[:, 0])
    assert bool((st[:, 0] >= 1).all())
    assert bool((st[:, 0] <= cp.FUSED_SWEEPS).all())
    assert int(st[:, 1].sum()) < int(st[:, 2].sum())
    # each sweep walks the density blocks within its own ranges
    assert torch.equal(su[:, 3], su[:, 0] * su[:, 2])
    assert bool((st[:, 3].long() <= st[:, 0] * dens.sum(dim=1)).all())
    assert 0 < int(st[:, 3].sum()) < int(su[:, 3].sum())
    assert torch.equal(su[:, 4], 16 * su[:, 3])
    assert bool((st[:, 4] >= st[:, 3]).all())
    assert bool((st[:, 4].long() <= st[:, 0] * dens_t.sum(dim=(1, 2))).all())


@pytest.mark.parametrize("sb_mode", [False, True])
def test_fused_and_curl_short_and_holed_rows(dev, sb_mode):
    """Rows with cnt 0 return zeros, entries at or beyond cnt and -1
    entries inside the list take part in no pair: fused_wvt and
    stream_curl against their plain versions on such lists."""
    c = cusp.class_inputs("wc6", N, sb_mode, device=dev)
    S, M = c["cand"].shape
    cand = c["cand"].clone()
    cand[:, 1::3] = -1
    cnt = torch.clamp(c["cnt"] - 1, min=1).to(torch.int32)
    cnt[0] = 0
    cnt[1] = -2
    cnt[2] = M + 3
    args = list(_fused_args(c))
    args[2], args[3] = cand, cnt
    kw = dict(kernel="wc6", desnngb=c["desnngb"], sb_mode=sb_mode)
    st = torch.zeros((S, 5), dtype=torch.int32, device=dev)
    got = cp.fused_wvt(*args, **kw, stats=st)
    ref = cp._fused_wvt_reference(*args, n_sweeps=cp.FUSED_SWEEPS,
                                  do_disp=True, gdist=None, dkeep=None, **kw)
    torch.cuda.synchronize()
    for x in got:
        assert bool((x[:2] == 0).all())
    assert bool((st[:2] == 0).all()) and int(st[2, 2]) > 0
    dens, disp, ok = cp.fused_keep(c["pos_t"], c["hm_blocks"], cand, cnt,
                                   c["pos_t"], c["cap"], c["hm"], cusp.BOX,
                                   sb_mode=sb_mode)
    assert torch.equal(st[:, 2].long(), ok.sum(dim=1))
    assert torch.equal(st[:, 1].long(), (dens | disp).sum(dim=1))
    # thinned lists leave many lanes short of neighbours: compare where
    # both solved
    v = c["valid"]
    both = v & got[4] & (ref[..., 4] > 0.5)
    assert int(both.sum()) > 0
    near = torch.isclose(got[1][both], ref[..., 1][both], rtol=2e-3, atol=0)
    assert float(near.float().mean()) > 0.98
    _disp_close(got[5], ref[..., 5:8], v)
    cargs, ckw, valid = cusp.curl_inputs("wc6", N, device=dev,
                                         sb_mode=sb_mode)
    cargs = (cargs[0], cand, cnt) + cargs[3:]
    sc = torch.zeros((S, 5), dtype=torch.int32, device=dev)
    b = sp.stream_curl(*cargs, **ckw, stats=sc)
    a = sp._stream_curl_reference(*cargs, **ckw)
    torch.cuda.synchronize()
    assert bool((b[:2] == 0).all()) and bool((sc[:2, 1:] == 0).all())
    kept, ok = sp.curl_keep(cargs[0], cand, cnt, cargs[3], cargs[4],
                            cusp.BOX, sb_mode=sb_mode)
    assert torch.equal(sc[:, 1].long(), kept.sum(dim=1))
    assert torch.equal(sc[:, 2].long(), ok.sum(dim=1))
    torch.testing.assert_close(b[valid], a[valid], rtol=5e-4,
                               atol=2e-5 * float(a[valid].abs().max()))


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("sb_mode", [False, True])
@pytest.mark.parametrize("cluster", [1, 8])
def test_stream_curl_pruning_is_bit_identical(dev, kernel, sb_mode, cluster):
    """Pruned and unpruned, wrapped and unwrapped runs of stream_curl agree
    to the bit at a given cluster size (every fifth row forced to wrap by
    an hsml of half the box, beside rows that need no wrap); the blocks
    the kernel keeps and the warp tiles it walks are the plain oracle's,
    row by row."""
    cargs, kw, _ = cusp.curl_inputs(kernel, N, device=dev, sb_mode=sb_mode)
    cargs = list(cargs)
    hsml = cargs[4].clone()
    hsml[::5] = 0.5 * cusp.BOX
    cargs[4] = hsml
    S = cargs[1].shape[0]
    flag = sp.interior_rows(cargs[3], hsml.amax(dim=1), cusp.BOX)
    assert not bool(flag[::5].any()) and int(flag.sum()) > 0
    st, su = (torch.zeros((S, 5), dtype=torch.int32, device=dev)
              for _ in range(2))
    got = sp.stream_curl(*cargs, **kw, cluster=cluster, stats=st)
    for off in (dict(prune=False, stats=su), dict(hoist=False),
                dict(prune=False, hoist=False), dict()):
        assert torch.equal(got, sp.stream_curl(*cargs, **kw, cluster=cluster,
                                               **off))
    tiles, ok = sp.curl_keep(cargs[0], cargs[1], cargs[2], cargs[3], hsml,
                             cusp.BOX, sb_mode=sb_mode, tiles=True)
    kept = tiles.any(dim=2)
    torch.cuda.synchronize()
    assert torch.equal(st[:, 4].long(), tiles.sum(dim=(1, 2)))
    assert torch.equal(su[:, 4], 16 * su[:, 1])
    assert int(st[:, 4].sum()) < 16 * int(st[:, 1].sum())
    assert torch.equal(st[:, 1].long(), kept.sum(dim=1))
    assert torch.equal(st[:, 2].long(), ok.sum(dim=1))
    assert torch.equal(st[:, 3], st[:, 1]) and bool((st[:, 0] == 1).all())
    assert torch.equal(su[:, 1], su[:, 2]) and torch.equal(su[:, 2], st[:, 2])
    assert int(st[:, 1].sum()) < int(st[:, 2].sum())


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("sb_mode", [False, True])
@pytest.mark.parametrize("centre", [cusp.BOX / 2, 0.0])
def test_stream_curl_cluster_sizes_agree(dev, kernel, sb_mode, centre):
    """A row on one CTA and split over clusters of 2, 4 and 8 CTAs: every
    size matches the plain version (the cusp in the box centre and across
    the periodic edge), and a second run repeats the bits."""
    cargs, kw, valid = cusp.curl_inputs(kernel, N, device=dev,
                                        sb_mode=sb_mode)
    if centre != cusp.BOX / 2:
        # the same potential and lists on the cloud shifted rigidly
        shift = torch.tensor(centre - cusp.BOX / 2, device=dev)
        src8 = cargs[0].clone()
        src8[:, :3] = (src8[:, :3] + shift) % cusp.BOX
        cargs = (src8,) + cargs[1:3] + ((cargs[3] + shift) % cusp.BOX,) \
            + cargs[4:]
    ref = sp._stream_curl_reference(*cargs, **kw)
    scale = float(ref[valid].abs().max())
    assert scale > 0
    for cluster in (1, 2, 4, 8):
        got = sp.stream_curl(*cargs, **kw, cluster=cluster)
        assert torch.equal(got, sp.stream_curl(*cargs, **kw,
                                               cluster=cluster))
        torch.testing.assert_close(got[valid], ref[valid], rtol=5e-4,
                                   atol=2e-5 * scale)


def test_fused_and_curl_wrappers_raise(dev):
    """A list longer than the kernels' shared-memory lists hold raises, as
    does a cluster size the card does not take; nothing falls back to the
    plain version on a CUDA tensor."""
    c = cusp.class_inputs("m4", 3000, False, device=dev)
    S = c["cand"].shape[0]
    args = _fused_args(c)
    cargs, kw, _ = cusp.curl_inputs("m4", 3000, device=dev, sb_mode=False)
    before = (cp.fused_wvt.launches, sp.stream_curl.launches)
    wide = torch.full((S, cp.MAX_SHARE + 1), -1, dtype=torch.int32,
                      device=dev)
    wide[:, :c["cand"].shape[1]] = c["cand"]
    with pytest.raises(ValueError, match="exceeds"):
        cp.fused_wvt(*args[:2], wide, *args[3:], kernel="m4")
    wider = torch.full((S, cp.MAX_CLUSTER * cp.MAX_SHARE + 1), -1,
                       dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        sp.stream_curl(cargs[0], wider, *cargs[2:], **kw)
    with pytest.raises(ValueError, match="cluster must be"):
        sp.stream_curl(*cargs, **kw, cluster=16)
    with pytest.raises(ValueError, match="n_sweeps"):
        cp.fused_wvt(*args, kernel="m4", n_sweeps=0)
    assert (cp.fused_wvt.launches, sp.stream_curl.launches) == before
    # a row of the widest list one CTA holds still runs
    most = torch.full((S, cp.MAX_SHARE), -1, dtype=torch.int32, device=dev)
    most[:, -c["cand"].shape[1]:] = c["cand"]
    cnt = torch.full_like(c["cnt"], cp.MAX_SHARE)
    got = cp.fused_wvt(*args[:2], most, cnt, *args[4:], kernel="m4",
                       desnngb=c["desnngb"])
    ref = cp.fused_wvt(*args, kernel="m4", desnngb=c["desnngb"])
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_class_wrappers_raise_and_do_not_truncate(dev):
    """A list longer than the kernels' shared-memory lists hold raises,
    as does a cluster size the card does not take; nothing falls back to
    the plain version on a CUDA tensor."""
    c = cusp.class_inputs("m4", 3000, False, device=dev)
    args, dargs = _class_args(c)
    S = c["cand"].shape[0]
    wide = torch.full((S, cp.MAX_CLUSTER * cp.MAX_SHARE + 1), -1,
                      dtype=torch.int32, device=dev)
    wide[:, :c["cand"].shape[1]] = c["cand"]
    before = (cp.solve_density.launches, cp.wvt_displacement.launches)
    with pytest.raises(ValueError, match="exceeds"):
        cp.solve_density(*args[:2], wide, *args[3:], kernel="m4")
    with pytest.raises(ValueError, match="exceeds"):
        cp.wvt_displacement(*dargs[:3], wide, *dargs[4:], kernel="m4")
    with pytest.raises(ValueError, match="cluster must be"):
        cp.solve_density(*args, kernel="m4", cluster=16)
    assert (cp.solve_density.launches,
            cp.wvt_displacement.launches) == before
    # the C entry point refuses what the wrapper would have refused
    with pytest.raises(RuntimeError, match="launch failed"):
        packed = cp.pack_sources(c["pos_t"], c["valid_t"], None, cusp.BOX)
        rtab, flag, order = cp._row_tables(
            c["cand"], c["pos_t"], c["cap"], None, c["cap"].amax(dim=1),
            cusp.BOX, True)
        out = torch.empty((S, 128, 5), device=dev)
        sp._launch("solve_density", [
            packed.src, packed.ctab, rtab, c["cand"], flag, order,
            c["pos_t"], c["h0"], c["cap"], out, None, S, c["cand"].shape[1],
            c["pos_t"].shape[0], 1, False, 8, True, 16, 1.0, cusp.BOX,
            1.0 / cusp.BOX, 0.0, 50.0, 0.0])


def test_wrapper_rejects_mixed_devices(dev):
    args, kw, _ = cusp.wvt_inputs("m4", True, 3000, device=dev)
    bad = list(args)
    bad[1] = bad[1].cpu()
    with pytest.raises(ValueError, match="cand is on cpu"):
        sp.stream_wvt(*bad, **kw)


def test_cli_main_path_on_cuda(dev, tmp_path):
    """The CLI on device=cuda at a small size launches both kernels and
    writes a finite snapshot."""
    from toycluster_tpu_torch import cli
    from toycluster_tpu_torch.io.gadget import read_snapshot
    out = tmp_path / "IC"
    sp.stream_wvt.launches = sp.stream_curl.launches = 0
    assert cli.main([str(_PAR), "ntotal=20000", "sph_kernel=m4",
                     "wvt_max_iter=4", f"output_file={out}",
                     "device=cuda"]) == 0
    assert sp.stream_wvt.launches > 0 and sp.stream_curl.launches > 0
    snap = read_snapshot(str(out))
    assert snap["pos"].shape == (20000, 3)
    for k in ("pos", "vel", "u", "rho", "hsml", "bfld", "rho_model"):
        assert np.isfinite(snap[k]).all(), k
    assert (snap["rho"] > 0).all() and (snap["u"] > 0).all()


def test_cli_classed_on_cuda(dev, tmp_path):
    """engine=classed on device=cuda at a small size launches the
    count-class kernels and no stream_wvt, and writes a finite
    snapshot."""
    from toycluster_tpu_torch import cli
    from toycluster_tpu_torch.io.gadget import read_snapshot
    out = tmp_path / "IC"
    for k in (sp.stream_wvt, sp.stream_curl, cp.solve_density,
              cp.wvt_displacement, cp.fused_wvt):
        k.launches = 0
    assert cli.main([str(_PAR), "ntotal=20000", "sph_kernel=m4",
                     "wvt_max_iter=4", f"output_file={out}", "device=cuda",
                     "engine=classed"]) == 0
    assert sp.stream_wvt.launches == 0
    assert cp.fused_wvt.launches > 0 and sp.stream_curl.launches > 0
    snap = read_snapshot(str(out))
    for k in ("pos", "vel", "u", "rho", "hsml", "bfld", "rho_model"):
        assert np.isfinite(snap[k]).all(), k
    assert (snap["rho"] > 0).all() and (snap["u"] > 0).all()


def test_trace_sees_both_kernels_on_the_device(dev, capsys):
    from toycluster_tpu_torch import trace
    assert trace.main([str(_PAR), "ntotal=20000", "sph_kernel=m4",
                       "wvt_max_iter=4"]) == 0
    out = capsys.readouterr().out
    assert "stream_wvt_kernel" in out and "stream_curl_kernel" in out
    share = float(out.split("idle share ")[1].split()[0])
    assert 0.0 <= share < 1.0


def _subhalo_scene(dev, kernel="m4"):
    """The 60,000-particle config-4 scene (mass ratio 1/3, Giocoli
    substructure) with its halo arrays on the card."""
    from toycluster_tpu_torch import parse_par_file
    from toycluster_tpu_torch.models.substructure import setup_substructure
    from toycluster_tpu_torch.particles import halo_arrays_from_scene
    from toycluster_tpu_torch.scene import build_scene
    cfg = parse_par_file(str(_PAR), ntotal=60000, mass_ratio=1.0 / 3.0,
                         substructure=True, sph_kernel=kernel)
    scene = setup_substructure(build_scene(cfg), seed=cfg.seed + 7)
    return scene, halo_arrays_from_scene(scene, dev)


@pytest.mark.parametrize("kind", ["dm", "gas"])
def test_batched_subhalo_sampler_on_cuda(dev, kind):
    """The batched subhalo sampler on the card fills every target, with
    every lane inside its subhalo's sampling radius."""
    from toycluster_tpu_torch.models import positions as pos_mod
    scene, ha = _subhalo_scene(dev)
    idxs = list(range(scene.sub_first, scene.nhalos))
    assert len(idxs) >= 4
    ns = [getattr(scene.halos[i], f"npart_{kind}") for i in idxs]
    gen = torch.Generator(device=dev).manual_seed(2)
    res = pos_mod._batched_fill(gen, ha, idxs, ns, kind, scene.boxsize,
                                sub_first=scene.sub_first)
    r_max = ha.r_sample_dm if kind == "dm" else ha.r_sample_gas
    for i, n in zip(idxs, ns):
        pos, filled = res[i]
        assert pos.device.type == "cuda" and pos.shape == (n, 3)
        assert filled == n
        r = torch.linalg.vector_norm(pos, dim=-1)
        assert bool((r <= r_max[i] * 1.001).all()) and bool((r > 0).all())


@pytest.mark.parametrize("engine", ["stream", "classed"])
def test_subhalo_scene_on_cuda_with_density_audit(dev, engine):
    """make_ics on the 60,000-particle config-4 scene on the card, with
    the density audit against direct summation: subhalos, the engine's
    kernels, contract >= 0.999, audit <= 5e-3, finite fields."""
    from toycluster_tpu_torch import parse_par_file
    from toycluster_tpu_torch.models import sph
    from toycluster_tpu_torch.pipeline import make_ics
    cfg = parse_par_file(str(_PAR), ntotal=60000, mass_ratio=1.0 / 3.0,
                         substructure=True, wvt_max_iter=8)
    logs = {}
    for k in (sp.stream_wvt, sp.stream_curl, cp.solve_density,
              cp.wvt_displacement, cp.fused_wvt):
        k.launches = 0
    scene, parts = make_ics(cfg, device="cuda", engine=engine, check=True,
                            write=False,
                            log=lambda stage, **kw: logs.setdefault(stage, kw))
    assert scene.nhalos > scene.sub_first
    assert logs["substructure"]["nsub"] == scene.nhalos - scene.sub_first
    assert logs["check_density"]["worst_rel_err"] <= 5e-3
    assert sph.last_contract_frac >= 0.999
    if engine == "stream":
        assert sp.stream_wvt.launches > 0
    else:
        assert sp.stream_wvt.launches == 0 and cp.solve_density.launches > 0
    assert sp.stream_curl.launches > 0
    for k in ("pos", "vel", "rho", "hsml", "bfld"):
        assert bool(torch.isfinite(getattr(parts, k)).all()), k


@pytest.mark.parametrize("engine", ["stream", "classed"])
def test_checkpoint_resume_on_cuda(dev, engine, tmp_path, monkeypatch):
    """The 60,000-particle config-4 scene: a run that checkpoints every 4
    iterations leaves it = 3; a second run from that file resumes at
    it = 4 with the saved step and ends finite."""
    from functools import partial
    from toycluster_tpu_torch import parse_par_file
    from toycluster_tpu_torch.models import wvt
    from toycluster_tpu_torch.pipeline import make_ics
    monkeypatch.setattr(wvt, "regularise_sph_particles",
                        partial(wvt.regularise_sph_particles,
                                checkpoint_every=4))
    ck = str(tmp_path / "ck")
    cfg = parse_par_file(str(_PAR), ntotal=60000, mass_ratio=1.0 / 3.0,
                         substructure=True, wvt_max_iter=4)
    make_ics(cfg, device="cuda", engine=engine, write=False,
             wvt_checkpoint=ck, log=lambda *a, **k: None)
    with np.load(ck) as f:
        assert int(f["it"]) == 3
        step = float(f["step"])
        assert f["pos_gas"].shape == (30000, 3)
    logs = []
    _, parts = make_ics(cfg.replace(wvt_max_iter=8), device="cuda",
                        engine=engine, write=False, wvt_checkpoint=ck,
                        log=lambda stage, **kw: logs.append((stage, kw)))
    assert [kw for s, kw in logs if s == "wvt_resume"] == [
        dict(it=4, step=step)]
    assert [kw["it"] for s, kw in logs if s == "wvt"][0] == 4
    for k in ("pos", "vel", "rho", "hsml", "bfld"):
        assert bool(torch.isfinite(getattr(parts, k)).all()), k


def test_stage_memory_on_cuda(dev):
    """On the card the five stage records of make_ics carry the
    allocator's mem_gib and peak_gib, 0 < mem_gib <= peak_gib."""
    from toycluster_tpu_torch import parse_par_file
    from toycluster_tpu_torch.pipeline import make_ics
    logs = {}
    cfg = parse_par_file(str(_PAR), ntotal=20000, sph_kernel="m4",
                         wvt_max_iter=4)
    make_ics(cfg, device="cuda", write=False,
             log=lambda stage, **kw: logs.setdefault(stage, kw))
    for stage in ("positions", "sph_quantities", "magnetic_field",
                  "temperatures", "velocities"):
        rec = logs[stage]
        assert 0 < rec["mem_gib"] <= rec["peak_gib"], (stage, rec)


@pytest.mark.parametrize("engine,names", [
    ("stream", ("stream_wvt_kernel",)),
    ("classed", ("fused_wvt_kernel", "solve_density_kernel"))])
def test_profile_dir_on_cuda_names_the_kernels(dev, engine, names, tmp_path):
    import json
    from toycluster_tpu_torch import parse_par_file
    from toycluster_tpu_torch.pipeline import make_ics
    cfg = parse_par_file(str(_PAR), ntotal=20000, sph_kernel="m4",
                         wvt_max_iter=4)
    make_ics(cfg, device="cuda", engine=engine, write=False,
             profile_dir=str(tmp_path / "prof"), log=lambda *a, **k: None)
    with open(tmp_path / "prof" / "wvt_trace.json") as fh:
        seen = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    assert any(n in s for n in names for s in seen), sorted(seen)[:50]


@pytest.mark.parametrize("mode", ["ring", "xla"])
def test_sharded_step_on_one_nccl_rank(dev, mode):
    """One sharded WVT step (parallel/wvt_shard.py) on one NCCL rank on
    the card, against the same step on one gloo CPU rank (the plain
    versions), at the kernels' tolerances: h and rho rtol 2e-3 on >= 98%
    of the gas, the displacement rtol 2e-4 / atol 1e-6 max|delta|; the
    step launched its kernels on the card.  Lists of the JAX default width
    (256 blocks, 64 superblocks): 64 blocks overflow at this size."""
    from torch_parallel_ranks import port_scene, rank_steps
    from toycluster_tpu_torch.ops import cuda_build
    from toycluster_tpu_torch.parallel.mesh import spawn
    cuda_build.build(("stream_wvt", "solve_density", "wvt_displacement"))
    data = port_scene(20_000)
    got = spawn(rank_steps, 1, backend="nccl", device="cuda", timeout_s=300,
                args=(data, (mode,), 256))[0]
    ref = spawn(rank_steps, 1, backend="gloo", device="cpu", timeout_s=300,
                args=(data, (mode,), 256))[0]
    want = ("stream_wvt",) if mode == "ring" else ("solve_density",
                                                   "wvt_displacement")
    assert all(got["launches"][k] > 0 for k in want)
    assert ref["launches"] == dict.fromkeys(ref["launches"], 0)
    g, r = got[mode], ref[mode]
    assert int(g["cand_overflow"]) <= 0
    for k in ("rho", "hsml"):
        assert np.isclose(g[k], r[k], rtol=2e-3).mean() >= 0.98, k
    box = data["kw"]["boxsize"]

    def disp(p):
        d = p - data["pos"]
        return d - box * np.round(d / box)
    a, b = disp(r["pos"]), disp(g["pos"])
    np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-6 * np.abs(a).max())


def test_speculating_loop_has_no_host_sync_in_its_window(dev, monkeypatch):
    """The 1e6 par on the stream engine with the window between queuing
    iteration it+1 and reading it's scalars under the sync check
    (``wvt.SYNC_CHECK``: a host sync there raises): iterations are queued
    ahead and adopted; with TOYCLUSTER_SPECULATE=0 none is queued."""
    from toycluster_tpu_torch import parse_par_file
    from toycluster_tpu_torch.models import sph, wvt
    from toycluster_tpu_torch.pipeline import make_ics
    monkeypatch.setattr(wvt, "SYNC_CHECK", True)
    cfg = parse_par_file(str(_PAR))
    done = {}
    for spec in ("1", "0"):
        monkeypatch.setenv("TOYCLUSTER_SPECULATE", spec)
        logs = []
        make_ics(cfg, device="cuda", write=False,
                 log=lambda stage, **kw: logs.append((stage, kw)))
        done[spec] = [kw for s, kw in logs if s == "wvt_done"][0]
        assert sph.last_contract_frac >= 0.999
    assert done["1"]["speculated"] > 0 and done["1"]["adopted"] > 0
    assert done["0"]["speculated"] == done["0"]["adopted"] == 0
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
def test_stream_wvt_same_bits_at_a_trimmed_width(dev, kernel):
    """The kernel on the cusp's lists and on the same lists padded with
    -1 columns to the sticky trim width (``sph.trim_width``): every
    output equal to the bit."""
    from toycluster_tpu_torch.models import sph
    args, kw, _ = cusp.wvt_inputs(kernel, True, N, device=dev)
    cand = args[1]
    width = sph.trim_width(int(args[2].max()), sp.MAX_LIST_WIDTH, {}, 0)
    width = max(width, 2 * cand.shape[1])
    wide = torch.cat([cand, torch.full(
        (cand.shape[0], width - cand.shape[1]), -1, dtype=cand.dtype,
        device=dev)], dim=1).contiguous()
    ref = sp.stream_wvt(*args, **kw)
    got = sp.stream_wvt(args[0], wide, *args[2:], **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("engine", ["stream", "classed"])
def test_offload_gives_the_same_bits_on_cuda(dev, monkeypatch, engine):
    """``make_ics`` on the 60,000-particle config-4 scene with the
    offload (TOYCLUSTER_WVT_OFFLOAD_N at 1) and without it: the same
    particle set to the bit, and the loop parked and rebuilt it only
    with the offload."""
    from toycluster_tpu_torch import parse_par_file
    from toycluster_tpu_torch.pipeline import make_ics
    cfg = parse_par_file(str(_PAR), ntotal=60000, mass_ratio=1.0 / 3.0,
                         substructure=True, wvt_max_iter=4)
    runs = {}
    for offload_n in ("1", str(10**12)):
        monkeypatch.setenv("TOYCLUSTER_WVT_OFFLOAD_N", offload_n)
        logs = []
        _, parts = make_ics(cfg, device="cuda", engine=engine, write=False,
                            log=lambda stage, **kw: logs.append(stage))
        runs[offload_n] = (parts, logs)
    (on, logs_on), (off, logs_off) = runs["1"], runs[str(10**12)]
    assert logs_on.count("wvt_offload") == logs_on.count("wvt_restore") == 1
    assert "wvt_offload" not in logs_off and "wvt_restore" not in logs_off
    for k in ("pos", "vel", "pid", "halo", "u", "rho", "hsml",
              "var_hsml_fac", "rho_model", "bfld"):
        assert torch.equal(getattr(on, k), getattr(off, k)), k


def _sweep_inputs(dev, n=500_000):
    """The 1e6 par's sweep shapes on a cusp of ``n`` gas points (3,907
    blocks, 489 superblocks): the block index, per-block radii (3 h0)
    and the symmetric radii (0.7 of them)."""
    from toycluster_tpu_torch.ops import blocks as blk
    pos, h0 = (torch.as_tensor(a, device=dev)
               for a in cusp.cusp_points(n, seed=3))
    bi = blk.build_blocks(pos, cusp.BOX)
    hs = blk.pad_rows(h0[bi.order], bi.n_padded) * 3.0
    rad = hs.reshape(bi.n_blocks, blk.BLOCK).amax(dim=1)
    return bi, rad, rad * 0.7


@pytest.mark.parametrize("rows,width", [("all", 192), ("all", 256),
                                        ("all", "ns"), ("tail", 1024)])
def test_topk_sweep_equals_oracle_at_1e6_shapes(dev, rows, width):
    """The top-k superblock sweep against its oracle (the stable sort over
    every superblock) on the card at the 1e6 par's shapes: every row at
    the first search width, the probe width and k = ns, and 244 far-tail
    rows (108 real, the rest -1) at the far tail's width 1024 (k = ns):
    lists, counts and overflow to the bit."""
    from toycluster_tpu_torch.ops import blocks as blk
    bi, rad, sym = _sweep_inputs(dev)
    nb, ns = bi.n_blocks, bi.sb_lo.shape[0]
    assert (nb, ns) == (3907, 489)
    ids = torch.arange(nb, dtype=torch.int32, device=dev)
    if rows == "tail":
        ids = torch.cat([ids[-108:], ids.new_full((136,), -1)])
    width = ns if width == "ns" else width
    args = (bi, ids, rad, sym, cusp.BOX, width)
    got = blk._find_candidates_super_k(*args)
    ref = blk._find_candidates_super_k_sorted(*args)
    assert torch.equal(got.idx, ref.idx)
    assert torch.equal(got.count, ref.count)
    assert got.overflow == ref.overflow


def _config5_halos(dev):
    """Config 5's scene (72 halos, betas 0.54 and 2/3) with its halo
    arrays on the card, every third halo given a cool core."""
    import dataclasses
    from toycluster_tpu_torch.config import parse_par_file
    from toycluster_tpu_torch.models.substructure import setup_substructure
    from toycluster_tpu_torch.particles import halo_arrays_from_scene
    from toycluster_tpu_torch.run_configs import PARS, PRESETS
    from toycluster_tpu_torch.scene import build_scene
    cfg = parse_par_file(str(PARS[5]), **PRESETS[5])
    scene = setup_substructure(build_scene(cfg), seed=cfg.seed + 7)
    ha = halo_arrays_from_scene(scene, dev)
    cuspy = (torch.arange(ha.n_halos, device=dev) % 3 == 0).float()
    return scene, dataclasses.replace(ha, have_cuspy=cuspy)


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("cool_core", [None, (50.0, 40.0)])
@pytest.mark.parametrize("beta", [None, 2.0 / 3.0, 0.54])
def test_density_model_kernel_matches_plain(dev, beta, cool_core, subset):
    """The model-density kernel against its plain version (the per-halo
    PyTorch loop) on the card, on config 5's 72 halos and 1e6 lanes from
    the halo centres out past rcut, every branch: each halo's beta or a
    static one (2/3: the closed form), with and without the cool core,
    every gas halo or a subset.  Bit-equal, and a call with its table
    launches the kernel once and no PyTorch op."""
    from toycluster_tpu_torch.ops import density_model as dm
    scene, ha = _config5_halos(dev)
    assert ha.n_halos == 72
    halos = dm.gas_halos(ha)[1::4] if subset else dm.gas_halos(ha)
    box = scene.boxsize
    pos = cusp.model_points(ha, box, 1_000_000)
    table = dm.model_table(ha, box, halos, cool_core, beta)
    before = dm.density_model.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = dm.density_model(pos, ha, box, cool_core, beta=beta,
                               halos=halos, table=table)
        torch.cuda.synchronize()
    assert dm.density_model.launches == before + 1
    ops = {e.key: e.count for e in prof.key_averages()}
    assert sum(n for name, n in ops.items()
               if "density_model_kernel" in name) == 1
    assert not [name for name in ops if "at::native" in name]
    want = dm._density_model_reference(pos, ha, box, cool_core, beta, halos)
    assert (want > 0).all()
    assert torch.equal(got, want)
    assert torch.equal(dm.density_model(pos, ha, box, cool_core, beta=beta,
                                        halos=halos), got)
