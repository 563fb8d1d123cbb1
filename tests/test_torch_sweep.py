"""The superblock candidate sweep as the JAX package runs it
(``toycluster_tpu_torch/ops/blocks.py``, ``models/sph.py``): the nearest-k
selection by top-k against the full stable sort it replaced (the oracle
``_find_candidates_super_k_sorted``), to the bit; the sticky search width
and the sticky second-pass rows against the JAX package's
``_LAST_MAX_CAND`` and ``_SUBSET_MEMO`` over the same sequences of calls;
the builders' lists equal to those of the oracle's sweep; and the
sweeps' runner (``blk.Sweeps``) equal to direct calls.

Against the JAX package the lists are compared as sets where the order
of equal-distance superblocks could differ (float differences in d2), as
tests/test_torch_neighbours.py does; against the oracle, bit for bit.

The sweep kernel (``blk.super_sweep``, ``csrc/super_sweep.cu``) is held
on the card, bit for bit, against the chunked PyTorch sweep it replaces
(``blk._super_sweep`` with the top-k) and against the oracle; its CPU
path is that PyTorch sweep.  JAX is imported only by the tests that
compare with it, so the card tests run on a machine without it
(``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_sweep.py``); without a card they skip."""

from functools import partial

import numpy as np
import pytest
import torch

from toycluster_tpu_torch.models import sph as tsph
from toycluster_tpu_torch.ops import blocks as tblk
from toycluster_tpu_torch.ops import cusp as tcusp

torch.set_num_threads(2)

BOX = 1000.0
JAX_KEY = ("sball", False, True)   # the JAX memo key of the WVT loop's search


def _jax():
    """The JAX package's numpy, sph and blocks modules."""
    import jax.numpy as jnp

    from toycluster_tpu.models import sph as jsph
    from toycluster_tpu.ops import blocks as jblk
    return jnp, jsph, jblk


def _cusp(n, seed):
    """The clustered periodic points of tests/test_torch_neighbours.py."""
    rng = np.random.default_rng(seed)
    r = 80.0 * (rng.random(n) ** 2 / (1 - rng.random(n) * 0.7))
    r = np.clip(r, 0, 400.0)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return ((BOX / 2 + r[:, None] * u) % BOX).astype(np.float32)


def _radii(order, nb, n, seed, scale=1.0):
    """Per-block radii (the largest of the block's lanes) and the
    symmetric ones, 0.7 of them, float32."""
    rng = np.random.default_rng(seed)
    h = ((8.0 + 40.0 * rng.random(n)) * scale).astype(np.float32)[order]
    h = np.concatenate([h, np.repeat(h[-1:], nb * 128 - h.size)])
    rad = h.reshape(nb, 128).max(axis=1)
    return rad, (rad * 0.7).astype(np.float32)


@pytest.fixture(scope="module", params=[5000, 20000])
def cusp(request):
    """(port block index, per-block radii, symmetric radii) of a cusp."""
    n = request.param
    bi = tblk.build_blocks(torch.from_numpy(_cusp(n, n)), BOX)
    rad, sym = _radii(bi.order.numpy(), bi.n_blocks, n, seed=1)
    return bi, torch.from_numpy(rad), torch.from_numpy(sym)


def _rows(nb):
    """Every receiver block, two of them as padded (-1) rows."""
    ids = torch.arange(nb, dtype=torch.int32)
    ids[[3, -1]] = -1
    return ids


def _assert_same(got, ref):
    assert got.idx.dtype == ref.idx.dtype == torch.int32
    assert torch.equal(got.idx, ref.idx)
    assert torch.equal(got.count, ref.count)
    assert got.overflow == ref.overflow


# ------------------------------------------------- top-k against the oracle

@pytest.mark.parametrize("width", [4, 16, 64, "ns"])
def test_topk_sweep_equals_sorted_oracle(cusp, width):
    """Widths that overflow (4, 16) and that do not (64), and k = ns
    (width "ns"; 64 is past ns on both cusps, so k = ns there too),
    with padded receiver rows: the top-k sweep's lists, counts and
    overflow equal the stable sort's to the bit."""
    bi, rad, sym = cusp
    ns = bi.sb_lo.shape[0]
    width = ns if width == "ns" else width
    args = (bi, _rows(bi.n_blocks), rad, sym, BOX, width)
    got = tblk._find_candidates_super_k(*args)
    ref = tblk._find_candidates_super_k_sorted(*args)
    _assert_same(got, ref)
    assert bool((got.idx[[3, -1]] == -1).all())
    assert bool((got.count[[3, -1]] == 0).all())


def _tied_index():
    """A block index of 64 superblocks (512 blocks) built for ties:
    superblocks 0..7 hold the receivers, the boxes of 8..39 overlap
    theirs (d2 = 0 for all 40), and superblocks 40..63 sit in pairs at 12
    equal distances along the axes."""
    nb, ns = 512, 64
    centre = torch.full((ns, 3), 500.0)
    centre[8:40] += torch.linspace(-2.0, 2.0, 32)[:, None]
    for j in range(12):
        off = 30.0 + 10.0 * j
        centre[40 + 2 * j, j % 3] += off
        centre[41 + 2 * j, j % 3] -= off
    lo = (centre - 3.0).repeat_interleave(8, dim=0)
    hi = (centre + 3.0).repeat_interleave(8, dim=0)
    sb_lo, sb_hi = tblk.superblock_boxes(lo, hi)
    none = torch.empty((0,))
    return tblk.BlockIndex(order=none, pos=none, valid=none, bb_lo=lo,
                           bb_hi=hi, sb_lo=sb_lo, sb_hi=sb_hi)


@pytest.mark.parametrize("width", [1, 8, 40, 50])
def test_ties_at_zero_distance(width):
    """Rows whose hits tie at d2 = 0 (40 superblocks) and at equal
    distances past it: the cut falls inside the tie (1, 8), at its end
    (40) and inside the equal-distance pairs (50); the top-k keeps the
    lower ids of a tie, as the oracle does, to the bit."""
    bi = _tied_index()
    rad = torch.full((bi.n_blocks,), 200.0)
    args = (bi, torch.arange(64, dtype=torch.int32), rad, rad, BOX, width)
    got = tblk._find_candidates_super_k(*args)
    ref = tblk._find_candidates_super_k_sorted(*args)
    _assert_same(got, ref)
    assert bool((got.count == 64).all())
    zero = torch.arange(40, dtype=torch.int32)
    first = got.idx[:, :min(width, 40)]
    # every row's nearest hits are the zero-distance ones, lowest id first
    assert torch.equal(first, zero[:first.shape[1]].expand_as(first))


# ------------------------------------------------ the sticky search width

@pytest.fixture(scope="module")
def uniform():
    """600,000 uniform points blocked by both packages (586 superblocks:
    a search can grow past the first width and the probe), and radii."""
    jnp, _, jblk = _jax()
    n = 600_000
    pos = (np.random.default_rng(11).random((n, 3)) * BOX).astype(np.float32)
    tb = tblk.build_blocks(torch.from_numpy(pos), BOX)
    jb = jblk.build_blocks(jnp.asarray(pos), BOX)
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    rad, _ = _radii(tb.order.numpy(), tb.n_blocks, n, seed=1)
    return tb, jb, rad


def _tried(monkeypatch, mod):
    """Record the list width of each ``find_candidates_super`` call of
    ``mod``."""
    tried, orig = [], mod.find_candidates_super

    def call(*args, **kw):
        tried.append(kw["max_cand"])
        return orig(*args, **kw)
    monkeypatch.setattr(mod, "find_candidates_super", call)
    return tried


def test_search_width_follows_jax(uniform, monkeypatch):
    """The stream search of one relaxation's calls at radii scaled 8, 12,
    2, 8, 4 (growth past the probe, growth to the cap, the width let down
    to twice the trimmed width, growth again, a call whose start width
    holds): the widths each call tried, the sticky search width after it,
    the trimmed width and the counts equal the JAX package's (its memos
    emptied first); a call whose start width holds sweeps once."""
    jnp, jsph, jblk = _jax()
    tb, jb, rad0 = uniform
    for name in ("_LAST_MAX_CAND", "_TRIM_MEMO", "_BUCKET_MEMO"):
        monkeypatch.setattr(jsph, name, {})
    monkeypatch.setattr(jblk, "_SUBSET_MEMO", {})
    monkeypatch.delenv("TOYCLUSTER_SB_WIDTH_START", raising=False)
    j_tried, t_tried = _tried(monkeypatch, jblk), _tried(monkeypatch, tblk)
    widths, sweeps = {}, tblk.Sweeps()
    seen = []
    for scale in (8.0, 12.0, 2.0, 8.0, 4.0):
        rad = (rad0 * scale).astype(np.float32)
        sym = (rad * 0.7).astype(np.float32)
        del j_tried[:], t_tried[:]
        jc = jsph._sb_candidates(jb, JAX_KEY, jnp.asarray(rad),
                                 jnp.asarray(sym), BOX)
        jc, _ = jsph._trim_and_buckets(jc, search_key=JAX_KEY)
        tc = tsph._sb_candidates(tb, torch.from_numpy(rad),
                                 torch.from_numpy(sym), BOX, widths, sweeps)
        n_sweeps = sweeps.tally()[0]
        assert t_tried == j_tried
        assert tc.searched == (j_tried[0], j_tried[-1])
        assert widths[tsph.SEARCH_KEY] == jsph._LAST_MAX_CAND[JAX_KEY]
        assert tc.idx.shape == np.asarray(jc.idx).shape
        np.testing.assert_array_equal(tc.count.numpy(), np.asarray(jc.count))
        seen.append((tuple(t_tried), n_sweeps))
    # grown, let down, grown again; the last call's start width held
    assert [len(t) for t, _ in seen] == [2, 2, 1, 2, 1]
    assert seen[3][0][0] < seen[1][0][-1]
    assert seen[-1][1] == 1


def test_one_sweep_where_the_start_width_holds(cusp):
    """A relaxation's second search of the same lists starts at the width
    the first grew to and sweeps once; a fresh memo starts over."""
    bi, rad, sym = cusp
    widths, sweeps = {}, tblk.Sweeps()
    first = tsph._sb_candidates(bi, rad, sym, BOX, widths, sweeps)
    n_first = sweeps.tally()[0]
    again = tsph._sb_candidates(bi, rad, sym, BOX, widths, sweeps)
    assert sweeps.tally()[0] == 1
    assert again.searched == (first.searched[1], first.searched[1])
    assert torch.equal(again.idx, first.idx)
    fresh = tsph._sb_candidates(bi, rad, sym, BOX, {}, sweeps)
    assert fresh.searched == first.searched
    assert sweeps.tally()[0] == n_first


# ------------------------------------------------ the second pass's rows

def test_second_pass_rows_follow_jax(monkeypatch):
    """Two-pass searches (the probe cut to 12 superblocks in both
    packages) on the 20,000-point cusp at radii whose rows over the probe
    number 25, 103, 58, 155 and 25 again: the second pass's padded row
    count equals the JAX package's ``_SUBSET_MEMO`` after every call (the
    next power of two, at least 64, never below the last), and the lists
    equal the single pass of the oracle to the bit and JAX's as sets."""
    jnp, _, jblk = _jax()
    monkeypatch.setattr(jblk, "_K_PROBE", 12)
    monkeypatch.setattr(tblk, "_K_PROBE", 12)
    monkeypatch.setattr(jblk, "_SUBSET_MEMO", {})
    pos = _cusp(20000, 20000)
    tb = tblk.build_blocks(torch.from_numpy(pos), BOX)
    jb = jblk.build_blocks(jnp.asarray(pos), BOX)
    nb, ns = tb.n_blocks, tb.sb_lo.shape[0]
    ids = _rows(nb)
    memo, rows = {}, []
    for scale in (0.01, 0.5, 0.1, 2.0, 0.01):
        rad, sym = _radii(tb.order.numpy(), nb, 20000, 2, scale)
        args = (ids, torch.from_numpy(rad), torch.from_numpy(sym), BOX)
        got = tblk.find_candidates_super(tb, *args, max_cand=16, memo=memo)
        ref = tblk._find_candidates_super_k_sorted(tb, *args, 16)
        _assert_same(got, ref)
        jc = jblk.find_candidates_super(
            jb, jnp.asarray(ids.numpy()), jnp.asarray(rad), jnp.asarray(sym),
            BOX, max_cand=16)
        np.testing.assert_array_equal(got.count.numpy(), np.asarray(jc.count))
        for a, b in zip(got.idx.numpy(), np.asarray(jc.idx)):
            assert set(a) == set(b)
        assert memo["subset"] == jblk._SUBSET_MEMO
        rows.append((int((got.count > 12).sum()), memo["subset"][ns]))
    assert rows == [(25, 64), (103, 128), (58, 128), (155, 256), (25, 256)]


# ------------------------------------------- the builders through the oracle

def _oracle_sweep(monkeypatch):
    """Every sweep of ``tblk`` selecting by the full stable sort."""
    monkeypatch.setattr(tblk, "_super_sweep", partial(
        tblk._super_sweep, select=tblk._nearest_sorted))


def _assert_states_equal(a, b):
    assert torch.equal(a.cand.idx, b.cand.idx)
    assert torch.equal(a.cand.count, b.cand.count)
    assert (a.tail is None) == (b.tail is None)
    for x, y in zip(a.tail or (), b.tail or ()):
        assert torch.equal(x, y)


def _build(kind, pos, h, monkeypatch):
    """The state ``kind`` makes from ``pos`` on a fresh memo and sweeps:
    a stream build, a stream build then a refresh of moved positions, or
    a count-class build with far-tail rows and a two-pass far-tail
    search (narrow budgets, the probe cut to 2)."""
    widths, sweeps = {}, tblk.Sweeps()
    if kind == "classed":
        monkeypatch.setattr(tsph, "MAX_CAND_START", 16)
        monkeypatch.setattr(tsph, "MS_CAP", 8)
        monkeypatch.setattr(tsph, "TAIL_WIDTH_START", 4)
        monkeypatch.setattr(tblk, "_K_PROBE", 2)
        return tsph.build_neighbours_blocks(pos, h, BOX, radius_sym_gas=h,
                                            widths=widths, sweeps=sweeps)
    state = tsph.build_neighbours(pos, h, BOX, radius_sym_gas=h,
                                  widths=widths, sweeps=sweeps)
    if kind == "refresh":
        n = pos.shape[0]
        rng = np.random.default_rng(4)
        moved = state.index.pos[:n] + torch.from_numpy(
            rng.normal(scale=3.0, size=(n, 3)).astype(np.float32))
        moved = moved - torch.floor(moved / BOX) * BOX
        state = tsph.refresh_candidates(state, moved, h * 1.3, BOX,
                                        widths=widths, sweeps=sweeps)
    return state


@pytest.mark.parametrize("kind", ["build", "refresh", "classed"])
def test_builders_equal_their_oracle_lists(kind, monkeypatch):
    """build_neighbours, refresh_candidates and build_neighbours_blocks
    on the 20,000-point cusp give the same lists, counts and far-tail rows
    with the top-k sweep as with the stable sort's."""
    pos = torch.from_numpy(_cusp(20000, 7))
    h = torch.from_numpy(_radii(np.arange(20000), 157, 20000, 5)[0]
                         .repeat(128)[:20000])
    got = _build(kind, pos, h, monkeypatch)
    if kind == "classed":
        assert got.tail is not None and got.tail[1].shape[1] > 2
    _oracle_sweep(monkeypatch)
    _assert_states_equal(got, _build(kind, pos, h, monkeypatch))


# ------------------------------------------------------- the sweeps' runner

def _calls(kind, bi, sweeps, scale, memo):
    """One call of ``kind`` (a superblock search past the probe with its
    second pass, a block-granular search, a refresh's box pass) at radii
    or positions scaled by ``scale``."""
    nb = bi.n_blocks
    rad, sym = _radii(bi.order.numpy(), nb, bi.order.shape[0], 3, scale)
    rad, sym = torch.from_numpy(rad), torch.from_numpy(sym)
    if kind == "super":
        c = tblk.find_candidates_super(bi, _rows(nb), rad, sym, BOX,
                                       max_cand=16, memo=memo, sweeps=sweeps)
        return c.idx, c.count, c.overflow
    if kind == "blocks":
        c = tblk.find_candidates(bi, rad, BOX, max_cand=64, radius_sym=sym,
                                 sweeps=sweeps)
        return c.idx, c.count, c.sb_count, c.overflow, c.sb_overflow
    pos = bi.pos[:bi.order.shape[0]] * scale % BOX
    return tblk.run_sweep(sweeps, partial(
        tsph._refresh_boxes, n_padded=bi.n_padded, boxsize=BOX), (pos,),
        sweep=False)


@pytest.mark.parametrize("kind", ["super", "blocks", "boxes"])
def test_program_wrapper_equals_direct_calls(kind, monkeypatch):
    """``blk.Sweeps`` runs each sweep as the direct call does: every
    call equals a direct one, a result is left alone by a later call,
    the sweeps are counted (a refresh's box pass is no sweep) and each
    is one ``wvt_sweep`` span of the runner's ``spans``."""
    monkeypatch.setattr(tblk, "_K_PROBE", 2)
    bi = tblk.build_blocks(torch.from_numpy(_cusp(5000, 5000)), BOX)
    sweeps, memo = tblk.Sweeps(), {}
    outs = []
    for scale in (1.0, 0.5, 1.0):
        got = _calls(kind, bi, sweeps, scale, memo)
        ref = _calls(kind, bi, None, scale, {})
        for a, b in zip(got, ref):
            assert (torch.equal(a, b) if torch.is_tensor(a) else a == b)
        outs.append(got)
    for a, b in zip(outs[0], outs[2]):
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b)
    per_call = {"super": 2, "blocks": 1, "boxes": 1}[kind]
    assert sweeps.tally() == (0 if kind == "boxes" else 3 * per_call, 0)
    assert sweeps.tally() == (0, 0)
    spans = sweeps.spans.take()
    assert [s["name"] for s in spans] == ["wvt_sweep"] * 3 * per_call
    assert all(s["parent"] == -1 for s in spans)


# ------------------------------------------------ the loop that holds them

@pytest.mark.parametrize("engine", ["stream", "classed"])
def test_loop_is_freed_without_the_cycle_collector(engine):
    """A WVT loop object (``_Loop``: its sweeps, its spans, the state its
    selections hold) holds no reference to
    itself: it is freed as its last reference goes, not at the cycle
    collector's next pass, so a relaxation's lists do not outlive it on
    the card."""
    import gc
    import os
    import weakref

    from toycluster_tpu_torch.config import parse_par_file
    from toycluster_tpu_torch.models import wvt as twvt
    from toycluster_tpu_torch.particles import halo_arrays_from_scene
    from toycluster_tpu_torch.scene import build_scene
    par = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "toycluster_tpu_torch", "data", "cluster.par")
    scene = build_scene(parse_par_file(par, ntotal=3000))
    loop = twvt._Loop(scene, halo_arrays_from_scene(scene, "cpu"), 1500,
                      engine, torch.device("cpu"), lambda stage, **kw: None)
    assert loop.sweeps.spans is loop.spans
    ref = weakref.ref(loop)
    gc.disable()
    try:
        del loop
        assert ref() is None
    finally:
        gc.enable()


# ------------------------------------------------ the sweep kernel

def test_cpu_tensor_takes_the_plain_sweep(cusp):
    """On a CPU tensor ``super_sweep`` is the plain sweep: the lists,
    counts and widest count of ``_super_sweep`` with the top-k, no row
    spilled, and no kernel launched."""
    bi, rad, sym = cusp
    args = tblk._super_args(bi, _rows(bi.n_blocks), rad, sym)
    before = tblk.super_sweep.launches
    idx, count, most = tblk.super_sweep(*args, boxsize=BOX, max_cand=16)
    ref = tblk._super_sweep(*args, boxsize=BOX, max_cand=16)
    assert torch.equal(idx, ref[0]) and torch.equal(count, ref[1])
    assert most.tolist() == [int(ref[2]), 0]
    assert tblk.super_sweep.launches == before == 0


@pytest.mark.parametrize("t,k,n_sm,splits", [
    (390_625, 256, 132, 2),    # 1e8 particles, the probe
    (39_063, 256, 132, 2),     # 1e7
    (3_907, 192, 132, 32),     # 1e6: few rows, so 32 threads a row
    (390_625, 16, 132, 1),     # a narrow list: 32 keys a row hold it
    (64, 1536, 132, 32)])      # a second pass's padded rows
def test_sweep_splits_follow_the_rows_and_the_width(t, k, n_sm, splits):
    """The kernel's threads a row: the fewest that give each row at least
    min(k, 64) keys of the on-chip buffer and the sweep two CTAs a
    multiprocessor, at most 32."""
    got = tblk._sweep_splits(t, k, n_sm)
    assert got == splits
    row_keys = tblk._SWEEP_KEYS * got // tblk._SWEEP_THREADS
    grid = -(-t * got // tblk._SWEEP_THREADS)
    assert got == tblk._SWEEP_MAX_SPLITS or (
        row_keys >= min(k, tblk._SWEEP_MIN_ROW_KEYS) and grid >= 2 * n_sm)


def test_spills_read_where_the_sweeps_read_and_at_settle():
    """``Sweeps`` counts the rows spilled that a sweep's host read took,
    keeps those of the sweeps no read follows (a second pass's, on the
    device) for ``settle``, which reads them all in one read, and hands
    the sum to the record's tally."""
    sweeps = tblk.Sweeps()
    sweeps.note_spills(3)
    sweeps.note_spills(torch.tensor(4, dtype=torch.int32))
    sweeps.note_spills(torch.tensor([5], dtype=torch.int32)[0])
    assert sweeps.spills == 3 and len(sweeps.unread) == 2
    sweeps.settle(torch.device("cpu"))
    assert sweeps.spills == 12 and not sweeps.unread
    sweeps.settle(torch.device("cpu"))
    assert sweeps.spills == 12
    sweeps.tally()
    assert sweeps.spills == 0


@pytest.fixture
def dev():
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_scene(kind, dev, spread, n=2_500_000):
    """A block index of ``n`` points on the card (19,532 blocks, 2,442
    superblocks) and per-block radii and symmetric radii (0.7 of them):
    the cusp centred on the box's corner, so that it lies across the
    periodic edge on every axis, or uniform points.  ``spread``: radii
    log-uniform over 10-700 a block (rows from a few hits to every
    superblock), else the largest of 8-48 over each block's points."""
    if kind == "cusp":
        pos, _ = tcusp.cusp_points(n, seed=3, centre=0.0)
    else:
        pos = (np.random.default_rng(5).random((n, 3)) * BOX
               ).astype(np.float32)
    bi = tblk.build_blocks(torch.from_numpy(pos).to(dev), BOX)
    nb = bi.n_blocks
    if spread:
        rng = np.random.default_rng(9)
        rad = np.exp(rng.uniform(np.log(10.0), np.log(700.0), nb)
                     ).astype(np.float32)
        sym = (rad * 0.7).astype(np.float32)
    else:
        rad, sym = _radii(bi.order.cpu().numpy(), nb, n, seed=1)
    return bi, torch.from_numpy(rad).to(dev), torch.from_numpy(sym).to(dev)


@pytest.fixture(scope="module")
def card_scenes():
    """``_card_scene``s by (kind, spread), made once."""
    return {}


def _scene_of(card_scenes, kind, spread, dev):
    if (kind, spread) not in card_scenes:
        card_scenes[kind, spread] = _card_scene(kind, dev, spread)
    return card_scenes[kind, spread]


def _assert_kernel_equals_plain(bi, rows, rad, sym, width):
    """The kernel's lists, counts and widest count against the chunked
    PyTorch sweep's (top-k) and the oracle's (stable sort) on the card,
    to the bit, and a rerun's; returns the rows spilled."""
    args = tblk._super_args(bi, rows, rad, sym)
    before = tblk.super_sweep.launches
    got = tblk.super_sweep(*args, boxsize=BOX, max_cand=width)
    again = tblk.super_sweep(*args, boxsize=BOX, max_cand=width)
    assert tblk.super_sweep.launches == before + 2
    for select in (tblk._nearest_topk, tblk._nearest_sorted):
        ref = tblk._super_sweep(*args, boxsize=BOX, max_cand=width,
                                select=select)
        assert got[0].dtype == torch.int32 and got[0].shape == ref[0].shape
        assert torch.equal(got[0], ref[0])
        assert torch.equal(got[1], ref[1])
        assert int(got[2][0]) == int(ref[2])
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    return int(got[2][1])


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["default", "spills"])
@pytest.mark.parametrize("width", [4, 64, 256, 1536, 2048, 4096])
@pytest.mark.parametrize("kind", ["cusp", "uniform"])
def test_kernel_equals_torch_sweep(dev, card_scenes, kind, width, regime,
                                   monkeypatch):
    """Every receiver row (two of them padded, -1) of the cusp across the
    periodic edge and of uniform points, at widths 4, 64, 256, the cap
    1536, a far-tail width past it (k < ns = 2,442) and one past ns
    (4096: k = ns, the last columns -1): the kernel's lists, counts and
    widest count equal the PyTorch sweep's and the oracle's to the bit.  "spills": radii from a few hits to
    every superblock and a 512-key buffer (a 64-key slice a row), so
    rows spill, keep their k nearest as they go (past 512 hits) and, for
    k + 256 > 512, do so in the wrapper's device scratch; by default the
    uniform rows fit their slices and the cusp's densest spill."""
    if regime == "spills":
        monkeypatch.setattr(tblk, "_SWEEP_KEYS", 512)
    bi, rad, sym = _scene_of(card_scenes, kind, regime == "spills", dev)
    assert (bi.n_blocks, bi.sb_lo.shape[0]) == (19_532, 2_442)
    spilled = _assert_kernel_equals_plain(
        bi, _rows(bi.n_blocks).to(dev), rad, sym, width)
    assert (spilled > 0) == (regime == "spills" or kind == "cusp")


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["default", "spills"])
def test_kernel_on_padded_far_tail_rows(dev, card_scenes, regime,
                                        monkeypatch):
    """300 rows drawn from the cusp's blocks then 212 padded ones (-1), as
    the count-class engine's far tail passes them, at its first width
    1024: equal to the PyTorch sweep and the oracle; the padded rows
    count 0 and list -1 only."""
    if regime == "spills":
        monkeypatch.setattr(tblk, "_SWEEP_KEYS", 512)
    bi, rad, sym = _scene_of(card_scenes, "cusp", regime == "spills", dev)
    ids = torch.from_numpy(np.random.default_rng(2).choice(
        bi.n_blocks, 300, replace=False).astype(np.int32))
    rows = torch.cat([ids, ids.new_full((212,), -1)]).to(dev)
    _assert_kernel_equals_plain(bi, rows, rad, sym, 1024)
    idx, count, _ = tblk.super_sweep(*tblk._super_args(bi, rows, rad, sym),
                                     boxsize=BOX, max_cand=1024)
    assert bool((count[300:] == 0).all()) and bool((idx[300:] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 4, 256])
def test_kernel_at_any_threads_a_row(dev, card_scenes, splits,
                                     monkeypatch):
    """One thread a row, four, and a whole CTA a row, with the 512-key
    buffer (slices of 2, 8 and 512 keys) on the spread radii: the lists
    do not depend on how the kernel splits a row."""
    monkeypatch.setattr(tblk, "_SWEEP_KEYS", 512)
    monkeypatch.setattr(tblk, "_sweep_splits", lambda t, k, n_sm: splits)
    bi, rad, sym = _scene_of(card_scenes, "cusp", True, dev)
    spilled = _assert_kernel_equals_plain(
        bi, _rows(bi.n_blocks).to(dev), rad, sym, 256)
    assert spilled > 0


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 8, 40, 50, 80])
def test_kernel_ties_at_zero_distance(dev, width):
    """The tied index of ``test_ties_at_zero_distance`` on the card, and
    a width past its 64 superblocks: the kernel keeps the lower ids of a
    tie, as the PyTorch sweep and the oracle do, to the bit."""
    bi = tblk.BlockIndex(*(x.to(dev) for x in _tied_index()))
    rad = torch.full((bi.n_blocks,), 200.0, device=dev)
    _assert_kernel_equals_plain(
        bi, torch.arange(64, dtype=torch.int32, device=dev), rad, rad, width)


@pytest.mark.cuda
@pytest.mark.parametrize("boxsize", [1000.0, 14_285.714285714286])
def test_torch_divides_by_a_python_float_as_by_its_reciprocal(dev, boxsize):
    """PyTorch's CUDA division of a float32 tensor by a Python float is a
    multiplication by the float32 reciprocal, as the kernel computes the
    wrap (``d * inv_box``)."""
    d = torch.from_numpy(np.random.default_rng(1).uniform(
        -3 * boxsize, 3 * boxsize, 1 << 20).astype(np.float32)).to(dev)
    inv = (1.0 / torch.tensor(boxsize, dtype=torch.float32)).item()
    assert torch.equal(d / boxsize, d * inv)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1 << 20,), (512, 2_442), (7, 48_829)])
def test_torch_sums_three_axes_as_the_kernel_does(dev, shape):
    """PyTorch's CUDA sum over a last axis of three (``_interval_dist2``'s
    ``(gap * gap).sum(dim=-1)``) adds the first and the third, then the
    second, as the kernel sums the axes: a + b + c as (a + c) + b."""
    g = torch.from_numpy(np.random.default_rng(2).random(
        shape + (3,)).astype(np.float32)).to(dev) * 100
    assert torch.equal(g.sum(dim=-1),
                       (g[..., 0] + g[..., 2]) + g[..., 1])
