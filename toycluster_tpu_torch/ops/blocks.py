"""Block-sparse neighbour engine: equal-count particle blocks.

JAX counterpart: ``toycluster_tpu/ops/blocks.py``.  In place of the
reference's octree walk (tree.c:25-111):

1. sort particles along a Hilbert curve (ops/keys.py);
2. cut the sorted order into blocks of BLOCK particles, refined inside
   each SUPER*BLOCK segment by median splits (compact bounding boxes);
3. per block and per superblock of SUPER blocks, a bounding box;
4. per receiver block, the superblocks whose boxes lie within its search
   range under the periodic minimum-image metric, nearest first.

The stream kernels (ops/stream_pair.py) then walk each receiver's
superblock list.  The count-class engine (ops/class_pair.py) walks
block-granular lists from ``find_candidates``, a second level that keeps
the member blocks of the hit superblocks that lie in range.  BLOCK and
SUPER are those of the JAX package, so the two packages build the same
lists.

The sweeps run as the JAX package runs them: each row keeps its nearest
superblocks by a top-k (``jax.lax.top_k`` there), not a full sort over
all superblocks (the sort stays as the tests' oracle,
``_find_candidates_super_k_sorted``); a second pass re-sweeps only the
rows over the probe width, padded to a size that repeats; each sweep is
one function of tensors that reads nothing back, run through ``Sweeps``
within the WVT loop, and the host reads the widest count and the rows
over the probe between sweeps.

On a CUDA tensor the superblock sweep is one launch of the hand-written
kernel of ``csrc/super_sweep.cu`` (``super_sweep``, its launches in
``super_sweep.launches``): box distances, hit counts and the nearest-k
selection on chip, bit-equal to the chunked PyTorch sweep
``_super_sweep``, which a CPU tensor runs.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import torch

from ..utils.logging import Spans
from .cuda_build import _check, _launch

BLOCK = 128        # particles per block
SUPER = 8          # blocks per superblock
_CAND_CHUNK = 512  # receiver rows per chunk of the candidate search
_K_PROBE = 256     # probe width of the two-pass candidate search


class BlockIndex(NamedTuple):
    order: torch.Tensor      # (N,) permutation: sorted <- original
    pos: torch.Tensor        # (P, 3) sorted positions, padded to P = nb*B
    valid: torch.Tensor      # (P,) padding mask
    bb_lo: torch.Tensor      # (nb, 3) block bbox minima
    bb_hi: torch.Tensor      # (nb, 3)
    sb_lo: torch.Tensor      # (ns, 3) superblock bbox minima
    sb_hi: torch.Tensor      # (ns, 3)

    @property
    def n_blocks(self) -> int:
        return self.bb_lo.shape[0]

    @property
    def n_padded(self) -> int:
        return self.pos.shape[0]


def _kd_refine_segments(spos, order, nseg):
    """Re-partition each SUPER*BLOCK Hilbert segment into compact blocks
    by recursive median splits on the widest axis.  The splits never
    cross a segment, so superblock membership (and so the candidate
    lists) is unchanged while member-block boxes shrink."""
    m0 = SUPER * BLOCK
    seg = spos[:nseg * m0].reshape(nseg, m0, 3)
    idx = order[:nseg * m0].reshape(nseg, m0)
    m = m0
    while m > BLOCK:
        v = seg.reshape(-1, m, 3)
        i = idx.reshape(-1, m)
        ext = v.amax(dim=1) - v.amin(dim=1)
        ax = torch.argmax(ext, dim=1)
        key = torch.gather(v, 2, ax[:, None, None].expand(-1, m, 1))[..., 0]
        perm = torch.sort(key, dim=1, stable=True).indices
        seg = torch.gather(v, 1, perm[..., None].expand(-1, -1, 3)
                           ).reshape(nseg, m0, 3)
        idx = torch.gather(i, 1, perm).reshape(nseg, m0)
        m //= 2
    return (torch.cat([seg.reshape(-1, 3), spos[nseg * m0:]]),
            torch.cat([idx.reshape(-1), order[nseg * m0:]]))


def pad_rows(x, n):
    """Pad rows of x to n by repeating its last row."""
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return torch.cat([x, x[-1:].expand((pad,) + x.shape[1:])])


def superblock_boxes(bb_lo, bb_hi):
    nb = bb_lo.shape[0]
    ns = -(-nb // SUPER)
    sb_lo = pad_rows(bb_lo, ns * SUPER).reshape(ns, SUPER, 3).amin(dim=1)
    sb_hi = pad_rows(bb_hi, ns * SUPER).reshape(ns, SUPER, 3).amax(dim=1)
    return sb_lo, sb_hi


def build_blocks(pos, boxsize, order=None) -> BlockIndex:
    """Sort positions along the Hilbert curve and build block and
    superblock bounding boxes.  Padding repeats the last particle and is
    masked out of every pair sum through ``valid``."""
    from .keys import hilbert_order

    n = pos.shape[0]
    if order is None:
        order = hilbert_order(pos, boxsize)
    spos = pos[order]
    nseg = n // (SUPER * BLOCK)
    if nseg > 0:
        spos, order = _kd_refine_segments(spos, order, nseg)
    nb = -(-n // BLOCK)
    spos = pad_rows(spos, nb * BLOCK)
    valid = torch.arange(nb * BLOCK, device=pos.device) < n
    blocks = spos.reshape(nb, BLOCK, 3)
    bb_lo = blocks.amin(dim=1)
    bb_hi = blocks.amax(dim=1)
    sb_lo, sb_hi = superblock_boxes(bb_lo, bb_hi)
    return BlockIndex(order=order, pos=spos, valid=valid, bb_lo=bb_lo,
                      bb_hi=bb_hi, sb_lo=sb_lo, sb_hi=sb_hi)


def _interval_dist2(lo1, hi1, lo2, hi2, boxsize):
    """Squared min-image distance between two AABBs on a 3-torus."""
    c1 = 0.5 * (lo1 + hi1)
    c2 = 0.5 * (lo2 + hi2)
    w = 0.5 * (hi1 - lo1) + 0.5 * (hi2 - lo2)
    d = c1 - c2
    d = d - boxsize * torch.round(d / boxsize)
    gap = torch.clamp(torch.abs(d) - w, min=0.0)
    return (gap * gap).sum(dim=-1)


class CandidateList(NamedTuple):
    idx: torch.Tensor      # (T, M) superblock ids, nearest first, or block
    #                        ids in ascending order (find_candidates); -1
    #                        padded
    count: torch.Tensor    # (T,) true hit counts (may exceed M)
    overflow: int          # max(count) - M; positive means truncation
    sb_overflow: int = 0   # find_candidates: superblock-budget excess
    sb_count: torch.Tensor | None = None  # find_candidates: (T,) level-1
    #                                       superblock hit counts
    searched: tuple | None = None  # a grown search's (first, last) width


def host_ints(x):
    """The values of a small integer tensor on the host, in one read: on
    a CUDA device a non-blocking copy into pinned memory and a wait on
    the stream (as the WVT loop reads its scalars), so the read sits
    after the work queued before it (a sweep, say)."""
    if not x.is_cuda:
        return x.tolist()
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return buf.tolist()


class Sweeps:
    """The candidate sweeps of one WVT relaxation, as the JAX package runs
    them: each sweep is one function of tensors that reads nothing back
    (``jax.jit`` on ``find_candidates``, ``_find_candidates_super_k`` and
    the refresh's box pass there), and the host reads what it needs
    between them.  ``run`` calls one as a ``wvt_sweep`` span of ``spans``
    (a ``utils.logging.Spans``, the loop's).

    Counts (``tally``): the sweeps run and ``spills``, the rows whose
    hits overflowed the kernel's on-chip buffer (``super_sweep``), since
    the last tally, read in the host reads the sweeps make anyway
    (``note_spills``) or, for the sweeps no host read follows, at
    ``settle``."""

    def __init__(self, spans=None):
        self.spans = Spans() if spans is None else spans
        self._reset()

    def _reset(self):
        self.sweeps = self.spills = 0
        self.unread = []

    def run(self, fn, args, sweep=True):
        """``fn(*args)`` (a tuple of tensors); ``sweep``: count it as a
        candidate sweep."""
        self.sweeps += sweep
        with self.spans.span("wvt_sweep"):
            return fn(*args)

    def note_spills(self, spills):
        """Count ``spills``, the second number of a superblock sweep's
        ``most``: a host int where a host read took it, else the device
        tensor, kept for ``settle``."""
        if torch.is_tensor(spills):
            self.unread.append(spills.reshape(1))
        else:
            self.spills += spills

    def settle(self, device):
        """Wait for the work queued on ``device``, as the end of a build
        or list refresh does: where sweeps left spills unread, by reading
        them (one read, which waits for the stream's work), else by a
        synchronise."""
        if self.unread:
            self.spills += sum(host_ints(torch.cat(self.unread)))
            self.unread = []
        elif device.type == "cuda":
            torch.cuda.synchronize(device)

    def tally(self):
        """(sweeps run, rows spilled) since the last tally."""
        out = (self.sweeps, self.spills)
        self._reset()
        return out


def run_sweep(sweeps, fn, args, sweep=True):
    """``fn(*args)``, through ``sweeps`` where a caller passed one."""
    return fn(*args) if sweeps is None else sweeps.run(fn, args, sweep)


def default_max_super(ns: int, max_cand: int) -> int:
    """Superblock budget of the two-level search: bounds the level-2 test
    width (max_super * SUPER); callers grow it on sb_overflow."""
    return min(ns, max(64, max_cand // SUPER))


def _compact_left(hitb, cand, nb, max_cand):
    """The hit candidate ids, ascending, in a fixed-width list padded
    with nb."""
    idx = torch.sort(torch.where(hitb, cand, torch.full_like(cand, nb)),
                     dim=1).values[:, :max_cand]
    if idx.shape[1] < max_cand:  # fewer candidate columns than M
        idx = torch.cat([idx, torch.full(
            (idx.shape[0], max_cand - idx.shape[1]), nb, dtype=idx.dtype,
            device=idx.device)], dim=1)
    return idx


def _block_sweep(bb_lo, bb_hi, sb_lo, sb_hi, radius, radius_sym=None, *,
                 boxsize, max_cand, ms, symmetric):
    """The two-level sweep of ``find_candidates`` over every receiver
    block: (idx (nb, max_cand), count, sb_count, their two maxima).
    Reads nothing back."""
    nb = bb_lo.shape[0]
    ns = sb_lo.shape[0]
    dev = bb_lo.device
    pad = torch.zeros((ns * SUPER - nb,), dtype=radius.dtype, device=dev)
    rad_blocks = torch.cat([radius, pad])
    sb_rad = rad_blocks.reshape(ns, SUPER).amax(dim=1)
    if radius_sym is not None:
        sym_blocks = torch.cat([radius_sym, pad])
        sb_sym = sym_blocks.reshape(ns, SUPER).amax(dim=1)

    def rng_fn(rad_i, sym_i, rad_j, sym_j):
        if radius_sym is not None:
            return torch.maximum(rad_i, 0.5 * (sym_i + sym_j))
        if symmetric:
            return 0.5 * (rad_i + rad_j)
        return rad_i

    sb_ids = torch.arange(ns, dtype=torch.int32, device=dev)
    fan = torch.arange(SUPER, dtype=torch.int32, device=dev)
    idx_out = torch.empty((nb, max_cand), dtype=torch.int32, device=dev)
    cnt_out = torch.empty((nb,), dtype=torch.int32, device=dev)
    sbc_out = torch.empty((nb,), dtype=torch.int32, device=dev)
    for c0 in range(0, nb, _CAND_CHUNK):
        c1 = min(c0 + _CAND_CHUNK, nb)
        lo_i, hi_i = bb_lo[c0:c1, None], bb_hi[c0:c1, None]
        rad_i = radius[c0:c1, None]
        sym_i = radius_sym[c0:c1, None] if radius_sym is not None else None
        # level 1: receivers x superblocks
        d2 = _interval_dist2(lo_i, hi_i, sb_lo[None], sb_hi[None], boxsize)
        rng = rng_fn(rad_i, sym_i, sb_rad[None],
                     sb_sym[None] if radius_sym is not None else None)
        hit = d2 <= rng * rng
        sb_cand = torch.sort(torch.where(hit, sb_ids[None], ns),
                             dim=1).values[:, :ms]
        # level 2: the member blocks of the kept superblocks
        cand = (sb_cand[:, :, None] * SUPER + fan).reshape(c1 - c0,
                                                           ms * SUPER)
        cc = torch.clamp(cand, max=nb - 1).long()
        d2b = _interval_dist2(lo_i, hi_i, bb_lo[cc], bb_hi[cc], boxsize)
        rngb = rng_fn(rad_i, sym_i, rad_blocks[cc],
                      sym_blocks[cc] if radius_sym is not None else None)
        hitb = (d2b <= rngb * rngb) & (cand < nb)
        idx = _compact_left(hitb, cand, nb, max_cand)
        idx_out[c0:c1] = torch.where(idx >= nb, torch.full_like(idx, -1),
                                     idx)
        cnt_out[c0:c1] = hitb.sum(dim=1)
        sbc_out[c0:c1] = hit.sum(dim=1)
    return (idx_out, cnt_out, sbc_out,
            torch.stack([cnt_out.max(), sbc_out.max()]))


def find_candidates(bi: BlockIndex, radius, boxsize, *, max_cand: int,
                    max_super: int | None = None, symmetric: bool = False,
                    radius_sym=None, sweeps: Sweeps | None = None
                    ) -> CandidateList:
    """Block-granular candidate lists: per receiver block, the blocks
    whose box lies within its range under the minimum-image metric, in
    ascending id order.  ``radius`` is (nb,) per block; the range is
    radius_i (gather), (radius_i + radius_j)/2 with ``symmetric`` (the
    WVT displacement pair range, wvt_relax.c:158), or, with
    ``radius_sym``, the union max(radius_i, (radius_sym_i +
    radius_sym_j)/2) that serves a whole WVT iteration.

    Two levels: superblock boxes first, keeping the first ``max_super``
    hit superblocks by id; then their member blocks.  Callers check
    ``overflow`` (truncated block lists) and ``sb_overflow`` (truncated
    superblock lists) and grow the widths.  The sweep runs through
    ``sweeps`` where it is given; both maxima come back in one read."""
    ns = bi.sb_lo.shape[0]
    if max_super is None:
        max_super = default_max_super(ns, max_cand)
    ms = min(max_super, ns)
    args = (bi.bb_lo, bi.bb_hi, bi.sb_lo, bi.sb_hi, radius) + (
        () if radius_sym is None else (radius_sym,))
    idx, count, sb_count, most = run_sweep(
        sweeps, partial(_block_sweep, boxsize=boxsize, max_cand=max_cand,
                        ms=ms, symmetric=symmetric), args)
    c_max, sb_max = host_ints(most)
    return CandidateList(idx=idx, count=count, overflow=c_max - max_cand,
                         sb_overflow=sb_max - ms, sb_count=sb_count)


# the int32 bits of +inf: the selection key of a superblock a row misses
_INF_BITS = 0x7F800000


def _nearest_topk(d2, hit, k):
    """Each row's ``k`` nearest hit superblocks, nearest first, ties to
    the lower id, -1 past the hits (the JAX package's ``jax.lax.top_k``
    selection): a top-k over one int64 key a superblock, the int32 bits
    of its d2 (monotone in d2 >= 0 and +inf, the key of a miss) above
    its id, so the order is total and equals a stable sort's."""
    ids = torch.arange(d2.shape[1], dtype=torch.int64, device=d2.device)
    # ids + bits * 2^32 = (bits << 32) | ids: bits < 2^31, ids < 2^32
    key = torch.add(ids, torch.where(hit, d2.view(torch.int32), _INF_BITS),
                    alpha=1 << 32)
    idx = torch.topk(key, k, dim=1, largest=False,
                     sorted=True).values.bitwise_and_(0xFFFFFFFF)
    return torch.where(torch.gather(hit, 1, idx), idx,
                       torch.full_like(idx, -1))


def _nearest_sorted(d2, hit, k):
    """The oracle of ``_nearest_topk``: a stable sort of each row over
    every superblock (ties to the lower id), the first ``k``."""
    key = torch.where(hit, d2, torch.full_like(d2, float("inf")))
    idx = torch.sort(key, dim=1, stable=True).indices[:, :k]
    return torch.where(torch.gather(hit, 1, idx), idx,
                       torch.full_like(idx, -1))


def _super_sweep(bb_lo, bb_hi, sb_lo, sb_hi, rec_ids, radius, radius_sym,
                 *, boxsize, max_cand, select=_nearest_topk):
    """The superblock sweep of receiver blocks ``rec_ids`` at list width
    ``max_cand`` (see ``find_candidates_super``), ``select`` keeping each
    row's nearest: (idx (T, max_cand), count (T,), count.max()).  Reads
    nothing back."""
    nb = bb_lo.shape[0]
    ns = sb_lo.shape[0]
    dev = bb_lo.device
    pad = torch.zeros((ns * SUPER - nb,), dtype=radius_sym.dtype,
                      device=dev)
    sb_sym = torch.cat([radius_sym, pad]).reshape(ns, SUPER).amax(dim=1)
    k = min(max_cand, ns)
    t = rec_ids.shape[0]
    idx = torch.full((t, max_cand), -1, dtype=torch.int32, device=dev)
    count = torch.empty((t,), dtype=torch.int32, device=dev)
    for c0 in range(0, t, _CAND_CHUNK):
        rec = rec_ids[c0:c0 + _CAND_CHUNK]
        idc = torch.clamp(rec, min=0).long()
        d2 = _interval_dist2(bb_lo[idc][:, None], bb_hi[idc][:, None],
                             sb_lo[None], sb_hi[None], boxsize)
        rng = torch.maximum(radius[idc][:, None],
                            0.5 * (radius_sym[idc][:, None] + sb_sym[None]))
        hit = (d2 <= rng * rng) & (rec >= 0)[:, None]
        # distance-ordered: a row over max_cand keeps its NEAREST
        # superblocks (the NGBMAX truncation analogue, globals.h:50)
        idx[c0:c0 + _CAND_CHUNK, :k] = select(d2, hit, k)
        count[c0:c0 + _CAND_CHUNK] = hit.sum(dim=1)
    return idx, count, count.max()


# csrc/super_sweep.cu: threads a CTA, the keys of its on-chip buffer (a
# power of two: 64 KiB), the threads a row may take and the CTAs a sweep
# should make at least (two a streaming multiprocessor)
_SWEEP_THREADS = 256
_SWEEP_KEYS = 8192
_SWEEP_MAX_SPLITS = 32
_SWEEP_MIN_ROW_KEYS = 64


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _sweep_splits(t, k, n_sm):
    """Threads a receiver row of the sweep kernel for ``t`` rows at
    selection width ``k`` on ``n_sm`` multiprocessors: the fewest (a
    power of two) that give each row a slice of the on-chip buffer of
    at least min(k, _SWEEP_MIN_ROW_KEYS) keys and the sweep two CTAs a
    multiprocessor, at most _SWEEP_MAX_SPLITS."""
    s = 1
    while s < _SWEEP_MAX_SPLITS and (
            _SWEEP_KEYS * s // _SWEEP_THREADS < min(k, _SWEEP_MIN_ROW_KEYS)
            or -(-t * s // _SWEEP_THREADS) < 2 * n_sm):
        s *= 2
    return s


def super_sweep(bb_lo, bb_hi, sb_lo, sb_hi, rec_ids, radius, radius_sym,
                *, boxsize, max_cand):
    """The superblock sweep of receiver blocks ``rec_ids`` at list width
    ``max_cand``: (idx (T, max_cand) int32, count (T,) int32, most (2,)
    int32: the widest count and the rows that spilled).  A CUDA tensor
    launches the kernel of ``csrc/super_sweep.cu`` (``_sweep_splits``
    threads a row), which gives ``_super_sweep``'s lists and counts to
    the bit; ``most``
    also counts the rows whose hits overflowed their slice of the
    kernel's on-chip buffer and were swept again alone.  A CPU tensor
    runs ``_super_sweep``, which spills nothing.  Reads nothing back."""
    if not bb_lo.is_cuda:
        idx, count, c_max = _super_sweep(
            bb_lo, bb_hi, sb_lo, sb_hi, rec_ids, radius, radius_sym,
            boxsize=boxsize, max_cand=max_cand)
        return idx, count, torch.stack([c_max, torch.zeros_like(c_max)])
    dev = bb_lo.device
    nb, ns, t = bb_lo.shape[0], sb_lo.shape[0], rec_ids.shape[0]
    bb_lo, bb_hi, sb_lo, sb_hi, rec_ids, radius, radius_sym = (
        x.contiguous() for x in (bb_lo, bb_hi, sb_lo, sb_hi, rec_ids,
                                 radius, radius_sym))
    for name, x, dtype, shape in (
            ("bb_lo", bb_lo, torch.float32, (nb, 3)),
            ("bb_hi", bb_hi, torch.float32, (nb, 3)),
            ("sb_lo", sb_lo, torch.float32, (ns, 3)),
            ("sb_hi", sb_hi, torch.float32, (ns, 3)),
            ("rec_ids", rec_ids, torch.int32, (t,)),
            ("radius", radius, torch.float32, (nb,)),
            ("radius_sym", radius_sym, torch.float32, (nb,))):
        _check(name, x, dtype, shape, dev)
    k = min(max_cand, ns)
    splits = _sweep_splits(t, k, _sm_count(dev))
    # each superblock's centre and sym, half-width and 0, rounded as
    # _interval_dist2 and _super_sweep round them
    pad = torch.zeros((ns * SUPER - nb,), dtype=torch.float32, device=dev)
    sb_sym = torch.cat([radius_sym, pad]).reshape(ns, SUPER).amax(dim=1)
    sbp = torch.cat([0.5 * (sb_lo + sb_hi), sb_sym[:, None],
                     0.5 * (sb_hi - sb_lo), sb_sym.new_zeros((ns, 1))], dim=1)
    idx = torch.empty((t, max_cand), dtype=torch.int32, device=dev)
    count = torch.empty((t,), dtype=torch.int32, device=dev)
    most = torch.zeros((2,), dtype=torch.int32, device=dev)
    scratch, capg = None, 0
    if k + _SWEEP_THREADS > _SWEEP_KEYS:
        # rows over the on-chip buffer keep their k nearest in a slice of
        # device memory a CTA instead
        capg = 1 << (k + _SWEEP_THREADS - 1).bit_length()
        grid = -(-t * splits // _SWEEP_THREADS)
        scratch = torch.empty((grid, capg), dtype=torch.int64, device=dev)
    box = torch.tensor(boxsize, dtype=torch.float32)
    _launch("super_sweep", [
        bb_lo, bb_hi, sbp, rec_ids, radius, radius_sym, idx, count, most,
        scratch, ns, t, max_cand, k, splits, _SWEEP_KEYS, capg, box.item(),
        (1.0 / box).item()])
    super_sweep.launches += 1
    return idx, count, most


super_sweep.launches = 0


def _super_args(bi, rec_ids, radius, radius_sym):
    return (bi.bb_lo, bi.bb_hi, bi.sb_lo, bi.sb_hi, rec_ids, radius,
            radius_sym)


def _super_lists(bi, rec_ids, radius, radius_sym, boxsize, max_cand,
                 sweeps=None):
    """``super_sweep``, through ``sweeps`` where it is given."""
    return run_sweep(sweeps,
                     partial(super_sweep, boxsize=boxsize, max_cand=max_cand),
                     _super_args(bi, rec_ids, radius, radius_sym))


def _find_candidates_super_k(bi: BlockIndex, rec_ids, radius, radius_sym,
                             boxsize, max_cand: int, sweeps=None
                             ) -> CandidateList:
    """Single-pass superblock sweep at list width max_cand (the nearest
    first); the widest row's count and the rows spilled come back in one
    read."""
    idx, count, most = _super_lists(bi, rec_ids, radius, radius_sym,
                                    boxsize, max_cand, sweeps)
    c_max, spills = host_ints(most)
    if sweeps is not None:
        sweeps.note_spills(spills)
    return CandidateList(idx=idx, count=count, overflow=c_max - max_cand)


def _find_candidates_super_k_sorted(bi: BlockIndex, rec_ids, radius,
                                    radius_sym, boxsize, max_cand: int
                                    ) -> CandidateList:
    """The oracle of ``_find_candidates_super_k``: the same sweep with a
    full stable sort of every row over the superblocks.  Only the tests
    and chip_smoke.py call it."""
    idx, count, most = _super_sweep(
        *_super_args(bi, rec_ids, radius, radius_sym), boxsize=boxsize,
        max_cand=max_cand, select=_nearest_sorted)
    return CandidateList(idx=idx, count=count,
                         overflow=int(most) - max_cand)


def subset_rows(n_over, ns, memo=None):
    """Rows of the second pass of ``find_candidates_super`` for
    ``n_over`` rows over the probe: the next power of two, at least 64,
    and, with ``memo`` (a dict: the relaxation's width memo), never
    below the size it holds for ``ns`` superblocks, stored back (the JAX
    package's ``_SUBSET_MEMO``)."""
    m = max(64, 1 << (n_over - 1).bit_length())
    if memo is not None:
        held = memo.setdefault("subset", {})
        m = held[ns] = max(m, held.get(ns, 0))
    return m


def find_candidates_super(bi: BlockIndex, rec_ids, radius, radius_sym,
                          boxsize, *, max_cand: int, memo=None,
                          sweeps: Sweeps | None = None) -> CandidateList:
    """Superblock-granular candidate lists for receiver blocks ``rec_ids``
    ((T,), -1 padded).  ``radius``/``radius_sym`` are per block (nb,): a
    superblock is a candidate when its box lies within
    max(radius_i, (radius_sym_i + max radius_sym over the superblock)/2).

    Two passes when max_cand > _K_PROBE: a probe at width _K_PROBE gives
    exact hit counts, and only rows whose count exceeds the probe re-run
    at the full width, padded with -1 to ``subset_rows`` (``memo``: the
    relaxation's width memo) so that the second pass's shape repeats.
    The output equals the single pass at max_cand.  The sweeps run
    through ``sweeps`` where it is given; the host reads the probe's
    widest count and spills and, where it overflows, the rows over it
    between them (the second pass's spills wait for ``sweeps.settle``)."""
    if max_cand <= _K_PROBE:
        return _find_candidates_super_k(bi, rec_ids, radius, radius_sym,
                                        boxsize, max_cand, sweeps)
    probe = _find_candidates_super_k(bi, rec_ids, radius, radius_sym,
                                     boxsize, _K_PROBE, sweeps)
    t = rec_ids.shape[0]
    idx = torch.cat([probe.idx,
                     torch.full((t, max_cand - _K_PROBE), -1,
                                dtype=torch.int32, device=probe.idx.device)],
                    dim=1)
    if probe.overflow > 0:
        over_rows = torch.nonzero(probe.count > _K_PROBE)[:, 0]
        n_over = over_rows.shape[0]
        sub = rec_ids.new_full(
            (subset_rows(n_over, bi.sb_lo.shape[0], memo),), -1)
        sub[:n_over] = rec_ids[over_rows]
        full, _, most = _super_lists(bi, sub, radius, radius_sym, boxsize,
                                     max_cand, sweeps)
        if sweeps is not None:
            sweeps.note_spills(most[1])
        idx[over_rows] = full[:n_over]
    return CandidateList(idx=idx, count=probe.count,
                         overflow=probe.overflow + _K_PROBE - max_cand)
