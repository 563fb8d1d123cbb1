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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def find_candidates(bi: BlockIndex, radius, boxsize, *, max_cand: int,
                    max_super: int | None = None, symmetric: bool = False,
                    radius_sym=None) -> CandidateList:
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
    superblock lists) and grow the widths."""
    nb = bi.n_blocks
    ns = bi.sb_lo.shape[0]
    dev = bi.bb_lo.device
    if max_super is None:
        max_super = default_max_super(ns, max_cand)
    ms = min(max_super, ns)
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
    idx_out, cnt_out, sbc_out = [], [], []
    for c0 in range(0, nb, _CAND_CHUNK):
        c1 = min(c0 + _CAND_CHUNK, nb)
        lo_i, hi_i = bi.bb_lo[c0:c1, None], bi.bb_hi[c0:c1, None]
        rad_i = radius[c0:c1, None]
        sym_i = radius_sym[c0:c1, None] if radius_sym is not None else None
        # level 1: receivers x superblocks
        d2 = _interval_dist2(lo_i, hi_i, bi.sb_lo[None], bi.sb_hi[None],
                             boxsize)
        rng = rng_fn(rad_i, sym_i, sb_rad[None],
                     sb_sym[None] if radius_sym is not None else None)
        hit = d2 <= rng * rng
        sb_cand = torch.sort(torch.where(hit, sb_ids[None], ns),
                             dim=1).values[:, :ms]
        # level 2: the member blocks of the kept superblocks
        cand = (sb_cand[:, :, None] * SUPER + fan).reshape(c1 - c0,
                                                           ms * SUPER)
        cc = torch.clamp(cand, max=nb - 1).long()
        d2b = _interval_dist2(lo_i, hi_i, bi.bb_lo[cc], bi.bb_hi[cc],
                              boxsize)
        rngb = rng_fn(rad_i, sym_i, rad_blocks[cc],
                      sym_blocks[cc] if radius_sym is not None else None)
        hitb = (d2b <= rngb * rngb) & (cand < nb)
        idx = _compact_left(hitb, cand, nb, max_cand)
        idx_out.append(torch.where(idx >= nb, torch.full_like(idx, -1),
                                   idx).to(torch.int32))
        cnt_out.append(hitb.sum(dim=1).to(torch.int32))
        sbc_out.append(hit.sum(dim=1).to(torch.int32))
    count = torch.cat(cnt_out)
    sb_count = torch.cat(sbc_out)
    return CandidateList(idx=torch.cat(idx_out), count=count,
                         overflow=int(count.max()) - max_cand,
                         sb_overflow=int(sb_count.max()) - ms,
                         sb_count=sb_count)


def _find_candidates_super_k(bi: BlockIndex, rec_ids, radius, radius_sym,
                             boxsize, max_cand: int) -> CandidateList:
    """Single-pass superblock sweep at list width max_cand."""
    nb = bi.n_blocks
    ns = bi.sb_lo.shape[0]
    dev = bi.bb_lo.device
    pad = torch.zeros((ns * SUPER - nb,), dtype=radius_sym.dtype,
                      device=dev)
    sb_sym = torch.cat([radius_sym, pad]).reshape(ns, SUPER).amax(dim=1)
    k = min(max_cand, ns)
    idx_out, cnt_out = [], []
    for c0 in range(0, rec_ids.shape[0], _CAND_CHUNK):
        rec = rec_ids[c0:c0 + _CAND_CHUNK]
        idc = torch.clamp(rec, min=0).long()
        d2 = _interval_dist2(bi.bb_lo[idc][:, None], bi.bb_hi[idc][:, None],
                             bi.sb_lo[None], bi.sb_hi[None], boxsize)
        rng = torch.maximum(radius[idc][:, None],
                            0.5 * (radius_sym[idc][:, None] + sb_sym[None]))
        hit = (d2 <= rng * rng) & (rec >= 0)[:, None]
        # distance-ordered: a row over max_cand keeps its NEAREST
        # superblocks (the NGBMAX truncation analogue, globals.h:50);
        # the stable sort breaks ties towards the lower id, as top_k does
        key = torch.where(hit, d2, torch.full_like(d2, float("inf")))
        idx = torch.sort(key, dim=1, stable=True).indices[:, :k]
        hit_sel = torch.gather(hit, 1, idx)
        idx = torch.where(hit_sel, idx, torch.full_like(idx, -1))
        if k < max_cand:
            idx = torch.cat([idx, torch.full((idx.shape[0], max_cand - k),
                                             -1, dtype=idx.dtype,
                                             device=dev)], dim=1)
        idx_out.append(idx.to(torch.int32))
        cnt_out.append(hit.sum(dim=1).to(torch.int32))
    idx = torch.cat(idx_out)
    count = torch.cat(cnt_out)
    return CandidateList(idx=idx, count=count,
                         overflow=int(count.max()) - max_cand)


def find_candidates_super(bi: BlockIndex, rec_ids, radius, radius_sym,
                          boxsize, *, max_cand: int) -> CandidateList:
    """Superblock-granular candidate lists for receiver blocks ``rec_ids``
    ((T,), -1 padded).  ``radius``/``radius_sym`` are per block (nb,): a
    superblock is a candidate when its box lies within
    max(radius_i, (radius_sym_i + max radius_sym over the superblock)/2).

    Two passes when max_cand > _K_PROBE: a probe at width _K_PROBE gives
    exact hit counts, and only rows whose count exceeds the probe re-run
    at the full width.  The output equals the single pass at max_cand."""
    if max_cand <= _K_PROBE:
        return _find_candidates_super_k(bi, rec_ids, radius, radius_sym,
                                        boxsize, max_cand)
    probe = _find_candidates_super_k(bi, rec_ids, radius, radius_sym,
                                     boxsize, _K_PROBE)
    t = rec_ids.shape[0]
    idx = torch.cat([probe.idx,
                     torch.full((t, max_cand - _K_PROBE), -1,
                                dtype=torch.int32, device=probe.idx.device)],
                    dim=1)
    over_rows = torch.nonzero(probe.count > _K_PROBE)[:, 0]
    if over_rows.numel():
        full = _find_candidates_super_k(bi, rec_ids[over_rows], radius,
                                        radius_sym, boxsize, max_cand)
        idx[over_rows] = full.idx
    return CandidateList(idx=idx, count=probe.count,
                         overflow=int(probe.count.max()) - max_cand)
