"""Stream pair operators: the fused WVT density solve + displacement, and
the SPH curl, over superblock candidate lists.

JAX counterpart: ``toycluster_tpu/ops/pallas_pair.py``
(``stream_wvt_pallas``/``_stream_kernel`` and
``stream_curl_pallas``/``_curl_stream_kernel``).  Layouts are those of the
Pallas wrappers in superblock mode:

* sources ``(nb, 4, 128)`` (x, y, z, hm) for the solve, ``(nb, 8, 128)``
  (x, y, z, valid, A0, A1, A2, pad) for the curl; a source lane with
  hm == 0 (valid == 0) takes part in no pair;
* ``cand (S, M)`` int32 superblock ids, -1 padded (the curl also takes
  block ids, its block-list mode); ``cnt (S,)`` int32 hit counts,
  clamped to M here;
* receivers ``xi (S, 3, 128)`` and per-lane ``(S, 128)`` rows.

Each operator has two paths.  A CUDA tensor launches the hand-written
kernel of ``csrc/`` (one CTA per receiver block) and counts the launch in
``stream_wvt.launches`` / ``stream_curl.launches``; a CPU tensor runs the
plain PyTorch version beside it (``_stream_wvt_reference`` /
``_stream_curl_reference``), which evaluates every listed pair with the
same block-level loop.  Any other device raises.

Both kernels prune member blocks themselves, with the JAX package's
chunk cross test (``build_chunk_tab``, ``stream_skip_bits``: their plain
versions are here and are the test oracle of the kernels' test;
``curl_keep`` is the curl's), and drop the periodic wrap from the pair
loop on rows that need none (``interior_rows``).  Neither changes a bit
of a kernel's outputs, so the plain versions stay the references.
``stream_curl`` runs on the list walk of ``csrc/class_walk.cuh``, whose
host side (``PackedSources``, ``_row_tables``, ``_cluster_size``) is
here too, for ``ops/class_pair.py`` as well.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import constants as const
from .blocks import BLOCK, SUPER
from .cuda_build import _check, _launch
from .kernels import WC6_NORM, m4_flat

# Newton/bisection sweeps of the per-block h solve (warm starts converge
# in <= ~4; unconverged lanes re-enter through the callers' retry loop)
N_SWEEPS = 16
# speculative accept: a lane with |wkNgb - DESNNGB| <
# sqrt(NNGBDEV * DESNNGB / SPEC_KAPPA) takes its Newton step without a
# confirming sweep (the epilogue extrapolates its sums to the new h)
SPEC_KAPPA = 5.0
_KIND = {"wc6": 0, "m4": 1}
# elements of one row chunk's (rows, 128, sources) pair arrays in the
# plain versions, by device type
_PAIR_BUDGET = {"cuda": 1 << 25, "cpu": 1 << 22}
# 16-particle chunks per block in the member test
N_CHUNKS = 8
# absolute inflation of the member test's thresholds, in box units: two
# quanta of the TPU's 2^22 position grid (a few float32 ulps of a
# coordinate), so that no rounding of a pair distance in the kernel puts
# a pair of a dropped member within range
_INFL = 2.0 ** -21
# the kernel's member lists hold list positions in 14 bits
MAX_LIST_WIDTH = (1 << 14) // SUPER
# the list walk of csrc/class_walk.cuh: CTAs a row may be split over (a
# thread-block cluster), and the list entries one CTA's shared-memory
# list holds
MAX_CLUSTER = 8
MAX_SHARE = 1 << 14
# a call is split over clusters while it has fewer CTAs than this (132
# SMs, two to four resident CTAs of 512 threads each) and every CTA's
# share of the row keeps at least _MIN_SHARE entries.  Over the 36 calls
# of the 1e6 reference run the rule came within 3% of the best size per
# call (python -m toycluster_tpu_torch.cluster_sweep, PERF.md).
_FILL_CTAS = 528
_MIN_SHARE = 32


def _spec_win(desnngb):
    return math.sqrt(const.NNGBDEV * desnngb / SPEC_KAPPA)


def _rho_corr(desnngb, mpart, kernel):
    """Dehnen+12 WC6 self-contribution correction factor (sph.c:202-210),
    multiplied by W(0, h) = WC6_NORM / h^3 in the epilogue."""
    if kernel != "wc6":
        return 0.0
    return -0.0116 * (desnngb * 0.01) ** (-2.236) * mpart


def _check_common(src_blocks, rows, cand, cnt, xi, lane_arrays):
    dev = src_blocks.device
    nb = src_blocks.shape[0]
    S, M = cand.shape
    _check("src_blocks", src_blocks, torch.float32, (nb, rows, BLOCK), dev)
    _check("cand", cand, torch.int32, (S, M), dev)
    _check("cnt", cnt, torch.int32, (S,), dev)
    _check("xi", xi, torch.float32, (S, 3, BLOCK), dev)
    for name, t in lane_arrays.items():
        _check(name, t, torch.float32, (S, BLOCK), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no stream kernel for device {dev}")
    return dev, nb, S, M


def _pad_superblocks(src_blocks):
    """Zero-pad the sources to whole superblocks (zero hm/valid lanes
    take part in no pair)."""
    nb = src_blocks.shape[0]
    pad = -(-nb // SUPER) * SUPER - nb
    if pad == 0:
        return src_blocks
    return torch.cat([src_blocks, src_blocks.new_zeros(
        (pad,) + tuple(src_blocks.shape[1:]))])


# --------------------------------------------------------------------------
# Member pruning: the chunk cross test, and the hoisted-wrap flag
# --------------------------------------------------------------------------

def _min_image(d, boxsize):
    return d - boxsize * torch.round(d * (1.0 / boxsize))


def _wrapped_bounds(p, boxsize):
    """Min and max over the last axis of positions p, wrap-aware (as
    ``sph.block_boxes``): each group is re-centred on its first element
    with min-image deltas, so a group that straddles the periodic edge
    gets its true extent."""
    ref = p[..., :1]
    d = _min_image(p - ref, boxsize)
    return ref[..., 0] + d.amin(dim=-1), ref[..., 0] + d.amax(dim=-1)


def build_chunk_tab(pos_t, hm_src_b, boxsize, n_chunks=N_CHUNKS):
    """(nb, n_chunks * 8) float32 chunk geometry of the blocks ``pos_t``
    (nb, 3, 128): per 16-particle chunk [cen xyz, ext xyz, the chunk's
    largest ``hm_src_b`` (nb, 128), 0].  The JAX package's
    ``build_chunk_tab``, made wrap-aware: a chunk's hull is its true
    extent even where it straddles the periodic edge.  Pad lanes are
    copies of a real particle, so hulls stay exact bounds."""
    nb = pos_t.shape[0]
    lo, hi = _wrapped_bounds(pos_t.reshape(nb, 3, n_chunks, -1), boxsize)
    bh = hm_src_b.reshape(nb, n_chunks, -1).amax(dim=2)
    tab = torch.cat([(0.5 * (lo + hi)).transpose(1, 2),
                     (0.5 * (hi - lo)).transpose(1, 2), bh[..., None],
                     torch.zeros_like(bh[..., None])], dim=-1)
    return tab.reshape(nb, n_chunks * 8).to(torch.float32).contiguous()


def _warp_tiles(within):
    """(C, E, 16) bool from the verdicts ``within`` (C, E, rc, mc) of the
    8 x 8 chunk pairs: tile w holds if a pair of receiver chunks 2 (w % 4),
    2 (w % 4) + 1 and member chunks 2 (w // 4), 2 (w // 4) + 1 does.  A
    warp of the list-walk kernels serves those 32 receiver lanes and 32
    sources (csrc/class_walk.cuh ``keep_tiles``) and skips a block whose
    tile is clear."""
    C, E = within.shape[:2]
    t = within.reshape(C, E, 4, 2, 4, 2).any(dim=5).any(dim=3)  # (C,E,q,p)
    return t.transpose(2, 3).reshape(C, E, 16)


def member_keep(rtab, mtab, boxsize, do_disp, tiles=False):
    """The chunk cross test of receiver blocks against member blocks.
    ``rtab`` (C, 8, 8) receiver chunks [cen, ext, largest cap, largest
    hm_i (box units)], ``mtab`` (C, E, 8, 8) member chunks [cen, ext,
    largest hm, 0].  A member is kept for the density if the minimum-image
    gap of some (receiver chunk, member chunk) pair is at most that
    receiver chunk's cap, and for the displacement if it is at most
    0.5 (hm_i + hm) boxsize; both thresholds are inflated by _INFL
    boxsize.  Every operation rounds as in the kernel's test
    (csrc/stream_wvt.cu ``hull_gap2``), so both keep the same members.
    Returns (dens, disp), each (C, E) bool, or with ``tiles`` each (C, E,
    16) bool, the verdict per warp tile (``_warp_tiles``): a member is
    kept where one of its tiles is."""
    ri = rtab[:, None, :, None, :]                       # (C,1,rc,1,8)
    cj = mtab[:, :, None, :, :]                          # (C,E,1,mc,8)
    infl = _INFL * boxsize
    g2 = None
    for d in range(3):
        dd = _min_image(ri[..., d] - cj[..., d], boxsize)
        gp = torch.clamp(dd.abs() - (ri[..., 3 + d] + cj[..., 3 + d]),
                         min=0.0)
        g2 = gp * gp if g2 is None else g2 + gp * gp
    td = ri[..., 6] + infl
    dens = g2 <= td * td
    dens = _warp_tiles(dens) if tiles else dens.flatten(2).any(dim=2)
    if not do_disp:
        return dens, torch.zeros_like(dens)
    tx = 0.5 * (ri[..., 7] + cj[..., 6]) * boxsize + infl
    disp = g2 <= tx * tx
    return dens, (_warp_tiles(disp) if tiles
                  else disp.flatten(2).any(dim=2))


def _listed_members(cand, cnt, nb, sb_mode=True):
    """(S, E) member block ids of the first min(cnt, M) list entries of
    each row and their validity (listed, id >= 0, block < nb); E = M * 8
    (superblock ids) or M (block ids, without ``sb_mode``)."""
    S, M = cand.shape
    slot = torch.arange(M, device=cand.device)
    listed = torch.where(slot[None] < torch.clamp(cnt, max=M)[:, None],
                         cand, torch.full_like(cand, -1))
    return list_entries(listed, nb, sb_mode)


def _keep_rows(rtab, ctab, cand, cnt, boxsize, do_disp, sb_mode=True,
               tiles=False):
    """``member_keep`` over every row of the lists ``cand`` (S, M) of
    superblock ids (block ids without ``sb_mode``) in row chunks: returns
    (dens, disp, listed), each (S, E) bool as ``_listed_members`` (dens
    and disp (S, E, 16) with ``tiles``); unlisted members are kept by
    neither test."""
    nb = ctab.shape[0]
    e, ok = _listed_members(cand, cnt, nb, sb_mode)
    if tiles:
        ok = ok[..., None]
    dens = torch.zeros(ok.shape[:2] + ((16,) if tiles else ()),
                       dtype=torch.bool, device=ok.device)
    disp = torch.zeros_like(dens)
    per_row = max(e.shape[1] * N_CHUNKS * N_CHUNKS, 1)
    step = max(1, _PAIR_BUDGET[cand.device.type] // 4 // per_row)
    mt = ctab.reshape(nb, N_CHUNKS, 8)
    for s0 in range(0, cand.shape[0], step):
        s1 = min(s0 + step, cand.shape[0])
        d, x = member_keep(rtab[s0:s1], mt[e[s0:s1]], boxsize, do_disp,
                           tiles)
        dens[s0:s1] = d & ok[s0:s1]
        disp[s0:s1] = x & ok[s0:s1]
    return dens, disp, (ok[..., 0] if tiles else ok)


def pair_range(cap_rows, hm_rows, bhm_max, boxsize):
    """(S,) the largest pair range of each row: its largest cap and, with
    ``hm_rows`` (S, 128) and the sources' largest hm ``bhm_max`` (box
    units), the widest displacement range 0.5 (hm_i + hm_j) boxsize."""
    r_pair = cap_rows.amax(dim=1)
    if hm_rows is None:
        return r_pair
    return torch.maximum(
        r_pair, 0.5 * (hm_rows.amax(dim=1) + bhm_max) * boxsize)


def hoist_safe(half_ext, r_pair, boxsize):
    """(S,) int32: 1 where the TPU kernel's hoisted periodic wrap is valid
    for a row, i.e. the receiver block's half-extent ``half_ext`` (S, 3)
    plus its largest pair range ``r_pair`` (S,) stays below 0.49 boxsize
    on every axis."""
    return (half_ext + r_pair[:, None] < 0.49 * boxsize).all(
        dim=1).to(torch.int32)


def _recv_tab(ctab_rows, cap_rows, hm_rows):
    """(S, 8, 8) receiver chunks: the chunk geometry ``ctab_rows`` (S, 64)
    with the chunks' largest cap and hm_i (zeros without ``hm_rows``) in
    columns 6 and 7."""
    S = cap_rows.shape[0]
    rt = ctab_rows.reshape(S, N_CHUNKS, 8).clone()
    rt[:, :, 6] = cap_rows.reshape(S, N_CHUNKS, -1).amax(dim=2)
    rt[:, :, 7] = (0.0 if hm_rows is None else
                   hm_rows.reshape(S, N_CHUNKS, -1).amax(dim=2))
    return rt


def stream_skip_bits(bb_lo, bb_hi, bhm, idc, block_rows, cap_rows, hm_rows,
                     boxsize, chunk_tab):
    """The JAX package's ``stream_skip_bits`` in superblock mode with the
    chunk cross test, without count buckets, at margin 1.0: packed 2-bit
    fields, 16 per int32 word, for the members of each row's superblocks
    ``block_rows`` (S, M) (-1 empty): bit0 set where the density can skip
    the member (no chunk pair within cap, or an invalid member), bit1 set
    where the displacement needs it.  ``bb_lo``/``bb_hi`` (nb, 3) block
    boxes, ``bhm`` (nb,) the blocks' largest source hm in box units (None:
    no displacement), ``idc`` (S,) receiver block ids, ``cap_rows`` and
    ``hm_rows`` (S, 128), ``chunk_tab`` from ``build_chunk_tab``.  Returns
    (bits (S, M8 / 16) int32 with M8 = 8 M rounded up to 16, safe (S,)
    int32 from ``hoist_safe``)."""
    S, M = block_rows.shape
    if M % 2:
        block_rows = torch.cat([block_rows, torch.full(
            (S, 1), -1, dtype=block_rows.dtype, device=block_rows.device)],
            dim=1)
    idl = torch.clamp(idc.long(), max=bb_lo.shape[0] - 1)
    rtab = _recv_tab(chunk_tab[idl], cap_rows,
                     hm_rows if bhm is not None else None)
    cnt = torch.full((S,), block_rows.shape[1], dtype=torch.int32,
                     device=block_rows.device)
    dens, disp, _ = _keep_rows(rtab, chunk_tab, block_rows, cnt, boxsize,
                               bhm is not None)
    b2 = ((~dens).long() | (disp.long() << 1)).reshape(S, -1, 16)
    shifts = torch.arange(16, device=b2.device) * 2
    words = (b2 << shifts).sum(dim=2)
    bits = (((words + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)
    r_pair = pair_range(cap_rows, None if bhm is None else hm_rows,
                        None if bhm is None else bhm.max(), boxsize)
    return bits, hoist_safe(0.5 * (bb_hi[idl] - bb_lo[idl]), r_pair, boxsize)


def interior_rows(xi, r_pair, boxsize):
    """(S,) bool: rows whose reach, the receivers' extent (as stored, not
    wrapped) widened by the pair range ``r_pair`` (S,) and the test's
    inflation, lies inside (0, boxsize) on every axis.  Every source
    within range of such a row is stored at its minimum-image position,
    less than half a box away (the reach spans less than the box), so no
    separation of a pair in range needs the periodic wrap, and a source
    out of range can only come out farther without it."""
    reach = r_pair * (1.0 + 2.0 ** -20) + _INFL * boxsize
    lo = xi.amin(dim=2) - reach[:, None]
    hi = xi.amax(dim=2) + reach[:, None]
    return ((lo > 0.0) & (hi < boxsize)).all(dim=1)


def prune_tables(src_blocks, xi, cap, hm_i, boxsize, *, do_disp=True,
                 hoist=True):
    """What ``stream_wvt``'s kernel reads for its member test and its
    hoisted wrap: the sources' chunk table (nb, 64) (``build_chunk_tab``
    of the coordinates and the hm row), the receivers' chunks (S, 8, 8)
    (``_recv_tab``; hm_i only with ``do_disp``), and per row (S,) int32
    the flag of the rows that skip the periodic wrap, ``interior_rows``
    (0 on every row without ``hoist``)."""
    ctab = build_chunk_tab(src_blocks[:, :3], src_blocks[:, 3], boxsize)
    hm_rows = hm_i if do_disp else None
    bhm_max = src_blocks[:, 3].amax() if do_disp else None
    rtab = _recv_tab(build_chunk_tab(xi, cap, boxsize), cap, hm_rows)
    flag = interior_rows(xi, pair_range(cap, hm_rows, bhm_max, boxsize),
                         boxsize).to(torch.int32)
    if not hoist:
        flag = torch.zeros_like(flag)
    return ctab, rtab.contiguous(), flag.contiguous()


def member_counts(src_blocks, cand, cnt, xi, cap, hm_i, boxsize, *,
                  do_disp=True):
    """Per row (S, 3) int32: the members that the kernel's test keeps for
    either consumer and for the density, and the listed members."""
    ctab, rtab, _ = prune_tables(src_blocks, xi, cap, hm_i, boxsize,
                                 do_disp=do_disp)
    dens, disp, ok = _keep_rows(rtab, ctab, cand, cnt, boxsize, do_disp)
    return torch.stack([(dens | disp).sum(dim=1), dens.sum(dim=1),
                        ok.sum(dim=1)], dim=1).to(torch.int32)


# --------------------------------------------------------------------------
# The list walk of csrc/class_walk.cuh: what its kernels read
# --------------------------------------------------------------------------

class PackedSources(NamedTuple):
    """The sources as the list-walk kernels read them: ``src`` (nb, 128,
    4) records (x, y, z, w) (``stream_curl``: (nb, 256, 4), the 128
    (a0, a1, a2, 0) records after them), ``ctab`` (nb, 64) their chunk
    table (``build_chunk_tab``), ``w_max`` the largest w."""
    src: torch.Tensor
    ctab: torch.Tensor
    w_max: torch.Tensor


def _check_packed(packed, nb, dev, recs=1):
    _check("packed.src", packed.src, torch.float32, (nb, recs * BLOCK, 4),
           dev)
    _check("packed.ctab", packed.ctab, torch.float32, (nb, 64), dev)


def _cluster_size(n_rows, n_entries, cluster):
    """CTAs a row is split over: ``cluster`` if given, else doubled from 1
    while the call has fewer than _FILL_CTAS CTAs and every share keeps
    _MIN_SHARE entries, or until a share fits a CTA's list.  Raises if no
    allowed size holds the list."""
    if cluster is None:
        cluster = 1
        while cluster < MAX_CLUSTER and (
                -(-n_entries // cluster) > MAX_SHARE
                or (n_rows * cluster < _FILL_CTAS
                    and n_entries >= 2 * cluster * _MIN_SHARE)):
            cluster *= 2
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster must be in 1..{MAX_CLUSTER}, "
                         f"not {cluster}")
    if -(-n_entries // cluster) > MAX_SHARE:
        raise ValueError(
            f"a list of {n_entries} blocks over {cluster} CTAs exceeds the "
            f"{MAX_SHARE} entries of a CTA's shared-memory list")
    return cluster


def padded_cluster(cand, sb_mode):
    """CTAs a row is split over in a call on padded rows: ``cand`` (S,
    M) lists whose S is a size of ``sph.quantize_size``'s grid, past the
    real rows padding rows that exit at once.  The grid gives a size S
    to S/4 < n <= S real rows, so the split is ``_cluster_size``'s for
    S/2 rows, the middle of that range on a log scale: a function of the
    shape alone (an iteration program's replay and an eager call split
    alike), which the padding does not shrink below the split of S/4
    real rows."""
    S, M = cand.shape
    return _cluster_size(max(S // 2, 1), M * SUPER if sb_mode else M, None)


def _row_tables(cand, xi, cap, h_i, r_pair, boxsize, hoist, cnt=None):
    """What the list-walk kernels read per row: the receiver chunks
    (S, 8, 8) (largest cap in column 6 for the density, largest h_i in
    column 7 for the displacement), the flag (S,) int32 of the rows that
    skip the periodic wrap (``interior_rows`` at the row's largest pair
    range ``r_pair``; zeros without ``hoist``), and the rows ordered
    longest list first (by ``cnt`` where the kernel reads only the first
    cnt entries)."""
    lane = cap if cap is not None else h_i
    rtab = _recv_tab(build_chunk_tab(xi, lane, boxsize), lane, h_i)
    flag = interior_rows(xi, r_pair, boxsize).to(torch.int32)
    if not hoist:
        flag = torch.zeros_like(flag)
    length = (cand >= 0).sum(dim=1) if cnt is None else cnt
    order = torch.argsort(length, descending=True,
                          stable=True).to(torch.int32)
    return rtab.contiguous(), flag.contiguous(), order


# --------------------------------------------------------------------------
# Fused density solve + WVT displacement
# --------------------------------------------------------------------------

def stream_wvt(src_blocks, cand, cnt, xi, h0, cap, hm_i, mpart, boxsize, *,
               kernel="wc6", desnngb=295, n_sweeps=N_SWEEPS, do_disp=True,
               stats=None, prune=True, hoist=True):
    """Per receiver block: the adaptive-h density solve and, with
    ``do_disp``, the WVT displacement.

    Sweep 0 measures the WC6/M4 sums sum w and sum r dW/dr at h0 (and the
    displacement sum of w_flat(r/hbar)/r dx with hbar = (hm_i + hm_j)/2 in
    box units, times boxsize).  Newton/bisection sweeps then repeat until
    all 128 lanes of the block are done or ``n_sweeps`` measurements were
    taken.  Returns (rho, h, var_hsml_fac, wk_ngb, done, delta): five
    (S, 128) tensors (done bool) and delta (S, 128, 3), or None without
    ``do_disp``.

    ``stats``, an optional (S, 4) int32 output, receives per row the
    sweeps taken, the members kept for either consumer, the members kept
    for the density, and the listed members (``member_counts``; the
    plain version evaluates every listed pair all the same).  The kernel
    streams only the kept members and skips the periodic wrap on the rows
    that ``prune_tables`` flags; ``prune=False`` / ``hoist=False`` turn
    that off, for the checks that neither changes a bit."""
    dev, nb, S, M = _check_common(src_blocks, 4, cand, cnt, xi,
                                  dict(h0=h0, cap=cap, hm_i=hm_i))
    if kernel not in _KIND:
        raise ValueError(f"unknown kernel {kernel!r}")
    if stats is not None:
        _check("stats", stats, torch.int32, (S, 4), dev)
    if dev.type == "cpu":
        return _stream_wvt_reference(
            src_blocks, cand, cnt, xi, h0, cap, hm_i, mpart, boxsize,
            kernel=kernel, desnngb=desnngb, n_sweeps=n_sweeps,
            do_disp=do_disp, stats=stats)
    if M > MAX_LIST_WIDTH:
        raise ValueError(f"list width {M} exceeds {MAX_LIST_WIDTH}")
    ctab, rtab, flag = prune_tables(src_blocks, xi, cap, hm_i, boxsize,
                                    do_disp=do_disp, hoist=hoist)
    # rows with the longest lists first, so that they do not set the end
    # of the grid
    order = torch.argsort(torch.clamp(cnt, max=M), descending=True,
                          stable=True).to(torch.int32)
    # the kernel stages sources as (x, y, z, hm) 16-byte records
    src = _pad_superblocks(src_blocks).transpose(1, 2).contiguous()
    out = torch.empty((S, BLOCK, 8), dtype=torch.float32, device=dev)
    _launch("stream_wvt", [
        src, cand, cnt, xi, h0, cap, hm_i, ctab, rtab, flag, order, out,
        stats, S, M, nb, _KIND[kernel], bool(do_disp), n_sweeps,
        bool(prune), float(mpart), float(boxsize),
        float(1.0 / boxsize), float(_INFL * boxsize), float(desnngb),
        float(_spec_win(desnngb)), float(_rho_corr(desnngb, mpart, kernel))])
    stream_wvt.launches += 1
    rho, h, vf, wk, done = (out[:, :, k] for k in range(5))
    return rho, h, vf, wk, done > 0.5, (out[:, :, 5:8] if do_disp else None)


stream_wvt.launches = 0


def list_entries(cand, nb, sb_mode):
    """The source blocks of list entries: (C, E) block ids and their
    validity, E = M (block ids) or M * SUPER (superblock ids, whose
    members past nb are invalid).  A -1 entry is invalid wherever it
    stands in a row."""
    if sb_mode:
        e = (torch.clamp(cand, min=0).long()[:, :, None] * SUPER
             + torch.arange(SUPER, device=cand.device))
        ok = (cand >= 0)[:, :, None] & (e < nb)
        e, ok = e.reshape(e.shape[0], -1), ok.reshape(ok.shape[0], -1)
    else:
        e, ok = torch.clamp(cand, min=0).long(), cand >= 0
    return torch.clamp(e, max=nb - 1), ok


def gather_sources(src_blocks, e, ok):
    """(C, R, E*128) source lanes of the entry blocks e (C, E), and the
    (C, E*128) lane mask of the valid entries."""
    g = src_blocks[e]                                          # (C,E,R,B)
    g = g.permute(0, 2, 1, 3).reshape(g.shape[0], g.shape[2], -1)
    return g, ok[:, :, None].expand(-1, -1, BLOCK).reshape(ok.shape[0], -1)


def _member_gather(src_blocks, cand, cnt, rows_sel, sb_mode):
    """Gather the source lanes of the listed superblocks (blocks without
    ``sb_mode``) of the receiver rows ``rows_sel``: returns (C, R, L)
    sources with the hm / validity row (row 3) zeroed on every lane the
    kernel skips (padded cand entries, entries past cnt, members past
    nb)."""
    c_cand = cand[rows_sel]
    c_cnt = cnt[rows_sel].long()
    mc = max(int(c_cnt.max()), 1)
    c_cand = c_cand[:, :mc]
    slot = torch.arange(mc, device=cand.device)
    c_cand = torch.where(slot[None] < c_cnt[:, None], c_cand,
                         torch.full_like(c_cand, -1))
    e, ok = list_entries(c_cand, src_blocks.shape[0], sb_mode)
    g, okl = gather_sources(src_blocks, e, ok)
    g[:, 3] = torch.where(okl, g[:, 3], torch.zeros_like(g[:, 3]))
    return g


def _row_chunks(cnt, budget, per_entry=SUPER * BLOCK * BLOCK):
    """Consecutive receiver-row chunks whose (rows, 128, sources) pair
    arrays stay within ``budget`` elements, for rows of ``cnt`` list
    entries of ``per_entry`` pairs each (rows are padded to the chunk's
    longest list; one row may exceed the budget alone)."""
    chunks, s0, widest = [], 0, 1
    for s, c in enumerate(cnt.tolist()):
        w = max(widest, c, 1)
        if s > s0 and (s - s0 + 1) * w * per_entry > budget:
            chunks.append((s0, s))
            s0, w = s, max(c, 1)
        widest = w
    if s0 < len(cnt):
        chunks.append((s0, len(cnt)))
    return chunks


def _pair_dx(xi_c, xs_c, boxsize):
    """Min-image receiver-minus-source separations, each (C, 128, L)."""
    inv_box = 1.0 / boxsize
    dx = []
    for d in range(3):
        dd = xi_c[:, d, :, None] - xs_c[:, d, None, :]
        dd = dd - boxsize * torch.round(dd * inv_box)
        dx.append(dd)
    return dx


def _dens_sums(kernel, r2, vj, h, r=None):
    """Raw density sums (sum w, sum r dW) over the source axis.  WC6 sums
    are unnormalised (t^8 poly and t^7 poly, see _norm_sums); M4 sums
    carry their 1/h^3 factors."""
    hh = h[..., None]
    if kernel == "m4":
        if r is None:
            r = torch.sqrt(r2)
        u = r / hh
        zero = torch.zeros_like(u)
        wi = 2.546479089470 + 15.278874536822 * (u - 1.0) * u * u
        wo = 5.092958178941 * (1.0 - u) ** 3
        w = torch.where(u < 0.5, wi, torch.where(u < 1.0, wo, zero)) \
            / (hh * hh * hh)
        di = u * (45.836623610466 * u - 30.557749073644)
        do = -15.278874536822 * (1.0 - u) ** 2
        dw = torch.where(u < 0.5, di, torch.where(u < 1.0, do, zero)) \
            / (hh * hh * hh * hh)
        return (w * vj).sum(-1), ((r * dw) * vj).sum(-1)
    if r is None:
        u = torch.sqrt(r2 * (1.0 / (hh * hh)))
    else:
        u = r * (1.0 / hh)
    t = torch.clamp(1.0 - u, min=0.0) * vj
    t2 = t * t
    t4 = t2 * t2
    t7 = t4 * t2 * t
    wpoly = 1.0 + u * (8.0 + u * (25.0 + 32.0 * u))
    dpoly = u * u * (1.0 + u * (7.0 + 16.0 * u))
    return (t4 * t4 * wpoly).sum(-1), (t7 * dpoly).sum(-1)


def _norm_sums(kernel, h, raw_w, raw_rdw):
    if kernel == "m4":
        return raw_w, raw_rdw
    inv_h = 1.0 / h
    norm_h3 = WC6_NORM * (inv_h * inv_h * inv_h)
    return raw_w * norm_h3, raw_rdw * (-22.0 * norm_h3)


def _update(kernel, state, acc, cap, mpart, desnngb, spec_win):
    """Newton/bisection h update from the measured sums (sph.c:175-195),
    with the speculative accept of the stream kernel."""
    k, h, _h_meas, lo, hi, done = state
    sum_w, sum_rdw = _norm_sums(kernel, h, *acc)
    wk = const.FOURPITHIRD * (h * h * h) * sum_w
    rho = mpart * sum_w
    drho = -mpart * (3.0 / h * sum_w + sum_rdw / h)
    dev = torch.abs(wk - desnngb)
    now_done = dev < const.NNGBDEV
    omega = 1.0 + drho * h / (3.0 * torch.clamp(rho, min=1e-30))
    fac = 1.0 - (wk - desnngb) / (3.0 * torch.clamp(wk, min=1e-30) * omega)
    fac = torch.clamp(fac, 1.0 / 1.24, 1.24)
    hi_n = torch.where(wk > desnngb, h, hi)
    lo_n = torch.where(wk < desnngb, h, lo)
    h_bis = (0.5 * (lo_n * lo_n * lo_n + hi_n * hi_n * hi_n)) ** (1.0 / 3.0)
    h_new = torch.where(dev < 0.5 * desnngb, h * fac, h_bis)
    h_new = torch.minimum(h_new, cap)
    spec = ((done < 0.5) & ~now_done & (dev < spec_win) & (h * fac < cap))
    freeze = (done > 0.5) | now_done
    keep = freeze | spec
    return (k + 1, torch.where(freeze, h, h_new), torch.where(keep, h, h_new),
            lo_n, hi_n, keep.to(h.dtype))


def _stream_wvt_reference(src_blocks, cand, cnt, xi, h0, cap, hm_i, mpart,
                          boxsize, *, kernel, desnngb, n_sweeps, do_disp,
                          stats=None):
    """Plain PyTorch version of ``stream_wvt``: chunks of receiver rows,
    the candidate member blocks gathered, the same per-block sweep loop
    (a row stops when all its lanes are done).  ``stats`` as for
    ``stream_wvt``: the sweeps come from this loop."""
    S, M = cand.shape
    dev = src_blocks.device
    f32 = torch.float32
    cnt = torch.clamp(cnt, max=M)
    spec_win = _spec_win(desnngb)
    out = torch.zeros((S, BLOCK, 8), dtype=f32, device=dev)
    sweeps = torch.zeros((S,), dtype=torch.int32, device=dev)
    for s0, s1 in _row_chunks(cnt, _PAIR_BUDGET[dev.type]):
        rows = torch.arange(s0, s1, device=dev)
        g = _member_gather(src_blocks, cand, cnt, rows, True)  # (C, 4, L)
        xs, hj = g[:, :3], g[:, 3][:, None, :]                # hj (C,1,L)
        vj = (hj > 0).to(f32)
        dx = _pair_dx(xi[s0:s1], xs, boxsize)
        r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
        c_cap = cap[s0:s1]
        h0c = torch.minimum(h0[s0:s1], c_cap)
        if do_disp:
            inv_r = torch.rsqrt(torch.clamp(r2, min=1e-30))
            r = r2 * inv_r
            acc = _dens_sums(kernel, r2, vj, h0c, r=r)
            hbar = (hm_i[s0:s1][..., None] + hj) * (0.5 * boxsize)
            mask = (r2 < hbar * hbar) & (r2 > 0.0) & (hj > 0.0)
            u = torch.where(mask, r / hbar, torch.ones_like(r))
            if kernel == "m4":
                wflat = m4_flat(u)
            else:
                t = torch.clamp(1.0 - u, min=0.0)
                t4 = (t * t) ** 2
                wflat = t4 * t4 * (1.0 + u * (8.0 + u * (25.0 + 32.0 * u)))
            coef = torch.where(mask, wflat, torch.zeros_like(wflat)) * inv_r
            acc_d = [(coef * dx[d]).sum(-1) for d in range(3)]
            del inv_r, r, hbar, mask, u, wflat, coef
        else:
            acc = _dens_sums(kernel, r2, vj, h0c)
        del dx
        zero = torch.zeros_like(h0c)
        state = _update(kernel, (0, h0c, h0c, zero, c_cap, zero), acc,
                        c_cap, mpart, desnngb, spec_win)
        k = 1
        active = ~(state[5] > 0.5).all(dim=1)                 # per row
        sweeps[s0:s1] = 1
        while k < n_sweeps and bool(active.any()):
            sweeps[s0:s1] += active.to(torch.int32)
            acc_n = _dens_sums(kernel, r2, vj, state[1])
            new = _update(kernel, state, acc_n, c_cap, mpart, desnngb,
                          spec_win)
            a = active[:, None]
            state = (k + 1,) + tuple(torch.where(a, n, o) for n, o in
                                     zip(new[1:], state[1:]))
            acc = tuple(torch.where(a, n, o) for n, o in zip(acc_n, acc))
            k += 1
            active = active & ~(state[5] > 0.5).all(dim=1)
        _, h, h_meas, _, _, done_f = state
        # the sums belong to h_meas (== h except for speculatively
        # accepted lanes): extrapolate sum w to h at first order
        sum_w, sum_rdw = _norm_sums(kernel, h_meas, *acc)
        sum_w = sum_w - (3.0 * sum_w + sum_rdw) / h_meas * (h - h_meas)
        wk = const.FOURPITHIRD * (h * h * h) * sum_w
        rho = mpart * sum_w
        drho = -mpart * (3.0 / h * sum_w + sum_rdw / h)
        now_done = torch.abs(wk - desnngb) < const.NNGBDEV
        rho_out = rho + _rho_corr(desnngb, mpart, kernel) * (
            WC6_NORM / (h * h * h))
        o = out[s0:s1]
        o[:, :, 0] = rho_out
        o[:, :, 1] = h
        o[:, :, 2] = 1.0 / (1.0 + h / (3.0 * torch.clamp(rho, min=1e-30))
                            * drho)
        o[:, :, 3] = wk
        o[:, :, 4] = ((done_f > 0.5) | now_done).to(f32)
        if do_disp:
            dnorm = hm_i[s0:s1] * (1.0 if kernel == "m4" else WC6_NORM)
            for d in range(3):
                o[:, :, 5 + d] = dnorm * acc_d[d]
    if stats is not None:
        stats[:, 0] = sweeps
        stats[:, 1:] = member_counts(src_blocks, cand, cnt, xi, cap, hm_i,
                                     boxsize, do_disp=do_disp)
    rho, h, vf, wk, done = (out[:, :, k] for k in range(5))
    return rho, h, vf, wk, done > 0.5, (out[:, :, 5:8] if do_disp else None)


# --------------------------------------------------------------------------
# SPH curl
# --------------------------------------------------------------------------

def pack_curl_sources(src_blocks, boxsize):
    """``PackedSources`` of ``stream_curl`` from its (nb, 8, 128) sources
    (x, y, z, valid, A0, A1, A2, pad): per block 128 (x, y, z, valid)
    records, then 128 (A0, A1, A2, pad) records, and the chunk table of
    the valid sources.  A caller with several calls over the same
    sources packs once and passes ``packed=``."""
    nb = src_blocks.shape[0]
    src = src_blocks.reshape(nb, 2, 4, BLOCK).transpose(2, 3).reshape(
        nb, 2 * BLOCK, 4)
    return PackedSources(
        src.contiguous(),
        build_chunk_tab(src_blocks[:, :3], src_blocks[:, 3], boxsize),
        src_blocks[:, 3].amax())


def curl_keep(src_blocks, cand, cnt, xi, hsml, boxsize, *, sb_mode=False,
              tiles=False):
    """The plain oracle of ``stream_curl``'s member test: (kept, listed),
    each (S, E) bool, E = M or M * 8 with ``sb_mode``; with ``tiles`` kept
    is (S, E, 16), the verdict per warp tile (``_warp_tiles``).  Of the first
    min(cnt, M) list entries a block is kept if the minimum-image gap
    between one of its 16-particle chunk hulls and one of the receiver
    block's is at most that receiver chunk's largest hsml (inflated as
    ``member_keep`` does): the JAX curl's ``stream_skip_bits`` call, with
    the chunk cross test."""
    ctab = build_chunk_tab(src_blocks[:, :3], src_blocks[:, 3], boxsize)
    rtab = _recv_tab(build_chunk_tab(xi, hsml, boxsize), hsml, None)
    kept, _, ok = _keep_rows(rtab, ctab, cand, cnt, boxsize, False, sb_mode,
                             tiles)
    return kept, ok


def stream_curl(src_blocks, cand, cnt, xi, hsml, wfac, apot_t, mpart,
                boxsize, *, kernel="wc6", sb_mode=False, prune=True,
                hoist=True, cluster=None, stats=None, packed=None):
    """B_i = wfac_i sum_j dW(r, h_i)/dr / r (dx x (A_i - A_j)) over
    r < h_i, r > 0, j valid (Price 2010 eq. 79, sph.c:216-300), with
    wfac = -m varHsmlFac / rho.  ``apot_t`` (S, 3, 128) is the receivers'
    vector potential.  ``cand`` holds block ids (the count-class
    engine's lists) or, with ``sb_mode``, superblock ids (the stream
    engine's lists and the far-tail rows); the first min(cnt, M) entries
    are read.  Returns (S, 128, 3).

    The kernel walks only the listed blocks that ``curl_keep`` keeps
    (each warp only those whose tile of its 32 lanes and 32 sources the
    test keeps) and skips the periodic wrap on interior rows; ``prune=False`` /
    ``hoist=False`` turn that off, for the checks that neither changes a
    bit.  ``cluster`` (1..8) fixes the CTAs a row is split over (None:
    ``_cluster_size``; the size changes the order of the sums).
    ``stats``, an optional (S, 5) int32 output, receives per row 1, the
    blocks kept, the blocks listed, the blocks walked (the kept ones) and
    the warp tiles walked, 16 a block (the plain version evaluates every
    listed pair all the same and reports the oracle's counts).
    ``packed`` takes ``pack_curl_sources(src_blocks, boxsize)``."""
    dev, nb, S, M = _check_common(src_blocks, 8, cand, cnt, xi,
                                  dict(hsml=hsml, wfac=wfac))
    _check("apot_t", apot_t, torch.float32, (S, 3, BLOCK), dev)
    if kernel not in _KIND:
        raise ValueError(f"unknown kernel {kernel!r}")
    if stats is not None:
        _check("stats", stats, torch.int32, (S, 5), dev)
    if dev.type == "cpu":
        if stats is not None:
            kept, ok = curl_keep(src_blocks, cand, cnt, xi, hsml, boxsize,
                                 sb_mode=sb_mode, tiles=True)
            stats[:, 0] = 1
            stats[:, 1] = stats[:, 3] = kept.any(dim=2).sum(dim=1)
            stats[:, 2] = ok.sum(dim=1)
            stats[:, 4] = kept.sum(dim=(1, 2))
        return _stream_curl_reference(src_blocks, cand, cnt, xi, hsml,
                                      wfac, apot_t, mpart, boxsize,
                                      kernel=kernel, sb_mode=sb_mode)
    cluster = _cluster_size(S, M * SUPER if sb_mode else M, cluster)
    if packed is None:
        packed = pack_curl_sources(src_blocks, boxsize)
    _check_packed(packed, nb, dev, recs=2)
    rtab, flag, order = _row_tables(cand, xi, hsml, None, hsml.amax(dim=1),
                                    boxsize, hoist, cnt=cnt)
    out = torch.empty((S, BLOCK, 3), dtype=torch.float32, device=dev)
    _launch("stream_curl", [
        packed.src, packed.ctab, rtab, cand, cnt, flag, order, xi, hsml,
        wfac, apot_t, out, stats, S, M, nb, _KIND[kernel], bool(sb_mode),
        bool(prune), cluster, float(boxsize), float(1.0 / boxsize),
        float(_INFL * boxsize)])
    stream_curl.launches += 1
    return out


stream_curl.launches = 0


def _stream_curl_reference(src_blocks, cand, cnt, xi, hsml, wfac, apot_t,
                           mpart, boxsize, *, kernel, sb_mode):
    """Plain PyTorch version of ``stream_curl``."""
    S, M = cand.shape
    dev = src_blocks.device
    cnt = torch.clamp(cnt, max=M)
    out = torch.zeros((S, BLOCK, 3), dtype=torch.float32, device=dev)
    per_entry = (SUPER if sb_mode else 1) * BLOCK * BLOCK
    for s0, s1 in _row_chunks(cnt, _PAIR_BUDGET[dev.type], per_entry):
        rows = torch.arange(s0, s1, device=dev)
        g = _member_gather(src_blocks, cand, cnt, rows,
                           sb_mode)                           # (C, 8, L)
        vj = g[:, 3][:, None, :]
        dx = _pair_dx(xi[s0:s1], g[:, :3], boxsize)
        r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
        h = hsml[s0:s1][..., None]
        inv_h = 1.0 / h
        mask = (r2 < h * h) & (r2 > 0.0) & (vj > 0.0)
        u = torch.sqrt(r2) * inv_h
        t = torch.clamp(1.0 - u, min=0.0)
        inv_h5 = inv_h * inv_h * inv_h * inv_h * inv_h
        if kernel == "m4":
            inv_u = torch.rsqrt(torch.clamp(r2, min=1e-30)) * h
            inner = 45.836623610466 * u - 30.557749073644
            outer = -15.278874536822 * t * t * inv_u
            w = torch.where(u < 0.5, inner, outer) * inv_h5
        else:
            t3 = t * t * t
            w = (WC6_NORM * inv_h5) * (-22.0) * t3 * t3 * t * (
                16.0 * u * u + 7.0 * u + 1.0)
        w = torch.where(mask, w, torch.zeros_like(w))
        ai = apot_t[s0:s1]
        dA = [ai[:, d, :, None] - g[:, 4 + d, None, :] for d in range(3)]
        acc = [(w * (dx[2] * dA[1] - dx[1] * dA[2])).sum(-1),
               (w * (dx[0] * dA[2] - dx[2] * dA[0])).sum(-1),
               (w * (dx[1] * dA[0] - dx[0] * dA[1])).sum(-1)]
        has = (cnt[s0:s1] > 0)[:, None]
        for d in range(3):
            out[s0:s1, :, d] = torch.where(has, wfac[s0:s1] * acc[d],
                                           torch.zeros_like(acc[d]))
    return out
