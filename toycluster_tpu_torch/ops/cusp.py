"""Synthetic cusp inputs for the pair kernels, and lanes about halo
centres for the model-density kernel (``model_points``).

The fixture of ``tests/test_pallas_density.py:34-57``: a cuspy particle
cloud in a periodic box, with smoothing lengths growing outwards.  At n
particles h is scaled by (1500/n)^(1/3), which keeps the neighbour count
of the 1500-particle original.  Sources, candidate lists and receivers
are built by the port's neighbour engine, in the layouts of
``ops/stream_pair.py`` and ``ops/class_pair.py``.  The kernel checks use
it: ``chip_smoke.py`` and the ``tests/test_torch_*`` files (the JAX
kernels take the same arrays).
"""

from __future__ import annotations

import numpy as np
import torch

from . import blocks as blk
from .class_pair import fused_bounds
from .density_model import gas_halos

BOX = 1000.0
DESNNGB = {"wc6": 64, "m4": 50}


def cusp_points(n, seed, centre=BOX / 2):
    """(pos (n, 3), h0 (n,)) float32 NumPy arrays, the cusp centred on
    ``centre`` (at 0 it lies across the periodic edge on every axis)."""
    rng = np.random.default_rng(seed)
    r = np.clip(80.0 * (rng.random(n) ** 2 / (1 - rng.random(n) * 0.7)),
                0, 400.0)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = ((centre + r[:, None] * u) % BOX).astype(np.float32)
    d = pos - centre
    rr = np.linalg.norm(d - BOX * np.round(d / BOX), axis=1)
    h0 = np.clip(8.0 + rr * 0.2, 8.0, 90.0) * (1500.0 / n) ** (1 / 3)
    return pos, h0.astype(np.float32)


def wvt_inputs(kernel, do_disp, n, seed=7, device="cpu", centre=BOX / 2):
    """``stream_wvt`` arguments for the cusp: (args, kw, valid), with
    superblock lists over every receiver row (cap = 3 h0) and valid the
    (S, 128) mask of real lanes."""
    pos, h0 = (torch.as_tensor(a, device=device)
               for a in cusp_points(n, seed, centre))
    bi = blk.build_blocks(pos, BOX)
    nb = bi.n_blocks
    hs = blk.pad_rows(h0[bi.order], bi.n_padded)
    cap = hs * 3.0
    radius = cap.reshape(nb, blk.BLOCK).amax(dim=1)
    cand = blk.find_candidates_super(
        bi, torch.arange(nb, dtype=torch.int32, device=pos.device), radius,
        radius, BOX, max_cand=max(4, bi.sb_lo.shape[0]))
    pos_t = bi.pos.reshape(nb, blk.BLOCK, 3).transpose(1, 2).contiguous()
    hm = (hs / BOX).reshape(nb, blk.BLOCK).contiguous()
    valid = bi.valid.reshape(nb, blk.BLOCK)
    row3 = (torch.where(valid, hm, torch.zeros_like(hm)) if do_disp
            else valid.float())
    src = torch.cat([pos_t, row3[:, None]], dim=1).contiguous()
    args = (src, cand.idx.contiguous(), cand.count, pos_t,
            hs.reshape(nb, blk.BLOCK).contiguous(),
            cap.reshape(nb, blk.BLOCK).contiguous(), hm, 1.0, BOX)
    kw = dict(kernel=kernel, desnngb=DESNNGB[kernel], do_disp=do_disp)
    return args, kw, valid


def class_inputs(kernel, n, sb_mode, seed=7, device="cpu", centre=BOX / 2):
    """The count-class operators' arrays for the cusp (cap = 3 h0),
    with block-granular lists (``find_candidates``) or, with
    ``sb_mode``, superblock lists over every receiver row.  Returns a
    dict: pos_t, valid_t, hm_blocks (hm on real lanes, else 0), h_b3 (hm
    on every lane), cand, cnt, h0, cap, hm (S, 128), the fused bounds
    gdist/dkeep, valid (S, 128) and desnngb."""
    pos, h0 = (torch.as_tensor(a, device=device)
               for a in cusp_points(n, seed, centre))
    bi = blk.build_blocks(pos, BOX)
    nb = bi.n_blocks
    hs = blk.pad_rows(h0[bi.order], bi.n_padded)
    cap = hs * 3.0
    radius = cap.reshape(nb, blk.BLOCK).amax(dim=1)
    if sb_mode:
        cand = blk.find_candidates_super(
            bi, torch.arange(nb, dtype=torch.int32, device=pos.device),
            radius, radius, BOX, max_cand=max(4, bi.sb_lo.shape[0]))
    else:
        cand = blk.find_candidates(bi, radius, BOX, max_cand=nb)
    width = max(int(cand.count.max()), 1)
    idx = cand.idx[:, :width].contiguous()
    valid = bi.valid.reshape(nb, blk.BLOCK)
    hm = (hs / BOX).reshape(nb, blk.BLOCK).contiguous()
    hm_blocks = torch.where(valid, hm, torch.zeros_like(hm))[:, None]
    gdist, dkeep = fused_bounds(
        bi.bb_lo, bi.bb_hi, torch.arange(nb, device=pos.device), idx,
        hm.amax(dim=1), hm_blocks[:, 0].amax(dim=1), BOX, sb_mode=sb_mode)
    return dict(
        pos_t=bi.pos.reshape(nb, blk.BLOCK, 3).transpose(1, 2).contiguous(),
        valid_t=valid.to(torch.float32)[:, None].contiguous(),
        hm_blocks=hm_blocks.contiguous(), h_b3=hm[:, None].contiguous(),
        cand=idx, cnt=cand.count, h0=hs.reshape(nb, blk.BLOCK).contiguous(),
        cap=cap.reshape(nb, blk.BLOCK).contiguous(), hm=hm, gdist=gdist,
        dkeep=dkeep, valid=valid, desnngb=DESNNGB[kernel])


def curl_inputs(kernel, n, seed=11, device="cpu", sb_mode=True):
    """``stream_curl`` arguments for the cusp with a smooth vector
    potential (one per kernel) and wfac in [-1.5, -0.5) on real lanes:
    (args, kw, valid); superblock lists, or block lists without
    ``sb_mode``."""
    args, _, valid = wvt_inputs(kernel, False, n, seed=seed, device=device)
    _, cand, cnt, pos_t, h0, _, _, mpart, box = args
    if not sb_mode:
        c = class_inputs(kernel, n, False, seed=seed, device=device)
        cand, cnt = c["cand"], c["cnt"]
    nb = pos_t.shape[0]
    p = pos_t / box
    if kernel == "wc6":
        ap = torch.stack([torch.sin(3.1 * p[:, 0]) + p[:, 1] ** 2,
                          torch.cos(2.3 * p[:, 1]) * p[:, 2],
                          p[:, 0] * p[:, 1] + 0.5 * p[:, 2]], dim=1)
    else:
        ap = torch.stack([p[:, 1], p[:, 2] ** 2, torch.sin(2.0 * p[:, 0])],
                         dim=1)
    v = valid.reshape(nb, 1, blk.BLOCK).float()
    src8 = torch.cat([pos_t, v, ap, torch.zeros_like(v)], dim=1).contiguous()
    u = np.random.default_rng(seed + 1).random((nb, blk.BLOCK))
    wfac = torch.where(valid, -(0.5 + torch.as_tensor(
        u, dtype=torch.float32, device=pos_t.device)), torch.zeros_like(h0))
    args = (src8, cand, cnt, pos_t, (h0 * 1.3).contiguous(),
            wfac.contiguous(), ap.contiguous(), mpart, box)
    return args, dict(kernel=kernel, sb_mode=sb_mode), valid


def model_points(ha, boxsize, n, seed=5, halos=None):
    """(n, 3) float32 box positions on the device of the halo arrays
    ``ha`` for the model-density checks: a lane about the centre
    (d_com + boxsize / 2) of a halo drawn from ``halos`` (default: those
    with gas), at a distance uniform in [0, 1.5 rcut) in an isotropic
    direction, folded into the box; the first tenth uniform in the box."""
    dev = ha.d_com.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    idx = torch.tensor(gas_halos(ha) if halos is None else halos,
                       dtype=torch.long, device=dev)
    pick = idx[torch.randint(idx.numel(), (n,), generator=gen, device=dev)]
    u = torch.randn((n, 3), generator=gen, device=dev)
    u = u / torch.linalg.vector_norm(u, dim=1, keepdim=True)
    r = 1.5 * ha.rcut[pick] * torch.rand(n, generator=gen, device=dev)
    pos = torch.remainder(ha.d_com[pick] + boxsize / 2 + r[:, None] * u,
                          boxsize)
    k = n // 10
    pos[:k] = torch.rand((k, 3), generator=gen, device=dev) * boxsize
    return pos.contiguous()
