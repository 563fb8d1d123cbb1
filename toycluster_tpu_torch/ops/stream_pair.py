"""Stream pair operators: the fused WVT density solve + displacement, and
the SPH curl, over superblock candidate lists.

JAX counterpart: ``toycluster_tpu/ops/pallas_pair.py``
(``stream_wvt_pallas``/``_stream_kernel`` and
``stream_curl_pallas``/``_curl_stream_kernel``).  Layouts are those of the
Pallas wrappers in superblock mode:

* sources ``(nb, 4, 128)`` (x, y, z, hm) for the solve, ``(nb, 8, 128)``
  (x, y, z, valid, A0, A1, A2, pad) for the curl; a source lane with
  hm == 0 (valid == 0) takes part in no pair;
* ``cand (S, M)`` int32 superblock ids, -1 padded; ``cnt (S,)`` int32 hit
  counts, clamped to M here;
* receivers ``xi (S, 3, 128)`` and per-lane ``(S, 128)`` rows.

Each operator has two paths.  A CUDA tensor launches the hand-written
kernel of ``csrc/`` (one CTA of 128 threads per receiver block) and
counts the launch in ``stream_wvt.launches`` / ``stream_curl.launches``;
a CPU tensor runs the plain PyTorch version beside it
(``_stream_wvt_reference`` / ``_stream_curl_reference``), which evaluates
the same algorithm with the same block-level loop.  Any other device
raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import constants as const
from .blocks import BLOCK, SUPER
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


def _spec_win(desnngb):
    return math.sqrt(const.NNGBDEV * desnngb / SPEC_KAPPA)


def _rho_corr(desnngb, mpart, kernel):
    """Dehnen+12 WC6 self-contribution correction factor (sph.c:202-210),
    multiplied by W(0, h) = WC6_NORM / h^3 in the epilogue."""
    if kernel != "wc6":
        return 0.0
    return -0.0116 * (desnngb * 0.01) ** (-2.236) * mpart


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "stream_wvt_launch": [_P] * 8 + [_I] * 6 + [_F] * 5 + [_P],
    "stream_curl_launch": [_P] * 8 + [_I] * 4 + [_F, _P],
}


def _entry(lib_name, fn_name):
    """The C entry point of a compiled kernel library, typed."""
    from .cuda_build import load
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = _ARGTYPES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


# --------------------------------------------------------------------------
# Fused density solve + WVT displacement
# --------------------------------------------------------------------------

def stream_wvt(src_blocks, cand, cnt, xi, h0, cap, hm_i, mpart, boxsize, *,
               kernel="wc6", desnngb=295, n_sweeps=N_SWEEPS, do_disp=True):
    """Per receiver block: the adaptive-h density solve and, with
    ``do_disp``, the WVT displacement.

    Sweep 0 measures the WC6/M4 sums sum w and sum r dW/dr at h0 (and the
    displacement sum of w_flat(r/hbar)/r dx with hbar = (hm_i + hm_j)/2 in
    box units, times boxsize).  Newton/bisection sweeps then repeat until
    all 128 lanes of the block are done or ``n_sweeps`` measurements were
    taken.  Returns (rho, h, var_hsml_fac, wk_ngb, done, delta): five
    (S, 128) tensors (done bool) and delta (S, 128, 3), or None without
    ``do_disp``."""
    dev, nb, S, M = _check_common(src_blocks, 4, cand, cnt, xi,
                                  dict(h0=h0, cap=cap, hm_i=hm_i))
    if kernel not in _KIND:
        raise ValueError(f"unknown kernel {kernel!r}")
    if dev.type == "cpu":
        return _stream_wvt_reference(
            src_blocks, cand, cnt, xi, h0, cap, hm_i, mpart, boxsize,
            kernel=kernel, desnngb=desnngb, n_sweeps=n_sweeps,
            do_disp=do_disp)
    launch = _entry("stream_wvt", "stream_wvt_launch")
    src = _pad_superblocks(src_blocks)
    out = torch.empty((S, BLOCK, 8), dtype=torch.float32, device=dev)
    rc = launch(
        _ptr(src), _ptr(cand), _ptr(cnt), _ptr(xi), _ptr(h0), _ptr(cap),
        _ptr(hm_i), _ptr(out), ctypes.c_int(S), ctypes.c_int(M),
        ctypes.c_int(nb), ctypes.c_int(_KIND[kernel]),
        ctypes.c_int(int(bool(do_disp))), ctypes.c_int(int(n_sweeps)),
        ctypes.c_float(mpart), ctypes.c_float(boxsize),
        ctypes.c_float(desnngb), ctypes.c_float(_spec_win(desnngb)),
        ctypes.c_float(_rho_corr(desnngb, mpart, kernel)), _stream())
    if rc != 0:
        raise RuntimeError(
            f"stream_wvt kernel launch failed: CUDA error {rc}")
    stream_wvt.launches += 1
    rho, h, vf, wk, done = (out[:, :, k] for k in range(5))
    return rho, h, vf, wk, done > 0.5, (out[:, :, 5:8] if do_disp else None)


stream_wvt.launches = 0


def _member_gather(src_blocks, cand, cnt, rows_sel):
    """Gather the source lanes of the listed superblocks of the receiver
    rows ``rows_sel``: returns (C, R, L) sources with the hm / validity
    row (row 3) zeroed on every lane the kernel skips (padded cand
    entries, entries past cnt, members past nb)."""
    nb = src_blocks.shape[0]
    c_cand = cand[rows_sel].long()
    c_cnt = cnt[rows_sel].long()
    mc = max(int(c_cnt.max()), 1)
    c_cand = c_cand[:, :mc]
    e = (torch.clamp(c_cand, min=0)[:, :, None] * SUPER
         + torch.arange(SUPER, device=cand.device))           # (C, mc, 8)
    slot = torch.arange(mc, device=cand.device)
    ok = ((c_cand >= 0) & (slot[None] < c_cnt[:, None]))[:, :, None] \
        & (e < nb)
    e = torch.clamp(e, max=nb - 1).reshape(e.shape[0], -1)     # (C, mc*8)
    g = src_blocks[e]                                          # (C,mb,R,B)
    g = g.permute(0, 2, 1, 3).reshape(g.shape[0], g.shape[2], -1)
    okl = ok.reshape(ok.shape[0], -1, 1).expand(-1, -1, BLOCK).reshape(
        ok.shape[0], -1)
    g[:, 3] = torch.where(okl, g[:, 3], torch.zeros_like(g[:, 3]))
    return g


def _row_chunks(cnt, budget):
    """Consecutive receiver-row chunks whose (rows, 128, sources) pair
    arrays stay within ``budget`` elements (rows are padded to the
    chunk's longest list; one row may exceed the budget alone)."""
    per_sb = SUPER * BLOCK * BLOCK
    chunks, s0, widest = [], 0, 1
    for s, c in enumerate(cnt.tolist()):
        w = max(widest, c, 1)
        if s > s0 and (s - s0 + 1) * w * per_sb > budget:
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
                          boxsize, *, kernel, desnngb, n_sweeps, do_disp):
    """Plain PyTorch version of ``stream_wvt``: chunks of receiver rows,
    the candidate member blocks gathered, the same per-block sweep loop
    (a row stops when all its lanes are done)."""
    S, M = cand.shape
    dev = src_blocks.device
    f32 = torch.float32
    cnt = torch.clamp(cnt, max=M)
    spec_win = _spec_win(desnngb)
    out = torch.zeros((S, BLOCK, 8), dtype=f32, device=dev)
    for s0, s1 in _row_chunks(cnt, _PAIR_BUDGET[dev.type]):
        rows = torch.arange(s0, s1, device=dev)
        g = _member_gather(src_blocks, cand, cnt, rows)       # (C, 4, L)
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
        while k < n_sweeps and bool(active.any()):
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
    rho, h, vf, wk, done = (out[:, :, k] for k in range(5))
    return rho, h, vf, wk, done > 0.5, (out[:, :, 5:8] if do_disp else None)


# --------------------------------------------------------------------------
# SPH curl
# --------------------------------------------------------------------------

def stream_curl(src_blocks, cand, cnt, xi, hsml, wfac, apot_t, mpart,
                boxsize, *, kernel="wc6"):
    """B_i = wfac_i sum_j dW(r, h_i)/dr / r (dx x (A_i - A_j)) over
    r < h_i, r > 0, j valid (Price 2010 eq. 79, sph.c:216-300), with
    wfac = -m varHsmlFac / rho.  ``apot_t`` (S, 3, 128) is the receivers'
    vector potential.  Returns (S, 128, 3)."""
    dev, nb, S, M = _check_common(src_blocks, 8, cand, cnt, xi,
                                  dict(hsml=hsml, wfac=wfac))
    _check("apot_t", apot_t, torch.float32, (S, 3, BLOCK), dev)
    if kernel not in _KIND:
        raise ValueError(f"unknown kernel {kernel!r}")
    if dev.type == "cpu":
        return _stream_curl_reference(src_blocks, cand, cnt, xi, hsml,
                                      wfac, apot_t, mpart, boxsize,
                                      kernel=kernel)
    launch = _entry("stream_curl", "stream_curl_launch")
    src = _pad_superblocks(src_blocks)
    out = torch.empty((S, BLOCK, 3), dtype=torch.float32, device=dev)
    rc = launch(
        _ptr(src), _ptr(cand), _ptr(cnt), _ptr(xi), _ptr(hsml), _ptr(wfac),
        _ptr(apot_t), _ptr(out), ctypes.c_int(S), ctypes.c_int(M),
        ctypes.c_int(nb), ctypes.c_int(_KIND[kernel]),
        ctypes.c_float(boxsize), _stream())
    if rc != 0:
        raise RuntimeError(
            f"stream_curl kernel launch failed: CUDA error {rc}")
    stream_curl.launches += 1
    return out


stream_curl.launches = 0


def _stream_curl_reference(src_blocks, cand, cnt, xi, hsml, wfac, apot_t,
                           mpart, boxsize, *, kernel):
    """Plain PyTorch version of ``stream_curl``."""
    S, M = cand.shape
    dev = src_blocks.device
    cnt = torch.clamp(cnt, max=M)
    out = torch.zeros((S, BLOCK, 3), dtype=torch.float32, device=dev)
    for s0, s1 in _row_chunks(cnt, _PAIR_BUDGET[dev.type]):
        rows = torch.arange(s0, s1, device=dev)
        g = _member_gather(src_blocks, cand, cnt, rows)       # (C, 8, L)
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
