"""The port's count-class pair operators (ops/class_pair.py) and the
block-list mode of stream_curl against the very TPU kernels
(solve_density_pallas, wvt_displacement_pallas, fused_wvt_pallas,
stream_curl_pallas in interpret mode) and the XLA pair operators
(ops/pair_ops.py) on the cusp fixture of tests/test_pallas_density.py:
34-57 (N = 1500, box 1000), WC6 (DESNNGB 64) and M4 (DESNNGB 50), with
block-granular lists (find_candidates) and superblock lists (sb mode).
On the CPU the port runs its plain PyTorch versions; the CUDA kernels
are held against those on the card by tests/test_torch_cuda.py.

Tolerances of tests/test_pallas_density.py: h/rho rtol 2e-3 on lanes done
in both, var_fac rtol 5e-3, |wkNgb - DESNNGB| < 0.05 + 1e-3, done count
>= 0.97x the reference's; displacement rtol 2e-4, atol 1e-6 max|delta|;
curl rtol 5e-4, atol 2e-5 max|B|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycluster_tpu.ops import blocks as jblk
from toycluster_tpu.ops import pair_ops
from toycluster_tpu.ops.pallas_pair import (fused_wvt_pallas,
                                            solve_density_pallas,
                                            stream_curl_pallas,
                                            wvt_displacement_pallas)
from toycluster_tpu_torch.ops import class_pair as cp
from toycluster_tpu_torch.ops import cusp, stream_pair

torch.set_num_threads(2)

BOX = cusp.BOX
N = 1500
SWEEPS = 24


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module", params=["wc6", "m4"])
def fix(request):
    """The JAX fixture and its arrays in the Pallas layouts, block lists
    and superblock lists over every receiver row, plus the XLA pair
    operators' density solve and displacement on the block lists."""
    kernel = request.param
    des = cusp.DESNNGB[kernel]
    pos, h0 = cusp.cusp_points(N, seed=7)
    bi = jblk.build_blocks(jnp.asarray(pos), BOX)
    nb = bi.n_blocks

    def pad(x):
        xs = x[np.asarray(bi.order)]
        return np.concatenate([xs, np.repeat(xs[-1:], bi.n_padded - len(xs))])

    h0s = jnp.asarray(pad(h0))
    cap = h0s * 3.0
    radius = cap.reshape(nb, 128).max(axis=1)
    cand = jblk.find_candidates(bi, radius, BOX, max_cand=16)
    assert int(cand.overflow) <= 0
    cand_sb = jblk.find_candidates_super(
        bi, jnp.arange(nb, dtype=jnp.int32), radius, radius, BOX,
        max_cand=max(4, bi.sb_lo.shape[0]))
    assert int(cand_sb.overflow) <= 0
    sel = pair_ops.full_selection(bi, cand.idx)
    res = pair_ops.solve_density(bi, sel, h0s, cap, 1.0, BOX, kernel=kernel,
                                 desnngb=des, max_iter=SWEEPS)
    h_box = h0s / BOX
    d_xla = pair_ops.wvt_displacement(bi, sel, h_box, 1.0, BOX, kernel=kernel)
    pos_t = bi.pos.reshape(nb, 128, 3).transpose(0, 2, 1)
    valid = np.asarray(bi.valid)
    a = dict(
        pos_t=pos_t, valid_t=bi.valid.reshape(nb, 1, 128).astype(jnp.float32),
        hm_blocks=jnp.where(bi.valid, h_box, 0.0).reshape(nb, 1, 128),
        h_b3=h_box.reshape(nb, 1, 128), h0_b=h0s.reshape(nb, 128),
        cap_b=cap.reshape(nb, 128), hm_b=h_box.reshape(nb, 128))
    lists = {"block": (cand.idx, cand.count), "sb": (cand_sb.idx,
                                                     cand_sb.count)}
    return dict(kernel=kernel, des=des, bi=bi, a=a, lists=lists, res=res,
                d_xla=d_xla, valid=valid)


def _args(fix, mode):
    a = fix["a"]
    cand, cnt = fix["lists"][mode]
    return a, cand, cnt


def assert_density(got, ref, valid, des, var_fac=True):
    g_rho, g_h, g_vf, g_wk, g_done = (_np(x).reshape(-1) for x in got[:5])
    r_rho, r_h, r_vf, _, r_done = (_np(x).reshape(-1) for x in ref[:5])
    both = valid & g_done & r_done
    assert both.sum() >= 0.97 * (valid & r_done).sum()
    assert both.sum() > 0.9 * valid.sum()
    np.testing.assert_allclose(g_h[both], r_h[both], rtol=2e-3)
    np.testing.assert_allclose(g_rho[both], r_rho[both], rtol=2e-3)
    if var_fac:
        np.testing.assert_allclose(g_vf[both], r_vf[both], rtol=5e-3)
    assert np.abs(g_wk[both] - des).max() < 0.05 + 1e-3


def assert_disp(got, ref, valid):
    a = _np(ref).reshape(-1, 3)[valid]
    b = _np(got).reshape(-1, 3)[valid]
    assert np.abs(a).max() > 0
    np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("mode", ["block", "sb"])
def test_solve_density_matches_pallas_and_xla(fix, mode):
    a, cand, _ = _args(fix, mode)
    kw = dict(kernel=fix["kernel"], desnngb=fix["des"], n_sweeps=SWEEPS,
              sb_mode=mode == "sb")
    ref = solve_density_pallas(a["pos_t"], a["valid_t"], cand, a["pos_t"],
                               a["h0_b"], a["cap_b"], 1.0, BOX, **kw,
                               interpret=True)
    got = cp.solve_density(*(_t(x) for x in (
        a["pos_t"], a["valid_t"], cand, a["pos_t"], a["h0_b"], a["cap_b"])),
        1.0, BOX, **kw)
    assert_density(got, ref, fix["valid"], fix["des"])
    assert_density(got, fix["res"], fix["valid"], fix["des"])
    sat = _np(got[5]).reshape(-1)
    exp = ~_np(got[4]).reshape(-1) | (_np(got[1]).reshape(-1)
                                      >= _np(a["cap_b"]).reshape(-1) * 0.999)
    np.testing.assert_array_equal(sat, exp)


@pytest.mark.parametrize("mode", ["block", "sb"])
def test_wvt_displacement_matches_pallas_and_xla(fix, mode):
    a, cand, _ = _args(fix, mode)
    kw = dict(kernel=fix["kernel"], sb_mode=mode == "sb")
    ref = wvt_displacement_pallas(a["pos_t"], a["valid_t"], a["h_b3"], cand,
                                  a["pos_t"], a["hm_b"], 0.01, BOX, **kw,
                                  interpret=True)
    got = cp.wvt_displacement(*(_t(x) for x in (
        a["pos_t"], a["valid_t"], a["h_b3"], cand, a["pos_t"], a["hm_b"])),
        0.01, BOX, **kw)
    assert got.shape == (fix["bi"].n_blocks, 128, 3)
    assert_disp(got, ref, fix["valid"])
    assert_disp(got, np.asarray(fix["d_xla"]) * 0.01, fix["valid"])


def _fused_args(fix, mode):
    a, cand, cnt = _args(fix, mode)
    return (a["pos_t"], a["hm_blocks"], cand, cnt, a["pos_t"], a["h0_b"],
            a["cap_b"], a["hm_b"])


@pytest.mark.parametrize("mode", ["block", "sb"])
def test_fused_wvt_matches_pallas_and_xla(fix, mode):
    args = _fused_args(fix, mode)
    kw = dict(kernel=fix["kernel"], desnngb=fix["des"], n_sweeps=SWEEPS,
              sb_mode=mode == "sb")
    ref = fused_wvt_pallas(*args, 1.0, BOX, **kw, interpret=True)
    got = cp.fused_wvt(*(_t(x) for x in args), 1.0, BOX, **kw)
    # the fused record reuses the last sweep's sums: varHsmlFac of lanes
    # still moving at the sweep limit is not comparable
    assert_density(got, ref, fix["valid"], fix["des"])
    assert_density(got, fix["res"], fix["valid"], fix["des"], var_fac=False)
    assert_disp(got[5], ref[5], fix["valid"])
    assert_disp(got[5], fix["d_xla"], fix["valid"])


def _bounds(fix, mode):
    """gdist/dkeep from the block boxes, as the classed WVT loop builds
    them (tests/test_pallas_density.py:264-273)."""
    bi, a = fix["bi"], fix["a"]
    cand, _ = fix["lists"][mode]
    cand = np.asarray(cand)
    nb = bi.n_blocks
    if mode == "sb":
        e = np.maximum(cand, 0)[:, :, None] * 8 + np.arange(8)
        cand = np.where((cand >= 0)[:, :, None] & (e < nb), e, -1)
        cand = cand.reshape(nb, -1)
    rowsc = np.maximum(cand, 0)
    lo, hi = np.asarray(bi.bb_lo), np.asarray(bi.bb_hi)
    d2 = np.asarray(jblk._interval_dist2(
        jnp.asarray(lo[:, None]), jnp.asarray(hi[:, None]),
        jnp.asarray(lo[rowsc]), jnp.asarray(hi[rowsc]), BOX))
    gd = np.where(cand >= 0, np.sqrt(d2), np.inf).astype(np.float32)
    bhm = np.asarray(a["hm_blocks"]).reshape(nb, 128).max(axis=1)
    dk = gd <= 0.5 * (np.asarray(a["hm_b"]).max(axis=1)[:, None]
                      + bhm[rowsc]) * BOX
    return _t(gd), _t(dk)


@pytest.mark.parametrize("mode", ["block", "sb"])
def test_fused_bounds_are_bit_identical(fix, mode):
    args = [_t(x) for x in _fused_args(fix, mode)]
    kw = dict(kernel=fix["kernel"], desnngb=fix["des"], n_sweeps=4,
              sb_mode=mode == "sb")
    gd, dk = _bounds(fix, mode)
    assert bool((gd[torch.isfinite(gd)] > 0).any())
    assert bool((~dk).any())
    base = cp.fused_wvt(*args, 1.0, BOX, **kw)
    skip = cp.fused_wvt(*args, 1.0, BOX, **kw, gdist=gd, dkeep=dk)
    for x, y in zip(base, skip):
        assert torch.equal(x, y)


def test_curl_block_mode_matches_pallas_and_xla(fix):
    """stream_curl in block-list mode against stream_curl_pallas
    (sb_mode=False) and pair_ops.sph_curl
    (tests/test_pallas_density.py:746-784)."""
    bi, a, res = fix["bi"], fix["a"], fix["res"]
    nb = bi.n_blocks
    cand, cnt = fix["lists"]["block"]
    p = bi.pos / BOX
    apot = jnp.stack([jnp.sin(3.1 * p[:, 0]) + p[:, 1] ** 2,
                      jnp.cos(2.3 * p[:, 1]) * p[:, 2],
                      p[:, 0] * p[:, 1] + 0.5 * p[:, 2]],
                     axis=1).astype(jnp.float32)
    rho = jnp.where(bi.valid, res.rho, 1.0)
    vf = jnp.where(bi.valid, res.var_hsml_fac, 0.0)
    b_xla = pair_ops.sph_curl(bi, pair_ops.full_selection(bi, cand), res.hsml,
                              rho, vf, apot, 1.0, BOX, kernel=fix["kernel"])
    ap_t = apot.reshape(nb, 128, 3).transpose(0, 2, 1)
    src8 = jnp.concatenate([a["pos_t"], a["valid_t"], ap_t,
                            jnp.zeros((nb, 1, 128), jnp.float32)], axis=1)
    h_b = res.hsml.reshape(nb, 128)
    wfac = jnp.where(bi.valid, -vf / rho, 0.0).reshape(nb, 128)
    args = (src8, cand, cnt, a["pos_t"], h_b, wfac, ap_t)
    b_pal = stream_curl_pallas(*args, 1.0, BOX, kernel=fix["kernel"],
                               interpret=True)
    got = stream_pair.stream_curl(*(_t(x) for x in args), 1.0, BOX,
                                  kernel=fix["kernel"])
    v = fix["valid"]
    for ref in (b_pal, b_xla):
        r = np.asarray(ref).reshape(-1, 3)[v]
        g = got.numpy().reshape(-1, 3)[v]
        np.testing.assert_allclose(g, r, rtol=5e-4,
                                   atol=2e-5 * np.abs(r).max())


def test_padded_rows_and_entries():
    """-1 entries anywhere in a row take part in no pair, fused rows with
    cnt = 0 are zero, and the CPU path counts no launch."""
    args, kw, _ = cusp.wvt_inputs("m4", True, 600)
    src, _, _, pos_t, h0, cap, hm, mpart, box = args
    nb = pos_t.shape[0]
    valid_t = (src[:, 3:4] > 0).to(torch.float32).contiguous()
    full = torch.arange(nb, dtype=torch.int32).repeat(nb, 1)
    holes = full.clone()
    holes[:, 1::2] = -1
    shuffled = torch.cat([holes, torch.full((nb, 3), -1, dtype=torch.int32)],
                         dim=1)
    shuffled = shuffled[:, torch.randperm(shuffled.shape[1],
                                          generator=torch.Generator()
                                          .manual_seed(0))].contiguous()
    before = (cp.solve_density.launches, cp.fused_wvt.launches,
              cp.wvt_displacement.launches)
    d_a = cp.wvt_displacement(pos_t, valid_t, hm[:, None].contiguous(),
                              holes, pos_t, hm, 1.0, box, kernel="m4")
    d_b = cp.wvt_displacement(pos_t, valid_t, hm[:, None].contiguous(),
                              shuffled, pos_t, hm, 1.0, box, kernel="m4")
    torch.testing.assert_close(d_b, d_a, rtol=1e-5, atol=1e-7)
    s_a = cp.solve_density(pos_t, valid_t, holes, pos_t, h0, cap, mpart,
                           box, kernel="m4", desnngb=kw["desnngb"])
    s_b = cp.solve_density(pos_t, valid_t, shuffled, pos_t, h0, cap, mpart,
                           box, kernel="m4", desnngb=kw["desnngb"])
    torch.testing.assert_close(s_b[1], s_a[1], rtol=1e-5, atol=0)
    cnt = torch.full((nb,), nb, dtype=torch.int32)
    cnt[0] = 0
    f = cp.fused_wvt(pos_t, src[:, 3:4].contiguous(), full, cnt, pos_t, h0,
                     cap, hm, mpart, box, kernel="m4", desnngb=kw["desnngb"])
    assert all(bool((x[0] == 0).all()) for x in f)
    assert bool((f[1][1:] > 0).all())
    assert (cp.solve_density.launches, cp.fused_wvt.launches,
            cp.wvt_displacement.launches) == before


def test_wrappers_reject_bad_inputs():
    args, _, _ = cusp.wvt_inputs("wc6", True, N)
    src, _, _, pos_t, h0, cap, hm, mpart, box = args
    valid_t = src[:, 3:4].contiguous()
    cand = torch.zeros((pos_t.shape[0], 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="dtype"):
        cp.solve_density(pos_t, valid_t, cand.long(), pos_t, h0, cap, mpart,
                         box)
    with pytest.raises(ValueError, match="shape"):
        cp.wvt_displacement(pos_t, valid_t, valid_t, cand, pos_t,
                            hm[:, :64], 1.0, box)
    with pytest.raises(ValueError, match="contiguous"):
        cp.fused_wvt(pos_t, valid_t, cand, cand[:, 0].contiguous(), pos_t,
                     h0.t().contiguous().t(), cap, hm, mpart, box)
    with pytest.raises(ValueError, match="gdist"):
        cp.fused_wvt(pos_t, valid_t, cand, cand[:, 0].contiguous(), pos_t,
                     h0, cap, hm, mpart, box,
                     gdist=torch.zeros((pos_t.shape[0], 5)))
    with pytest.raises(ValueError, match="kernel"):
        cp.solve_density(pos_t, valid_t, cand, pos_t, h0, cap, mpart, box,
                         kernel="wc2")
