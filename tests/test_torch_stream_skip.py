"""The member test of the port's stream_wvt kernel, in its plain form
(ops/stream_pair.py: build_chunk_tab, stream_skip_bits, hoist_safe,
member_counts, prune_tables), against the JAX package's build_chunk_tab and
stream_skip_bits (superblock mode, chunk cross test) on the synthetic cusp
of ops/cusp.py; its conservativeness against brute force; and the plain
version's per-row statistics.  The CUDA kernel's own test is held against
these functions on the card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycluster_tpu.ops import pallas_pair as pp
from toycluster_tpu_torch.ops import cusp
from toycluster_tpu_torch.ops import stream_pair as sp

torch.set_num_threads(2)

N = 1500
BOX = cusp.BOX
QUANTUM = BOX / 2 ** 22        # the TPU's position quantum


def _listed(cand, cnt):
    """cand with the slots past cnt emptied (-1)."""
    slot = torch.arange(cand.shape[1])
    return torch.where(slot[None] < cnt[:, None], cand,
                       torch.full_like(cand, -1))


def _inputs(do_disp, n=N, centre=BOX / 2, unsafe_every=0):
    """Cusp inputs of the member test: src (nb, 4, 128), listed cand,
    cnt, cap, hm and plain (not wrap-aware) block boxes; with
    ``unsafe_every`` every such row gets a cap of 0.49 box (unsafe)."""
    args, _, valid = cusp.wvt_inputs("wc6", do_disp, n, centre=centre)
    src, cand, cnt, pos_t, _, cap, hm = args[:7]
    if unsafe_every:
        cap = cap.clone()
        cap[::unsafe_every] = 0.49 * BOX
    bb_lo = pos_t.amin(dim=2)
    bb_hi = pos_t.amax(dim=2)
    return src, _listed(cand, cnt), cnt, pos_t, cap, hm, bb_lo, bb_hi, valid


def _fields(words, n):
    """(S, n) 2-bit fields of packed int32 words."""
    w = torch.as_tensor(np.array(words)).long() & 0xFFFFFFFF
    f = (w[:, :, None] >> (torch.arange(16) * 2)) & 3
    return f.reshape(w.shape[0], -1)[:, :n]


def _margins(ctab, cand, cap, hm, do_disp):
    """Per (row, member): the smallest |gap - threshold| over the 8 x 8
    chunk pairs, for the density and the displacement (float64)."""
    c = ctab.double().reshape(-1, 8, 8)
    nb = c.shape[0]
    e, _ = sp.list_entries(cand, nb, True)
    ci = c[:, None, :, None, :]
    cj = c[e][:, :, None, :, :]
    d = ci[..., :3] - cj[..., :3]
    d = d - BOX * torch.round(d / BOX)
    gap = torch.clamp(d.abs() - (ci[..., 3:6] + cj[..., 3:6]), min=0.0)
    gd = torch.sqrt((gap * gap).sum(-1))                  # (S, E, 8, 8)
    S = cap.shape[0]
    cap8 = cap.double().reshape(S, 8, -1).amax(2)[:, None, :, None]
    m_d = (gd - cap8).abs().flatten(2).amin(2)
    if not do_disp:
        return m_d, None
    hm8 = hm.double().reshape(S, 8, -1).amax(2)[:, None, :, None]
    thr = 0.5 * (hm8 + cj[..., 6]) * BOX
    return m_d, (gd - thr).abs().flatten(2).amin(2)


@pytest.mark.parametrize("do_disp", [True, False])
@pytest.mark.parametrize("n,unsafe_every", [(N, 0), (N, 3), (6000, 0)])
def test_chunk_tab_and_bits_match_jax(do_disp, n, unsafe_every):
    """The chunk tables agree; the 2-bit words agree except in fields
    whose deciding gap lies within two quanta of its threshold (JAX
    compares quantized distances with a one-quantum slack, the port
    floats with a two-quantum inflation); the safe flags agree.  (At
    1500 gas every listed member is kept; at 6000 some are not.)"""
    src, cand, cnt, pos_t, cap, hm, bb_lo, bb_hi, _ = _inputs(
        do_disp, n=n, unsafe_every=unsafe_every)
    nb = src.shape[0]
    hm_src = src[:, 3]
    ctab = sp.build_chunk_tab(pos_t, hm_src, BOX)
    ctab_j = pp.build_chunk_tab(jnp.asarray(pos_t.numpy()),
                                jnp.asarray(hm_src.numpy()))
    np.testing.assert_allclose(ctab.numpy(), np.asarray(ctab_j), rtol=0,
                               atol=1e-4)
    bhm = hm_src.amax(dim=1) if do_disp else None
    idc = torch.arange(nb, dtype=torch.int32)
    bits, safe = sp.stream_skip_bits(bb_lo, bb_hi, bhm, idc, cand, cap,
                                     hm if do_disp else None, BOX, ctab)
    bits_j, safe_j = pp.stream_skip_bits(
        jnp.asarray(bb_lo.numpy()), jnp.asarray(bb_hi.numpy()),
        None if bhm is None else jnp.asarray(bhm.numpy()),
        jnp.asarray(idc.numpy()), jnp.asarray(cand.numpy()),
        jnp.asarray(cap.numpy()),
        jnp.asarray(hm.numpy()) if do_disp else None, BOX, sb=True,
        chunk_tab=ctab_j)
    assert bits.dtype == torch.int32 and bits.shape == bits_j.shape
    np.testing.assert_array_equal(safe.numpy(), np.asarray(safe_j))
    if unsafe_every:
        assert 0 < int(safe.sum()) < nb
    m8 = cand.shape[1] * 8
    f, fj = _fields(bits, m8), _fields(bits_j, m8)
    if n > N:
        assert bool((f & 1).any())
    m_d, m_x = _margins(ctab, cand, cap, hm, do_disp)
    near = 2 * QUANTUM
    bad_d = ((f & 1) != (fj & 1)) & ~(m_d <= near)
    assert not bool(bad_d.any()), f"{int(bad_d.sum())} density fields"
    if do_disp:
        bad_x = ((f & 2) != (fj & 2)) & ~(m_x <= near)
        assert not bool(bad_x.any()), f"{int(bad_x.sum())} disp fields"
    else:
        assert not bool((f & 2).any())


@pytest.mark.parametrize("n,centre", [(N, BOX / 2), (6000, BOX / 2),
                                      (6000, 0.0)])
def test_member_test_is_conservative(n, centre):
    """Brute force over every listed member: a member holding a pair
    with r < cap_i is kept for the density, one holding a pair with
    0 < r < hbar_ij for the displacement -- also where the cusp lies
    across the periodic edge; at 6000 gas the test prunes."""
    args, _, valid = cusp.wvt_inputs("wc6", True, n, centre=centre)
    src, cand, cnt, xi, _, cap, hm = args[:7]
    ctab, rtab, _ = sp.prune_tables(src, xi, cap, hm, BOX)
    dens, disp, ok = sp._keep_rows(rtab, ctab, cand, cnt, BOX, True)
    nb = src.shape[0]
    e, _ = sp.list_entries(_listed(cand, cnt), nb, True)
    s64 = src.double()
    for s in range(cand.shape[0]):
        xs = s64[e[s]]                                     # (E, 4, 128)
        d = xi[s].double()[None, :, :, None] - xs[:, :3, None, :]
        d = d - BOX * torch.round(d / BOX)
        r = torch.sqrt((d * d).sum(1))                     # (E, 128, 128)
        hj = xs[:, 3][:, None, :]
        vi = valid[s][None, :, None]
        in_d = ((r < cap[s].double()[None, :, None]) & (hj > 0) & vi)
        hbar = 0.5 * (hm[s].double()[None, :, None] + hj) * BOX
        in_x = (r < hbar) & (r > 0) & (hj > 0) & vi
        need_d = in_d.flatten(1).any(1) & ok[s]
        need_x = in_x.flatten(1).any(1) & ok[s]
        assert not bool((need_d & ~dens[s]).any()), f"row {s} density"
        assert not bool((need_x & ~disp[s]).any()), f"row {s} disp"
    if n > N:
        assert int(dens.sum()) < int(ok.sum())


@pytest.mark.parametrize("centre", [BOX / 2, 100.0])
def test_flagged_rows_need_no_wrap(centre):
    """On the rows that prune_tables flags, every listed pair within range
    (r < cap_i or r < hbar_ij) has the same separation with and without
    the periodic wrap, bit for bit, and every other pair is no nearer
    without it; rows with a cap of half the box (a reach no row holds
    inside the box) are not flagged, and with the cusp's outskirts across
    the edge neither are the rows across it."""
    args, _, valid = cusp.wvt_inputs("wc6", True, 6000, centre=centre)
    src, cand, cnt, xi, _, cap, hm = args[:7]
    cap = cap.clone()
    cap[::4] = 0.5 * BOX
    _, _, flag = sp.prune_tables(src, xi, cap, hm, BOX)
    nb = src.shape[0]
    assert flag.dtype == torch.int32
    assert not bool(flag[::4].any())
    assert 0 < int(flag.sum()) < nb
    e, ok = sp.list_entries(_listed(cand, cnt), nb, True)
    for s in torch.nonzero(flag)[:, 0].tolist():
        xs = src[e[s][ok[s]]]
        raw = xi[s][None, :, :, None] - xs[:, :3, None, :]
        wrapped = raw - BOX * torch.round(raw * (1.0 / BOX))
        r2w = (wrapped * wrapped).sum(1)
        r2r = (raw * raw).sum(1)
        hj = xs[:, 3][:, None, :]
        hbar = 0.5 * (hm[s][None, :, None] + hj) * BOX
        near = ((r2w < cap[s][None, :, None] ** 2) | (r2w < hbar * hbar))
        assert torch.equal(raw.transpose(0, 1)[:, near],
                           wrapped.transpose(0, 1)[:, near])
        assert bool((r2r >= r2w).all())
    _, _, off = sp.prune_tables(src, xi, cap, hm, BOX, hoist=False)
    assert not bool(off.any())


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
def test_plain_stats(kernel):
    """The plain version's stats: sweeps within 1..n_sweeps, 1 exactly on
    the rows whose lanes all finish in sweep 0 (those a one-sweep run
    leaves all done); the member counts are member_counts'."""
    args, kw, valid = cusp.wvt_inputs(kernel, True, N)
    S = args[1].shape[0]
    stats = torch.zeros((S, 4), dtype=torch.int32)
    sp.stream_wvt(*args, **kw, stats=stats)
    sweeps = stats[:, 0]
    assert bool((sweeps >= 1).all()) and bool((sweeps <= sp.N_SWEEPS).all())
    assert bool((sweeps > 1).any())
    one = torch.zeros_like(stats)
    done1 = sp.stream_wvt(*args, **kw, n_sweeps=1, stats=one)[4]
    assert bool((one[:, 0] == 1).all())
    assert torch.equal(sweeps == 1, done1.all(dim=1))
    src, cand, cnt, xi, _, cap, hm = args[:7]
    counts = sp.member_counts(src, cand, cnt, xi, cap, hm, BOX)
    assert torch.equal(stats[:, 1:], counts)
    assert bool((counts[:, 1] <= counts[:, 0]).all())
    assert bool((counts[:, 0] <= counts[:, 2]).all())


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
def test_class_operator_sweep_counts(kernel):
    """The sweep counts the count-class plain versions report (the bounds
    of chip_smoke.py count pairs with them): within 1..n_sweeps, and a
    one-sweep budget gives one sweep on every row with a list."""
    from toycluster_tpu_torch.ops import class_pair as cp
    c = cusp.class_inputs(kernel, N, False)
    kw = dict(kernel=kernel, desnngb=c["desnngb"], sb_mode=False)
    S = c["cand"].shape[0]
    args = (c["pos_t"], c["valid_t"], c["cand"], c["pos_t"], c["h0"],
            c["cap"], 1.0, BOX)
    for n_sweeps in (cp.SOLVE_SWEEPS, 1):
        sw = torch.zeros(S, dtype=torch.int32)
        cp._solve_density_reference(*args, n_sweeps=n_sweeps, **kw,
                                    sweeps=sw)
        assert bool((sw >= 1).all()) and bool((sw <= n_sweeps).all())
    fargs = (c["pos_t"], c["hm_blocks"], c["cand"], c["cnt"], c["pos_t"],
             c["h0"], c["cap"], c["hm"], 1.0, BOX)
    for n_sweeps in (cp.FUSED_SWEEPS, 1):
        sw = torch.full((S,), -1, dtype=torch.int32)
        cp._fused_wvt_reference(*fargs, n_sweeps=n_sweeps, do_disp=True,
                                gdist=None, dkeep=None, **kw, sweeps=sw)
        has = c["cnt"] > 0
        assert bool((sw[has] >= 1).all()) and bool((sw <= n_sweeps).all())
        assert bool((sw[~has] == 0).all())
