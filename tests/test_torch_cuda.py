"""Tests that need an NVIDIA GPU: each hand-written CUDA kernel against
its plain PyTorch version on the same inputs, with the tolerances of the
CPU tests, and the CLI main path on ``device=cuda`` at a small size.

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


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("sb_mode", [False, True])
def test_class_kernels_match_plain(dev, kernel, sb_mode):
    """solve_density, wvt_displacement and fused_wvt (with and without
    the bounds, bit-identical) against their plain versions."""
    c = cusp.class_inputs(kernel, N, sb_mode, device=dev)
    des, v = c["desnngb"], c["valid"]
    kw = dict(kernel=kernel, desnngb=des, sb_mode=sb_mode)
    before = (cp.solve_density.launches, cp.wvt_displacement.launches,
              cp.fused_wvt.launches)
    args = (c["pos_t"], c["valid_t"], c["cand"], c["pos_t"], c["h0"],
            c["cap"], 1.0, cusp.BOX)
    got = cp.solve_density(*args, **kw)
    ref = cp._solve_density_reference(*args, n_sweeps=cp.SOLVE_SWEEPS, **kw)
    _density_close(got, (ref[..., 0], ref[..., 1], None, ref[..., 3],
                         ref[..., 4] > 0.5), v, des)
    dargs = (c["pos_t"], c["valid_t"], c["h_b3"], c["cand"], c["pos_t"],
             c["hm"], 1.0, cusp.BOX)
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
