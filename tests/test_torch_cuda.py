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
    g_rho, g_h, _, g_wk, g_done, g_d = got
    r_rho, r_h, _, r_wk, r_done, r_d = ref
    both = valid & g_done & r_done
    assert int(both.sum()) >= 0.97 * int((valid & r_done).sum())
    ok = (torch.isclose(g_h[both], r_h[both], rtol=2e-3, atol=0)
          & torch.isclose(g_rho[both], r_rho[both], rtol=2e-3, atol=0))
    assert float(ok.float().mean()) > 0.98
    # a speculatively accepted lane is extrapolated, not re-measured: the
    # kernel may deviate from the contract window as far as the plain
    # version does on the same lanes, and no farther
    dev_plain = float((r_wk[both] - kw["desnngb"]).abs().max())
    assert float((g_wk[both] - kw["desnngb"]).abs().max()) \
        < max(0.05, dev_plain) + 1e-3
    if do_disp:
        a, b = r_d[valid], g_d[valid]
        torch.testing.assert_close(b, a, rtol=2e-4,
                                   atol=1e-6 * float(a.abs().max()))
    else:
        assert g_d is None


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
def test_stream_curl_kernel_matches_plain(dev, kernel):
    cargs, kw, valid = cusp.curl_inputs(kernel, N, device=dev)
    before = sp.stream_curl.launches
    got = sp.stream_curl(*cargs, **kw)
    torch.cuda.synchronize()
    assert sp.stream_curl.launches == before + 1
    ref = sp._stream_curl_reference(*cargs, **kw)
    a, b = ref[valid], got[valid]
    scale = float(a.abs().max())
    assert scale > 0
    torch.testing.assert_close(b, a, rtol=5e-4, atol=2e-5 * scale)


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


def test_trace_sees_both_kernels_on_the_device(dev, capsys):
    from toycluster_tpu_torch import trace
    assert trace.main([str(_PAR), "ntotal=20000", "sph_kernel=m4",
                       "wvt_max_iter=4"]) == 0
    out = capsys.readouterr().out
    assert "stream_wvt_kernel" in out and "stream_curl_kernel" in out
    share = float(out.split("idle share ")[1].split()[0])
    assert 0.0 <= share < 1.0
