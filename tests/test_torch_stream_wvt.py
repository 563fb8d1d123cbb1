"""The port's stream_wvt (ops/stream_pair.py) against the very TPU
kernel, stream_wvt_pallas in interpret mode, on the synthetic cusp of
tests/test_pallas_density.py:34-57 (ops/cusp.py) with superblock lists
over every receiver row.  On the CPU the port runs its plain PyTorch
version; the CUDA kernel is held against that plain version on the card
by tests/test_torch_cuda.py.  Tolerances are those of
tests/test_pallas_density.py:17-31, 319-337."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycluster_tpu.ops.pallas_pair import stream_wvt_pallas
from toycluster_tpu_torch.ops import cusp, stream_pair

torch.set_num_threads(2)

N = 1500


def _np(x):
    if x is None or isinstance(x, np.ndarray):
        return x
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def assert_match(ref, got, valid, desnngb):
    """h/rho rtol 2e-3 on >= 98% of lanes, |wkNgb - DESNNGB| < 0.05 +
    1e-3 on done lanes, delta rtol 2e-4 / atol 1e-6 max|delta|."""
    r_rho, r_h, _, _, r_done, r_d = (_np(x) for x in ref)
    g_rho, g_h, _, g_wk, g_done, g_d = (_np(x) for x in got)
    v = _np(valid).reshape(-1)
    both = v & r_done.reshape(-1) & g_done.reshape(-1)
    assert both.sum() >= 0.97 * (v & r_done.reshape(-1)).sum()
    ok = (np.isclose(g_h.reshape(-1)[both], r_h.reshape(-1)[both], rtol=2e-3)
          & np.isclose(g_rho.reshape(-1)[both], r_rho.reshape(-1)[both],
                       rtol=2e-3))
    assert ok.mean() > 0.98, f"h/rho mismatch on {(~ok).sum()} lanes"
    assert np.abs(g_wk.reshape(-1)[both] - desnngb).max() < 0.05 + 1e-3
    if r_d is not None:
        a = r_d.reshape(-1, 3)[v]
        b = g_d.reshape(-1, 3)[v]
        np.testing.assert_allclose(b, a, rtol=2e-4,
                                   atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
@pytest.mark.parametrize("do_disp", [True, False])
def test_plain_matches_pallas_kernel(kernel, do_disp):
    args, kw, valid = cusp.wvt_inputs(kernel, do_disp, N)
    ref = stream_wvt_pallas(
        *(jnp.asarray(a.numpy()) if torch.is_tensor(a) else a for a in args),
        **kw, sb_mode=True, interpret=True)
    got = stream_pair.stream_wvt(*args, **kw)
    assert (got[5] is None) == (not do_disp)
    assert_match(ref, got, valid, kw["desnngb"])


def test_count_clamp_and_padded_entries():
    """Counts past the list width are clamped, and padded (-1) entries
    and past-nb superblock members take part in no pair: appending -1
    columns and inflating counts leaves the result unchanged."""
    args, kw, _ = cusp.wvt_inputs("m4", True, N)
    base = stream_pair.stream_wvt(*args, **kw)
    bad = list(args)
    cand, cnt = args[1], args[2]
    bad[1] = torch.cat([cand, torch.full((cand.shape[0], 3), -1,
                                         dtype=torch.int32)], dim=1)
    bad[2] = cnt + 1000
    got = stream_pair.stream_wvt(*bad, **kw)
    for a, b in zip(base, got):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_cpu_path_does_not_count_launches():
    args, kw, _ = cusp.wvt_inputs("m4", False, N)
    before = stream_pair.stream_wvt.launches
    stream_pair.stream_wvt(*args, **kw)
    assert stream_pair.stream_wvt.launches == before


def test_wrapper_rejects_bad_inputs():
    args, _, _ = cusp.wvt_inputs("wc6", True, N)
    bad = list(args)
    bad[1] = bad[1].to(torch.int64)
    with pytest.raises(ValueError, match="dtype"):
        stream_pair.stream_wvt(*bad)
    bad = list(args)
    bad[4] = bad[4][:, :64]
    with pytest.raises(ValueError, match="shape"):
        stream_pair.stream_wvt(*bad)
    bad = list(args)
    bad[4] = bad[4].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        stream_pair.stream_wvt(*bad)
