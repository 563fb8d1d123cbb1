"""The port's stream_curl (ops/stream_pair.py) against the very TPU
kernel, stream_curl_pallas in interpret mode, on the cusp fixture of
ops/cusp.py with superblock lists over every receiver row and a smooth
synthetic vector potential.  Tolerance of
tests/test_pallas_density.py:784-798: rtol 5e-4, atol 2e-5 of the
largest component."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycluster_tpu.ops.pallas_pair import stream_curl_pallas
from toycluster_tpu_torch.ops import cusp, stream_pair

torch.set_num_threads(2)

N = 1500


def assert_close(got, ref, valid):
    v = valid.numpy().reshape(-1)
    a = np.asarray(ref).reshape(-1, 3)[v]
    b = got.cpu().numpy().reshape(-1, 3)[v]
    assert np.abs(a).max() > 0
    np.testing.assert_allclose(b, a, rtol=5e-4, atol=2e-5 * np.abs(a).max())


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
def test_plain_matches_pallas_kernel(kernel):
    args, kw, valid = cusp.curl_inputs(kernel, N)
    ref = stream_curl_pallas(
        *(jnp.asarray(a.numpy()) if torch.is_tensor(a) else a for a in args),
        **kw, interpret=True)
    got = stream_pair.stream_curl(*args, **kw)
    assert got.shape == (args[1].shape[0], 128, 3)
    assert_close(got, ref, valid)


def test_empty_rows_are_zero():
    args, kw, _ = cusp.curl_inputs("wc6", N)
    args = list(args)
    args[2] = args[2].clone()
    args[2][0] = 0
    before = stream_pair.stream_curl.launches
    got = stream_pair.stream_curl(*args, **kw)
    assert bool((got[0] == 0).all())
    assert stream_pair.stream_curl.launches == before  # CPU: no launch
