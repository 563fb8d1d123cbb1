"""The port's last two JAX functions against the JAX package: the 30-bit
Morton key (``ops/keys.py`` ``morton_keys``) bit for bit, and the linear
table interpolation (``ops/interp.py`` ``linear_eval``) against
``jnp.interp``, queries outside the table included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycluster_tpu.ops import interp as jinterp
from toycluster_tpu.ops import keys as jkeys
from toycluster_tpu_torch.ops import interp as tinterp
from toycluster_tpu_torch.ops import keys as tkeys

torch.set_num_threads(2)


@pytest.mark.parametrize("boxsize", [1.0, 7424.0])
def test_morton_keys_match_jax_bit_for_bit(boxsize):
    """A seeded cloud with the edge cells: positions at 0, just under the
    box, at the box (clamped to the last cell) and on cell boundaries."""
    rng = np.random.default_rng(3)
    pos = (rng.random((20000, 3)) * boxsize).astype(np.float32)
    cell = np.float32(boxsize / 1024)
    edges = np.array([[0, 0, 0], [boxsize, boxsize, boxsize],
                      [np.nextafter(np.float32(boxsize), np.float32(0))] * 3,
                      [0, boxsize, 0], [cell, 2 * cell, 1023 * cell],
                      [512 * cell, 0, boxsize]], np.float32)
    pos = np.concatenate([edges, pos])
    want = np.asarray(jkeys.morton_keys(jnp.asarray(pos), boxsize))
    got = tkeys.morton_keys(torch.from_numpy(pos), boxsize)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got[0] == 0 and got[1] == got[2] == (1 << 30) - 1
    assert int(got.max()) < 1 << 30


def test_morton_keys_interleave_x_highest():
    """One set bit per axis lands at its interleaved place: x above y
    above z in every bit triplet."""
    box = 1024.0
    for bit in range(10):
        for axis in range(3):
            p = np.zeros((1, 3), np.float32)
            p[0, axis] = float(1 << bit)
            key = int(tkeys.morton_keys(torch.from_numpy(p), box)[0])
            assert key == 1 << (3 * bit + 2 - axis)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_linear_eval_matches_jnp_interp(dtype):
    """Queries inside, at and outside the knots, against jnp.interp at
    rtol 1e-6 (float64 needs JAX's x64 mode, so both sides run in the
    table's dtype as jnp gives it)."""
    rng = np.random.default_rng(5)
    xs = np.cumsum(rng.random(200) + 0.01).astype(dtype)
    ys = np.sin(xs / 7.0).astype(dtype) * 3.0 + 1.0
    xq = np.concatenate([
        np.linspace(xs[0] - 5.0, xs[-1] + 5.0, 4001),
        xs, [xs[0], xs[-1], xs[0] - 1e6, xs[-1] + 1e6]]).astype(dtype)
    jx, jy, jq = (jnp.asarray(a) for a in (xs, ys, xq))
    want = np.asarray(jinterp.linear_eval(jx, jy, jq))
    xs, ys, xq = (np.asarray(a, want.dtype) for a in (xs, ys, xq))
    got = tinterp.linear_eval(*map(torch.from_numpy, (xs, ys, xq))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # clamped outside the table, as jnp.interp's default left / right
    assert (got[xq < xs[0]] == ys[0]).all()
    assert (got[xq > xs[-1]] == ys[-1]).all()


def test_linear_eval_repeated_knots():
    """A zero-width interval takes its left value, as in jnp.interp."""
    xs = np.array([0.0, 1.0, 1.0, 2.0, 3.0], np.float32)
    ys = np.array([0.0, 1.0, 5.0, 6.0, 4.0], np.float32)
    xq = np.linspace(-1.0, 4.0, 501, dtype=np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(xq), jnp.asarray(xs),
                                 jnp.asarray(ys)))
    got = tinterp.linear_eval(torch.from_numpy(xs), torch.from_numpy(ys),
                              torch.from_numpy(xq)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
