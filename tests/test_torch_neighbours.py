"""The port's neighbour engine (ops/keys.py, ops/blocks.py,
models/sph.py structure) against the JAX package's on the same
positions: identical Hilbert keys and order, identical block and
superblock boxes, equal candidate SETS (top-k ties may order lists
differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycluster_tpu.ops import blocks as jblk
from toycluster_tpu.ops import keys as jkeys
from toycluster_tpu_torch.models import sph as tsph
from toycluster_tpu_torch.ops import blocks as tblk
from toycluster_tpu_torch.ops import keys as tkeys

torch.set_num_threads(2)

BOX = 1000.0


def _cusp(n, seed):
    """A clustered periodic point set (the cusp of
    tests/test_pallas_density.py, at another size)."""
    rng = np.random.default_rng(seed)
    r = 80.0 * (rng.random(n) ** 2 / (1 - rng.random(n) * 0.7))
    r = np.clip(r, 0, 400.0)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return ((BOX / 2 + r[:, None] * u) % BOX).astype(np.float32)


@pytest.fixture(scope="module", params=[5000, 20000])
def both(request):
    pos = _cusp(request.param, seed=request.param)
    jb = jblk.build_blocks(jnp.asarray(pos), BOX)
    tb = tblk.build_blocks(torch.from_numpy(pos), BOX)
    return pos, jb, tb


def test_hilbert_keys_identical(both):
    pos, _, _ = both
    k_j = np.asarray(jkeys.hilbert_keys(jnp.asarray(pos), BOX))
    k_t = tkeys.hilbert_keys(torch.from_numpy(pos), BOX).numpy()
    np.testing.assert_array_equal(k_t.astype(np.int64),
                                  k_j.astype(np.int64))


def test_block_order_and_boxes_identical(both):
    _, jb, tb = both
    np.testing.assert_array_equal(tb.order.numpy(), np.asarray(jb.order))
    np.testing.assert_array_equal(tb.pos.numpy(), np.asarray(jb.pos))
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    for f in ("bb_lo", "bb_hi", "sb_lo", "sb_hi"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)


def _radii(pos, order, nb, seed):
    rng = np.random.default_rng(seed)
    h = (8.0 + 40.0 * rng.random(pos.shape[0])).astype(np.float32)
    hs = h[order]
    hs = np.concatenate([hs, np.repeat(hs[-1:], nb * 128 - hs.size)])
    rad = hs.reshape(nb, 128).max(axis=1)
    return rad, (rad * 0.7).astype(np.float32)


@pytest.mark.parametrize("width", [4, 16, 64])
def test_candidate_sets_equal(both, width):
    """find_candidates_super: counts equal, and every row's list holds the
    same superblocks (a truncated row keeps the same nearest set up to
    ties at the cut distance)."""
    pos, jb, tb = both
    nb = tb.n_blocks
    rad, sym = _radii(pos, np.asarray(jb.order), nb, seed=width)
    ids = np.arange(nb, dtype=np.int32)
    ids[-1] = -1   # a padded receiver row
    cj = jblk.find_candidates_super(jb, jnp.asarray(ids), jnp.asarray(rad),
                                    jnp.asarray(sym), BOX, max_cand=width)
    ct = tblk.find_candidates_super(tb, torch.from_numpy(ids),
                                    torch.from_numpy(rad),
                                    torch.from_numpy(sym), BOX,
                                    max_cand=width)
    np.testing.assert_array_equal(ct.count.numpy(), np.asarray(cj.count))
    assert ct.overflow == int(cj.overflow)
    ij, it = np.asarray(cj.idx), ct.idx.numpy()
    for row in range(nb):
        assert set(it[row]) == set(ij[row]), row


def test_two_pass_search_equals_single_pass(both, monkeypatch):
    """The probe + full-width re-run gives the single-pass lists."""
    pos, jb, tb = both
    nb = tb.n_blocks
    rad, sym = _radii(pos, np.asarray(jb.order), nb, seed=3)
    ids = torch.arange(nb, dtype=torch.int32)
    args = (tb, ids, torch.from_numpy(rad), torch.from_numpy(sym), BOX)
    width = tb.sb_lo.shape[0]
    single = tblk.find_candidates_super(*args, max_cand=width)
    monkeypatch.setattr(tblk, "_K_PROBE", 2)
    two = tblk.find_candidates_super(*args, max_cand=width)
    assert torch.equal(two.idx, single.idx)
    assert torch.equal(two.count, single.count)


def test_refresh_keeps_membership_and_covers_drift(both):
    """refresh_candidates: same sort, wrap-aware boxes of drifted
    positions, and lists that cover every pair within range."""
    pos, _, tb = both
    n = pos.shape[0]
    h = torch.full((n,), 30.0)
    state = tsph.build_neighbours(torch.from_numpy(pos), h, BOX,
                                  radius_sym_gas=h)
    rng = np.random.default_rng(1)
    moved = state.index.pos[:n] + torch.from_numpy(
        rng.normal(scale=3.0, size=(n, 3)).astype(np.float32))
    moved = moved - torch.floor(moved / BOX) * BOX
    ref = tsph.refresh_candidates(state, moved, h, BOX)
    assert torch.equal(ref.index.order, state.index.order)
    lo, hi = ref.index.bb_lo, ref.index.bb_hi
    pb = tblk.pad_rows(moved, state.index.n_padded).reshape(-1, 128, 3)
    d = pb - lo[:, None]
    d = d - BOX * torch.floor(d / BOX)
    assert bool((d <= (hi - lo)[:, None] + 1e-3).all())
