"""The stream engine's sticky list width (``sph.trim_width``) against the
JAX package's ``_trim_and_buckets`` (``toycluster_tpu/models/sph.py``),
on the count sequences of the JAX package's own tests
(tests/test_width_policy.py: a transient growth, the shrink back, never
below the need) and on seeded random ones; then the lists it makes: the
same entries as the exact width with -1 padding after them, a refresh
that keeps the width, and the plain ``stream_wvt`` equal to the bit at
the trimmed and the exact width."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycluster_tpu.models import sph as jsph
from toycluster_tpu.ops.blocks import CandidateList
from toycluster_tpu_torch.models import sph as tsph
from toycluster_tpu_torch.ops import cusp
from toycluster_tpu_torch.ops.stream_pair import stream_wvt

torch.set_num_threads(2)

BOX = 1000.0


def _jax_cand(nb_rows, width, max_count):
    """The JAX test's list: every row 8 entries, row 0 ``max_count``."""
    counts = np.full((nb_rows,), 8, np.int32)
    counts[0] = max_count
    idx = np.full((nb_rows, width), -1, np.int32)
    for r in range(nb_rows):
        idx[r, :counts[r]] = np.arange(counts[r])
    return CandidateList(idx=jnp.asarray(idx), count=jnp.asarray(counts),
                         overflow=jnp.int32(0), sb_overflow=jnp.int32(0))


def _jax_widths(nb_rows, steps):
    """JAX's trimmed widths over ``steps`` [(searched width, need)], its
    process-wide memos cleared for this row count before and after."""
    for memo in (jsph._TRIM_MEMO, jsph._BUCKET_MEMO):
        memo.pop(nb_rows, None)
    try:
        return [int(jsph._trim_and_buckets(_jax_cand(nb_rows, w, need))[0]
                    .idx.shape[1]) for w, need in steps]
    finally:
        for memo in (jsph._TRIM_MEMO, jsph._BUCKET_MEMO):
            memo.pop(nb_rows, None)


def _port_widths(nb_rows, steps):
    widths = {}
    return [tsph.trim_width(need, w, widths, nb_rows) for w, need in steps]


def _random_steps(seed, n=12):
    rng = np.random.default_rng(seed)
    w = int(rng.choice([192, 512, 1536]))
    return [(w, int(rng.integers(1, w + 1))) for _ in range(n)]


SEQUENCES = {
    # the JAX test's transient: need 1500, then 100 (held at 2x), 120,
    # and growth to 700 honoured at once
    "transient": [(1536, 1500), (1536, 100), (1536, 120), (1536, 700)],
    "never_below_need": [(512, 300)],
    # shrink back in steps, wobble across a power of two, regrow
    "shrink_back": [(1536, 1200), (1536, 500), (1536, 200), (1536, 90),
                    (1536, 40), (1536, 70), (1536, 60), (1536, 300)],
    # the searched width caps the power of two
    "capped_by_search": [(192, 150), (192, 100), (192, 30), (192, 190)],
    "random_1": _random_steps(1),
    "random_2": _random_steps(2),
    "random_3": _random_steps(3),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_trim_width_equals_jax(name):
    """Width for width along each sequence, from a fresh memo."""
    steps = SEQUENCES[name]
    nb_rows = 7100 + sorted(SEQUENCES).index(name)   # a row count of its own
    got = _port_widths(nb_rows, steps)
    assert got == _jax_widths(nb_rows, steps)
    for (w, need), width in zip(steps, got):
        assert min(need, w) <= width <= w


def test_memo_is_per_relaxation():
    """Each relaxation's memo is its own dict: a width held by one does
    not reach another, and row counts do not share an entry."""
    a, b = {}, {}
    assert tsph.trim_width(1500, 1536, a, 100) == 1536
    assert tsph.trim_width(100, 1536, a, 100) == 256
    assert tsph.trim_width(100, 1536, b, 100) == 128
    assert tsph.trim_width(100, 1536, a, 101) == 128


def _cloud(n, seed):
    """Clustered periodic positions (the neighbour tests' cusp) and a
    search length per particle."""
    rng = np.random.default_rng(seed)
    r = 80.0 * (rng.random(n) ** 2 / (1 - rng.random(n) * 0.7))
    r = np.clip(r, 0, 400.0)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = ((BOX / 2 + r[:, None] * u) % BOX).astype(np.float32)
    return torch.from_numpy(pos), torch.full((n,), 30.0)


def _assert_padded(trimmed, exact):
    """The trimmed lists hold the exact lists' entries, -1 after them."""
    w = exact.shape[1]
    assert trimmed.shape[1] >= w
    assert torch.equal(trimmed[:, :w], exact)
    assert bool((trimmed[:, w:] == -1).all())


def test_build_and_refresh_keep_the_sticky_width():
    """build_neighbours with a memo cuts to ``trim_width`` (entries of
    the exact build, -1 padding); a refresh of drifted positions keeps
    that width where its need fits, as the next build does."""
    pos, h = _cloud(40_000, 3)
    exact = tsph.build_neighbours(pos, h, BOX, radius_sym_gas=h)
    widths = {}
    state = tsph.build_neighbours(pos, h, BOX, radius_sym_gas=h,
                                  widths=widths)
    need = int(exact.cand.count.max())
    assert state.max_cand == tsph.trim_width(need, state.max_cand, {},
                                             exact.index.n_blocks)
    assert state.max_cand > exact.max_cand
    _assert_padded(state.cand.idx, exact.cand.idx)
    n = pos.shape[0]
    rng = np.random.default_rng(4)
    moved = state.index.pos[:n] + torch.from_numpy(
        rng.normal(scale=2.0, size=(n, 3)).astype(np.float32))
    moved = moved - torch.floor(moved / BOX) * BOX
    ref_exact = tsph.refresh_candidates(state, moved, h, BOX)
    ref = tsph.refresh_candidates(state, moved, h, BOX, widths=widths)
    assert ref.max_cand == state.max_cand
    _assert_padded(ref.cand.idx, ref_exact.cand.idx)
    assert torch.equal(ref.cand.count, ref_exact.cand.count)


@pytest.mark.parametrize("kernel", ["wc6", "m4"])
def test_plain_stream_wvt_same_bits_at_trimmed_width(kernel):
    """The plain stream_wvt on the cusp's lists and on the same lists
    padded with -1 columns to a trimmed width (64): every output equal
    to the bit."""
    args, kw, _ = cusp.wvt_inputs(kernel, True, 3000)
    cand = args[1]
    pad = torch.full((cand.shape[0], 64 - cand.shape[1]), -1,
                     dtype=cand.dtype)
    wide = torch.cat([cand, pad], dim=1).contiguous()
    ref = stream_wvt(*args, **kw)
    got = stream_wvt(args[0], wide, *args[2:], **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_plain_stream_wvt_same_bits_on_built_lists():
    """The same on lists that build_neighbours made with and without the
    memo, on a 3,000-point cloud (its superblock count caps the width)."""
    pos, h = _cloud(3000, 5)
    exact = tsph.build_neighbours(pos, h, BOX, radius_sym_gas=h)
    state = tsph.build_neighbours(pos, h, BOX, radius_sym_gas=h,
                                  widths={})
    assert state.max_cand > exact.max_cand
    _assert_padded(state.cand.idx, exact.cand.idx)
    bi = state.index
    nb = bi.n_blocks
    src, pos_t = tsph.source_blocks(bi.pos, torch.where(
        bi.valid, torch.full((bi.n_padded,), 0.02), torch.zeros(
            bi.n_padded)))
    h_b = torch.full((nb, 128), 20.0)
    outs = [stream_wvt(src, s.cand.idx, s.cand.count, pos_t, h_b,
                       s.h_cap.reshape(nb, 128), h_b * 1e-3, 1.0, BOX,
                       kernel="m4", desnngb=50)
            for s in (exact, state)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
