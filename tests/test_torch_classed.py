"""The port's count-class engine (engine="classed") against the JAX
package's (TOYCLUSTER_ENGINE=xla, the XLA pair operators): the
block-granular candidate search, the count classes and the far-tail
rows on the same positions, and the WVT loop and the density solve from
the same start (the JAX make_positions at ntotal = 3000, M4 kernel, as
tests/test_torch_wvt.py).  Bounds of tests/test_wvt.py:120-127: err_mean
trajectory rtol 2e-2, periodic position difference < 2e-3 box, rho rtol
2e-2 (pid-matched).  The JAX package's width memos are cleared first, so
both start from the same widths: those of a fresh process, or, where the
XLA pair operators run, a first list width of 16 blocks (this size has
12), since those operators evaluate every pair of the class width."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.io.gadget import read_snapshot
from toycluster_tpu.models import positions as jpos
from toycluster_tpu.models import sph as jsph
from toycluster_tpu.models import wvt as jwvt
from toycluster_tpu.ops import blocks as jblk
from toycluster_tpu.particles import halo_arrays_from_scene
from toycluster_tpu.scene import build_scene as jax_build_scene
from toycluster_tpu_torch import cli
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.from_reference import (halo_arrays_from_numpy,
                                                 neighbour_state_from_numpy,
                                                 particles_from_numpy)
from toycluster_tpu_torch.models import bfield as tbfield
from toycluster_tpu_torch.models import sph as tsph
from toycluster_tpu_torch.models import wvt as twvt
from toycluster_tpu_torch.ops import blocks as tblk
from toycluster_tpu_torch.ops import cusp
from toycluster_tpu_torch.pipeline import make_ics
from toycluster_tpu_torch.scene import build_scene

torch.set_num_threads(2)

PAR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "toycluster_tpu_torch", "data", "cluster.par")
BOX = cusp.BOX


@pytest.fixture
def fresh_jax(monkeypatch):
    """The JAX count-class engine with the width memos of a fresh
    process."""
    monkeypatch.setenv("TOYCLUSTER_ENGINE", "xla")
    monkeypatch.setattr(jsph, "_LAST_MAX_CAND", {})
    monkeypatch.setattr(jsph, "_CLASS_SIZE_MEMO", {})


@pytest.fixture
def narrow(fresh_jax, monkeypatch):
    """Both engines start from 16-block lists and 2-superblock far-tail
    lists."""
    for key in (("combined",), ("gather",)):
        jsph._LAST_MAX_CAND[key] = 16
        jsph._LAST_MAX_CAND[key + ("tail",)] = 2
    monkeypatch.setattr(tsph, "MAX_CAND_START", 16)
    monkeypatch.setattr(tsph, "TAIL_WIDTH_START", 2)


@pytest.fixture(scope="module")
def cloud():
    """A cusp of 5000 points, blocked by both packages, with per-block
    radii."""
    pos, _ = cusp.cusp_points(5000, seed=3)
    jb = jblk.build_blocks(jnp.asarray(pos), BOX)
    tb = tblk.build_blocks(torch.from_numpy(pos), BOX)
    rng = np.random.default_rng(4)
    h = (20.0 + 60.0 * rng.random(pos.shape[0])).astype(np.float32)
    return pos, h, jb, tb


def _rows_equal(a, b):
    np.testing.assert_array_equal(np.sort(np.asarray(a), axis=1),
                                  np.sort(np.asarray(b), axis=1))


@pytest.mark.parametrize("mode", ["gather", "symmetric", "union"])
def test_find_candidates_matches_jax(cloud, mode):
    pos, h, jb, tb = cloud
    nb = tb.n_blocks
    order = np.asarray(jb.order)
    hs = np.concatenate([h[order], np.repeat(h[order][-1:],
                                             nb * 128 - h.size)])
    rad = hs.reshape(nb, 128).max(axis=1)
    sym = (0.6 * rad).astype(np.float32)
    for max_cand, max_super in ((64, None), (16, 2)):
        kw = dict(max_cand=max_cand, max_super=max_super,
                  symmetric=mode == "symmetric")
        cj = jblk.find_candidates(
            jb, jnp.asarray(rad), BOX, **kw,
            radius_sym=jnp.asarray(sym) if mode == "union" else None)
        ct = tblk.find_candidates(
            tb, torch.from_numpy(rad), BOX, **kw,
            radius_sym=torch.from_numpy(sym) if mode == "union" else None)
        _rows_equal(ct.idx.numpy(), cj.idx)
        np.testing.assert_array_equal(ct.count.numpy(), np.asarray(cj.count))
        np.testing.assert_array_equal(ct.sb_count.numpy(),
                                      np.asarray(cj.sb_count))
        assert ct.overflow == int(cj.overflow)
        assert ct.sb_overflow == int(cj.sb_overflow)


def _jax_state_to_port(state):
    """A JAX block-granular NeighbourState as NumPy arrays, through the
    converter."""
    tail = None if state.tail is None else tuple(np.asarray(x)
                                                 for x in state.tail)
    return neighbour_state_from_numpy(
        {k: np.asarray(v) for k, v in state.index._asdict().items()},
        {k: np.asarray(v) for k, v in state.cand._asdict().items()},
        np.asarray(state.h_cap), tail=tail, sb=state.sb)


@pytest.mark.parametrize("ms_cap", [512, 2])
def test_classes_and_tail_match_jax(cloud, fresh_jax, monkeypatch, ms_cap):
    """The block-granular build, the count classes and the far-tail rows
    equal the JAX package's; ms_cap = 2 forces far-tail rows (every row
    seeing more than two superblocks)."""
    monkeypatch.setattr(jsph, "_MS_CAP", ms_cap)
    monkeypatch.setattr(tsph, "MS_CAP", ms_cap)
    pos, h, _, _ = cloud
    sym = 0.7 * h
    js = jsph._build_neighbours_blocks(jnp.asarray(pos), jnp.asarray(h),
                                       BOX, radius_sym_gas=jnp.asarray(sym))
    ts = tsph.build_neighbours_blocks(torch.from_numpy(pos),
                                      torch.from_numpy(h), BOX,
                                      radius_sym_gas=torch.from_numpy(sym))
    assert ts.max_cand == js.max_cand and not ts.sb
    _rows_equal(ts.cand.idx.numpy(), js.cand.idx)
    np.testing.assert_array_equal(ts.cand.count.numpy(),
                                  np.asarray(js.cand.count))
    assert (ts.tail is None) == (js.tail is None) == (ms_cap == 512)
    conv = _jax_state_to_port(js)
    if ts.tail is not None:
        # the padded ids (-1 to the quantized size), the whole searched
        # width, all -1 lists and zero counts on the padding
        t_ids, sb_idx, sb_cnt = ts.tail
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(js.tail[0]))
        assert sb_idx.shape == np.asarray(js.tail[1]).shape
        np.testing.assert_array_equal(sb_cnt.numpy(), np.asarray(js.tail[2]))
        assert (t_ids < 0).any() and (sb_idx[t_ids < 0] == -1).all()
        assert (sb_cnt[t_ids < 0] == 0).all()
        for r in range(t_ids.shape[0]):
            assert (set(sb_idx[r].tolist()) - {-1}
                    == set(conv.tail[1][r].tolist()) - {-1})
        # expand_tail_rows: block ids, -1 entries where JAX has them
        np.testing.assert_array_equal(
            tsph.expand_tail_rows(conv.tail[1], ts.index.n_blocks).numpy(),
            np.asarray(jsph.expand_tail_rows(js.tail[1], js.index.n_blocks)))
    for state in (ts, conv):
        # the JAX sizes of a fresh process: the grid alone
        sels_t = tsph.classed_selections(state)
        jsph._CLASS_SIZE_MEMO.clear()
        sels_j = jsph.classed_selections(js)
        assert [m for m, _ in sels_t] == [m for m, _ in sels_j]
        for (_, it), (_, ij) in zip(sels_t, sels_j):
            np.testing.assert_array_equal(it.numpy(), ij)


@pytest.fixture(scope="module")
def start():
    over = dict(ntotal=3000, wvt_max_iter=2, sph_kernel="m4")
    jscene = jax_build_scene(jax_parse(PAR, **over))
    ha = halo_arrays_from_scene(jscene)
    parts = jpos.make_positions(jax.random.PRNGKey(5), jscene, ha)
    parts = jpos.shift_origin(parts, ha, jscene.boxsize)
    n_gas = parts.n_gas
    # real ids before the relaxation, so final states match by particle
    parts = parts._replace(pid=parts.pid.at[:n_gas].set(
        np.arange(1, n_gas + 1, dtype=np.uint32)))
    tscene = build_scene(parse_par_file(PAR, **over))
    tparts = particles_from_numpy(
        {k: np.asarray(v) for k, v in parts._asdict().items()})
    tha = halo_arrays_from_numpy(
        {k: np.asarray(v) for k, v in ha._asdict().items()})
    return jscene, ha, parts, tscene, tha, tparts


def _by_pid(pid, *arrays):
    order = np.argsort(np.asarray(pid))
    return [np.asarray(a)[order] for a in arrays]


def _logger(events):
    def log(stage, **kw):
        if stage == "wvt":
            events.append(("wvt", kw["err_mean"]))
        elif stage == "wvt_build":
            events.append(("build", kw["it"], kw["attempt"]))
            events.append(("shape", kw["max_cand"], kw["classes"],
                           kw["tail"]))
        elif stage == "wvt_retry":
            events.append(("retry", kw["it"]))
    return log


def test_wvt_loop_classed_matches_jax(start, narrow, monkeypatch):
    """Same err_mean trajectory, the same builds (iteration, attempt)
    with the same sticky list width, quantized class shape and far-tail
    shape, the same number of solves (iterations + retries; the JAX
    loop's one-ahead speculation is off, so each call of its iteration
    program is one solve), the same final positions and densities."""
    jscene, ha, parts, tscene, tha, tparts = start
    monkeypatch.setenv("TOYCLUSTER_SPECULATE", "0")
    solves_j = []
    get_iter_fn = jwvt._get_iter_fn

    def counting(*args, **kw):
        fn = get_iter_fn(*args, **kw)

        def run(*a):
            solves_j.append(1)
            return fn(*a)
        return run

    monkeypatch.setattr(jwvt, "_get_iter_fn", counting)
    ev_j, ev_t = [], []
    ref = jwvt.regularise_sph_particles(jscene, ha, parts, log=_logger(ev_j))
    got, _fresh = twvt.regularise_sph_particles(tscene, tha, tparts,
                                                log=_logger(ev_t),
                                                engine="classed")
    errs_j = [e[1] for e in ev_j if e[0] == "wvt"]
    errs_t = [e[1] for e in ev_t if e[0] == "wvt"]
    assert len(errs_t) == len(errs_j) >= 3
    np.testing.assert_allclose(errs_t, errs_j, rtol=2e-2)
    assert ([e for e in ev_t if e[0] == "build"]
            == [e for e in ev_j if e[0] == "build"])
    assert ([e for e in ev_t if e[0] == "shape"]
            == [e for e in ev_j if e[0] == "shape"])
    assert len(solves_j) == len(errs_t) + len(
        [e for e in ev_t if e[0] == "retry"])
    n = ref.n_gas
    pj, rj = _by_pid(ref.pid[:n], ref.pos[:n], ref.rho)
    pt, rt = _by_pid(got.pid[:n].numpy(), got.pos[:n].numpy(),
                     got.rho.numpy())
    box = jscene.boxsize
    d = np.abs(pt - pj)
    d = np.minimum(d, box - d)
    assert d.max() < 2e-3 * box
    np.testing.assert_allclose(rt, rj, rtol=2e-2)


@pytest.mark.parametrize("ms_cap", [512, 1])
def test_find_sph_quantities_and_curl_classed_match_jax(start, narrow,
                                                        monkeypatch, ms_cap):
    """The stand-alone density solve (sph.c:13-75) on the count-class
    engine: same sort, rho and hsml, the neighbour contract; then the
    classed curl on its state, held against the JAX classed curl.
    ms_cap = 1 sends every row to the far tail."""
    monkeypatch.setattr(jsph, "_MS_CAP", ms_cap)
    monkeypatch.setattr(tsph, "MS_CAP", ms_cap)
    jscene, ha, parts, tscene, tha, tparts = start
    ref, jstate = jsph.find_sph_quantities(jscene, ha, parts,
                                           return_state=True)
    jfrac = jsph.last_contract_frac
    got, state = tsph.find_sph_quantities(tscene, tha, tparts,
                                          return_state=True,
                                          engine="classed")
    assert not state.sb
    assert (state.tail is None) == (jstate.tail is None) == (ms_cap == 512)
    n = ref.n_gas
    np.testing.assert_array_equal(got.pid[:n].numpy(),
                                  np.asarray(ref.pid[:n]))
    ok = (np.isclose(got.hsml.numpy(), np.asarray(ref.hsml), rtol=2e-3)
          & np.isclose(got.rho.numpy(), np.asarray(ref.rho), rtol=2e-3))
    assert ok.mean() > 0.98
    assert abs(tsph.last_contract_frac - jfrac) < 2e-3
    assert tsph.last_contract_frac > 0.99
    assert torch.equal(state.index.order, torch.arange(n))
    # the classed curl on the same particles (JAX's, converted)
    from toycluster_tpu.models import bfield as jbfield
    jb = jbfield.make_magnetic_field(jscene, ha, ref, jstate)
    tparts2 = particles_from_numpy(
        {k: np.asarray(v) for k, v in ref._asdict().items()})
    tb = tbfield.make_magnetic_field(tscene, tha, tparts2,
                                     _jax_state_to_port(jstate),
                                     engine="classed")
    a = np.asarray(jb.bfld)[:n]
    b = tb.bfld.numpy()[:n]
    np.testing.assert_allclose(b, a, rtol=5e-4, atol=2e-5 * np.abs(a).max())


def test_cli_classed_snapshot_read_by_jax(tmp_path):
    out = tmp_path / "IC"
    assert cli.main([PAR, "ntotal=2000", "sph_kernel=m4", "wvt_max_iter=2",
                     f"output_file={out}", "device=cpu",
                     "engine=classed"]) == 0
    snap = read_snapshot(str(out))
    assert snap["pos"].shape == (2000, 3)
    for k in ("pos", "vel", "u", "rho", "hsml", "bfld", "rho_model"):
        assert np.isfinite(snap[k]).all(), k
    n_gas = snap["header"].npart[0]
    assert (snap["rho"][:n_gas] > 0).all() and (snap["u"][:n_gas] > 0).all()
    assert (np.abs(snap["bfld"][:n_gas]).sum(axis=1) > 0).mean() > 0.99


def test_unknown_engine_raises(start):
    _, _, _, tscene, tha, tparts = start
    with pytest.raises(ValueError, match="engine"):
        cli.main([PAR, "device=cpu", "engine=xla"])
    with pytest.raises(ValueError, match="engine"):
        make_ics(parse_par_file(PAR, ntotal=2000), device="cpu",
                 engine="pallas")
    with pytest.raises(ValueError, match="engine"):
        twvt.regularise_sph_particles(tscene, tha, tparts, engine="xla")
    with pytest.raises(ValueError, match="engine"):
        tsph.find_sph_quantities(tscene, tha, tparts, engine="")
    with pytest.raises(ValueError, match="engine"):
        tbfield.make_magnetic_field(tscene, tha, tparts, engine="blocks")
