"""The count-class engine's stable shapes (``models/sph.py``:
``quantize_size``, the ``widths`` memo of ``build_neighbours_blocks`` and
``classed_selections``, padded ids in ``run_classed``) against the JAX
package's (``toycluster_tpu/models/sph.py`` ``_quantize_size``,
``_CLASS_SIZE_MEMO``, ``_LAST_MAX_CAND``, ``classed_selections``,
``run_classed``).

The JAX side runs as in tests/test_torch_classed.py: the count-class
engine (TOYCLUSTER_ENGINE=xla) with the memos of a fresh process.  The
builds run on a 40,000-point cusp (313 blocks, so the size grid has two
steps, 78 and 313 rows).  Padded and exact classes are held to the bit
on the plain versions, on the scene of tests/test_torch_iter_program.py
(the JAX make_positions at ntotal = 3,000, WC6, seed 5; 12 blocks, each
listing all 12) with list widths of 16 blocks (one class) or 8 (every
row in the far tail)."""

import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.models import positions as jpos
from toycluster_tpu.models import sph as jsph
from toycluster_tpu.particles import halo_arrays_from_scene
from toycluster_tpu.scene import build_scene as jax_build_scene
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.from_reference import (halo_arrays_from_numpy,
                                                 particles_from_numpy)
from toycluster_tpu_torch.models import bfield as tbfield
from toycluster_tpu_torch.models import sph as tsph
from toycluster_tpu_torch.models import wvt as twvt
from toycluster_tpu_torch.ops import blocks as tblk
from toycluster_tpu_torch.ops import cusp
from toycluster_tpu_torch.scene import build_scene

torch.set_num_threads(2)

PAR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "toycluster_tpu_torch", "data", "cluster.par")
SMALL = dict(ntotal=3000, sph_kernel="wc6")
KEY = ("combined",)


@pytest.fixture
def fresh_jax(monkeypatch):
    """The JAX count-class engine with the width memos of a fresh
    process."""
    monkeypatch.setenv("TOYCLUSTER_ENGINE", "xla")
    monkeypatch.setattr(jsph, "_LAST_MAX_CAND", {})
    monkeypatch.setattr(jsph, "_CLASS_SIZE_MEMO", {})


# ------------------------------------------------------------ the grid

SEQUENCES = {
    "grow": [(10, 1000, 128), (70, 1000, 128), (300, 1000, 128),
             (900, 1000, 128)],
    "shrink": [(900, 1000, 128), (20, 1000, 128), (300, 1000, 128)],
    "classes": [(5, 313, 128), (100, 313, 512), (70, 313, 128),
                (3, 313, -1), (250, 313, -1), (60, 313, -1)],
    "small nb": [(3, 12, 16), (12, 12, 16), (1, 40, -1), (40, 40, -1)],
    "large nb": [(107, 7813, -1), (131, 7813, -1), (500, 7813, -1),
                 (108, 7813, -1), (4000, 390625, 128), (7000, 390625, 128),
                 (5000, 390625, 128), (100000, 390625, 128)],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_quantize_matches_jax(fresh_jax, name):
    """``quantize_size`` equals ``_quantize_size`` over a sequence of
    calls: with a memo the sizes are sticky as JAX's, without one the
    grid alone (JAX's from a fresh memo each call)."""
    memo = {}
    for n, nb, m in SEQUENCES[name]:
        assert tsph.quantize_size(n, nb, m, memo) == jsph._quantize_size(
            n, nb, m)
    assert memo == jsph._CLASS_SIZE_MEMO
    for n, nb, m in SEQUENCES[name]:
        jsph._CLASS_SIZE_MEMO.clear()
        assert tsph.quantize_size(n, nb, m) == jsph._quantize_size(n, nb, m)


# ------------------------------------------------- successive builds

@pytest.fixture(scope="module")
def cloud():
    pos, h0 = cusp.cusp_points(40_000, seed=3)
    return pos, h0


@pytest.mark.parametrize("ms_cap", [512, 8])
@pytest.mark.parametrize("n_builds", [2, 3])
def test_successive_builds_match_jax(cloud, fresh_jax, monkeypatch, ms_cap,
                                     n_builds):
    """Builds on one memo from 16-block lists and 2-superblock far-tail
    lists, at search radii scaled 1.3, 0.5 and 1.0: the list width, the
    superblock budget, the far-tail width, the padded far-tail ids (and
    their all -1 lists and zero counts) and the padded classes equal
    JAX's after every build, and so does the size memo.  ms_cap = 8
    sends most rows to the far tail; at 512 none go there and the list
    width grows and stays."""
    monkeypatch.setattr(jsph, "_MS_CAP", ms_cap)
    monkeypatch.setattr(tsph, "MS_CAP", ms_cap)
    monkeypatch.setattr(tsph, "MAX_CAND_START", 16)
    monkeypatch.setattr(tsph, "TAIL_WIDTH_START", 2)
    jsph._LAST_MAX_CAND[KEY] = 16
    jsph._LAST_MAX_CAND[KEY + ("tail",)] = 2
    pos, h0 = cloud
    memo = {}
    sticky = []
    for scale in (1.3, 0.5, 1.0)[:n_builds]:
        h = (h0 * scale).astype(np.float32)
        sym = (0.7 * h).astype(np.float32)
        js = jsph._build_neighbours_blocks(jnp.asarray(pos), jnp.asarray(h),
                                           cusp.BOX,
                                           radius_sym_gas=jnp.asarray(sym))
        ts = tsph.build_neighbours_blocks(torch.from_numpy(pos),
                                          torch.from_numpy(h), cusp.BOX,
                                          radius_sym_gas=torch.from_numpy(sym),
                                          widths=memo)
        assert ts.max_cand == js.max_cand == memo["max_cand"]
        assert memo["ms"] == jsph._LAST_MAX_CAND[KEY + ("sb",)]
        assert (memo.get("m_sb", tsph.TAIL_WIDTH_START)
                == jsph._LAST_MAX_CAND[KEY + ("tail",)])
        assert (ts.tail is None) == (js.tail is None) == (ms_cap == 512)
        if ts.tail is not None:
            t_ids, sb_idx, sb_cnt = ts.tail
            np.testing.assert_array_equal(t_ids.numpy(),
                                          np.asarray(js.tail[0]))
            assert sb_idx.shape == np.asarray(js.tail[1]).shape
            assert sb_idx.shape[1] == memo["m_sb"]
            np.testing.assert_array_equal(sb_cnt.numpy(),
                                          np.asarray(js.tail[2]))
            pad = t_ids < 0
            assert (sb_idx[pad] == -1).all() and (sb_cnt[pad] == 0).all()
        sels_t = tsph.classed_selections(ts, memo)
        sels_j = jsph.classed_selections(js)
        assert [m for m, _ in sels_t] == [m for m, _ in sels_j]
        for (_, it), (_, ij) in zip(sels_t, sels_j):
            np.testing.assert_array_equal(it.numpy(), ij)
        assert ({k: v for k, v in memo.items() if isinstance(k, tuple)}
                == jsph._CLASS_SIZE_MEMO)
        sticky.append((ts.max_cand, twvt.class_shape(sels_t),
                       twvt.tail_shape(ts)))
    # the narrower searches after the first kept its shapes
    assert sticky[1] == sticky[0]


# ------------------------- the scene of tests/test_torch_iter_program.py

@lru_cache(maxsize=None)
def _start():
    """(port halo arrays, port particles): the JAX start of the SMALL
    scene with pids 1..n_gas on the gas."""
    jscene = jax_build_scene(jax_parse(PAR, **SMALL))
    ha = halo_arrays_from_scene(jscene)
    parts = jpos.make_positions(jax.random.PRNGKey(5), jscene, ha)
    parts = jpos.shift_origin(parts, ha, jscene.boxsize)
    n_gas = parts.n_gas
    parts = parts._replace(pid=parts.pid.at[:n_gas].set(
        np.arange(1, n_gas + 1, dtype=np.uint32)))
    tparts = particles_from_numpy(
        {k: np.asarray(v) for k, v in parts._asdict().items()})
    tha = halo_arrays_from_numpy(
        {k: np.asarray(v) for k, v in ha._asdict().items()})
    return tha, tparts


def _scene(**more):
    return build_scene(parse_par_file(PAR, **SMALL, **more))


# every block of this scene lists all 12: list widths of 16 blocks keep
# them in one class (12 rows, padded to 64), widths of 8 send them all
# to the far tail (12 rows, padded to 64)
LIST_WIDTHS = {"classes": 16, "tail": 8}


def _exact(monkeypatch, state):
    """Exact sizes from here on (``quantize_size`` returns n) and
    ``state`` without its padded far-tail rows."""
    monkeypatch.setattr(tsph, "quantize_size",
                        lambda n, nb, m=0, memo=None: n)
    if state.tail is None:
        return state
    keep = state.tail[0] >= 0
    return state._replace(tail=tuple(x[keep] for x in state.tail))


def _build(L, pos_gas, widths):
    _, h0_model, h_box = L.model_fields(pos_gas)
    h_cap = torch.clamp(h0_model * tsph.CAP_FACTOR * 1.5, max=L.h_hard)
    return tsph.build_neighbours_blocks(
        pos_gas, h_cap, L.boxsize, widths=widths,
        radius_sym_gas=h_box * L.boxsize * twvt.SYM_MARGIN)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("rows", sorted(LIST_WIDTHS))
def test_padded_classes_give_the_exact_bits(monkeypatch, rows):
    """``run_classed`` with a padded class or padded far-tail rows
    against the exact ones, on the plain versions, to the bit: the WVT
    loop's solve and displacement (``_Loop.solve_classed``), the density
    stage's solve (``sph._solve_classed``) and the classed curl
    (``bfield.sph_curl``)."""
    monkeypatch.setattr(tsph, "MAX_CAND_START", LIST_WIDTHS[rows])
    monkeypatch.setattr(tsph, "MAX_CAND_CAP", LIST_WIDTHS[rows])
    tha, tparts = _start()
    scene = _scene()
    L = twvt._Loop(scene, tha, tparts.n_gas, "classed", torch.device("cpu"),
                   lambda stage, **kw: None)
    state = _build(L, tparts.pos[:L.n_gas].clone(), {})
    sels = tsph.classed_selections(state)
    padded_ids = ([ids for _, ids in sels] if rows == "classes"
                  else [state.tail[0]])
    assert padded_ids and (state.tail is None) == (rows == "classes")
    assert all(ids.numel() == 64 and int((ids >= 0).sum()) == 12
               for ids in padded_ids)
    n, nb = L.n_gas, state.index.n_blocks
    pos_pad = state.index.pos
    valid = torch.arange(nb * 128) < n
    _, h0_model, h_box = L.model_fields(pos_pad[:n])
    h0_s = tblk.pad_rows(h0_model, nb * 128)
    hm_s = tblk.pad_rows(h_box, nb * 128)
    hm_src = torch.where(valid, hm_s, torch.zeros_like(hm_s))
    wvt_args = (pos_pad, h0_s, state.h_cap, hm_s, hm_src, valid)
    h0_b = h0_s.reshape(nb, 128).contiguous()
    cfg = scene.config
    padded = (L.solve_classed(state, *wvt_args, sels=sels),
              tsph._solve_classed(state, h0_b, cfg, scene.mpart_gas,
                                  scene.boxsize))
    # the curl on the relaxed stand-alone solve's state (padded tail)
    parts, cstate = tsph.find_sph_quantities(scene, tha, tparts,
                                             return_state=True,
                                             engine="classed")
    assert (cstate.tail is None) == (rows == "classes")
    parts = tbfield.set_vector_potential(scene, tha, parts)
    b_padded = tbfield.sph_curl(scene, parts, cstate)

    exact = _exact(monkeypatch, state)
    exact_sels = tsph.classed_selections(exact)
    assert [m for m, _ in exact_sels] == [m for m, _ in sels]
    for (_, e), (_, p) in zip(exact_sels, sels):
        assert torch.equal(e, p[p >= 0])
    _equal(L.solve_classed(exact, *wvt_args, sels=exact_sels), padded[0])
    _equal(tsph._solve_classed(exact, h0_b, cfg, scene.mpart_gas,
                               scene.boxsize), padded[1])
    assert torch.equal(tbfield.sph_curl(scene, parts,
                                        _exact(monkeypatch, cstate)),
                       b_padded)
