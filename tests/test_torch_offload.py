"""The WVT loop's large-run memory path (``models/wvt.py``: the holder
protocol, ``offload_enabled``, ``_Parked``), the counterpart of the JAX
loop's (``toycluster_tpu/models/wvt.py:656-717, :1096-1113``,
``toycluster_tpu/pipeline.py:108-116``) and the CTA split of padded
count classes (``stream_pair.padded_cluster``), on the CPU.

Each case sets TOYCLUSTER_WVT_OFFLOAD_N, the JAX package's variable,
which the port reads too.  The scene: the JAX make_positions at ntotal
= 3,000 (1,500 gas), M4, seed 5, as tests/test_torch_classed.py.  An
offloaded relaxation must equal the one without offload to the bit on
both engines, and the port's count-class engine with the offload must
agree with the JAX xla engine with its offload within the bounds of
tests/test_wvt.py:120-127 (err_mean rtol 2e-2, periodic position
difference < 2e-3 box, rho rtol 2e-2, pid-matched).

The pair kernels' plain versions are deterministic functions of their
inputs, so the bit-equality cases memoise them on the bytes of every
argument (as tests/test_torch_iter_program.py)."""

import os
import weakref

import jax
import numpy as np
import pytest
import torch

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.models import positions as jpos
from toycluster_tpu.models import sph as jsph
from toycluster_tpu.models import wvt as jwvt
from toycluster_tpu.particles import halo_arrays_from_scene
from toycluster_tpu.scene import build_scene as jax_build_scene
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.from_reference import (halo_arrays_from_numpy,
                                                 particles_from_numpy)
from toycluster_tpu_torch.models import sph as tsph
from toycluster_tpu_torch.models import wvt as twvt
from toycluster_tpu_torch.ops import stream_pair as tsp
from toycluster_tpu_torch.pipeline import make_ics
from toycluster_tpu_torch.scene import build_scene

torch.set_num_threads(2)

PAR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "toycluster_tpu_torch", "data", "cluster.par")
SMALL = dict(ntotal=3000, sph_kernel="m4")
ENGINES = ("stream", "classed")
FIELDS = ("pos", "rho", "hsml", "var_hsml_fac", "rho_model", "pid", "halo",
          "u", "vel", "bfld", "apot")
OFF = str(10**12)   # a threshold no test scene reaches: no offload


@pytest.fixture(scope="module")
def start():
    """The JAX start of the SMALL scene, with pids 1..n_gas on the gas
    (so that final states match by particle): (JAX halo arrays, JAX
    particles, port halo arrays, port particles)."""
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
    return ha, parts, tha, tparts


def _jax_scene(**more):
    return jax_build_scene(jax_parse(PAR, **SMALL, **more))


def _port_scene(**more):
    return build_scene(parse_par_file(PAR, **SMALL, **more))


_MEMO: dict = {}


def _key(x):
    if torch.is_tensor(x):
        return (str(x.dtype), tuple(x.shape),
                x.detach().contiguous().numpy().tobytes())
    if isinstance(x, (tuple, list)):
        return tuple(_key(v) for v in x)
    return x


@pytest.fixture
def memo(monkeypatch):
    """The loop's pair kernels, memoised on their arguments' bytes."""
    for name in ("stream_wvt", "fused_wvt", "solve_density",
                 "wvt_displacement"):
        fn = getattr(twvt, name)

        def call(*args, _fn=fn, _name=name, **kw):
            k = (_name, _key(args), _key(sorted(kw.items())))
            if k not in _MEMO:
                _MEMO[k] = _fn(*args, **kw)
            return _MEMO[k]
        monkeypatch.setattr(twvt, name, call)


def _relax(monkeypatch, tha, tparts, engine, offload_n, held=True, **kw):
    """The port's relaxation of a copy of ``tparts`` (three iterations
    unless ``kw`` says otherwise) at the threshold ``offload_n``, the
    set handed over in a holder or, without ``held``, as a plain
    argument.  Returns (particles, stage-log records)."""
    monkeypatch.setenv("TOYCLUSTER_WVT_OFFLOAD_N", str(offload_n))
    logs = []
    parts = tparts.replace(**{f: getattr(tparts, f).clone()
                              for f in FIELDS})
    over = {"wvt_max_iter": 2, **kw.pop("over", {})}
    got, _ = twvt.regularise_sph_particles(
        _port_scene(**over), tha, [parts] if held else parts,
        engine=engine, log=lambda stage, **r: logs.append((stage, r)), **kw)
    return got, logs


def _records(logs, stage):
    return [{k: v for k, v in r.items() if k != "seconds"}
            for s, r in logs if s == stage]


def _assert_same_particles(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


@pytest.mark.parametrize("engine", ENGINES)
def test_offload_gives_the_same_bits(start, memo, monkeypatch, engine):
    """With the offload on, the relaxation hands back the same particle
    set to the bit (every field) with the same stage records as without
    it; it parks and restores once, and a plain argument is never
    parked."""
    _, _, tha, tparts = start
    off, logs_off = _relax(monkeypatch, tha, tparts, engine, OFF)
    on, logs_on = _relax(monkeypatch, tha, tparts, engine, 1)
    plain, logs_plain = _relax(monkeypatch, tha, tparts, engine, 1,
                               held=False)
    for got in (on, plain):
        _assert_same_particles(got, off)
    for stage in ("wvt", "wvt_build", "wvt_retry", "wvt_refresh"):
        assert (_records(logs_on, stage) == _records(logs_off, stage)
                == _records(logs_plain, stage))
    (parked,) = _records(logs_on, "wvt_offload")
    assert parked["n_gas"] == tparts.n_gas
    # pid int64 and halo int32 in host memory
    assert parked["host_gib"] * 2**30 == tparts.n_total * 12
    assert len(_records(logs_on, "wvt_restore")) == 1
    for logs in (logs_off, logs_plain):
        assert not _records(logs, "wvt_offload")
        assert not _records(logs, "wvt_restore")
    # the gas ids are a permutation of the input's, the DM half unmoved
    n = tparts.n_gas
    assert torch.equal(torch.sort(on.pid[:n]).values,
                       torch.sort(tparts.pid[:n]).values)
    assert torch.equal(on.pos[n:], tparts.pos[n:])
    assert torch.equal(on.halo[n:], tparts.halo[n:])


def _by_pid(pid, *arrays):
    order = np.argsort(np.asarray(pid))
    return [np.asarray(a)[order] for a in arrays]


def test_offload_matches_the_jax_loop(start, monkeypatch):
    """The JAX loop with its offload (xla engine, a fresh process's
    width memos, both packages from 16-block lists) against the port's
    count-class engine with the offload: the err_mean trajectory, the
    positions and densities within the JAX tests' bounds, and the same
    permutation of pid and halo."""
    ha, parts, tha, tparts = start
    monkeypatch.setenv("TOYCLUSTER_ENGINE", "xla")
    monkeypatch.setattr(jsph, "_LAST_MAX_CAND", {})
    monkeypatch.setattr(jsph, "_CLASS_SIZE_MEMO", {})
    for key in (("combined",), ("gather",)):
        jsph._LAST_MAX_CAND[key] = 16
        jsph._LAST_MAX_CAND[key + ("tail",)] = 2
    monkeypatch.setattr(tsph, "MAX_CAND_START", 16)
    monkeypatch.setattr(tsph, "TAIL_WIDTH_START", 2)
    monkeypatch.setenv("TOYCLUSTER_WVT_OFFLOAD_N", "1")
    errs_j = []
    ref = jwvt.regularise_sph_particles(
        _jax_scene(wvt_max_iter=2), ha, [parts],
        log=lambda stage, **r: stage == "wvt" and errs_j.append(
            r["err_mean"]))
    got, logs = _relax(monkeypatch, tha, tparts, "classed", 1)
    assert _records(logs, "wvt_offload")
    errs_t = [r["err_mean"] for r in _records(logs, "wvt")]
    assert len(errs_t) == len(errs_j) >= 3
    np.testing.assert_allclose(errs_t, errs_j, rtol=2e-2)
    np.testing.assert_array_equal(got.pid.numpy(), np.asarray(ref.pid))
    np.testing.assert_array_equal(got.halo.numpy(), np.asarray(ref.halo))
    n = ref.n_gas
    pj, rj = _by_pid(ref.pid[:n], ref.pos[:n], ref.rho)
    pt, rt = _by_pid(got.pid[:n].numpy(), got.pos[:n].numpy(),
                     got.rho.numpy())
    box = float(_port_scene().boxsize)
    d = np.abs(pt - pj)
    d = np.minimum(d, box - d)
    assert d.max() < 2e-3 * box
    np.testing.assert_allclose(rt, rj, rtol=2e-2)
    np.testing.assert_array_equal(got.pos[n:].numpy(),
                                  np.asarray(ref.pos[n:]))
    np.testing.assert_array_equal(got.u.numpy(), np.asarray(ref.u))


class _Stop(Exception):
    pass


@pytest.mark.parametrize("offload", [True, False])
def test_make_ics_hands_the_particle_set_over(monkeypatch, offload):
    """``make_ics`` passes its particle set in a holder and keeps no
    reference of its own: inside the loop, at its first iteration, the
    set it handed over is gone when the loop parks it, and alive when
    the loop keeps it (below the threshold)."""
    refs, alive = [], []
    regularise = twvt.regularise_sph_particles

    def handed(scene, ha, holder, **kw):
        assert isinstance(holder, list) and len(holder) == 1
        refs.append(weakref.ref(holder[0]))
        return regularise(scene, ha, holder, **kw)

    def first_iteration(*args, **kw):
        alive.append(refs[0]() is not None)
        raise _Stop

    monkeypatch.setattr(twvt, "regularise_sph_particles", handed)
    monkeypatch.setattr(twvt._Loop, "iterate", first_iteration)
    monkeypatch.setenv("TOYCLUSTER_WVT_OFFLOAD_N", "1" if offload else OFF)
    cfg = parse_par_file(PAR, ntotal=2000, sph_kernel="m4", wvt_max_iter=1)
    with pytest.raises(_Stop):
        make_ics(cfg, device="cpu", write=False,
                 log=lambda stage, **r: None)
    assert alive == [not offload]


def test_checkpoint_with_offload_resumes_to_the_same_bits(start, memo,
                                                          monkeypatch,
                                                          tmp_path):
    """A checkpoint written with the offload on holds what the one
    written without it holds, and resuming from it with the offload on
    gives the bits of resuming without it."""
    _, _, tha, tparts = start
    files = {}
    for name, offload_n in (("on", 1), ("off", OFF)):
        files[name] = tmp_path / f"wvt_{name}.npz"
        _relax(monkeypatch, tha, tparts, "stream", offload_n,
               over=dict(wvt_max_iter=1), checkpoint_path=str(files[name]),
               checkpoint_every=2)
    with np.load(files["on"]) as a, np.load(files["off"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
        assert int(a["it"]) == 1
    runs = {}
    for offload_n in (1, OFF):
        runs[offload_n] = _relax(monkeypatch, tha, tparts, "stream",
                                 offload_n, over=dict(wvt_max_iter=3),
                                 checkpoint_path=str(files["on"]),
                                 checkpoint_every=1000)
    (on, logs_on), (off, logs_off) = runs[1], runs[OFF]
    assert _records(logs_on, "wvt_resume") == [dict(it=2, step=_records(
        logs_off, "wvt_resume")[0]["step"])]
    assert _records(logs_on, "wvt") == _records(logs_off, "wvt")
    assert [r["it"] for r in _records(logs_on, "wvt")] == [2, 3]
    _assert_same_particles(on, off)


def test_offload_gives_the_same_bits_on_config_5(memo, monkeypatch):
    """Config 5's set (mass ratio 1/2, comet orbit, substructure, the
    third subhalo of ``data/cluster_config5.par``) through ``make_ics``
    with the threshold below its gas count and above it: the same
    particle set to the bit, and one park and one restore."""
    par5 = os.path.join(os.path.dirname(PAR), "cluster_config5.par")
    cfg = parse_par_file(par5, ntotal=2000, sph_kernel="m4",
                         wvt_max_iter=2, mass_ratio=0.5, orbit="comet",
                         substructure=True, add_third_subhalo=True,
                         sub_first_mass=1e3)
    runs = {}
    for offload_n in (OFF, 1):
        monkeypatch.setenv("TOYCLUSTER_WVT_OFFLOAD_N", str(offload_n))
        logs = []
        scene, parts = make_ics(cfg, device="cpu", write=False,
                                log=lambda stage, **r: logs.append((stage,
                                                                    r)))
        runs[offload_n] = parts, logs
    assert scene.nhalos == 4 and parts.n_gas < int(OFF)
    (off, logs_off), (on, logs_on) = runs[OFF], runs[1]
    _assert_same_particles(on, off)
    assert _records(logs_on, "wvt") == _records(logs_off, "wvt")
    assert [r["n_gas"] for r in _records(logs_on, "wvt_offload")] == [
        on.n_gas]
    assert len(_records(logs_on, "wvt_restore")) == 1
    assert not _records(logs_off, "wvt_offload")


def test_offload_threshold_is_the_jax_default(monkeypatch):
    monkeypatch.delenv("TOYCLUSTER_WVT_OFFLOAD_N", raising=False)
    assert twvt.OFFLOAD_N == 20_000_000
    assert not twvt.offload_enabled(19_999_999)
    assert twvt.offload_enabled(20_000_000)
    monkeypatch.setenv("TOYCLUSTER_WVT_OFFLOAD_N", "1000")
    assert twvt.offload_enabled(1000) and not twvt.offload_enabled(999)


# (padded rows S, list width M, superblock mode, real rows of the 1e6
# par's first build, where there is one)
PADDED_CALLS = [(976, 512, False, 266), (244, 1024, True, 108),
                (3907, 128, False, None), (64, 2048, False, 20),
                (7813, 512, False, None), (244, 4096, False, None)]


@pytest.mark.parametrize("S,M,sb_mode,real", PADDED_CALLS)
def test_padded_split_is_a_function_of_the_shape(S, M, sb_mode, real):
    """The split of a padded call depends on its shape alone, never
    gives fewer CTAs a row than the padded row count would, nor more
    than the fewest real rows the size admits (S/4); at the 1e6 par's
    512 class (266 real rows in 976) and far tail (108 in 244) it is the
    split of the real rows, 2 and 8 CTAs."""
    entries = M * tsp.SUPER if sb_mode else M
    got = tsp.padded_cluster(torch.full((S, M), -1, dtype=torch.int32),
                             sb_mode)
    assert got == tsp.padded_cluster(
        torch.zeros((S, M), dtype=torch.int32), sb_mode)
    assert (tsp._cluster_size(S, entries, None) <= got
            <= tsp._cluster_size(max(S // 4, 1), entries, None))
    if real is not None:
        assert got == tsp._cluster_size(real, entries, None)
    assert (S, M, got) != (976, 512, 1)
