"""The PyTorch port's host layer against the JAX package: the parameter
file parser and the scene built from the port's cluster.par, the
compiled reference's setup table, the CLI's error paths, and that the
port imports no JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.scene import build_scene as jax_build_scene
from toycluster_tpu_torch import parse_par_file
from toycluster_tpu_torch.scene import build_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR = os.path.join(REPO, "toycluster_tpu_torch", "data", "cluster.par")
GOLDEN = os.path.join(REPO, "tests", "golden", "setup_table_cluster.txt")
RTOL = 1e-5   # the bound of tests/test_setup_parity.py


def test_par_file_values():
    """The port's cluster.par carries the values pinned for the
    reference's file (tests/test_config.py:14-40)."""
    cfg = parse_par_file(PAR)
    assert cfg.output_file == "./IC_single_0"
    assert (cfg.ntotal, cfg.mtot200, cfg.mass_ratio) == (1_000_000, 1e5, 0.0)
    assert (cfg.impact_param, cfg.zero_e_orbit_frac, cfg.cuspy) == \
        (50.0, 0.8, 0)
    assert (cfg.redshift, cfg.bfld_norm, cfg.bfld_eta) == (0.87, 20e-6, 0.5)
    assert cfg.baryon_fraction == 0.17
    assert (cfg.unit_length_cm, cfg.unit_mass_g, cfg.unit_vel_cgs) == \
        (3.085678e21, 1.989e43, 1e5)
    gp = parse_par_file(PAR, give_params=True)
    assert gp.c_nfw_given == (4.0, 4.089)
    assert gp.beta_given == (0.54, 0.79)
    assert gp.rc_given == (30.0, 300.0)
    assert gp.v_com_given == (0.0, 0.0)
    text = open(PAR).read()
    assert "h_100" in text and "Bfld_Scale" in text


@pytest.mark.parametrize("over", [{}, {"give_params": True},
                                  {"ntotal": 20000, "sph_kernel": "m4"},
                                  {"mass_ratio": 0.3125, "cuspy": 1}])
def test_parser_and_scene_match_jax(over):
    cfg = parse_par_file(PAR, **over)
    ref = jax_parse(PAR, **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    scene, ref_scene = build_scene(cfg), jax_build_scene(ref)
    for f in ("boxsize", "mtotal", "mpart_gas", "mpart_dm", "npart_gas",
              "npart_dm", "sub_first", "nhalos", "vel_merger"):
        assert getattr(scene, f) == getattr(ref_scene, f), f
    for h, r in zip(scene.halos, ref_scene.halos):
        for f in dataclasses.fields(h):
            if f.name == "mass_table":
                np.testing.assert_array_equal(h.mass_table.r,
                                              r.mass_table.r)
                np.testing.assert_array_equal(h.mass_table.m,
                                              r.mass_table.m)
            else:
                assert getattr(h, f.name) == getattr(r, f.name), f.name


def _load_golden(path):
    glob, halos = {}, {}
    for line in open(path):
        t = line.split()
        if not t or t[0] != "PARITY" or t[1] in ("begin", "end"):
            continue
        if t[1] == "global":
            glob[t[2]] = float(t[3])
        else:
            halos.setdefault(int(t[2]), {})[t[3]] = float(t[4])
    return glob, halos


def test_scene_matches_compiled_reference_table():
    """Scene from the port's par vs the compiled reference Setup()'s
    PARITY table (tests/golden/setup_table_cluster.txt)."""
    glob, halos = _load_golden(GOLDEN)
    scene = build_scene(parse_par_file(PAR))

    def close(a, b, what, rtol=RTOL):
        assert abs(a - b) / max(abs(a), abs(b), 1e-30) <= rtol, \
            f"{what}: port {a!r} vs reference {b!r}"

    close(scene.boxsize, glob["Boxsize"], "boxsize")
    close(scene.mtotal, glob["Mtotal"], "mtotal")
    close(scene.mpart_gas, glob["Mpart0"], "mpart_gas")
    close(scene.mpart_dm, glob["Mpart1"], "mpart_dm")
    close(scene.grav_softening, glob["GravSoftening"], "softening")
    assert len(scene.halos) == len(halos) == 1
    h, r = scene.halos[0], halos[0]
    assert (h.npart_gas, h.npart_dm) == (int(r["Npart0"]), int(r["Npart1"]))
    for attr, key in (("mtotal", "Mtotal"), ("mtotal200", "Mtotal200"),
                      ("mass_gas", "Mass0"), ("mass_dm", "Mass1"),
                      ("mass_corr_fac", "MassCorrFac"), ("c_nfw", "C_nfw"),
                      ("rs", "Rs"), ("r200", "R200"), ("r500", "R500"),
                      ("a_hernq", "A_hernq"), ("beta", "Beta"),
                      ("rcore", "Rcore"), ("rcut", "Rcut"),
                      ("r_sample_gas", "R_Sample0"),
                      ("r_sample_dm", "R_Sample1")):
        close(getattr(h, attr), r[key], attr)
    # spline-table calibration noise floor, as in test_setup_parity.py
    close(h.rho0, r["Rho0"], "rho0", rtol=1e-4)
    close(h.bf_eff, r["Bf_eff"], "bf_eff", rtol=1e-4)


def _run(code, **env):
    e = dict(os.environ, PYTHONPATH=REPO, **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=e, cwd=REPO, timeout=300)


def test_port_imports_no_jax():
    code = ("import sys, toycluster_tpu_torch, toycluster_tpu_torch.cli, "
            "toycluster_tpu_torch.pipeline, toycluster_tpu_torch.models.wvt, "
            "toycluster_tpu_torch.models.bfield, "
            "toycluster_tpu_torch.models.velocities, "
            "toycluster_tpu_torch.models.temperature, "
            "toycluster_tpu_torch.from_reference, "
            "toycluster_tpu_torch.ops.stream_pair, "
            "toycluster_tpu_torch.ops.cuda_build, "
            "toycluster_tpu_torch.ops.cusp, toycluster_tpu_torch.trace; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'toycluster_tpu' "
            "or m.startswith('toycluster_tpu.')]; print(bad)")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_error_paths(tmp_path):
    usage = _run("from toycluster_tpu_torch.cli import main; "
                 "raise SystemExit(main([]))")
    assert usage.returncode == 1 and "Usage" in usage.stderr
    bad = tmp_path / "bad.par"
    bad.write_text("Output_file x\nNtotal 100\n")
    missing = _run(f"from toycluster_tpu_torch.cli import main; "
                   f"main([{str(bad)!r}, 'device=cpu'])")
    assert missing.returncode == 1 and "missing" in missing.stderr
    unknown = _run(f"from toycluster_tpu_torch.cli import main; "
                   f"main([{PAR!r}, 'no_such_field=1', 'device=cpu'])")
    assert unknown.returncode == 1 and "no_such_field" in unknown.stderr


def test_cuda_default_never_falls_back_to_cpu():
    """Without a card the default device=cuda raises; it never runs on
    the CPU unless told to."""
    from toycluster_tpu_torch.cli import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device=cpu"):
        main([PAR, "ntotal=2000"])


def test_trace_needs_a_card_and_unions_device_intervals():
    from toycluster_tpu_torch import trace
    assert trace._busy_us([(5.0, 7.0), (0.0, 2.0), (1.0, 3.0),
                           (5.5, 6.0)]) == 5.0
    assert trace._busy_us([]) == 0.0
    assert trace.main([]) == 1
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        trace.main([PAR, "ntotal=2000"])


def test_substructure_not_ported_raises():
    from toycluster_tpu_torch.pipeline import make_ics
    cfg = parse_par_file(PAR, ntotal=2000, substructure=True)
    with pytest.raises(NotImplementedError, match="substructure"):
        make_ics(cfg, device="cpu", write=False)
