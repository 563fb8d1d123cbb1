"""The rest of the port's ``make_ics`` surface against the JAX package on
the CPU: the WVT loop's percentile at any length (``torch.quantile``
refuses inputs of more than 2^24 elements), ``profile_dir=``, the stage
memory records, and the five run presets with their runner."""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu_torch import run_configs
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.io.gadget import read_snapshot
from toycluster_tpu_torch.models.wvt import percentile
from toycluster_tpu_torch.pipeline import make_ics

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR = os.path.join(ROOT, "toycluster_tpu_torch", "data", "cluster.par")
MEMORY_STAGES = ("positions", "sph_quantities", "magnetic_field",
                 "temperatures", "velocities")


@pytest.fixture(scope="module")
def jax_presets():
    spec = importlib.util.spec_from_file_location(
        "jax_run_configs", os.path.join(ROOT, "configs", "run_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.PRESETS


@pytest.mark.parametrize("q", [98.0, 99.9])
def test_percentile_past_the_quantile_limit(q):
    """2^24 + 1 elements: numpy's linear percentile, rel 1e-6."""
    x = np.random.default_rng(3).lognormal(size=2**24 + 1).astype(
        np.float32)
    got = float(percentile(torch.from_numpy(x), q))
    assert got == pytest.approx(float(np.percentile(x, q)), rel=1e-6)


@pytest.mark.parametrize("n", [1, 2, 3, 10, 3906, 100003])
@pytest.mark.parametrize("q", [98.0, 99.9])
def test_percentile_matches_quantile_and_jnp(n, q):
    """Below 2^24: torch.quantile within one float32 ulp (the calls it
    replaces), and jnp.percentile (the JAX loop's threshold) within 1e-4
    relative: its interpolation weight is rounded differently, which
    moves the result by a fraction of one neighbour gap."""
    x = np.random.default_rng(n).lognormal(size=n).astype(np.float32)
    got = np.float32(percentile(torch.from_numpy(x), q))
    ref = np.float32(torch.quantile(torch.from_numpy(x), q / 100.0))
    assert abs(got - ref) <= np.spacing(ref)
    assert got == pytest.approx(float(jnp.percentile(jnp.asarray(x), q)),
                                rel=1e-4)


def test_make_ics_profile_dir_on_cpu(tmp_path):
    """profile_dir= writes a Chrome trace of the WVT loop; on the CPU
    the stage records carry no device memory."""
    logs = []
    cfg = parse_par_file(PAR, ntotal=4000, sph_kernel="m4", wvt_max_iter=2)
    prof = tmp_path / "prof"
    make_ics(cfg, device="cpu", write=False, profile_dir=str(prof),
             log=lambda stage, **kw: logs.append((stage, kw)))
    with open(prof / "wvt_trace.json") as fh:
        assert len(json.load(fh)["traceEvents"]) >= 1
    stages = {stage for stage, _ in logs}
    assert set(MEMORY_STAGES) <= stages
    assert not any("mem_gib" in kw or "peak_gib" in kw for _, kw in logs)


def test_presets_equal_the_jax_presets(jax_presets):
    assert run_configs.PRESETS == jax_presets


def test_preset_5_raises_like_the_jax_parser(jax_presets):
    """The repository's par lacks the SubFirst* tags of config 5."""
    with pytest.raises(ValueError) as ej:
        jax_parse(PAR, **jax_presets[5])
    with pytest.raises(ValueError) as et:
        parse_par_file(PAR, **run_configs.PRESETS[5])
    assert str(et.value) == str(ej.value)
    assert "missing" in str(et.value)


def test_runner_on_cpu(tmp_path):
    out = tmp_path / "IC"
    assert run_configs.main(["4", "ntotal=3000", "sph_kernel=m4",
                             "wvt_max_iter=2", "device=cpu",
                             f"output_file={out}"]) == 0
    snap = read_snapshot(str(out))
    assert snap["pos"].shape == (3000, 3)
    assert np.isfinite(snap["pos"]).all()


def test_runner_rejects_bad_arguments(tmp_path):
    assert run_configs.main([]) == 1
    assert run_configs.main(["6"]) == 1
    with pytest.raises(ValueError, match="device must be"):
        run_configs.main(["1", "device=tpu"])
    with pytest.raises(ValueError, match="engine"):
        run_configs.main(["1", "device=cpu", "engine=pallas"])


def test_runner_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_configs.main(["1"])


def test_runner_runs_preset_5_with_its_own_par(tmp_path):
    """Preset 5 reads ``data/cluster_config5.par`` (the SubFirst* tags)
    unless ``par=`` is given, and writes a snapshot."""
    assert run_configs.PARS[5].name == "cluster_config5.par"
    out = tmp_path / "IC5"
    assert run_configs.main(["5", "ntotal=2000", "sph_kernel=m4",
                             "wvt_max_iter=2", "device=cpu",
                             f"output_file={out}"]) == 0
    snap = read_snapshot(str(out))
    assert snap["pos"].shape == (2000, 3)
    assert np.isfinite(snap["pos"]).all()
    with pytest.raises(ValueError, match="missing"):
        run_configs.main(["5", "ntotal=2000", "device=cpu", f"par={PAR}"])
