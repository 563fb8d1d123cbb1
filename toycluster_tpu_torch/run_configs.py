"""The five configurations of the JAX package's ``configs/run_configs.py``
as presets over the port's par::

    python -m toycluster_tpu_torch.run_configs <1..5> [field=value ...]
        [device=cuda|cpu] [engine=stream|classed] [wvt_checkpoint=PATH]
        [profile_dir=DIR] [par=PATH]

1. Single beta-model halo, no B field, ~32^3 SPH particles
2. Single NFW halo + Bonafede+2010 magnetic field, 1e6 particles
3. Equal-mass two-cluster merger, zero-energy orbit, 1e7 particles
4. 1:3 mass-ratio merger with Giocoli 2010 substructure, 1e7 particles
5. Three-halo configuration (merger + ADD_THIRD_SUBHALO), comet setup,
   1e8 particles

Each preset is a dict of ``Config`` overrides of ``par`` (default: the
repository's ``data/cluster.par``, and for preset 5, which needs the
``SubFirst*`` tags that par lacks, ``data/cluster_config5.par``: the same
tags and a third subhalo's); ``field=value`` tokens override the preset.
A ``par`` without the ``SubFirst*`` tags makes preset 5 raise the par
parser's missing-tag ValueError.  ``device`` defaults to ``cuda`` and
raises without a card; ``wvt_checkpoint`` and ``profile_dir`` are the
``make_ics`` keywords of the same names.
"""

from __future__ import annotations

import sys
from pathlib import Path

from .cli import _coerce, check_device
from .config import parse_par_file
from .models.sph import check_engine
from .pipeline import make_ics

PAR = Path(__file__).resolve().parent / "data" / "cluster.par"
# the default par of a preset where it is not PAR
PARS = {5: PAR.with_name("cluster_config5.par")}

PRESETS = {
    1: dict(ntotal=2 * 32**3, bfld_norm=0.0, output_file="IC_config1"),
    2: dict(ntotal=1_000_000, output_file="IC_config2"),
    3: dict(ntotal=10_000_000, mass_ratio=1.0, zero_e_orbit_frac=1.0,
            orbit="comet", output_file="IC_config3"),
    4: dict(ntotal=10_000_000, mass_ratio=1.0 / 3.0, substructure=True,
            output_file="IC_config4"),
    5: dict(ntotal=100_000_000, mass_ratio=0.5, add_third_subhalo=True,
            substructure=True, orbit="comet", sub_first_mass=1e3,
            output_file="IC_config5"),
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in {str(k) for k in PRESETS}:
        print("Usage: python -m toycluster_tpu_torch.run_configs <1..5> "
              "[field=value...] [device=cuda|cpu] [engine=stream|classed] "
              "[wvt_checkpoint=PATH] [profile_dir=DIR] [par=PATH]",
              file=sys.stderr)
        return 1
    preset = int(argv[0])
    opts = dict(device="cuda", engine="stream", wvt_checkpoint=None,
                profile_dir=None, par=str(PARS.get(preset, PAR)))
    overrides = {}
    for tok in argv[1:]:
        k, _, v = tok.partition("=")
        if k in opts:
            opts[k] = v
        else:
            overrides[k] = _coerce(v)
    check_device(opts["device"])
    check_engine(opts["engine"])
    cfg = parse_par_file(opts["par"], **{**PRESETS[preset], **overrides})
    make_ics(cfg, device=opts["device"], engine=opts["engine"],
             wvt_checkpoint=opts["wvt_checkpoint"],
             profile_dir=opts["profile_dir"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
