"""Command-line entry point::

    python -m toycluster_tpu_torch <parfile> [field=value ...] [device=...]
        [engine=...]

JAX counterpart: ``toycluster_tpu/cli.py``.  Replaces ``./Toycluster
cluster.par`` (main.c:11-72); the reference's compile-time flags are
``field=value`` overrides of the Config, e.g.::

    python -m toycluster_tpu_torch cluster.par ntotal=100000 sph_kernel=m4

The device defaults to ``cuda``; without a card the run fails unless
``device=cpu`` is given.  ``engine`` picks the neighbour engine:
``stream`` (the default) or ``classed`` (models/sph.py); any other value
raises.
"""

from __future__ import annotations

import sys

import torch

from .config import parse_par_file
from .models.sph import check_engine
from .pipeline import make_ics


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def check_device(device: str) -> None:
    """Raise unless ``device`` is cpu, or cuda with a card present."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but CUDA is not available; pass "
                           "device=cpu to run on the CPU")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: python -m toycluster_tpu_torch <parameterfile> "
              "[field=value...] [device=cuda|cpu] [engine=stream|classed]",
              file=sys.stderr)
        return 1
    overrides = {}
    device, engine = "cuda", "stream"
    for tok in argv[1:]:
        k, _, v = tok.partition("=")
        if k == "device":
            device = v
        elif k == "engine":
            engine = v
        else:
            overrides[k] = _coerce(v)
    check_device(device)
    check_engine(engine)
    cfg = parse_par_file(argv[0], **overrides)
    make_ics(cfg, device=device, engine=engine)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
