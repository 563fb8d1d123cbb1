"""A frozen copy of the host set-up of ``toycluster_tpu_torch``: the par
parser (``config``), units, cosmology, the halo scene (``scene``), the
profiles and tables it integrates, and the Giocoli substructure
(``models/substructure``).  Host NumPy and SciPy only.

It is a copy, not an import, so that the reference works out the halo
quantities itself and a change to the program's set-up cannot move the
yardstick.  ``build(par_path, overrides)`` is the scene of a run.
"""

from __future__ import annotations


def build(par_path, overrides):
    """The scene that ``make_ics`` builds from the par at ``par_path``
    with the ``Config`` field ``overrides``: the substructure draws from
    ``Config.seed + 7``, as the program's pipeline does."""
    from .config import parse_par_file
    from .scene import build_scene
    cfg = parse_par_file(str(par_path), **overrides)
    scene = build_scene(cfg)
    if cfg.substructure:
        from .models.substructure import setup_substructure
        scene = setup_substructure(scene, seed=cfg.seed + 7)
    return scene
