"""Set-up time: from the first line of ``run.py`` to the window's start
(imports, the kernels loaded or built, the warm-up IC).  Host clock."""


def read(run):
    return run.setup_s
