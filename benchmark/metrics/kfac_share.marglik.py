"""Share of a traced whole run spent in the KFAC factors of the -log
marglik evaluations and hypersteps (the forward, its vjp, the vmapped
pullback and the covariances): the union of the program's span
``lgnn.kfac`` (``curvature/kfac.py::compute_kfac_factors``) over the
traced stretch's wall time. Moves ``run_s``."""

from benchlib import program


def read(view):
    return program.span_share(view, "kfac")
