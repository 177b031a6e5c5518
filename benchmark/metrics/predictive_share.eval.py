"""Share of the traced evaluations that the device spends on the Laplace
predictive (the probit's Jacobians, their vmapped pullbacks through
``core_spmm``, and the functional variance's products): the device time
of the work launched while the program's span
``lgnn.laplace.predictive`` (``laplace/base.py::ParametricLaplace.__call__``)
is open, over the traced stretch's wall time. (The span's host time is
the enqueueing only: the host waits for the probit after it closes.)
Moves ``eval_s``."""

from benchlib import program


def read(view):
    s = program.span_device_s(view.prof, "laplace.predictive")
    if not s or view.prof.wall_s <= 0:
        return None
    return 100.0 * s / view.prof.wall_s
