"""Share of the traced evaluations spent in the marglik tuning of the
prior precision (100 Adam steps on its log): the union of the program's
span ``lgnn.laplace.tune_prior``
(``laplace/base.py::BaseLaplace.optimize_prior_precision``) over the
traced stretch's wall time. Moves ``lastlayer_eval_s``."""

from benchlib import program


def read(view):
    return program.span_share(view, "laplace.tune_prior")
