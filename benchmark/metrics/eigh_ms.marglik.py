"""Device milliseconds of one whole run's eigensolves: the work launched
under the benchmark's span around each call of the trainer's batched
eigensolver (``ops/linalg.py::batched_eigvalsh``). Moves ``run_s``."""


def read(view):
    s = view.prof.under_s({"bench.eigh"})
    if not s or not view.units:
        return None
    return 1e3 * s / view.units
