"""Device milliseconds of an epoch's sparse SpMMs, forward and the
transposed backward: the work launched under the program's span
``lgnn.spmm`` (``graph/container.py::SparseGraph.spmm``) over the traced
epochs. Moves ``epoch_ms``."""


def read(view):
    s = view.prof.under_s({"lgnn.spmm"})
    if not s or not view.units:
        return None
    return 1e3 * s / view.units
