"""Device milliseconds of an epoch's sparse SpMMs in the GCNII cell,
forward and the transposed backward: the work launched while the
program's span ``lgnn.spmm`` (``graph/container.py::SparseGraph.spmm``)
is open, on any thread, over the traced epochs, each kernel counted once
(``benchlib.launched``): the shared kernel's part of the convs. A program
without the span gives None. Moves ``epoch_ms``."""

from benchlib.launched import launched_device_s


def read(view):
    s = launched_device_s(view.prof, "spmm")
    if not s or not view.units:
        return None
    return 1e3 * s / view.units
