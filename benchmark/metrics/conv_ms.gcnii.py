"""Device milliseconds of an epoch's GCNII convs, forward and backward:
the work launched while the program's span ``lgnn.gcnii.conv``
(``models/sparse_gnn.py::SparseGCNIIConv``, each layer's SpMM, initial
residual, identity-mapped product and ReLU) or ``lgnn.gcnii.conv.backward``
(laid over that work's backward) is open, on any thread, over the traced
epochs, each kernel counted once (``benchlib.launched``). A program
without the spans gives None. Moves ``epoch_ms``."""

from benchlib.launched import launched_device_s


def read(view):
    fwd = launched_device_s(view.prof, "gcnii.conv")
    bwd = launched_device_s(view.prof, "gcnii.conv.backward")
    if not fwd or not view.units:
        return None
    return 1e3 * (fwd + (bwd or 0.0)) / view.units
