"""Device milliseconds of an epoch's GAT attention, forward and backward:
the work launched while the program's span ``lgnn.gat.attention``
(``models/sparse_gnn.py::SparseGATConv``, each layer's edge softmax and
aggregation) or ``lgnn.gat.attention.backward`` (laid over that work's
backward) is open, over the traced epochs. A program without the spans
gives None. Moves ``epoch_ms``."""

from benchlib.program import span_device_s


def read(view):
    fwd = span_device_s(view.prof, "gat.attention")
    bwd = span_device_s(view.prof, "gat.attention.backward")
    if not fwd or not view.units:
        return None
    return 1e3 * (fwd + (bwd or 0.0)) / view.units
