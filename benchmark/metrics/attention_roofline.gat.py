"""The GAT attention's share of its roofline over the traced epochs: the
epoch's bound (``benchlib.gat_counts.attention_bound_s``: each stored
edge's gathered row and source index, the output and the destination
scores once, forward, and a backward of twice that; from the shapes, so
it is the same whatever implements the attention) over the device time
that ``attention_ms.gat`` reads. Moves ``epoch_ms``."""

from benchlib.program import span_device_s


def read(view):
    bound = view.counters.get("attention_bound_s_per_unit")
    fwd = span_device_s(view.prof, "gat.attention")
    bwd = span_device_s(view.prof, "gat.attention.backward")
    if not bound or not fwd or not view.units:
        return None
    return 100.0 * bound * view.units / (fwd + (bwd or 0.0))
