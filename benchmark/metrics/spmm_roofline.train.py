"""The sparse SpMM's share of its roofline over the traced epochs: the
sum of each call's bound (``benchlib.counts.spmm_bound_s``: the edges'
source indices and weights, the input and the output at the aggregation
dtype, each once), forward and backward, over the device time of the work
under the benchmark's span around the forward SpMM and under the SpMM
Function's backward node. Moves ``epoch_ms``."""

BACKWARD = "autograd::engine::evaluate_function: _SpMMFnBackward"


def read(view):
    bound = view.counters.get("spmm_bound_s")
    busy = view.prof.under_s({"bench.spmm", BACKWARD})
    if not bound or busy <= 0:
        return None
    return 100.0 * bound / busy
