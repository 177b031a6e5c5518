"""Model operations of a whole run on the composed route
(``benchlib.composed_counts.run_flops``: every train step, tracking pass,
-log marglik evaluation and hyperstep with its outer backward into the
adjacency; eigensolves and the dense forms of the adjacency not counted)
over ``run_s`` of the untraced window times the published dense bf16
peak, as ``mfu.marglik`` reads the fused route. Moves ``run_s``."""

from benchlib import peaks


def read(view):
    flops = view.counters.get("model_flops_per_unit")
    run_s = view.e2e.get("run_s")
    if not flops or not run_s:
        return None
    return 100.0 * flops / (run_s * peaks.BF16_FLOPS)
