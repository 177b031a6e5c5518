"""``core_spmm``'s share of its roofline over a traced whole run: the sum
of each launch's bound (``benchlib.counts.core_spmm_bound_s``, shapes from
a recording wrapper around the launch) over the kernel's device time.
Moves ``run_s``."""


def read(view):
    bound = view.counters.get("core_spmm_bound_s")
    busy = view.prof.device_s(lambda name: "core_kernel" in name)
    if not bound or busy <= 0:
        return None
    return 100.0 * bound / busy
