"""Device operations (kernels, copies, fills) of one whole run, counted
in the profiler's trace. Moves ``run_s``."""


def read(view):
    if not view.prof.n_device_ops or not view.units:
        return None
    return view.prof.n_device_ops / view.units
