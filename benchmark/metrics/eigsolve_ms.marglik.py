"""Device milliseconds a whole run of the small eigensolver's kernels
(``csrc/small_eigh.cu``: ``small_eigvalsh_kernel``, and
``small_eigh_kernel`` where a backward recomputes eigenvectors), read by
kernel name from the trace, replayed launches included. None where the
program has no such kernel. Moves ``run_s``."""

NAMES = ("small_eigvalsh_kernel", "small_eigh_kernel")


def read(view):
    s = view.prof.device_s(lambda name: any(k in name for k in NAMES))
    if s <= 0 or not view.units:
        return None
    return 1e3 * s / view.units
