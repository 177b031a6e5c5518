"""Device milliseconds a whole run of the small eigensolver's vector
kernel alone (``csrc/small_eigh.cu``'s ``small_eigh_kernel``, launched by
``ops/linalg.py::small_eigenvectors`` where the backward of the
eigenvalues recomputes their vectors: the hypersteps' outer backward on
the composed route), read by kernel name from the trace, replayed
launches included. None where no such kernel ran. Moves ``run_s``."""

NAME = "small_eigh_kernel"


def read(view):
    s = view.prof.device_s(lambda name: NAME in name)
    if s <= 0 or not view.units:
        return None
    return 1e3 * s / view.units
