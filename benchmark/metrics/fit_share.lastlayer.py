"""Share of the traced evaluations spent in the last-layer Laplace fit
with its marglik prior tuning, from the benchmark's synchronized span
around the fit, over the traced stretch's wall time. Moves
``lastlayer_eval_s``."""


def read(view):
    s = view.spans.seconds.get("fit")
    if not s or view.prof.wall_s <= 0:
        return None
    return 100.0 * s / view.prof.wall_s
