"""Share of a traced whole run spent in the steps called from Python
(the -log marglik evaluations and the hypersteps, which hold eigensolves
and are not captured), from the benchmark's synchronized spans around
those step calls, over the traced stretch's wall time. Moves ``run_s``."""


def read(view):
    s = view.spans.seconds.get("eager_step")
    if not s or view.prof.wall_s <= 0:
        return None
    return 100.0 * s / view.prof.wall_s
