"""Share of the traced stretch in which no operation ran on the device:
1 - (the union of device operation intervals / the stretch's wall time).
Moves ``run_s``."""


def read(view):
    if view.prof.wall_s <= 0 or not view.prof.n_device_ops:
        return None
    return 100.0 * (1.0 - view.prof.busy_s / view.prof.wall_s)
