"""Times one whole run makes the host wait for the device: the program's
counter ``host_sync`` (each eigensolve, whose ``info`` torch checks on
the host, and each read of a device tensor: ``.item()``, ``float()``,
``int()``, ``bool()``, ``.cpu()``) over the traced whole runs. Moves
``run_s``."""

from benchlib import program


def read(view):
    n = program.counter("host_sync")
    if not n or not view.units:
        return None
    return n / view.units
