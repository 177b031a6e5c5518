"""Share of a traced whole run's step calls that replayed a CUDA graph,
from the program's counters ``step.<name>.replay`` and
``step.<name>.eager`` (``training/graphs.py::Step``): the engagement of
the whole run's capture. Moves ``run_s``."""

from benchlib import program

STEPS = ("train_step", "hyperstep", "neg_marglik", "tracking")


def read(view):
    replay = sum(program.counter(f"step.{s}.replay") or 0 for s in STEPS)
    eager = sum(program.counter(f"step.{s}.eager") or 0 for s in STEPS)
    if replay + eager == 0:
        return None
    return 100.0 * replay / (replay + eager)
