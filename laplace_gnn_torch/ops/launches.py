"""Launch counters of the port's CUDA kernel wrappers.

Each wrapper counts its kernel's launches in ``launches``. A launch made
while its stream is capturing a CUDA graph runs nothing yet: it is counted
in ``recorded``, and the graph's replays count it, once a replay each, in
``launches`` and in ``replayed`` (see ``training/graphs.py``). So
``launches`` is how many times the kernel ran, and ``replayed`` how many
of those came from a graph rather than a call from Python.
"""

from __future__ import annotations

import torch

KERNELS: list = []     # every counted wrapper, in the order made


class LaunchCounter:

    def __init__(self):
        self.launches = 0
        self.replayed = 0
        self.recorded = 0
        KERNELS.append(self)

    def _counted(self) -> None:
        """Count one launch of the kernel on the current stream."""
        if torch.cuda.is_current_stream_capturing():
            self.recorded += 1
        else:
            self.launches += 1

    def count_replay(self, n: int) -> None:
        """``n`` launches recorded into a graph ran once more."""
        self.launches += n
        self.replayed += n
