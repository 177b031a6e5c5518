"""Steps of a training loop that replay from CUDA graphs.

A :class:`Step` wraps a function of no arguments that reads and writes
only tensors that outlive it: static inputs, parameters, optimizer state
and output buffers. Calling the step calls the function, until
:func:`capture` has recorded it into a ``torch.cuda.CUDAGraph``; from then
on calling it replays the graph, so the host launches one graph instead
of each of its kernels. The kernels count the launches recorded into a
graph once per replay (``ops/cuda_build.py::Kernel``).

Each call is a span, ``step.<name>`` when called eagerly and
``step.<name>.replay`` when replayed, and counts as ``step.<name>.eager``
or ``step.<name>.replay`` (``profiling.py``): a replay runs none of the
function's Python, so the spans inside it are not seen again.
"""

from __future__ import annotations

import gc
from typing import Callable, Sequence

import torch

from ..ops.cuda_build import counting
from ..profiling import annotate, count

WARMUP = 2      # eager calls of each step before its capture


class Step:
    """One step of a loop. ``capture`` says whether :func:`capture` records
    it; ``calls`` counts its calls, and ``launches`` each kernel's launches
    in them (by kernel name), replayed or not."""

    def __init__(self, name: str, fn: Callable[[], None], capture: bool):
        self.name = name
        self.fn = fn
        self.capture = capture
        self.graph = None
        self.recorded: dict = {}        # kernel -> launches a replay
        self.calls = 0
        self.launches: dict = {}
        self._span = annotate(f"step.{name}")
        self._replay_span = annotate(f"step.{name}.replay")
        self._eager_counter = f"step.{name}.eager"
        self._replay_counter = f"step.{name}.replay"

    def __call__(self) -> None:
        self.calls += 1
        if self.graph is None:
            count(self._eager_counter)
            with counting() as launched, self._span:
                self.fn()
            for k, n in launched.items():
                self.launches[k.name] = self.launches.get(k.name, 0) + n
            return
        count(self._replay_counter)
        with self._replay_span:
            self.graph.replay()
        for k, n in self.recorded.items():
            k.count_replay(n)
            self.launches[k.name] = self.launches.get(k.name, 0) + n


def capture(steps: Sequence[Step], generators=()) -> None:
    """Record every step that has ``capture`` set into a graph of its own
    (each with a private memory pool): first ``WARMUP`` calls of each on
    a side stream, which make the lazy allocations and library handles
    that a capture may not, then one capture each. Each ``generators``
    entry is registered with every graph, so a replay draws from it what
    the eager call would and advances it as far. The warm-up calls change
    the state that the steps own: the caller resets it before a run.

    Python's cyclic garbage collector is run before the captures and held
    off during them: a dead run (its steps and it refer to each other)
    dies only in a collection, and freeing its graphs while a stream
    captures invalidates the capture, which then fails at its end."""
    todo = [s for s in steps if s.capture and s.graph is None]
    if not todo:
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            for s in todo:
                s.fn()
    torch.cuda.current_stream().wait_stream(side)
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        for s in todo:
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                graph.register_generator_state(gen)
            with counting("recorded") as recorded, torch.cuda.graph(graph):
                s.fn()
            s.recorded = recorded
            s.graph = graph
    finally:
        if enabled:
            gc.enable()
    torch.cuda.synchronize()
