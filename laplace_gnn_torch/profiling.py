"""Profiling and timing helpers.

Counterpart of ``laplace_gnn_tpu/profiling.py``: ``trace`` records a
``torch.profiler`` trace (CPU and, where there is a card, CUDA activity) of
the enclosed region into ``log_dir``, ``annotate`` names a region in it,
``device_time`` is the per-iteration time of a function as the slope of
``iters`` against ``4 * iters`` repetitions (CUDA events on the card, the
host clock for CPU tensors), and ``memory_stats`` reads each card's
allocator statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "laplace_gnn_trace"):
    """Write a Chrome trace of the enclosed region into ``log_dir``:

        with profiling.trace("traces"):
            train_step(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the trace's timeline."""
    with torch.profiler.record_function(name):
        yield


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            found = _first_tensor(t)
            if found is not None:
                return found
    return None


def device_time(fn: Callable, *args, iters: int = 20,
                chain: Optional[Callable] = None) -> float:
    """Per-iteration time of ``fn(*args)`` in seconds, on the device of
    the arguments' first tensor.

    Runs ``iters`` and ``4 * iters`` repetitions after a warm-up call and
    returns the slope, so fixed costs drop out. Each repetition adds
    ``1e-30 * chain(previous output)`` (default: the sum of the output's
    first tensor) to the first tensor argument, so the repetitions form
    one dependent chain, as the JAX package's loop does. On CUDA tensors
    the clock is a pair of CUDA events; on CPU tensors the host clock."""
    chain = chain or (lambda out: torch.sum(_first_tensor(out)))
    first = _first_tensor(args)
    if first is None:
        raise ValueError("device_time needs a tensor argument")
    on_cuda = first.device.type == "cuda"

    def loop(n: int) -> None:
        acc = torch.zeros((), dtype=first.dtype, device=first.device)
        for _ in range(n):
            a0 = args[0] + (1e-30 * acc).to(args[0].dtype) \
                if isinstance(args[0], torch.Tensor) else args[0]
            acc = acc + chain(fn(a0, *args[1:]))

    def clock(n: int) -> float:
        if on_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loop(n)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        loop(n)
        return time.perf_counter() - t0

    with torch.no_grad():
        loop(1)
        if on_cuda:
            torch.cuda.synchronize(first.device)
        t1 = clock(iters)
        t4 = clock(4 * iters)
    return max((t4 - t1) / (3 * iters), 0.0)


def memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of each card (bytes), by device name;
    empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
