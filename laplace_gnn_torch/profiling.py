"""Profiling and timing helpers.

Counterpart of ``laplace_gnn_tpu/profiling.py``, and the port's one
tracing system:

* ``annotate(name)`` is the program's span, as a context manager or as a
  decorator. While no ``torch.profiler`` records it does one check
  (``torch.autograd._profiler_enabled()``) and nothing more: no range, no
  clock read, no allocation. While one records it opens
  ``torch.profiler.record_function("lgnn." + name)``, so the span lies in
  the profiler's own timeline, on the clock that it aligns with the
  device's activity, nested in the span it was opened in.
* ``spanned(name, fn, *args)`` runs ``fn(*args)`` in the span ``name``
  and, where autograd will differentiate it, lays the span
  ``name + ".backward"`` over its backward: two identity nodes, one on
  its output (whose backward opens the span) and one on its tensor
  arguments (whose backward closes it). Call it only while a profiler
  records (``tracing()``); under a ``torch.func`` transform it sets no
  marks.
* ``count(name, n)`` adds to a counter while a profiler records and the
  current stream is not capturing a CUDA graph; ``counters()`` is a
  snapshot of the counts, ``reset_counters()`` clears them.
* ``trace(log_dir)`` records a ``torch.profiler`` trace (CPU and, where
  there is a card, CUDA activity) of the enclosed region: it clears the
  counters when it starts and writes ``trace_<pid>_<ns>.json`` (Chrome
  trace) and ``counters_<pid>_<ns>.json`` into ``log_dir`` when it ends.

So tracing is on exactly while a profiler records; there is no other
switch. Spans and counts inside a function that a CUDA graph captures
fire once, at the capture: a replay runs none of the function's Python.
``training/graphs.py::Step`` spans and counts each replay instead.

``device_time`` is the per-iteration time of a function as the slope of
``iters`` against ``4 * iters`` repetitions (CUDA events on the card, the
host clock for CPU tensors), and ``memory_stats`` reads each card's
allocator statistics.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Callable, Optional

import torch
from torch.autograd import _profiler_enabled

#: the prefix of the program's spans in a trace
SPAN_PREFIX = "lgnn."

_COUNTERS: dict = {}
_COUNTERS_LOCK = threading.Lock()   # the autograd engine's threads count too
_SPANS: dict = {}


class _Span:
    """One named span, shared by every site of that name. A range is
    opened only when a profiler records at entry; the ranges open under
    this name are a stack, so nested and recursive uses close in order
    (one thread at a time inside a given span, as the program's are: the
    backward's thread runs while the caller waits for it)."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        self.name = SPAN_PREFIX + name
        self._open: list = []

    def __enter__(self) -> None:
        if _profiler_enabled():
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
            self._open.append(rf)

    def __exit__(self, *exc) -> bool:
        if self._open:
            self._open.pop().__exit__(*exc)
        return False

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


def annotate(name: str) -> _Span:
    """The span ``name`` (``lgnn.<name>`` in a trace), as a context
    manager or a decorator:

        with profiling.annotate("kfac"):
            ...

        @profiling.annotate("laplace.fit")
        def fit(...): ...
    """
    span = _SPANS.get(name)
    if span is None:
        span = _SPANS[name] = _Span(name)
    return span


#: whether a profiler records, so spans and counters are live: one check,
#: for a site that would do work to count
tracing = _profiler_enabled


class _OpenInBackward(torch.autograd.Function):
    """Identity on a region's output; its backward opens ``span``."""

    @staticmethod
    def forward(ctx, span, x):
        ctx.span = span
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.span.__enter__()
        return None, g


class _CloseInBackward(torch.autograd.Function):
    """Identity on a region's tensor arguments; its backward, which runs
    once the gradients of all of them are formed, closes ``span``."""

    @staticmethod
    def forward(ctx, span, *xs):
        ctx.span = span
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        ctx.span.__exit__(None, None, None)
        return (None,) + tuple(g if need else None for g, need in
                               zip(gs, ctx.needs_input_grad[1:]))


def spanned(name: str, fn: Callable, *args):
    """``fn(*args)`` in the span ``name``. Where autograd will
    differentiate it (grad mode on, a tensor argument that requires grad,
    no ``torch.func`` transform active), its backward lies in the span
    ``name + ".backward"``: the autograd engine runs the region's backward
    nodes after the gradient of its output arrives and before the
    gradients of its arguments leave, as nothing else that was made
    between the two is waiting. For sites that checked ``tracing()``."""
    pos = [i for i, a in enumerate(args)
           if isinstance(a, torch.Tensor)]
    marks = (torch.is_grad_enabled()
             and not torch._C._are_functorch_transforms_active()
             and any(args[i].requires_grad for i in pos))
    if marks:
        back = annotate(name + ".backward")
        args = list(args)
        for i, t in zip(pos, _CloseInBackward.apply(
                back, *[args[i] for i in pos])):
            args[i] = t
    with annotate(name):
        out = fn(*args)
    return _OpenInBackward.apply(back, out) if marks else out


def _capturing() -> bool:
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records (and no
    CUDA graph is being captured on the current stream)."""
    if _profiler_enabled() and not _capturing():
        with _COUNTERS_LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> dict:
    """A snapshot of the counters: {name: count}."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _COUNTERS_LOCK:
        _COUNTERS.clear()


@contextlib.contextmanager
def trace(log_dir: str = "laplace_gnn_trace"):
    """Write a Chrome trace of the enclosed region, and the counters it
    counted, into ``log_dir``:

        with profiling.trace("traces"):
            train_step(...)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    reset_counters()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        tag = f"{os.getpid()}_{time.time_ns()}"
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{tag}.json"))
        with open(os.path.join(log_dir, f"counters_{tag}.json"), "w") as f:
            json.dump(counters(), f, indent=1, sort_keys=True)


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
