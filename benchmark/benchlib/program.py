"""What the program itself records in a profiled stretch: the host time
of its spans (``laplace_gnn_torch/profiling.py``'s ``annotate``, CPU
events named ``lgnn.<span>`` in the trace), the device time of the work
launched inside them, and its counters
(``profiling.counters()``, counted only while a profiler records, so
after the stretch they are the stretch's). A program without them (an
older checkout) gives None, and raises nothing."""

from __future__ import annotations

import bisect

from benchlib.trace import _merge

SPAN_PREFIX = "lgnn."


def _intervals(prof, span: str) -> list:
    """Sorted, disjoint [start, end] host intervals (us) of the program's
    span ``span``."""
    name = SPAN_PREFIX + span
    return _merge((e.time_range.start, e.time_range.end)
                  for e in prof.cpu if e.name == name)


def span_s(prof, span: str):
    """Seconds of the union of the host intervals of the program's span
    ``span`` in the profiled stretch ``prof`` (nested and repeated uses
    counted once), or None where the trace holds none."""
    intervals = _intervals(prof, span)
    if not intervals:
        return None
    return sum(t - s for s, t in intervals) / 1e6


def _self_device_us(e) -> float:
    v = getattr(e, "self_device_time_total", None)
    return float(e.self_cuda_time_total if v is None else v)


def span_device_s(prof, span: str):
    """Device seconds of the work launched while the program's span
    ``span`` is open: each operation's own device time, on any thread,
    for the host events that start inside the span's intervals (a
    vmapped pullback runs its backward on the autograd engine's thread,
    outside the span's children), or None where the trace holds no such
    span."""
    intervals = _intervals(prof, span)
    if not intervals:
        return None
    starts = [s for s, _ in intervals]
    total = 0.0
    for e in prof.cpu:
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= intervals[i][1]:
            total += _self_device_us(e)
    return total / 1e6


def span_share(view, span: str):
    """The union of ``span``'s intervals as a percentage of the traced
    stretch's wall time, or None."""
    s = span_s(view.prof, span)
    if not s or view.prof.wall_s <= 0:
        return None
    return 100.0 * s / view.prof.wall_s


def counter(name: str):
    """The program's counter ``name`` after the stretch, or None where
    the program has no counters or never counted it."""
    try:
        from laplace_gnn_torch import profiling
        return profiling.counters().get(name)
    except (ImportError, AttributeError):
        return None
