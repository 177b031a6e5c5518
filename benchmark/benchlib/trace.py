"""Spans around calls into the program, and the reading of one
``torch.profiler`` trace: device time by kernel name, the union of device
intervals (busy time), device time under a span, and the breakdown
(longest device operations, idle gaps by what the host was doing)."""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

SPAN_PREFIX = "bench."


class Spans:
    """Host-clock spans, each also a ``record_function`` range of the same
    name so the profiler attributes the device work launched inside it.
    ``sync`` spans synchronize the device at both ends, so their host
    time is the device work they enclose."""

    def __init__(self, sync=torch.cuda.synchronize):
        self.sync = sync
        self.seconds: dict = defaultdict(float)
        self.count: dict = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = True):
        full = SPAN_PREFIX + name
        if sync:
            self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(full):
            yield
            if sync:
                self.sync()
        self.seconds[name] += time.perf_counter() - t0
        self.count[name] += 1

    def wrap(self, name: str, fn, sync: bool = True):
        def wrapped(*args, **kwargs):
            with self.span(name, sync):
                return fn(*args, **kwargs)
        return wrapped


def _is_annotation(e) -> bool:
    return (getattr(e, "is_user_annotation", False)
            or e.name.startswith(SPAN_PREFIX))


def _device_total_us(e) -> float:
    v = getattr(e, "device_time_total", None)
    if v is None:
        v = e.cuda_time_total
    return float(v)


class Profile:
    """One profiled stretch of the run: ``wall_s`` is its host-clock
    length between two synchronizes, ``kernels`` its device operations
    (kernels, copies, fills) as (name, start_us, end_us)."""

    def __init__(self, prof, wall_s: float):
        from torch.autograd import DeviceType
        self.wall_s = wall_s
        self.kernels = []
        self.cpu = []
        for e in prof.events():
            if e.device_type == DeviceType.CPU:
                self.cpu.append(e)
            elif not _is_annotation(e):
                self.kernels.append((e.name, e.time_range.start,
                                     e.time_range.end))
        self.kernels.sort(key=lambda k: k[1])
        self._merged = _merge([(s, t) for _, s, t in self.kernels])

    @property
    def n_device_ops(self) -> int:
        return len(self.kernels)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(t - s for s, t in self._merged) / 1e6

    def device_s(self, pred) -> float:
        """Device seconds of the operations whose name passes ``pred``."""
        return sum(t - s for n, s, t in self.kernels if pred(n)) / 1e6

    def under_s(self, names) -> float:
        """Device seconds of the work launched under the CPU events named
        in ``names`` (spans or autograd nodes), children included."""
        names = set(names)
        return sum(_device_total_us(e) for e in self.cpu
                   if e.name in names) / 1e6

    def device_ops(self, top: int = 10) -> list:
        by = defaultdict(float)
        for n, s, t in self.kernels:
            by[n[:120]] += (t - s) / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time between operations, summed by what the host
        was doing at each gap's middle: the innermost span of the
        benchmark and the innermost operation of the thread that runs
        them."""
        if len(self._merged) < 2:
            return []
        threads = defaultdict(int)
        for e in self.cpu:
            if e.name.startswith(SPAN_PREFIX):
                threads[e.thread] += 1
        main = max(threads, key=threads.get) if threads else None
        mine = [e for e in self.cpu if main is None or e.thread == main]
        key = (lambda e: (e.time_range.start, -e.time_range.end))
        ops = sorted((e for e in mine if not e.name.startswith(SPAN_PREFIX)),
                     key=key)
        spans = sorted((e for e in mine if e.name.startswith(SPAN_PREFIX)),
                       key=key)
        op_starts = [e.time_range.start for e in ops]
        span_starts = [e.time_range.start for e in spans]

        def innermost(evs, starts, t, reach):
            # the innermost covering event started last before t
            i = bisect.bisect_right(starts, t) - 1
            for j in range(i, max(i - reach, -1), -1):
                if evs[j].time_range.end >= t:
                    return evs[j].name
            return None

        by = defaultdict(float)
        for (_, end), (nxt, _) in zip(self._merged, self._merged[1:]):
            gap = nxt - end
            if gap <= 0:
                continue
            mid = (end + nxt) / 2
            span = innermost(spans, span_starts, mid, len(spans))
            op = innermost(ops, op_starts, mid, 400) or "host"
            label = f"{span} > {op}" if span else op
            by[label[:120]] += gap / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]


def _merge(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return out


def profiled(fn, sync=torch.cuda.synchronize, cuda: bool = True) -> Profile:
    """Run ``fn()`` under ``torch.profiler`` (host, and the device when
    ``cuda``), between two calls of ``sync``, and read the trace."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    return Profile(prof, wall)
