"""Device time of the work launched while one of the program's spans is
open, counted once.

The profiler attaches each kernel to the CPU event whose correlation id
its launch carries, and a CPU event that is no operation can carry an
operation's id too: a call of the CUDA runtime or driver made outside any
operation (the program's ``torch.cuda.is_current_stream_capturing()``
checks), and the tracer's own records, ``Command Buffer Full`` (a launch
that waited for the device's queue) and ``Activity Buffer Request``. That
operation's kernels are then attached twice, and a sum over every CPU
event counts them twice. Seen on the card in 5 epochs of
``sparsegcnii-arxiv.train``: 300-313 ``Command Buffer Full`` records
inside the convs' forward spans held 126-156 ms of device time, and the
sum over the spans read above the stretch's busy time. Only operations
launch work, so those records are left out here; otherwise as
``benchlib.program.span_device_s``."""

from __future__ import annotations

import bisect
import re

from benchlib.program import _intervals, _self_device_us

#: CPU events that are no operation: the CUDA runtime's
#: (``cudaLaunchKernel``) and driver's (``cuLaunchKernel``) calls, and the
#: tracer's own records
_NOT_AN_OPERATION = re.compile(
    r"cuda|cu[A-Z]|Command Buffer Full|Activity Buffer Request")


def launched_device_s(prof, span: str):
    """Device seconds of the work that operations starting inside the
    program's span ``span`` launched, on any thread, or None where the
    trace holds no such span."""
    intervals = _intervals(prof, span)
    if not intervals:
        return None
    starts = [s for s, _ in intervals]
    total = 0.0
    for e in prof.cpu:
        if _NOT_AN_OPERATION.match(e.name):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start <= intervals[i][1]:
            total += _self_device_us(e)
    return total / 1e6
