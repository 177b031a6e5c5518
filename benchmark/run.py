#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload stegcn-cora.marglik --seed 7 \\
        --seconds 40 --trace 0

Everything a cell needs is found by name from ``BENCHMARK.json`` at the
root of the checkout: its configuration
(``benchmark/configs/<config>.json``, whose ``reference`` names the plain
reference in ``benchmark/references/``), its traffic mix
(``benchmark/mixes/<traffic>.json``, whose ``driver`` names the code in
``benchmark/drivers/`` that drives the program), the limits that decide
``correct`` (``benchmark/limits/<cell>.json``) and, with ``--trace 1``,
one reader per per-layer metric (``benchmark/metrics/<metric>.py``).

A run: set-up (imports, the program's build cache, inputs and weights from
the seed, the driver's warm-up; where a cell evaluates a trained model, the
plain reference trains it from the seed there, and that time is kept out
of ``setup_s``), then units back to back for ``--seconds``
(the window ends when the last unit begun inside it has completed, with a
synchronize), then with ``--trace 1`` a profiled stretch of a few more
units for the per-layer metrics, then the program's state is freed and the
plain reference checks the outputs. The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "laplace_gnn_tpu")
# a time per unit in the metric's own unit, from seconds
PER_SECOND = {"s": 1.0, "ms": 1e3, "us": 1e6}


class Refused(Exception):
    """The run cannot measure; it prints no result."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    that the measured process must not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise Refused(f"missing {path}") from e


class Context:
    """What a driver and a metric reader are handed."""

    def __init__(self, root, cell, bench, seed, seconds, trace, device):
        self.root = root
        self.bench_dir = os.path.join(root, "benchmark")
        self.cell = cell
        self.bench = bench
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.config = read_json(os.path.join(
            self.bench_dir, "configs", f"{cell['config']}.json"))
        self.mix = read_json(os.path.join(
            self.bench_dir, "mixes", f"{cell['traffic']}.json"))
        self.limits = read_json(os.path.join(
            self.bench_dir, "limits", f"{cell['name']}.json"))

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def cell_metrics(bench: dict, kind: str, cell: str) -> list:
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def device_info(ctx, torch) -> dict:
    if ctx.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(ctx.device),
            "count": int(ctx.cell.get("chips", 1)),
            "memory_peak_bytes": int(
                torch.cuda.max_memory_allocated(ctx.device))}


def measure(ctx, torch) -> dict:
    """Set-up, window, the traced stretch with ``--trace 1``, the check;
    returns the result line's object."""
    from benchlib import compare, peaks, trace as tr
    from benchlib.drive import load, load_driver
    timed = [m for m in cell_metrics(ctx.bench, "end_to_end",
                                     ctx.cell["name"])
             if m["name"] != "setup_s"]
    for m in timed:
        if m["unit"] not in PER_SECOND:
            raise Refused(f"{m['name']}: no time unit {m['unit']!r}")
    driver = load_driver(ctx, ctx.mix["driver"])
    cell = driver.setup(ctx)
    ctx.sync()
    # set-up's objects leave the collector's generations, so its passes in
    # the window walk only what the window makes
    gc.collect()
    gc.freeze()
    # inputs that the plain reference made (trained weights) are not the
    # program's set-up
    reference_s = getattr(cell, "reference_setup_s", 0.0)
    setup_s = time.perf_counter() - T_START - reference_s

    units = 0
    t0 = time.perf_counter()
    marks = [t0]
    while marks[-1] - t0 < ctx.seconds:
        cell.unit(units)
        units += 1
        marks.append(time.perf_counter())
    ctx.sync()
    window_s = time.perf_counter() - t0
    metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
    e2e = {"setup_s": setup_s}
    for m in timed:
        e2e[m["name"]] = window_s / units * PER_SECOND[m["unit"]]
        metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device = device_info(ctx, torch)
    gaps = sorted(b - a for a, b in zip(marks, marks[1:]))
    print(f"setup_s {setup_s!r} (the reference's inputs {reference_s!r} s "
          f"apart), {units} units in {window_s!r} s; host "
          f"time between unit starts min {gaps[0]!r} median "
          f"{gaps[len(gaps) // 2]!r} max {gaps[-1]!r}",
          file=sys.stderr, flush=True)

    breakdown = None
    if ctx.trace:
        spans = tr.Spans(sync=ctx.sync)
        n_traced = int(ctx.mix["traced_units"])
        with cell.traced(spans) as counters:
            prof = tr.profiled(lambda: [cell.unit(units + k)
                                        for k in range(n_traced)],
                               ctx.sync, ctx.device.type == "cuda")
        view = MetricView(prof, spans, counters, n_traced, e2e)
        metrics = {}
        for m in cell_metrics(ctx.bench, "per_layer", ctx.cell["name"]):
            value = load(ctx, "metrics", m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = prof.busy_s
        device["window_s"] = prof.wall_s
        breakdown = {"device_ops": prof.device_ops(),
                     "idle_gaps": prof.idle_gaps()}

    cell.release()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    rows = cell.check()
    limits = ctx.limits["limits"]
    compared = compare.judged(compare.worst(rows), limits)
    failed = sum(1 for row in rows
                 if any(not v <= lim
                        for _, v, lim in compare.judged(row, limits)))
    result = {"correct": bool(rows) and failed == 0,
              "attempted": units, "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["card"] = peaks.card_power_limit() \
        if ctx.device.type == "cuda" else "cpu"
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in compared}
    return result


class MetricView:
    """What a per-layer metric reader reads: the profiled stretch
    (``prof``), the benchmark's spans, the driver's counters, the number
    of units traced and the untraced window's end-to-end values."""

    def __init__(self, prof, spans, counters, units, e2e):
        self.prof = prof
        self.spans = spans
        self.counters = counters
        self.units = units
        self.e2e = e2e


def main(argv=None, device=None, root=None) -> int:
    """The command line. ``device`` other than None (a test on the CPU)
    skips the look for a card; ``root`` is the checkout (default: the
    parent of this folder)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = root or os.path.dirname(BENCH_DIR)
    bench_dir = os.path.join(root, "benchmark")
    if bench_dir not in sys.path:
        sys.path.insert(0, bench_dir)
    if root not in sys.path:
        sys.path.insert(1, root)
    try:
        bench = read_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if args.workload not in cells:
            raise Refused(f"no workload {args.workload!r} in BENCHMARK.json")
        cell = cells[args.workload]
        import torch
        if device is None:
            if not torch.cuda.is_available():
                raise Refused("no CUDA device")
            if torch.cuda.device_count() < int(cell.get("chips", 1)):
                raise Refused(f"{torch.cuda.device_count()} CUDA devices, "
                              f"the cell asks for {cell.get('chips', 1)}")
            device = "cuda"
        # float32 as the configurations state it: no TF32 products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            import laplace_gnn_torch  # noqa: F401
        except ImportError as e:
            raise Refused(f"the program is not in the checkout: {e}") from e
        ctx = Context(root, cell, bench, args.seed, args.seconds,
                      bool(args.trace), torch.device(device))
        result = measure(ctx, torch)
    except Refused as e:
        print(f"benchmark: refused: {e}", file=sys.stderr, flush=True)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the measured process holds {found}",
              file=sys.stderr, flush=True)
        return 4
    for name, row in result["compared"].items():
        print(f"compared {name}: {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
