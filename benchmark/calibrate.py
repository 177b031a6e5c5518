#!/usr/bin/env python3
"""Readings from which a cell's limits are set, never run by the
benchmark's own runs.

    python3 benchmark/calibrate.py --workload stegcn-cora.marglik \\
        --seeds 11,12,13 [--control] [--faults state_unchanged,half_batch]

For each seed, in one process: the driver's set-up and one unit, then the
numbers the check compares (the program against the plain reference);
with ``--control`` the same numbers for the control (the reference at the
precision below the configuration's, in the program's place); with
``--faults`` the numbers for the program with each named fault planted
(the driver's ``FAULTS``). One JSON line a reading, on standard output and
appended to ``--out``."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))


def main(argv=None, device=None, root=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = root or os.path.dirname(BENCH_DIR)
    sys.path.insert(0, os.path.join(root, "benchmark"))
    sys.path.insert(1, root)
    import torch
    import run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device or "cuda")
    bench = run.read_json(os.path.join(root, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    for seed in [int(s) for s in args.seeds.split(",")]:
        ctx = run.Context(root, cell, bench, seed, 0.0, False, dev)
        from benchlib.drive import load_driver
        driver = load_driver(ctx, ctx.mix["driver"])
        plans = [("program", None)]
        plans += [(f, driver.FAULTS[f]) for f in args.faults.split(",") if f]
        for label, fault in plans:
            t0 = time.perf_counter()
            if fault is None:
                c = driver.setup(ctx)
                c.unit(0)
            else:
                with fault():
                    c = driver.setup(ctx)
                    c.unit(0)
            c.release()
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            for row in c.check():
                emit({"workload": args.workload, "seed": seed,
                      "side": label, "readings": row,
                      "program_s": t1 - t0,
                      "check_s": time.perf_counter() - t1})
            if label == "program" and args.control:
                t2 = time.perf_counter()
                for row in c.control():
                    emit({"workload": args.workload, "seed": seed,
                          "side": "control", "readings": row,
                          "control_s": time.perf_counter() - t2})
            del c
            gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
