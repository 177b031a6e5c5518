#!/usr/bin/env python3
"""Where the row-sharded GAT step's time goes on one card.

    python3 scripts/probe_parallel.py

Joins a one-process NCCL group, builds ``flash_attention.cu`` and times
the GAT train step of ``chip_smoke.py`` phase 19 (a) (N = 16384, d = 64,
hidden 64, 8 heads, ``TrainingPrograms.train_step``) four ways: the
unsharded flash attention; the row-sharded flash attention of
``laplace_gnn_torch.parallel``; the same with the one-rank collectives
replaced by local copies (what the NCCL calls cost on the host); and the
row-sharded step again. Each: the median of 20 steps by CUDA events, the
host ms of 10 steps ended by a synchronize, and one step under
torch.profiler (device ms, kernels, the largest by name). Then where the
host time of a step goes: 10 steps of the unsharded and of the row-sharded
step under cProfile, each function's own time a step (``self_ms``) and
calls a step, the largest first, and each step's total host ms under
cProfile split into the port's ``parallel`` modules, torch's autograd,
torch.distributed and the rest. Then the host cost of one collective:
``all_gather`` of the (N, 8, 8) h as a raw NCCL call and through the
port's Function, the mean of 200 calls. Prints one JSON line per
measurement and writes them to ``chiprun_out/probe_parallel.json``.
"""

from __future__ import annotations

import cProfile
import json
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _where(filename: str) -> str:
    """The part of the program a function's file belongs to."""
    if "laplace_gnn_torch/parallel" in filename:
        return "port parallel"
    if "laplace_gnn_torch" in filename:
        return "port other"
    if "torch/distributed" in filename:
        return "torch.distributed"
    if "torch/autograd" in filename or "torch/_functorch" in filename:
        return "torch autograd"
    if filename.startswith("~") or filename.startswith("<"):
        return "builtins and C calls"
    return "other Python"


def host_profile(step, steps: int = 10, top: int = 20) -> dict:
    """cProfile of ``steps`` calls of ``step``: the largest functions by
    their own time, and the host time a step by part of the program."""
    prof = cProfile.Profile()
    prof.enable()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall = time.perf_counter() - t0
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows, parts = [], {}
    for (fname, line, func), (_, ncalls, tt, _, _) in stats.items():
        part = _where(fname)
        parts[part] = parts.get(part, 0.0) + tt / steps * 1e3
        rows.append({"fn": f"{os.path.basename(fname)}:{line}:{func}",
                     "part": part, "self_ms": tt / steps * 1e3,
                     "calls": ncalls / steps})
    rows.sort(key=lambda r: -r["self_ms"])
    return {"wall_ms": wall / steps * 1e3, "parts_ms": parts,
            "top": rows[:top]}


def main() -> int:
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import torch.distributed as dist
    from laplace_gnn_torch import parallel as P
    from laplace_gnn_torch.ops import cuda_build
    from laplace_gnn_torch.parallel import collectives as C

    if not torch.cuda.is_available():
        print("probe_parallel: no CUDA device", file=sys.stderr)
        return 1
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    cs.build_kernels(cuda_build, out_dir, ["flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_info()
    P.initialize(f"tcp://127.0.0.1:{cs._free_port()}", 1, 0, device="cuda")
    rows = []

    def emit(row):
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)

    try:
        mesh = P.make_mesh()
        n = cs.GAT_N_KERNEL
        X, adj, y = cs.gat_graph(torch, n, seed=4)
        idx = torch.randperm(n, generator=torch.Generator().manual_seed(0))[
            :n // 10].to("cuda")
        yy = y[idx]
        impl = P.make_row_sharded_gat_attention(mesh, use_flash=True)
        progs = {name: cs.gat_programs(cs.gat_model(torch, X, adj, attn),
                                       int(idx.shape[0]))
                 for name, attn in (("sharded", impl),
                                    ("unsharded", "flash"))}
        for pr in progs.values():
            pr.train_step(idx, yy)
        torch.cuda.synchronize()

        def step_row(label, pr):
            med, _ = cs._events_ms(torch, lambda: pr.train_step(idx, yy), 20)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                pr.train_step(idx, yy)
            torch.cuda.synchronize()
            prof = cs.profile_step(torch, lambda: pr.train_step(idx, yy),
                                   top=8)
            emit({"step": label, "median_ms": med,
                  "host_ms": (time.perf_counter() - t0) / 10 * 1e3,
                  "device_ms": prof["device_ms"],
                  "n_kernels": prof["n_kernels"], "top": prof["top"]})

        step_row("unsharded flash", progs["unsharded"])
        step_row("row-sharded flash", progs["sharded"])
        saved = (C._all_gather, C._reduce_scatter, C._all_reduce)
        C._all_gather = C._reduce_scatter = C._all_reduce = \
            lambda x, ax: x.contiguous().clone()
        try:
            step_row("row-sharded flash, collectives as copies",
                     progs["sharded"])
        finally:
            C._all_gather, C._reduce_scatter, C._all_reduce = saved
        step_row("row-sharded flash again", progs["sharded"])
        for label, pr in (("unsharded flash", progs["unsharded"]),
                          ("row-sharded flash", progs["sharded"])):
            emit({"host_profile": label,
                  **host_profile(lambda: pr.train_step(idx, yy))})

        ax = C.mesh_axis(mesh)
        h = torch.randn(n, 8, 8, device="cuda")
        buf = torch.empty_like(h)
        hr = h.clone().requires_grad_(True)
        for label, call in (
                ("raw NCCL all_gather", lambda: C._all_gather_rows(
                    buf, h, group=ax.group)),
                ("all_gather Function", lambda: C.all_gather(h, ax)),
                ("all_gather Function, grad on",
                 lambda: C.all_gather(hr, ax))):
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            torch.cuda.synchronize()
            emit({"call": label, "host_us": (time.perf_counter() - t0)
                  / 200 * 1e6, "bytes": h.numel() * 4})
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, "probe_parallel.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
