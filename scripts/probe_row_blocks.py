#!/usr/bin/env python3
"""The composed STE-GCN on row blocks across four cards: which of two ways
to form the rank's rows of the transposed normalized aggregation is
faster, and what each rank holds.

    python3 scripts/probe_row_blocks.py [--cards 4] [--n 8192]

Starts one process per card (an NCCL group on a free local port) and runs
the composed STE-GCN at ``scripts/shard_scale_bench.py``'s size (N =
8192, d = 32, hidden 32, 7 classes, density 14e-4, 1024 train nodes,
f32), each rank on its row block of the adjacency, two ways:

- ``reduce_scatter`` (the port's ``parallel.sharded.NormalizedRowBlockAdj``):
  the rank's N x R columns of the normalized matrix, each product's
  (N, d) partial reduce-scattered to the row blocks;
- ``all_to_all``: the rank's R x N rows of A^T by one all-to-all of its
  block's tiles, then the rank's rows of the normalized matrix times the
  all-gathered features.

For each: the Kron hyperstep (the -log marglik and every gradient) and
the train step (cross entropy, gradients), the median of 10 by CUDA
events after 2 warm-up calls, each rank's peak bytes above the step's
start (``torch.cuda.max_memory_allocated``), and the -log marglik and
d/d adj against rank 0's unsharded hyperstep (which rank 0 runs alone
first). Rank 0 prints one JSON line per measurement and writes them to
``chiprun_out/probe_row_blocks.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FEAT, HIDDEN, N_CLASS, DENSITY, N_TRAIN = 32, 32, 7, 14e-4, 1024


class TransposedRowBlockAdj:
    """The other way: the rank's rows of A^T by one all-to-all, then its
    rows of ``d[:, None] * A^T * d[None, :]`` times the all-gathered
    features."""

    def __init__(self, a_blk, ax):
        import torch
        from laplace_gnn_torch.parallel.collectives import all_gather
        from laplace_gnn_torch.parallel.sharded import transpose_rows
        rowsum = a_blk.sum(dim=1)
        d_blk = torch.where(rowsum > 0,
                            torch.rsqrt(torch.clamp(rowsum, min=1e-38)),
                            torch.zeros_like(rowsum))
        d = all_gather(d_blk, ax)
        self.rows = d_blk[:, None] * transpose_rows(a_blk, ax) * d[None, :]
        self.ax = ax

    def spmm(self, x_blk):
        from laplace_gnn_torch.parallel.collectives import all_gather
        return self.rows @ all_gather(x_blk, self.ax)


def _timed(torch, fn, reps: int = 10):
    """(median CUDA-event ms, peak bytes above the start) of ``fn``."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return sorted(ms)[len(ms) // 2], torch.cuda.max_memory_allocated() - base


def rank_main(rank: int, world: int, port: int, n: int) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from laplace_gnn_torch import parallel as P
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.parallel import sharded as S
    from laplace_gnn_torch.training.marglik_gnn import (_ce_mean,
                                                        make_neg_marglik_fn)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, N_FEAT)).astype(np.float32)
    adj = (rng.random((n, n)) < DENSITY).astype(np.float32)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    n_train = min(N_TRAIN, n // 2)
    y = torch.as_tensor(rng.integers(0, N_CLASS, n_train), device="cuda")
    idx = torch.arange(n_train, device="cuda")
    model = STEGCN(N_FEAT, HIDDEN, N_CLASS, 2, X, adj, dropout_p=0.0,
                   device="cuda", generator=torch.Generator().manual_seed(0))
    del adj
    whole = {k: v.detach() for k, v in model.params().items()}
    rows_out = []

    def emit(row):
        if rank == 0:
            print(json.dumps(row), flush=True)
            rows_out.append(row)

    want = None
    if rank == 0:                      # the unsharded hyperstep, alone
        fn = make_neg_marglik_fn(model, "classification", "kron", "all",
                                 N=n_train)
        p = {k: v.clone().requires_grad_(True) for k, v in whole.items()}
        val = fn(p, idx, y)
        (g,) = torch.autograd.grad(val, [p["adj"]])
        want = (float(val.detach()), g.detach())
        del p, val, fn
    P.initialize(f"tcp://127.0.0.1:{port}", world, rank, device="cuda")
    mesh = P.make_mesh(world, device="cuda")
    sh = P.graph_sharding(mesh)
    placed = model.placed(sh)
    params = {k: sh.put(v) if k == "adj" else v.clone()
              for k, v in whole.items()}
    r = n // world
    original = S.NormalizedRowBlockAdj
    for way, cls in (("reduce_scatter", original),
                     ("all_to_all", TransposedRowBlockAdj),
                     ("reduce_scatter", original)):
        S.NormalizedRowBlockAdj = cls
        fn = make_neg_marglik_fn(placed, "classification", "kron", "all",
                                 N=n_train)

        def hyperstep():
            p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            val = fn(p, idx, y)
            return val.detach(), torch.autograd.grad(val, list(p.values()))

        def train_step():
            p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            loss = _ce_mean(placed.apply(p, idx), y)
            return torch.autograd.grad(loss, list(p.values()))

        h_ms, h_bytes = _timed(torch, hyperstep)
        t_ms, t_bytes = _timed(torch, train_step)
        val, grads = hyperstep()
        g_blk = grads[list(params).index("adj")]
        stats = torch.tensor([h_ms, t_ms, h_bytes / 1e9, t_bytes / 1e9],
                             device="cuda", dtype=torch.float64)
        every = [torch.zeros_like(stats) for _ in range(world)]
        dist.all_gather(every, stats)
        row = {"way": way, "cards": world, "n": n,
               "hyperstep_ms": [float(s[0]) for s in every],
               "train_step_ms": [float(s[1]) for s in every],
               "hyperstep_peak_gb": [float(s[2]) for s in every],
               "train_step_peak_gb": [float(s[3]) for s in every]}
        if rank == 0:
            row["neg_marglik_rel"] = abs(float(val) - want[0]) / abs(want[0])
            row["adj_grad_rel_block0"] = float(
                (g_blk - want[1][:r]).norm() / want[1][:r].norm())
        emit(row)
    S.NormalizedRowBlockAdj = original
    if rank == 0:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
        emit({"cards_seen": card})
        out = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "probe_row_blocks.json"), "w") as f:
            json.dump(rows_out, f, indent=1)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.cards, args.port, args.n)
        return 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cards",
         str(args.cards), "--n", str(args.n), "--rank", str(r), "--port",
         str(port)]) for r in range(args.cards)]
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break                       # a rank failed: stop the rest
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return max(p.returncode for p in procs)


if __name__ == "__main__":
    sys.exit(main())
