#!/usr/bin/env python3
"""Where the sparse path's time goes on the card, at ogbn-arxiv's shape.

    python3 scripts/probe_sparse.py

Builds the arxiv-shaped graph of ``chip_smoke.py`` (phase 18) with the
CLI's packing (sym weights, hybrid ELL), then times with CUDA events
(warm, mean of 20 calls) at the hidden width 256: the SpMM's parts (the
level-0 ELL table, each overflow level, the remainder as embedding_bag
sums and as a gather and segment sum in two levels and in one) in
float32 and bf16, the whole SpMM and its backward, the plain segment
path, the level-0 table as a gather and as an elementwise product-sum,
and torch.sparse's CSR product on the same matrix (a library call the
port does not use), beside the SpMM's bound on this card. Then one
SparseGCN and one SparseGAT train step under torch.profiler (device time
by kernel). Prints one JSON line last and writes it to
``chiprun_out/probe_sparse.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def top_kernels(torch, fn, top: int = 10) -> dict:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_time_total > 0), key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    return {"device_ms": total,
            "top": [{"name": k[:90], "ms": t, "calls": c}
                    for k, t, c in rows[:top]]}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_sparse: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from laplace_gnn_torch.graph import container as C
    from laplace_gnn_torch.training import sparse_experiment as se
    from laplace_gnn_torch.training.marglik_gnn import DeviceAdam

    out = {"card": cs.card_info()}
    x_np, y_np, ei = cs.arxiv_like(np)
    data = argparse.Namespace(edge_index=ei, num_nodes=cs.ARXIV_N,
                              num_features=cs.ARXIV_F,
                              num_classes=cs.ARXIV_C, x=x_np)
    args = se.argument_parser().parse_args(
        ["--hidden_channels", str(cs.SPARSE_HIDDEN)])
    g = se.build_graph(args, data, device="cuda")
    out["graph"] = cs._graph_stats(torch, g)
    d = cs.SPARSE_HIDDEN
    x32 = torch.randn(cs.ARXIV_N, d, device="cuda")
    parts = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        tag = str(dtype).split(".")[-1]
        parts[f"level0 {tag}"] = ms(torch, lambda: C._ell_tier(
            x, g.ell_cols, g.ell_vals.to(dtype)))
        flat = g.ell_cols.reshape(-1)
        parts[f"level0 gather only {tag}"] = ms(
            torch, lambda: x.index_select(0, flat))
        vals = g.ell_vals.to(dtype)
        parts[f"level0 mul-sum {tag}"] = ms(torch, lambda: torch.sum(
            vals[:, :, None] * x.index_select(0, flat).view(
                cs.ARXIV_N, -1, d), dim=1))
        for i, (rows, cols, v) in enumerate(g.ell_levels):
            parts[f"level{i + 1} {tag}"] = ms(torch, lambda: x.new_zeros(
                x.shape).index_add_(0, rows, C._ell_tier(x, cols,
                                                          v.to(dtype))))
        seg = g.segments("rem")
        msgs = g.rem_w[:, None].to(dtype) * x.index_select(0, g.rem_src)
        parts[f"remainder gather {tag}"] = ms(torch, lambda: (
            g.rem_w[:, None].to(dtype) * x.index_select(0, g.rem_src)))
        parts[f"remainder segment sum {tag}"] = ms(
            torch, lambda: seg.reduce(msgs, "sum"))
        parts[f"remainder bag sum {tag}"] = ms(torch, lambda: seg.bag_sum(
            x, g.rem_src, g.rem_w.to(dtype)))
        one = dataclasses.replace(seg, chunk_lengths=None, chunks=None)
        parts[f"remainder segment sum, one level {tag}"] = ms(
            torch, lambda: one.reduce(msgs, "sum"))
        gd = dataclasses.replace(g, agg_dtype=None)
        parts[f"spmm {tag}"] = ms(torch, lambda: gd.spmm(x))
    fast = C.FastAggGraph(g)
    xg = x32.clone().requires_grad_(True)
    yv = fast.spmm(xg)
    parts["spmm bf16 agg, f32 in/out"] = ms(torch, lambda: fast.spmm(x32))
    parts["spmm backward bf16 agg"] = ms(torch, lambda: torch.autograd.grad(
        yv, xg, x32, retain_graph=True))
    seg_g = dataclasses.replace(g, format="segment", agg_dtype=None)
    parts["segment path f32"] = ms(torch, lambda: seg_g.spmm(x32))
    csr = torch.sparse_coo_tensor(torch.stack([g.dst, g.src]), g.weights,
                                  (cs.ARXIV_N, cs.ARXIV_N)).to_sparse_csr()
    parts["torch.sparse.mm CSR f32 (library)"] = ms(
        torch, lambda: torch.sparse.mm(csr, x32))
    # the least time for the SpMM's work on this card: x read once, the
    # output written once, every edge's index and weight read once (f32),
    # over the card's memory rate; its 2 * E * d operations over the f32
    # rate take less
    peak_name, (bw, _) = cs.card_peaks(out["card"])
    moved = 2 * cs.ARXIV_N * d * 4 + g.n_edges * (8 + 4)
    out["spmm_bound_ms"] = max(moved / bw,
                               2 * g.n_edges * d / cs.FP32_PEAK) * 1e3
    out["spmm_bound_by"] = "bytes" if moved / bw > \
        2 * g.n_edges * d / cs.FP32_PEAK else "operations"
    out["peaks"] = peak_name
    out["spmm_ms"] = parts
    print(json.dumps({"spmm_ms": parts}), flush=True)

    steps = {}
    for model_type in ("sparsegcn", "sparsegat"):
        a = se.argument_parser().parse_args(
            ["--model_type", model_type, "--hidden_channels",
             str(cs.SPARSE_HIDDEN)])
        gm = g if model_type == "sparsegcn" else se.build_graph(
            a, data, device="cuda")
        model = se.build_model(a, data, gm, device="cuda")
        params = {k: v.requires_grad_(True) for k, v in model.init().items()}
        opt = DeviceAdam(params.values(), lr=1e-2)
        tr = torch.arange(0, cs.ARXIV_N, 2, device="cuda")
        ytr = torch.as_tensor(y_np, device="cuda")[tr]

        def step():
            se.train_steps(model, params, opt, tr, ytr, 1)

        steps[model_type] = {"step_ms": ms(torch, step, reps=10),
                             **top_kernels(torch, step)}
        print(json.dumps({model_type: steps[model_type]}), flush=True)
    out["train_step"] = steps
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "probe_sparse.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(out["card"], flush=True)
    print(json.dumps({"spmm_ms": parts,
                      "spmm_bound_ms": out["spmm_bound_ms"],
                      "step_ms": {k: v["step_ms"]
                                  for k, v in steps.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
