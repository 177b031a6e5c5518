#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``laplace_gnn_torch``) on one CUDA GPU.

    python3 chip_smoke.py

Phases, each fatal:
  1. build every CUDA kernel of the port from ``laplace_gnn_torch/csrc``;
  2. hold the ``core_spmm`` kernel against its plain PyTorch version at the
     trainer's shapes (N = 2708; d = 64 and 7; plain and transposed;
     binarized f32, raw f32 and int8 adjacency) and time it with CUDA
     events beside the plain version, one PyTorch matmul on a
     pre-binarized matrix, and its bound on this card;
  3. run the STE-GCN marglik trainer (``marglik_optimization``, fused
     kernel path, symmetric) at Cora's width on a synthetic Cora-shaped
     graph for a few epochs with two hyperstep rounds, with the kernel's
     launch counter set to 0 just before and read just after (and its
     launches inside train steps and hypersteps counted apart); then time
     one train step and one hyperstep and count their launches; check the
     kernel path's outputs against the composed PyTorch path at full size
     and against the float64 CPU path on a small graph;
  4. hold the two flash-attention kernels (``flash_fwd``, ``flash_bwd``)
     against their plain versions at the dense-GAT path's shapes (N = 16384
     and 2708; H = 8 with F = 8 and F = 1; float32 masks; one int8-mask,
     one bf16 and one row-shard case, the last with a target row that has
     no neighbour) and time them beside the plain
     versions and the composed chunked attention (forward and autograd
     backward);
  5. time one GAT train step at N = 16384 (d = 64, hidden 64, 8 heads,
     concat, 8 classes, Erdos-Renyi density 14e-4) through the kernels, with
     its launches (2 forward + 2 backward) and profile, beside the same step
     on the plain chunked attention;
  6. run the GAT marglik trainer (``model_type="gat"``, flash kernels) at
     N = 2708 for 4 epochs with every launch counter set to 0 just before
     and read just after, counting the launches inside train steps,
     -log marglik evaluations (0: they run the ``jvp_safe`` clone) and
     validation forwards; time one -log marglik evaluation and its peak
     memory; check one train step's weight gradients and the -log marglik
     on a small graph against the float64 CPU path.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result, when there is no CUDA device or the package is not beside it.
Per-shape measurements also go to ``chiprun_out/chip_smoke.json``, and
each source's ptxas report to ``chiprun_out/build_<source>.log``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

N_NODES, N_FEAT, HIDDEN, N_CLASS = 2708, 1433, 64, 7   # Cora's width
DENSITY = 10556 / (2708 * 2708)                        # Cora's edge density
N_TRAIN, N_VAL = 140, 500

# dense GAT, as the JAX package's flash benchmark configures it
# (scripts/bench_gat_scale.py, BENCH_GAT.json n16384_h8)
GAT_D, GAT_HIDDEN, GAT_HEADS, GAT_CLASSES = 64, 64, 8, 8
GAT_DENSITY = 14e-4
GAT_N_KERNEL, GAT_N_TRAIN = 16384, 2708
FP32_PEAK = 67e12           # FLOP/s outside the tensor cores (H100 SXM)
ISO_ROW = 7                 # the row-shard case's target row without edges

# (memory bytes/s, dense bf16 tensor-core FLOP/s) from NVIDIA's data sheets
CARD_PEAKS = {"H100 SXM": (3.35e12, 989e12), "H100 PCIe": (2.0e12, 756e12),
              "H100 NVL": (3.9e12, 835e12), "H200": (4.8e12, 989e12)}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS.items():
        if all(w in name for w in key.split()):
            return key, peaks
    if "H100" in name and "HBM3" in name:
        return "H100 SXM", CARD_PEAKS["H100 SXM"]
    return "H100 SXM (assumed)", CARD_PEAKS["H100 SXM"]


def cold_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, each after a
    256 MB write that evicts the 50 MB L2 and a ~1 ms spin that keeps the
    card busy while the host enqueues ``fn`` (CUDA events around the call
    alone; without the spin a wrapper's Python work would be timed as idle
    device time)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)          # clock cycles, ~1 ms
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def profile_step(torch, fn) -> dict:
    """One call of ``fn`` under torch.profiler: the device time of its GPU
    kernels (and memsets/copies), summed by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return {"device_ms": sum(r[1] for r in rows),
            "n_kernels": sum(r[2] for r in rows),
            "top": [{"name": k[:70], "ms": ms, "count": c}
                    for k, ms, c in rows[:8]]}


def make_graph(np, rng):
    """Synthetic Cora-shaped graph, built the way bench.py builds one."""
    X = rng.standard_normal((N_NODES, N_FEAT), dtype=np.float32)
    adj = (rng.random((N_NODES, N_NODES)) < DENSITY).astype(np.float32)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, N_CLASS, N_NODES)
    return X, adj, y


def phase_kernel(torch, np, fs, peaks):
    """Kernel against plain version at the trainer's shapes, and times."""
    bw, flops_peak = peaks
    rng = np.random.default_rng(1)
    _, adj, _ = make_graph(np, rng)
    # a learned adjacency after symmetrization: 1, 0 and exact 0.5 ties
    raw = np.where(rng.random(adj.shape) < 0.5, adj, adj.T)
    a_sym = torch.as_tensor((raw + raw.T) / 2, device="cuda")
    a_raw = torch.as_tensor(rng.random(adj.shape, dtype=np.float32),
                            device="cuda")
    a_i8 = torch.as_tensor((raw > 0.5).astype(np.int8), device="cuda")
    rows, max_err = [], 0.0
    for d in (HIDDEN, N_CLASS):
        t = torch.randn(N_NODES, d, device="cuda")
        t_q = torch.round(t * 8) / 8            # exact in bf16
        for transpose in (False, True):
            # binarized f32 A (the trainer's calls): t rounds to bf16, B is
            # exact, so |err| <= 2^-9 (|B|^T|t|); we allow 2^-8
            got = fs.core(a_sym, t, 0.5, True, transpose)
            ref = fs.core_reference(a_sym, t, 0.5, True, transpose)
            tol = 2.0 ** -8 * fs.core_reference(a_sym, t.abs(), 0.5, True,
                                                transpose) + 1e-6
            err = (got - ref).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"binarized d={d} T={transpose}: "
                                     f"max err {float(err.max())}")
            max_err = max(max_err, float(err.max()))
            # raw f32 A: A and t both round to bf16 -> 2^-7 (|A|^T|t|)
            got = fs.core(a_raw, t, binarize=False, transpose=transpose)
            ref = fs.core_reference(a_raw, t, binarize=False,
                                    transpose=transpose)
            tol = 2.0 ** -7 * fs.core_reference(
                a_raw, t.abs(), binarize=False, transpose=transpose) + 1e-5
            if not bool(((got - ref).abs() <= tol).all()):
                raise AssertionError(f"raw f32 d={d} T={transpose}")
            # int8 0/1 A with t exact in bf16: exact
            got = fs.core(a_i8, t_q, binarize=False, transpose=transpose)
            ref = fs.core_reference(a_i8, t_q, binarize=False,
                                    transpose=transpose)
            if not torch.equal(got, ref):
                raise AssertionError(f"int8 d={d} T={transpose} not exact")

            b_pre = fs.core_reference(a_sym, torch.eye(
                N_NODES, device="cuda"), 0.5, True, False).T.contiguous()
            lib = ((lambda: torch.matmul(b_pre, t)) if transpose
                   else (lambda: torch.matmul(b_pre.T, t)))
            nbytes = N_NODES * N_NODES * 4 + 2 * N_NODES * d * 4
            nflop = 2 * N_NODES * N_NODES * d
            bound = max(nbytes / bw, nflop / flops_peak) * 1e3
            rows.append({
                "n": N_NODES, "d": d, "transpose": transpose,
                "adj": "float32 binarized",
                "ms": cold_ms(torch, lambda: fs.core(a_sym, t, 0.5, True,
                                                     transpose)),
                "plain_ms": cold_ms(torch, lambda: fs.core_reference(
                    a_sym, t, 0.5, True, transpose)),
                "library_ms": cold_ms(torch, lib),
                "bound_ms": bound,
                "bound_by": "bytes" if nbytes / bw >= nflop / flops_peak
                else "operations"})
        # the int8 read of the same product (GCN "int8" mode)
        nbytes = N_NODES * N_NODES + 2 * N_NODES * d * 4
        rows.append({
            "n": N_NODES, "d": d, "transpose": False, "adj": "int8 raw",
            "ms": cold_ms(torch, lambda: fs.core(a_i8, t, binarize=False)),
            "plain_ms": cold_ms(torch, lambda: fs.core_reference(
                a_i8, t, binarize=False)),
            "library_ms": None,
            "bound_ms": max(nbytes / bw, 2 * N_NODES ** 2 * d / flops_peak)
            * 1e3, "bound_by": "bytes"})
    torch.cuda.synchronize()
    return rows, max_err


def phase_trainer(torch, np, card):
    """The port's main path: marglik_optimization at Cora's width."""
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.ops.fused_spmm import core
    from laplace_gnn_torch.training.marglik_gnn import (
        TrainingPrograms, marglik_optimization)

    rng = np.random.default_rng(0)
    X, adj, y = make_graph(np, rng)
    perm = rng.permutation(N_NODES)
    tr, va = perm[:N_TRAIN], perm[N_TRAIN:N_TRAIN + N_VAL]
    model = STEGCN(N_FEAT, HIDDEN, N_CLASS, 2, X, adj, dropout_p=0.5,
                   fused=True, symmetric=True, device="cuda",
                   generator=torch.Generator().manual_seed(0))
    params = model.params()
    cfg = dict(lr=1e-3, lr_adj=0.8, momentum_adj=0.9, weight_decay=5e-5,
               weight_decay_adj=5e-4, grad_norm=True,
               hessian_structure="kron", subset_of_weights="all")

    # the kernel's launches inside the run's train steps and hypersteps
    by_step = {"train_step": 0, "hyperstep": 0}

    def counted(name):
        method = getattr(TrainingPrograms, name)

        def run_counted(self, *args, **kwargs):
            before = core.launches
            out = method(self, *args, **kwargs)
            by_step[name] += core.launches - before
            return out
        return run_counted

    torch.cuda.synchronize()
    core.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(TrainingPrograms, "train_step",
                           counted("train_step")), \
            mock.patch.object(TrainingPrograms, "hyperstep",
                              counted("hyperstep")):
        _, final, losses, val_losses, nms = marglik_optimization(
            model, params, tr, y[tr], va, y[va], y=y, n_epochs=6,
            n_hypersteps=2, n_epochs_burnin=2, marglik_frequency=2,
            verbose=False, device="cuda", **cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_launches = core.launches
    if not all(math.isfinite(v) for v in losses + val_losses + nms):
        raise AssertionError(f"non-finite trace: {losses} {nms}")
    if torch.equal(final["adj"], params["adj"]):
        raise AssertionError("adj did not change")
    for name, n in by_step.items():
        if n == 0:
            raise AssertionError(f"the trainer's {name}s launched no "
                                 "core_spmm kernel")
    print(f"trainer: 6 epochs, 2 hyperstep rounds x 2 in {run_s:.3f} s "
          f"(host clock), {run_launches} core_spmm launches ({by_step}); "
          f"losses {losses}; neg-margliks {nms}  [{card}]", flush=True)

    # one train step and one hyperstep, timed and counted alone
    p = {k: v.detach().clone().requires_grad_(True) for k, v in
         final.items()}
    progs = TrainingPrograms(model, p, N=N_TRAIN, prior_precision=1.0,
                             **cfg)
    idx = torch.as_tensor(tr, device="cuda")
    yy = torch.as_tensor(y[tr], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = {}
    for name, fn in (("train_step", lambda: progs.train_step(idx, yy, gen)),
                     ("hyperstep", lambda: progs.hyperstep(idx, yy))):
        fn()
        torch.cuda.synchronize()
        reps, ms = 5, []
        core.launches = 0
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        launches = core.launches / reps
        if launches <= 0:
            raise AssertionError(f"{name} launched no core_spmm kernel")
        prof = profile_step(torch, fn)
        step_ms = sorted(ms)[reps // 2]
        prof["busy_share"] = prof["device_ms"] / step_ms
        steps[name] = {"ms": step_ms, "ms_all": ms, "launches": launches,
                       "profile": prof}
        print(f"{name}: median {step_ms:.3f} ms over {reps} (CUDA events), "
              f"{launches:g} core_spmm launches; profiled kernels: "
              f"{prof['device_ms']:.3f} ms of device time in "
              f"{prof['n_kernels']} launches, busy share "
              f"{prof['busy_share']:.2f}  [{card}]", flush=True)
        for r in prof["top"]:
            print(f"  {r['ms']:8.3f} ms x{r['count']:<4d} {r['name']}",
                  flush=True)

    # the kernel path against the composed PyTorch path at full width
    plain = STEGCN(N_FEAT, HIDDEN, N_CLASS, 2, X, adj, dropout_p=0.5,
                   fused=False, symmetric=True, device="cuda")
    with torch.no_grad():
        det = {k: v.detach() for k, v in final.items()}
        f_k = model.apply(det, None)
        f_p = plain.apply(det, None)
    if f_k.shape != (N_NODES, N_CLASS) or not torch.isfinite(f_k).all():
        raise AssertionError("model output has the wrong shape or NaNs")
    rel = float((f_k - f_p).norm() / f_p.norm())
    if rel > 2e-2:
        raise AssertionError(f"kernel path vs composed path: rel {rel}")
    print(f"full-width output vs composed path: relative error {rel:.3e}",
          flush=True)
    return {"run_s": run_s, "run_launches": run_launches,
            "run_launches_by_step": by_step, "steps": steps,
            "losses": losses, "neg_margliks": nms, "output_rel_err": rel}


def phase_small_reference(torch, np):
    """-log marglik and its d/d adj on a small graph: the kernel path in
    float32 on the card against the float64 CPU path (which the CPU tests
    hold to the JAX package)."""
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.training.marglik_gnn import make_neg_marglik_fn

    rng = np.random.default_rng(2)
    n, f = 96, 24
    X = rng.standard_normal((n, f))
    adj = (rng.random((n, n)) < 0.08).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, N_CLASS, n)
    vals = {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = STEGCN(f, 16, N_CLASS, 2, X, adj, dropout_p=0.0, fused=True,
                   symmetric=True, device=dev, dtype=dt,
                   generator=torch.Generator().manual_seed(0))
        fn = make_neg_marglik_fn(m, "classification", "kron", "all", N=40)
        idx = torch.arange(40, device=dev)
        vals[dev] = float(fn(m.params(), idx, torch.as_tensor(
            y[:40], device=dev)).detach())
    rel = abs(vals["cuda"] - vals["cpu"]) / abs(vals["cpu"])
    if not math.isfinite(vals["cuda"]) or rel > 1e-2:
        raise AssertionError(f"small marglik: {vals}")
    print(f"small-graph -log marglik: card {vals['cuda']:.6f} vs CPU f64 "
          f"{vals['cpu']:.6f} (relative {rel:.2e})", flush=True)
    return vals


def gat_graph(torch, n: int, seed: int):
    """Symmetric Erdos-Renyi graph of density GAT_DENSITY without
    self-loops (the model adds them), features and labels, made on the
    card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand(n, n, generator=g, device="cuda") < GAT_DENSITY
    adj = (a | a.T).to(torch.float32)
    del a
    adj.fill_diagonal_(0.0)
    X = torch.randn(n, GAT_D, generator=g, device="cuda")
    y = torch.randint(0, GAT_CLASSES, (n,), generator=g, device="cuda")
    return X, adj, y


def flash_bound(n, r, heads, f, nnz, adj_bytes, bw, backward):
    """(bound ms, what bounds it): the bytes each input is read and each
    output written once, against the float32 operations (exponentials
    counted as one) that the nnz * heads (edge, head) pairs of this run
    need."""
    vec = 4 * (n * heads + r * heads + n * heads * f)     # a_src, a_dst, h
    if backward:     # + g, m, linv, D in; d_a_src, d_a_dst, d_h out
        nbytes = adj_bytes + vec + 4 * (r * heads * f + 3 * heads * r
                                        + n * heads + r * heads
                                        + n * heads * f)
        ops = nnz * heads * (4 * f + 14)
    else:            # out, m, l out
        nbytes = adj_bytes + vec + 4 * (r * heads * f + 2 * heads * r)
        ops = nnz * heads * (2 * f + 9)
    t_bytes, t_ops = nbytes / bw, ops / FP32_PEAK
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def phase_flash_kernels(torch, np, fa, bw):
    """Both flash kernels against their plain versions at the GAT path's
    shapes, timed beside the plain versions and the composed chunked
    attention. Tolerances: float32 results within 1e-4 of the largest
    reference entry (the kernels sum in another order: an online softmax
    with rescaling, and float32 atomics for d_a_dst; m is a max and comes
    out exact); bf16 operands within 2^-7 of it."""
    from laplace_gnn_torch.models.layers import _masked_attention_chunked
    rows, max_err = [], {"flash_fwd": 0.0, "flash_bwd": 0.0}
    cases = []
    for n in (GAT_N_KERNEL, GAT_N_TRAIN):
        for f in (GAT_HIDDEN // GAT_HEADS, GAT_CLASSES // GAT_HEADS):
            cases.append(("main", n, n, f, "float32", None))
    cases += [("int8_mask", GAT_N_KERNEL, GAT_N_KERNEL, 8, "int8", None),
              ("bf16", GAT_N_KERNEL, GAT_N_KERNEL, 8, "float32", "bfloat16"),
              ("row_shard", GAT_N_KERNEL, GAT_N_KERNEL // 3, 8, "float32",
               None)]
    graphs = {}
    for case, n, r, f, mask_t, attn in cases:
        if n not in graphs:
            graphs.clear()
            torch.cuda.empty_cache()
            _, adj, _ = gat_graph(torch, n, seed=3)
            adj.fill_diagonal_(1.0)          # GAT's self-loops
            graphs[n] = adj
        adj = graphs[n][:r]
        if case == "row_shard":       # and a target row with no neighbour
            adj = adj.clone()
            adj[ISO_ROW] = 0.0
        mask = (adj > 0).to(torch.int8) if mask_t == "int8" else adj
        mask = mask.contiguous()
        g = torch.Generator(device="cuda").manual_seed(n + f)
        H = GAT_HEADS
        a_src = torch.randn(n, H, generator=g, device="cuda")
        a_dst = torch.randn(r, H, generator=g, device="cuda")
        h = torch.randn(n, H, f, generator=g, device="cuda")
        gout = torch.randn(r, H, f, generator=g, device="cuda")
        tol = 2.0 ** -7 if attn else 1e-4
        got = fa.flash_fwd(a_src, a_dst, mask, h, 0.2, attn)
        want = fa.flash_fwd_reference(a_src, a_dst, mask, h, 0.2, attn)
        got_b = fa.flash_bwd(a_src, a_dst, mask, h, gout, *want, 0.2, attn)
        want_b = fa.flash_bwd_reference(a_src, a_dst, mask, h, gout, *want,
                                        0.2, attn)
        torch.cuda.synchronize()
        errs = {}
        for kern, pairs in (("flash_fwd", zip(("out", "m", "l"), got, want)),
                            ("flash_bwd", zip(("d_a_src", "d_a_dst", "d_h"),
                                              got_b, want_b))):
            for name, x, y in pairs:
                err = float((x - y).abs().max())
                scale = float(y.abs().max())
                if not (bool(torch.isfinite(x).all())
                        and err <= tol * scale + 1e-6):
                    raise AssertionError(f"{kern} {case} n={n} f={f}: {name} "
                                         f"max err {err} (scale {scale})")
                errs[f"{kern}.{name}"] = err
                if attn is None:
                    max_err[kern] = max(max_err[kern], err)
        if case == "row_shard" and not (
                float(got[0][ISO_ROW].abs().max()) == 0.0
                and float(got[2][:, ISO_ROW].abs().max()) == 0.0
                and float(got_b[1][ISO_ROW].abs().max()) == 0.0):
            raise AssertionError("a row with no neighbour must give out = 0, "
                                 "l = 0 and d_a_dst = 0")
        nnz = int((adj > 0).sum())
        adj_bytes = r * n * mask.element_size()
        # the composed path: the chunked attention and its autograd backward
        xs = [t.clone().requires_grad_(True) for t in (a_src, a_dst, h)]
        with torch.no_grad():
            comp_fwd = cold_ms(torch, lambda: _masked_attention_chunked(
                a_src, a_dst, mask, h, 0.2, 512, attn), reps=3)
        out_c = _masked_attention_chunked(xs[0], xs[1], mask, xs[2], 0.2, 512,
                                          attn)
        comp_bwd = cold_ms(torch, lambda: torch.autograd.grad(
            out_c, xs, gout, retain_graph=True), reps=3)
        del out_c
        for kern in ("flash_fwd", "flash_bwd"):
            bwd = kern == "flash_bwd"
            if bwd:
                run = lambda: fa.flash_bwd(a_src, a_dst, mask, h, gout, *want,
                                           0.2, attn)
                plain = lambda: fa.flash_bwd_reference(
                    a_src, a_dst, mask, h, gout, *want, 0.2, attn)
            else:
                run = lambda: fa.flash_fwd(a_src, a_dst, mask, h, 0.2, attn)
                plain = lambda: fa.flash_fwd_reference(a_src, a_dst, mask, h,
                                                       0.2, attn)
            bound, by = flash_bound(n, r, H, f, nnz, adj_bytes, bw, bwd)
            rows.append({
                "kernel": kern, "case": case, "n": n, "r": r, "heads": H,
                "f": f, "adj": mask_t, "attn_dtype": attn, "nnz": nnz,
                "ms": cold_ms(torch, run), "plain_ms": cold_ms(torch, plain,
                                                               reps=3),
                "composed_ms": comp_bwd if bwd else comp_fwd,
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "errors": {k: v for k, v in errs.items()
                           if k.startswith(kern)}})
    graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows, max_err


def gat_model(torch, X, adj, impl, n_layers=2, **kw):
    from laplace_gnn_torch.models import GAT
    return GAT(X.shape[1], GAT_HIDDEN, GAT_CLASSES, n_layers, X, adj,
               heads=GAT_HEADS, concat=True, dropout_p=0.0,
               attention_impl=impl, device="cuda",
               generator=torch.Generator().manual_seed(0), **kw)


def gat_programs(model, n_train):
    from laplace_gnn_torch.training.marglik_gnn import TrainingPrograms
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.params().items()}
    return TrainingPrograms(
        model, params, lr=1e-2, weight_decay=5e-4, lr_adj=0.1,
        weight_decay_adj=0.0, momentum_adj=0.0, grad_norm=False,
        hessian_structure="kron", subset_of_weights="all",
        prior_precision=1.0, N=n_train)


def phase_gat_step(torch, card):
    """One GAT train step at N = 16384 through the flash kernels (median of
    5 by CUDA events, launches per step, torch.profiler busy share), beside
    the same step on the plain chunked attention."""
    from laplace_gnn_torch.ops.flash_attention import flash_bwd, flash_fwd
    n = GAT_N_KERNEL
    X, adj, y = gat_graph(torch, n, seed=4)
    idx = torch.randperm(n, generator=torch.Generator().manual_seed(0))[
        :n // 10].to("cuda")
    yy = y[idx]
    out = {}
    for impl in ("flash", None):
        model = gat_model(torch, X, adj, impl)
        progs = gat_programs(model, int(idx.shape[0]))
        step = lambda: progs.train_step(idx, yy)
        step()
        torch.cuda.synchronize()
        flash_fwd.launches = flash_bwd.launches = 0
        ms = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            step()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        launches = (flash_fwd.launches / 5, flash_bwd.launches / 5)
        if impl == "flash" and launches != (2, 2):
            raise AssertionError(f"flash GAT train step launched {launches} "
                                 "(forward, backward) kernels, not (2, 2)")
        if impl is None and launches != (0, 0):
            raise AssertionError("the plain GAT step launched a kernel")
        prof = profile_step(torch, step)
        step_ms = sorted(ms)[2]
        prof["busy_share"] = prof["device_ms"] / step_ms
        name = "flash" if impl else "plain_chunked"
        out[name] = {"ms": step_ms, "ms_all": ms, "launches": launches,
                     "profile": prof}
        print(f"GAT train step N={n} ({name}): median {step_ms:.3f} ms over "
              f"5 (CUDA events), flash launches (fwd, bwd) {launches}; "
              f"profiled kernels {prof['device_ms']:.3f} ms in "
              f"{prof['n_kernels']} launches, busy share "
              f"{prof['busy_share']:.2f}  [{card}]", flush=True)
        for r in prof["top"]:
            print(f"  {r['ms']:8.3f} ms x{r['count']:<4d} {r['name']}",
                  flush=True)
        del model, progs
    del X, adj
    torch.cuda.empty_cache()
    return out


def phase_gat_trainer(torch, np, fa, card):
    """The slice's main path: marglik_optimization(model_type="gat") on the
    flash kernels at N = 2708 for 4 epochs."""
    from laplace_gnn_torch.ops.fused_spmm import core
    from laplace_gnn_torch.training.marglik_gnn import (
        TrainingPrograms, marglik_optimization)
    n = GAT_N_TRAIN
    X, adj, y = gat_graph(torch, n, seed=5)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    tr, va = perm[:N_TRAIN].to("cuda"), perm[N_TRAIN:N_TRAIN + N_VAL].to(
        "cuda")
    model = gat_model(torch, X, adj, "flash")
    params = model.params()
    kernels = (fa.flash_fwd, fa.flash_bwd, core)
    methods = ("train_step", "neg_marglik_eval", "val_metrics")
    by = {m: {k.name: 0 for k in kernels} for m in methods}

    def counted(name):
        method = getattr(TrainingPrograms, name)

        def run_counted(self, *args, **kwargs):
            before = [k.launches for k in kernels]
            out = method(self, *args, **kwargs)
            for k, b in zip(kernels, before):
                by[name][k.name] += k.launches - b
            return out
        return run_counted

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(TrainingPrograms, "train_step",
                           counted("train_step")), \
            mock.patch.object(TrainingPrograms, "neg_marglik_eval",
                              counted("neg_marglik_eval")), \
            mock.patch.object(TrainingPrograms, "val_metrics",
                              counted("val_metrics")):
        _, final, losses, val_losses, nms = marglik_optimization(
            model, params, tr, y[tr], va, y[va], n_epochs=4, lr=1e-2,
            weight_decay=5e-4, model_type="gat", verbose=False,
            device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    if not all(math.isfinite(v) for v in losses + val_losses + nms):
        raise AssertionError(f"non-finite GAT trace: {losses} {nms}")
    if not torch.equal(final["adj"], params["adj"]):
        raise AssertionError("GAT's adjacency changed")
    for kern in ("flash_fwd", "flash_bwd"):
        if by["train_step"][kern] == 0:
            raise AssertionError(f"the GAT train steps launched no {kern}")
        if by["neg_marglik_eval"][kern] != 0:
            raise AssertionError(f"the -log marglik evaluation launched "
                                 f"{kern}: jvp_safe did not route around it")
    if by["val_metrics"]["flash_fwd"] == 0:
        raise AssertionError("the validation forwards launched no flash_fwd")
    print(f"GAT trainer: 4 epochs at N={n} in {run_s:.3f} s (host clock), "
          f"launches {launches}, by step {by}; losses {losses}; "
          f"neg-margliks {nms}  [{card}]", flush=True)

    # one -log marglik evaluation: wall time and peak memory
    progs = gat_programs(model, N_TRAIN)
    progs.neg_marglik_eval(tr, y[tr])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    nm = progs.neg_marglik_eval(tr, y[tr])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"GAT -log marglik evaluation at N={n}: {eval_s:.3f} s (host "
          f"clock), peak memory {peak_gb:.3f} GB above the "
          f"{base / 1e9:.3f} GB already allocated, value {float(nm):.6f}  "
          f"[{card}]", flush=True)
    del model, progs, X, adj
    torch.cuda.empty_cache()
    return {"run_s": run_s, "run_launches": launches,
            "run_launches_by_step": by, "losses": losses,
            "val_losses": val_losses, "neg_margliks": nms,
            "neg_marglik_eval_s": eval_s, "neg_marglik_peak_gb": peak_gb}


def phase_gat_small_reference(torch, np):
    """One train step's weight gradients (kernel path, float32, on the card)
    and the GAT -log marglik (jvp_safe path, float32) against the float64
    CPU path, which the CPU tests hold to the JAX package."""
    from laplace_gnn_torch.models import GAT
    from laplace_gnn_torch.training.marglik_gnn import (_ce_mean,
                                                        make_neg_marglik_fn)
    rng = np.random.default_rng(6)
    n, f = 96, 24
    X = rng.standard_normal((n, f))
    adj = (rng.random((n, n)) < 0.08).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, GAT_CLASSES, n)
    grads, vals = {}, {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = GAT(f, 16, GAT_CLASSES, 2, X, adj, heads=GAT_HEADS, concat=True,
                dropout_p=0.0, attention_impl="flash", device=dev, dtype=dt,
                generator=torch.Generator().manual_seed(0))
        p = {k: v.detach().requires_grad_(k != "adj")
             for k, v in m.params().items()}
        idx = torch.arange(40, device=dev)
        yy = torch.as_tensor(y[:40], device=dev)
        loss = _ce_mean(m.apply(p, idx, train=True), yy)
        names = [k for k in p if k != "adj"]
        grads[dev] = dict(zip(names, torch.autograd.grad(
            loss, [p[k] for k in names])))
        fn = make_neg_marglik_fn(m, "classification", "kron", "all", N=40)
        vals[dev] = float(fn({k: v.detach() for k, v in p.items()}, idx,
                             yy).detach())
    rel = {k: float((grads["cuda"][k].double().cpu() - g).norm() / g.norm())
           for k, g in grads["cpu"].items()}
    worst = max(rel.values())
    if worst > 1e-4:
        raise AssertionError(f"GAT weight gradients on the card: {rel}")
    nm_rel = abs(vals["cuda"] - vals["cpu"]) / abs(vals["cpu"])
    if not math.isfinite(vals["cuda"]) or nm_rel > 1e-3:
        raise AssertionError(f"small GAT marglik: {vals}")
    print(f"small GAT: train-step weight gradients on the card vs CPU f64, "
          f"worst relative error {worst:.2e}; -log marglik card "
          f"{vals['cuda']:.6f} vs CPU f64 {vals['cpu']:.6f} (relative "
          f"{nm_rel:.2e})", flush=True)
    return {"grad_rel": rel, "neg_marglik": vals, "neg_marglik_rel": nm_rel}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "laplace_gnn_torch")):
        return fail("laplace_gnn_torch is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    from laplace_gnn_torch.ops import cuda_build
    from laplace_gnn_torch.ops import flash_attention as fa
    from laplace_gnn_torch.ops import fused_spmm as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    peak_name, peaks = card_peaks(card)
    print(f"card: {card}  (peaks used for bounds: {peak_name}, "
          f"{peaks[0] / 1e12:g} TB/s, {peaks[1] / 1e12:g} TFLOP/s bf16)",
          flush=True)

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    report = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(report) or 'nothing (cached)'}", flush=True)
    for name, (secs, log) in report.items():
        # the full ptxas report goes to a file; one line per source here
        with open(os.path.join(out_dir, f"build_{name}.log"), "w") as f:
            f.write(log)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(x) for x in
                     re.findall(r"(\d+) bytes spill stores", log))
        print(f"  {name}: {secs:.1f} s, {len(regs)} kernels, "
              f"{min(regs, default=0)}-{max(regs, default=0)} registers, "
              f"{spills} bytes of spill stores", flush=True)

    rows, max_err = phase_kernel(torch, np, fs, peaks)
    for r in rows:
        print("core_spmm " + json.dumps(r), flush=True)
    small = phase_small_reference(torch, np)
    run = phase_trainer(torch, np, card)

    flash_rows, flash_err = phase_flash_kernels(torch, np, fa, peaks[0])
    for r in flash_rows:
        print(f"{r['kernel']} " + json.dumps(r), flush=True)
    gat_step = phase_gat_step(torch, card)
    gat_run = phase_gat_trainer(torch, np, fa, card)
    gat_small = phase_gat_small_reference(torch, np)

    main_row = rows[0]                  # d = 64, forward: the widest call
    kernels = [{
        "name": fs.core.name, "route": "cuda", "source": fs.core.source,
        "replaces": "laplace_gnn_tpu/ops/pallas_spmm.py:43",
        "launches": run["run_launches"], "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]
    for kern, replaces in ((fa.flash_fwd,
                            "laplace_gnn_tpu/ops/pallas_attention.py:59"),
                           (fa.flash_bwd,
                            "laplace_gnn_tpu/ops/pallas_attention.py:235")):
        # the kernels' own size: N = 16384, layer 0 (H = 8, F = 8), f32 mask
        r = next(x for x in flash_rows if x["kernel"] == kern.name
                 and x["case"] == "main" and x["n"] == GAT_N_KERNEL
                 and x["f"] == 8)
        kernels.append({
            "name": kern.name, "route": "cuda", "source": kern.source,
            "replaces": replaces,
            "launches": gat_run["run_launches"][kern.name],
            "max_abs_err": flash_err[kern.name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "peaks": peak_name,
                   "core_spmm": rows, "trainer": run, "small": small,
                   "flash": flash_rows, "gat_step": gat_step,
                   "gat_trainer": gat_run, "gat_small": gat_small,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
