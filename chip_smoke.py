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
     and against the float64 CPU path on a small graph.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result, when there is no CUDA device or the package is not beside it.
Per-shape measurements also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

N_NODES, N_FEAT, HIDDEN, N_CLASS = 2708, 1433, 64, 7   # Cora's width
DENSITY = 10556 / (2708 * 2708)                        # Cora's edge density
N_TRAIN, N_VAL = 140, 500

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
    256 MB write that evicts the 50 MB L2 and keeps the card busy while the
    host enqueues ``fn`` (CUDA events around the call alone)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "laplace_gnn_torch")):
        return fail("laplace_gnn_torch is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    from laplace_gnn_torch.ops import cuda_build
    from laplace_gnn_torch.ops import fused_spmm as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_info()
    kind = torch.cuda.get_device_name(0)
    peak_name, peaks = card_peaks(card)
    print(f"card: {card}  (peaks used for bounds: {peak_name}, "
          f"{peaks[0] / 1e12:g} TB/s, {peaks[1] / 1e12:g} TFLOP/s bf16)",
          flush=True)

    t0 = time.perf_counter()
    report = cuda_build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(report) or 'nothing (cached)'}", flush=True)
    for name, (secs, log) in report.items():
        print(f"  {name}: {secs:.1f} s\n{log.strip()}", flush=True)

    rows, max_err = phase_kernel(torch, np, fs, peaks)
    for r in rows:
        print("core_spmm " + json.dumps(r), flush=True)
    small = phase_small_reference(torch, np)
    run = phase_trainer(torch, np, card)

    main_row = rows[0]                  # d = 64, forward: the widest call
    kernels = [{
        "name": fs.core.name, "route": "cuda", "source": fs.core.source,
        "replaces": "laplace_gnn_tpu/ops/pallas_spmm.py:43",
        "launches": run["run_launches"], "max_abs_err": max_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "peaks": peak_name,
                   "core_spmm": rows, "trainer": run, "small": small,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
