#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``laplace_gnn_torch``) on one CUDA GPU.

    python3 chip_smoke.py                   # every phase: the port's proof
    python3 chip_smoke.py --only matmul     # build + phase 7, kernel work
    python3 chip_smoke.py --only core_spmm  # build + phase 2, kernel work
    python3 chip_smoke.py --only flash      # build + phase 4, kernel work
    python3 chip_smoke.py --only sparse     # phase 18 alone, no build
    python3 chip_smoke.py --only parallel   # build + phases 19 and 20
    python3 chip_smoke.py --only examples   # build + phase 21
    python3 chip_smoke.py --only small_eigh # build + phase 22, kernel work
    python3 chip_smoke.py --only gat_attention  # build + phase 23
    python3 chip_smoke.py --only spmm       # build + phase 24

Phases, each fatal:
  1. build every CUDA kernel of the port from ``laplace_gnn_torch/csrc``;
  2. hold the ``core_spmm`` kernel against its plain PyTorch version at the
     main paths' shapes (CORE_CASES: the trainer's N = 2708 with d = 64 and
     7, plain and transposed; the hyperstep pullback's folded d = 49 and
     448, transposed; the Jacobians' folded d = 12250, 112000 and 28000
     (hidden 16); GCN's int8 at N = 2708 and 16384, raw f32, and the raw
     f32 row chunks of the GCN-res diagonal hyperstep, d = 23296, both
     ways) and time it cold with
     CUDA events beside the plain version, torch.matmul on the
     pre-binarized matrix (f32; bf16 too at the wide widths) and its bound
     on this card, the trainer's shapes also warm; then check, untimed, the
     edge cases of CORE_CHECKS (N = 2707 and 40, offset views of A and t,
     d = 1, 65, 129, bf16 t, transposed raw and int8); every call is
     repeated and must give the same bits;
  3. run the STE-GCN marglik trainer (``marglik_optimization``, fused
     kernel path, symmetric, type-2 KFAC through the vmapped pullback) at
     Cora's width on a synthetic Cora-shaped graph for a few epochs with
     two hyperstep rounds, with the kernel's
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
     backward); then check, untimed, the edge cases of FLASH_CHECKS (N =
     2707 and 40, offset views, H = 1, 3, 16 and 256, F = 5 and 64, bf16,
     a banded graph, underflowing scores, a row shard); m must be exact
     and every call is repeated and must give the same bits;
  5. time one GAT train step at N = 16384 (d = 64, hidden 64, 8 heads,
     concat, 8 classes, Erdos-Renyi density 14e-4) through the kernels, with
     its launches (2 forward + 2 backward) and profile (device launches,
     the flash kernels' device time by kernel name), beside the same step
     on the plain chunked attention;
  6. run the GAT marglik trainer (``model_type="gat"``, flash kernels) at
     N = 2708 for 4 epochs with every launch counter set to 0 just before
     and read just after, counting the launches inside train steps,
     -log marglik evaluations (0: they run the ``jvp_safe`` clone) and
     validation forwards; time one -log marglik evaluation and its peak
     memory; check one train step's weight gradients and the -log marglik
     on a small graph against the float64 CPU path;
  7. hold the blocked ``matmul`` kernel against its plain version at the
     shapes of the product it was written for ((2708, 2708) @ (2708, 64)
     and (16384, 16384) @ (16384, 64), f32 and bf16), of the slice's
     largest product (``KronDecomposed._bmm`` on layer 0 for 542 x 7 rows:
     (242816, 1433) @ (1433, 1433), f32), a ragged case and two alignment
     cases (a view that starts one element into its buffer; K = 1433 in
     bf16), timed beside the plain version and ``torch.matmul`` (cuBLAS)
     with its bound, its split-K and its copy width, and the 16384 shapes
     again on the 64 x 64 tile (hint ``bm=64``); then check, untimed,
     the edge cases K = 1, M < 16, a split-K product and a view ``a[1:]``;
  8. evaluate the phase-3 STE-GCN (fused kernel path) as the experiment
     experiment does after training: ``fit_laplace``, the log marglik,
     ``evaluate_map``, the probit GLM predictive on 1000 further nodes (its
     vmapped Jacobians and the functional variance also timed apart) and
     ``mc_eval(pred_type="nn", n_samples=100)``, each with its time, peak
     memory and ``core_spmm`` launches (counts set to 0 just before each
     part), and the Jacobians' device time by kernel name (one more pass
     under torch.profiler); check the log marglik and probit probabilities
     on a small graph against the float64 CPU path;
  9. the same for the phase-6 GAT at N = 2708: ``fit_laplace`` (0 flash
     launches), the log marglik, ``mc_eval(pred_type="nn", n_samples=20)``
     (40 ``flash_fwd`` launches) and the probit GLM predictive on 100
     nodes;
 10. run the experiment entry point (``training/experiment.py::main``) as
     a user does, on a Cora-shaped synthetic npz dataset with a k-NN initial
     graph and the Cora STE-GCN config cut to 6 epochs (``fused=False``,
     as the JAX package runs it: no kernel launches), then again for 2
     epochs with ``--fisher_type type-2-sketch --sketch_size 4
     --column_chunk 2 --fisher_seed 3``, then for 2 epochs with
     ``--model_type lorastegcn --lora_r 16 --hessian_structure diag``, and
     check that each writes its stats;
 11. curvature: one hyperstep of the phase-3 STE-GCN per option of
     CURVATURE_OPTIONS (type-2 with ``column_chunk`` None and 2,
     type-2-fork, type-2-sketch with k = 4, mc with 2 samples, empirical,
     forward-only, ``kfac_approx="reduce"``, ``hessian_structure="diag"``)
     and one on the column loop that the vmapped pullback replaced
     (patched in), each with its wall ms (median of 5, CUDA events), device
     ms and device launches (torch.profiler), ``core_spmm`` launches and
     peak memory; the vmapped type-2 must launch fewer kernels than the
     loop and agree with it; then every option and
     ``hessian_structure="full"`` on a small graph against the float64 CPU
     path with the same draws (1e-2 relative); then the phase-6 GAT's
     -log marglik at N = 2708 with ``diag_probes`` 8 (``probe_batch`` None
     and 4), timed with its peak memory beside the exact blocks', two
     calls to the same bits and no flash launch;
 12. the other dense models at Cora's width on the phase-3 synthetic graph
     (DENSE_MODELS: GraphSAGE with and without a 5-neighbour sample,
     STEGraphSAGE, LoRA-STE-GCN r 16, AttSTEGCN d_k 8, STEGCN fused with
     layer and batch norms, GCN fused with residual Linears and STEGCN
     with residual Linears, the last two with the "diag" structure):
     ``marglik_optimization`` for 4 epochs (1 burn-in, one round of 2
     hypersteps; none for GraphSAGE and GCN), each with its wall time,
     peak memory and ``core_spmm`` launches, one train step and one
     hyperstep timed; finite parameters, LoRA's hypersteps moving
     ``adj_lora_*`` and not ``adj``; then each model's train-mode loss,
     weight gradients and -log marglik on a small graph against the
     float64 CPU path (1e-2 for the fused kernel's entries, 1e-4 for the
     composed ones);
 13. the Laplace flavours: DiagLaplace on the phase-3 STE-GCN (hidden 64,
     P = 92231) and FullLaplace on an STE-GCN of hidden 16 (P = 23063)
     over the same graph and learned adjacency: fit, log marglik, marglik
     tuning of the prior precision (scalar and layerwise; 100 steps for
     Diag, 5 for Full), a grid search of 20 values on the 500 validation
     nodes, the probit predictive on 1000 nodes, 100 GLM predictive
     samples and a ``state_dict`` round trip to the same bits, each part
     with its time, peak memory and launches; then each flavour's log
     marglik, tuned prior precision and probit probabilities on a small
     graph against the float64 CPU path (1e-2);
 14. the rest of the Laplace library on the phase-3 STE-GCN (hidden 64,
     its learned adjacency): last-layer Kron (``Laplace()``'s default
     key), Diag (with ``functional_variance_fast``) and Full (fit, log
     marglik, 100 steps of marglik tuning, probit on 1000 nodes); GP
     Laplace over all weights and over the last layer with n_subset 140
     (fit, log marglik, a 10-value grid search on the 500 validation
     nodes, probit and 100 predictive samples on 1000 nodes); subnetwork
     masks of 4096 parameters (largest magnitude, largest Diag variance,
     SWAG with 10 snapshots) and Full / Diag subnetwork Laplace on the
     first two (fit, log marglik, probit, ``sample(100)``);
     ``marglik_training`` with the adjacency fixed (layerwise prior,
     Kron, 20 epochs, 5 of burn-in, 10 hypersteps every 5 epochs), its
     marglik not falling and its refit; then Kron and last-layer Kron on
     a LeNet-shaped CNN at MNIST's shape (fit on 1024 synthetic images,
     probit on 256). Each part with its time, peak memory and launches;
     then every flavour and ``marglik_training`` on a small graph, and
     Kron on a small CNN, against the float64 CPU path;
 15. the curvature engine on the phase-3 graph and learned adjacency:
     on the composed STE-GCN (``fused=False``, hidden 64, P = 92,231) a
     GGN matvec and 10-column matmat, a Hessian and an EF matvec,
     LowRank Laplace of rank 10 (fit, log marglik, 100 steps of marglik
     tuning), the Lanczos spectral density (ncv 64), Hutchinson's trace
     and diagonal (16 probes), 20 CG iterations on GGN + prior, 20 LSMR
     iterations (damp 1) on the Jacobian and one activation-Hessian
     matvec at the last tap site (N x C = 18,956 dims); LowRank at hidden
     16 (P = 23,063): the probit predictive on 1000 nodes and 100 samples
     (the dense covariance); on the fused STE-GCN, LowRank's fit must
     raise, and the transposed-Jacobian matvec, the Kron fit and the KFAC
     inverse (plain, heuristic, exact; one matvec each) run through
     ``core_spmm``, and the fused J^T u is held against the composed
     path, that path run with the kernel's bf16 operands, and that path
     given the kernel's ReLU masks (``_jt_witness``). Each part with its
     time, peak memory and launches;
     then the same parts on a small graph against the float64 CPU path
     (1e-4 relative for the composed parts, 1e-2 through the kernel);
 16. the whole run (``marglik_optimization_scan``) in bench.py's
     ``bench_full_train`` configuration (200 epochs, 7 hyper phases of 10
     hypersteps, burn-in 50, lr 1e-3, lr_adj 0.8, grad_norm) on the
     phase-3 graph at Cora's width, with ``fused=False`` and
     ``fused=True``: a cold call (the build, warm-up and CUDA-graph
     capture of the program), a warm call that must hit the model's
     program cache, the eager ``marglik_optimization`` on the same inputs
     (traces within 1e-5 relative, the same best epochs, the final
     adjacency within 1e-6), what was captured, ``core_spmm``'s launches
     (per call of each step, replayed from a graph or called from Python)
     and one warm run under torch.profiler (device time, busy share,
     device launches); whether ``torch.linalg.eigvalsh`` can be captured
     (in a process of its own); a 16-epoch dropout run and a 20-epoch run
     with learned-graph snapshots against the eager loop (the files
     deleted after); then on a small graph the card in float32 against
     the CPU in float64, a run captured while a dead run's graphs await
     collection (a collection forced at each capture's start), and the
     diagonal curvature (every step captured) against the eager loop;
 17. hold ``core_spmm`` against its plain version, untimed, at every
     (N, d, adjacency mode, t dtype, transpose) that phases 2-16 launched
     and no earlier check covered (each launch's shape is recorded as it
     is made), so no plan that the run chose goes unchecked; it comes
     after every phase that launches the kernel;
 18. the sparse scale path, whose SpMMs launch the ``spmm`` kernel
     (phase 24) and which reaches no other kernel of the four: the C++
     graph packer must have built; the SpMM of ``FastAggGraph`` on each
     tier (segment, ELL, ELL + overflow levels + remainder) in float32
     and bf16, forward, backward, vmap and jvp against the dense float64
     product, two calls the same bits, and the ELL GAT attention against
     the segment path, on small graphs; then an ogbn-arxiv-shaped npz
     (169,343 nodes, 128 features, 40 classes, ~1.17 M undirected edges
     with three hubs of ~11.7k) at the width of
     scripts/bench_laplace_scale.py (hidden 256, 2 layers): the full-size
     SpMM (two calls and two backward calls the same bits, against the
     float64 segment path, timed), then ``sparse_experiment.main`` as a
     user runs it: SparseGCN for 400 steps at the CLI's defaults
     (last-layer Kron, ELL, bf16 aggregation), the same in two
     checkpointed halves of 200 (the resumed run's NLLs within 1e-5 of
     the straight run's), SparseGCN over all weights with a type-2 sketch
     of 8 in chunks of 4 columns (50 steps), SparseSAGE (100 steps) and
     SparseGAT over all weights with the mc Fisher and 2 Hutchinson
     probes a batch of 2 (50 steps),
     each with its K, levels and remainder, its train-step ms (CUDA
     events), fit-and-tuning and predictive seconds, peak memory and the
     four kernels' launches (0); and whether SparseGAT's weight gradient
     is the same bits twice;
 19. the single-axis scale-out layer (``laplace_gnn_torch/parallel``) on
     a real NCCL group of world size ``torch.cuda.device_count()`` (one
     card: 1), joined through ``parallel.initialize`` on a free local
     port and destroyed after: (a) GAT at N = 16384 on the row-sharded
     flash attention against the unsharded flash attention (one step to
     the same bits, then 20 steps each by CUDA events with peak memory
     and the flash launches, which must be 2 + 2 a step), and a GAT Kron
     hyperstep at N = 2708 through ``jvp_safe()`` (the plain twin; the
     -log marglik within 1e-3 of the unsharded one, d/d adj zero); (b)
     P = 4 row blocks (R = 4096) on the one card, each rank's body with
     a_src and h gathered by hand, against the unsharded flash call
     (rows and summed gradients within 1e-4 of the largest entry), each
     block's kernels against their plain versions (``flash_check``), the
     pair timed at R = 4096 beside the plain versions and the bound; (c)
     SparseGCN at ogbn-arxiv's shape through HaloAggGraph (the local path
     at one part), its train step timed; RCM order, edge-balanced blocks
     padded to one width, both halo plans and every rank's body against
     the whole SpMM (1e-5, twice the same bits), each schedule's
     rows that cross (JAX's comm_volume_ratio: the bodies return their
     blocks) and the projected scaling at 2 / 4 / 8 GPUs from the
     measured SpMM; the halo GAT's P = 4 bodies on a 4096-node cut; (d)
     ``make_sharded_train_step`` on STE-GCN at Cora's width, fused
     (``core_spmm``, launches counted; it keeps the square adjacency, so
     its sharded step is the unsharded step on each rank) and composed
     (on the rank's row block), 10 steps each the same bits as a plain
     autograd SGD step written here; the composed Kron hyperstep on the
     row block the same bits as the unsharded one; and an AttSTEGCN Kron
     hyperstep with ``adj_constraint`` (value and d/d adj_W within 1e-4
     of the unsharded ones). Every kernel's count, ``matmul``'s too, is
     set to 0 before the parts and read after;
 20. per-rank memory and the DCN bodies, after phase 19's group is
     destroyed: (a) rank 0 of a 4-rank fake group
     (``torch.testing._internal.distributed.fake_pg``, its collectives
     move nothing, every tensor has its real shape; the mesh takes it
     only with ``allow_fake=True``) against the unsharded step, peak
     bytes above the step's start by ``torch.cuda.max_memory_allocated``:
     the composed STE-GCN Kron hyperstep at
     ``scripts/shard_scale_bench.py``'s size (N = 8192, d = 32, hidden
     32, 7 classes, density 14e-4, 1024 train nodes, f32; the ratio must
     be at least 3.0) and the SparseGCN train step on the padded
     arxiv-shaped graph (with the features each rank holds); (b) the DCN
     bodies at (dcn, graph) = (2, 2) rank by rank on the card against the
     unsharded SpMM and GAT edge softmax (1e-5), with the halo and
     dcn_psum rows. No kernel is on these paths but the ``spmm`` kernel of
     the unsharded SpMMs they are held to;
 21. the examples (``examples/torch/``), the port's user entry points, as
     a user runs them: 01, 06, 03, 07, 08, 12, 09, 02, 13, 04 and 10 (one
     process, a one-rank NCCL group), each through ``main(["--device",
     "cuda"])`` in this process, with its wall seconds and every kernel's
     launches (counts set to 0 just before and read just after), its
     output in ``chiprun_out/examples/``, the markers the JAX examples'
     tests assert and the example's own checks (01's wider std in the gap
     and marglik not falling in tuning, finite -log marglik traces,
     predictive rows summing to 1 within 1e-5); the flash pair must launch
     in example 13, and is then held against its plain versions at every
     shape that example launched it with (``flash_check``). Examples 05
     (scikit-learn) and 11 (matplotlib) need packages this machine lacks:
     the phase prints that they were not run, and why; the CPU tests run
     them;
 22. (run right after phase 2) the small eigensolver
     (``csrc/small_eigh.cu``) at the main path's shapes, (2, 64, 64) and
     (1, 7, 7) in f32: values against the plain version in float64 and
     the Jacobi vectors' residual, timed cold beside the plain version
     (the CPU) and ``torch.linalg.eigvalsh`` on the card; then n = 1, 2,
     31, 32, 33, 65, 127, 128 in f32 and f64 at batches 1-4 (one matrix
     with exactly repeated eigenvalues), the zero matrix, and a
     non-finite input that must set the failure flag. Phase 16 requires
     every step of both whole runs captured and counts the solver's
     launches in the warm call;
 23. (run right after phase 22) the sparse GAT attention kernel pair
     (``csrc/gat_attention.cu``) against its plain version on the card:
     small edge cases (split hub rows and sources, a self-loop-only node,
     a node without edges; bf16, f32 and f64 payloads), then the
     ``sparsegat-arxiv`` cell's shapes (H 3 of F 250 and 40, bf16), two
     calls the same bits, one launch of each entry a call, each direction
     timed cold beside the benchmark's bound, the plain version and the
     composed ELL body; then a SparseGAT training step at the cell's
     widths, whose every layer must take the kernels (``gat.kernel`` ==
     ``gat.calls``) and whose gradient must come out the same bits twice;
 24. (run right after phase 23) the sparse SpMM kernel
     (``csrc/spmm.cu``) against the float64 product of the operands it
     reads and against the plain route: small edge cases (a hub split into
     ten chunks, nodes without edges; bf16, f32 and f64 operands, d = 1 to
     1200), then the ``sparsegcn-arxiv`` cell's graph at d = 256 and 40,
     two calls the same bits, one launch a call, timed cold beside the
     benchmark's bound, the plain route and ``torch.sparse.mm``, at
     d = 256 also in slabs of 128 and 64 columns; then a SparseGCN
     training step at the cell's widths and a last-layer Kron fit with its
     prior tuning and an MC predictive, each of whose SpMMs must launch
     the kernel (``spmm.kernel`` == ``spmm.calls``), and two training
     steps the same gradient bits.

Every phase prints its seconds. Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. With ``--only matmul``
it runs phases 1 (``matmul.cu`` alone) and 7, and its last line is
``{"partial": ["matmul"]}``, never the ``ok`` line; ``--only
core_spmm`` likewise runs phases 1 (``core_spmm.cu`` alone) and 2, and
``--only flash`` phases 1 (``flash_attention.cu`` alone) and 4, and
``--only sparse`` phase 18 alone (its SpMMs build ``spmm.cu`` at first
use), ``--only
parallel`` phases 1 (``core_spmm.cu`` and ``flash_attention.cu``), 19
and 20, ``--only examples`` phases 1 (``flash_attention.cu``) and 21,
``--only small_eigh`` phases 1 (``small_eigh.cu``) and 22, ``--only
gat_attention`` phases 1 (``gat_attention.cu``) and 23 (last line
``{"partial": ["gat_attention"]}``), ``--only spmm`` phases 1
(``spmm.cu``) and 24.
Exits
non-zero, with no result, when there is no CUDA device or the package is
not beside it.
Per-shape measurements also go to ``chiprun_out/chip_smoke.json``, and
each source's ptxas report to ``chiprun_out/build_<source>.log``.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

N_NODES, N_FEAT, HIDDEN, N_CLASS = 2708, 1433, 64, 7   # Cora's width
DENSITY = 10556 / (2708 * 2708)                        # Cora's edge density
N_TRAIN, N_VAL = 140, 500
FULL_HIDDEN = 16         # phase 13's FullLaplace: the experiment grid's
                         # smallest width

# dense GAT, as the JAX package's flash benchmark configures it
# (scripts/bench_gat_scale.py, BENCH_GAT.json n16384_h8)
GAT_D, GAT_HIDDEN, GAT_HEADS, GAT_CLASSES = 64, 64, 8, 8
GAT_DENSITY = 14e-4
GAT_N_KERNEL, GAT_N_TRAIN = 16384, 2708
FP32_PEAK = 67e12           # FLOP/s outside the tensor cores (H100 SXM)
ISO_ROW = 7                 # the row-shard case's target row without edges

# (memory bytes/s, dense bf16 tensor-core FLOP/s) from NVIDIA's data sheets;
# dense TF32 is half the bf16 rate on each
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


def card_state() -> str:
    """SM clock, power draw and temperature, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


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
    device time). Python's garbage collector is off during the launches:
    late in the run a collection outlasts the spin and was timed as idle
    device time (20x on one small product)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    gc.collect()
    gc.disable()
    try:
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
    finally:
        gc.enable()
    return total / reps


def _rel(a, b) -> float:
    """||a - b|| / ||b|| in float64 on the host."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm())


def profile_step(torch, fn, top: int = 8) -> dict:
    """One call of ``fn`` under torch.profiler: the device time of its GPU
    kernels (and memsets/copies), summed by kernel name (the ``top``
    longest listed), and the share of it in the ``core_spmm`` kernel."""
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
    device_ms = sum(r[1] for r in rows)
    core_ms = sum(r[1] for r in rows if "core_" in r[0])
    return {"device_ms": device_ms,
            "n_kernels": sum(r[2] for r in rows),
            "core_spmm_ms": core_ms,
            "core_spmm_share": core_ms / device_ms if device_ms else 0.0,
            "flash": [{"name": k[:70], "ms": ms, "count": c}
                      for k, ms, c in rows if "flash" in k],
            "top": [{"name": k[:70], "ms": ms, "count": c}
                    for k, ms, c in rows[:top]]}


def make_graph(np, rng):
    """Synthetic Cora-shaped graph, built the way bench.py builds one."""
    X = rng.standard_normal((N_NODES, N_FEAT), dtype=np.float32)
    adj = (rng.random((N_NODES, N_NODES)) < DENSITY).astype(np.float32)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, N_CLASS, N_NODES)
    return X, adj, y


# the core_spmm calls of the main paths, timed: (case, N, d, adjacency,
# transposes). Trainer: STE-GCN layer 1 (d = 64) and layer 2 (d = 7). The
# hyperstep's KFAC pullback: the C columns folded into the feature axis by
# _CoreFn's vmap rule (C x C at layer 2, C x HIDDEN at layer 1).
# Jacobians: one chunk of JAC_CHUNK test nodes x C one-hot cotangents,
# folded the same way (at hidden 64, and at phase 13's FullLaplace width).
# GCN: fused="int8" at Cora's size, "auto" at N = 16384 (where it switches
# to int8), fused=True (raw f32). GCN(fused=True, res=True)'s diagonal
# hyperstep: raw f32 row chunks of 2^28 // (C * P * 4) = 52 samples
# (P = 184,007), both ways. Every other shape a phase launches is checked,
# untimed, by the last phase (phase_core_launched)
CORE_CASES = [
    ("trainer_layer1", N_NODES, HIDDEN, "f32_bin", (False, True)),
    ("trainer_layer2", N_NODES, N_CLASS, "f32_bin", (False, True)),
    ("pullback_layer2", N_NODES, N_CLASS * N_CLASS, "f32_bin", (True,)),
    ("pullback_layer1", N_NODES, N_CLASS * HIDDEN, "f32_bin", (True,)),
    ("jacobians_layer2", N_NODES, 250 * N_CLASS * N_CLASS, "f32_bin",
     (True,)),
    ("jacobians_layer1", N_NODES, 250 * N_CLASS * HIDDEN, "f32_bin",
     (True,)),
    ("jacobians_layer1_h16", N_NODES, 250 * N_CLASS * FULL_HIDDEN, "f32_bin",
     (True,)),
    ("gcn_int8", N_NODES, HIDDEN, "int8", (False,)),
    ("gcn_auto_int8", 16384, HIDDEN, "int8", (False,)),
    ("gcn_fused_f32", N_NODES, HIDDEN, "f32_raw", (False,)),
    ("gcn_res_diag_rows", N_NODES, 52 * N_CLASS * HIDDEN, "f32_raw",
     (False, True)),
]
WARM_CASES = ("trainer_layer1", "trainer_layer2")


def warm_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back launches on
    the same inputs (no L2 flush: what the train step and hyperstep see,
    launching the same adjacency in turn), CUDA events around the run."""
    for _ in range(3):
        fn()
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
    finally:
        gc.enable()
    return a.elapsed_time(b) / reps


def core_adjacency(torch, n, kind, seed):
    """(the kernel's adjacency, the pre-binarized f32 matrix B with
    core(A, t) = B^T t for transpose=False): a learned adjacency after
    symmetrization (1, 0 and exact 0.5 ties) at Cora's density, uniform
    [0, 1) values for the raw f32 mode, a 0/1 int8 matrix for the int8
    mode; made on the card from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "f32_raw":
        a = torch.rand(n, n, generator=g, device="cuda")
        return a, a
    e = torch.rand(n, n, generator=g, device="cuda") < DENSITY
    e = e | e.T
    one_way = e & (torch.rand(n, n, generator=g, device="cuda") < 0.5)
    raw = one_way.float()
    del e, one_way
    a = (raw + raw.T) / 2
    a.fill_diagonal_(0.0)
    del raw
    if kind == "int8":
        a = (a > 0.5).to(torch.int8)
        return a, a.float()
    b = (a > 0.5).float()
    b.fill_diagonal_(1.0)
    return a, b


# every core_spmm launch of the run, and every call core_check held against
# the plain version, by core_key
LAUNCHED, CHECKED = set(), set()


def core_key(a, t, threshold, binarize, transpose):
    """(N, d, adjacency mode, t's dtype, transpose, threshold)."""
    kind = ("int8" if a.element_size() == 1
            else "f32_bin" if binarize else "f32_raw")
    return (a.shape[0], t.shape[1], kind, str(t.dtype).split(".")[-1],
            bool(transpose), float(threshold))


def record_launches(fs):
    """From now on, add every core_spmm launch's core_key to LAUNCHED."""
    launch = fs.CoreKernel._launch

    def recorded(self, adj, t, threshold, binarize, transpose):
        out = launch(self, adj, t, threshold, binarize, transpose)
        if out.numel():                 # an empty t launches nothing
            LAUNCHED.add(core_key(adj, t, threshold, binarize, transpose))
        return out

    fs.CoreKernel._launch = recorded


def core_check(torch, fs, a, t, kind, transpose, threshold=0.5):
    """(kernel output, max abs error, its tolerance) against the plain
    version; raises when it disagrees or when a second call does not give
    the same bits. Binarized f32 A: B is exact in bf16
    and t rounds once, |err| <= 2^-9 |B|^T|t|, held at 2^-8; raw f32 A: A
    and t both round, held at 2^-7 |A|^T|t|; int8 0/1 A with t exact in
    bf16: exact."""
    binarize = kind == "f32_bin"
    got = fs.core(a, t, threshold, binarize, transpose)
    # deterministic: a split plan sums its partials in a fixed order
    if not torch.equal(got, fs.core(a, t, threshold, binarize, transpose)):
        raise AssertionError(f"core_spmm {kind} n={a.shape[0]} d={t.shape[1]}"
                             f" T={transpose}: two calls differ")
    ref = fs.core_reference(a, t, threshold, binarize, transpose)
    err = (got.float() - ref.float()).abs()
    if kind == "int8":
        ok, tol = torch.equal(got, ref), 0.0
    else:
        scale = fs.core_reference(a, t.abs(), threshold, binarize,
                                  transpose)
        bound = (2.0 ** -8 if binarize else 2.0 ** -7) * scale.float() + (
            1e-6 if binarize else 1e-5)
        ok, tol = bool((err <= bound).all()), float(bound.max())
        del scale, bound
    if not (ok and got.shape == t.shape and got.dtype == t.dtype
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"core_spmm {kind} n={a.shape[0]} d={t.shape[1]}"
                             f" T={transpose}: max err {float(err.max())}")
    CHECKED.add(core_key(a, t, threshold, binarize, transpose))
    return got, float(err.max()), tol


def phase_kernel(torch, fs, peaks):
    """core_spmm against its plain version at every shape of CORE_CASES,
    timed cold beside the plain version, torch.matmul on the pre-binarized
    matrix (f32, and bf16 at the wide widths) and its bound on this card;
    the trainer's shapes also warm."""
    bw, flops_peak = peaks
    rows, max_err = [], 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for case, n, d, kind, transposes in CORE_CASES:
        a, b_pre = core_adjacency(torch, n, kind, seed=n + d)
        g = torch.Generator(device="cuda").manual_seed(d)
        t = torch.randn(n, d, generator=g, device="cuda")
        if kind == "int8":
            t = torch.round(t * 8) / 8            # exact in bf16
        wide = d > 1024
        reps = 5 if wide else 20
        binarize = kind == "f32_bin"
        for transpose in transposes:
            _, err, tol = core_check(torch, fs, a, t, kind, transpose)
            max_err = max(max_err, err)
            nbytes = n * n * a.element_size() + 2 * n * d * 4
            nflop = 2 * n * n * d
            t_b, t_o = nbytes / bw, nflop / flops_peak
            run = lambda: fs.core(a, t, 0.5, binarize, transpose)
            bm = b_pre if transpose else b_pre.T
            row = {
                "case": case, "n": n, "d": d, "transpose": transpose,
                "adj": kind,
                "plan": fs.plan(n, d, a.dtype, t.dtype, a.data_ptr(),
                                t.data_ptr(), sms)._asdict(),
                "ms": cold_ms(torch, run, reps),
                "plain_ms": cold_ms(torch, lambda: fs.core_reference(
                    a, t, 0.5, binarize, transpose), reps),
                "library_ms": cold_ms(torch, lambda: torch.matmul(bm, t),
                                      reps),
                "bound_ms": max(t_b, t_o) * 1e3,
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "max_abs_err": err, "tol": tol}
            if wide:
                bm16, t16 = bm.to(torch.bfloat16), t.to(torch.bfloat16)
                row["library_bf16_ms"] = cold_ms(
                    torch, lambda: torch.matmul(bm16, t16), reps)
                del bm16, t16
            if case in WARM_CASES:
                row["warm_ms"] = warm_ms(torch, run)
                row["library_warm_ms"] = warm_ms(
                    torch, lambda: torch.matmul(bm, t))
            row["card_after"] = card_state()
            rows.append(row)
            print("core_spmm " + json.dumps(row), flush=True)
        del a, b_pre, t
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rows, max_err


# edge cases of core_spmm checked against the plain version, not timed:
# (case, N, d, adjacency, transpose, variant). N = 2707 has no 16-byte
# rows (f32: 4-byte copies; int8: 1-byte loads), N = 40 is smaller than
# one tile; the views: A one element into its buffer (4-byte copies),
# a[1:, 1:].contiguous(), t one element into its buffer; d = 1, 65 (the
# wide tile, split) and 129; bf16 t (output in bf16; d = 7 takes 2-byte
# loads); the transposed raw and int8 modes
CORE_CHECKS = [
    ("n=2707", 2707, HIDDEN, "f32_bin", False, None),
    ("n=2707", 2707, HIDDEN, "f32_bin", True, None),
    ("n=2707", 2707, HIDDEN, "int8", False, None),
    ("n=2707", 2707, N_CLASS, "int8", True, None),
    ("n=2707", 2707, N_CLASS, "f32_raw", True, None),
    ("n=40", 40, N_CLASS, "f32_bin", False, None),
    ("n=40", 40, N_CLASS, "f32_bin", True, None),
    ("a_offset_view", N_NODES, HIDDEN, "f32_bin", False, "a_offset"),
    ("a_offset_view", N_NODES, HIDDEN, "f32_bin", True, "a_offset"),
    ("a[1:,1:]", N_NODES, HIDDEN, "f32_bin", False, "a_sub"),
    ("t_offset_view", N_NODES, HIDDEN, "f32_bin", False, "t_offset"),
    ("t_offset_view", N_NODES, 129, "f32_bin", True, "t_offset"),
    ("d=1", N_NODES, 1, "f32_bin", False, None),
    ("d=1", N_NODES, 1, "f32_bin", True, None),
    ("d=65", N_NODES, 65, "f32_bin", False, None),
    ("d=65", N_NODES, 65, "f32_bin", True, None),
    ("d=129", N_NODES, 129, "f32_bin", False, None),
    ("d=129", N_NODES, 129, "f32_bin", True, None),
    ("bf16_t", N_NODES, HIDDEN, "f32_bin", False, "t_bf16"),
    ("bf16_t", N_NODES, HIDDEN, "f32_bin", True, "t_bf16"),
    ("bf16_t", N_NODES, N_CLASS, "f32_bin", True, "t_bf16"),
    ("bf16_t", N_NODES, 129, "f32_bin", True, "t_bf16"),
    ("raw", N_NODES, HIDDEN, "f32_raw", True, None),
    ("raw", N_NODES, 129, "f32_raw", False, None),
    ("int8", N_NODES, HIDDEN, "int8", True, None),
    ("int8", N_NODES, N_CLASS, "int8", False, None),
    ("int8", N_NODES, 200, "int8", True, None),
]


def phase_core_checks(torch, fs):
    """core_spmm's edge cases against the plain version, untimed, with the
    tolerances of ``core_check`` (which also holds two calls to the same
    bits); at least one case must split j."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, adjs = [], {}
    for case, n, d, kind, transpose, variant in CORE_CHECKS:
        if (n, kind) not in adjs:
            adjs.clear()
            adjs[(n, kind)] = core_adjacency(torch, n, kind, seed=n)[0]
        a = adjs[(n, kind)]
        if variant == "a_offset":
            buf = torch.empty(n * n + 1, dtype=a.dtype, device="cuda")
            buf[1:].copy_(a.reshape(-1))
            a = buf[1:].view(n, n)
        elif variant == "a_sub":
            a = a[1:, 1:].contiguous()
        m = a.shape[0]
        g = torch.Generator(device="cuda").manual_seed(m + d)
        t = torch.randn(m * d + 1, generator=g, device="cuda")
        t = t[1:].view(m, d) if variant == "t_offset" else t[:m * d].view(m, d)
        if kind == "int8":
            t = torch.round(t * 8) / 8            # exact in bf16
        if variant == "t_bf16":
            t = t.to(torch.bfloat16)
        p = fs.plan(m, d, a.dtype, t.dtype, a.data_ptr(), t.data_ptr(), sms)
        _, err, tol = core_check(torch, fs, a, t, kind, transpose)
        out.append({"case": case, "n": m, "d": d, "adj": kind,
                    "t_dtype": str(t.dtype).split(".")[-1],
                    "transpose": transpose, "tile": p.tile,
                    "split": p.split, "vec_a": p.vec_a, "vec_t": p.vec_t,
                    "max_abs_err": err, "tol": tol})
        print("core_spmm check " + json.dumps(out[-1]), flush=True)
    if not any(r["split"] > 1 for r in out):
        raise AssertionError("core_spmm: no checked case split j")
    torch.cuda.synchronize()
    return out


def phase_core_launched(torch, fs):
    """core_spmm against its plain version, untimed, at every shape that a
    phase launched and no core_check has held yet (the row chunks of the
    trainers, hypersteps, fits and predictives), with t drawn on the card
    at that shape and dtype; fails if any disagrees."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, adjs = [], {}
    for key in sorted(LAUNCHED - CHECKED):
        n, d, kind, t_dtype, transpose, threshold = key
        if (n, kind) not in adjs:
            adjs.clear()
            adjs[(n, kind)] = core_adjacency(torch, n, kind, seed=n)[0]
        a = adjs[(n, kind)]
        g = torch.Generator(device="cuda").manual_seed(d)
        t = torch.randn(n, d, generator=g, device="cuda")
        if kind == "int8":
            t = torch.round(t * 8) / 8            # exact in bf16
        t = t.to(getattr(torch, t_dtype))
        p = fs.plan(n, d, a.dtype, t.dtype, a.data_ptr(), t.data_ptr(), sms)
        _, err, tol = core_check(torch, fs, a, t, kind, transpose, threshold)
        out.append({"n": n, "d": d, "adj": kind, "t_dtype": t_dtype,
                    "transpose": transpose, "threshold": threshold,
                    "tile": p.tile, "split": p.split, "max_abs_err": err,
                    "tol": tol})
        print("core_spmm launched shape " + json.dumps(out[-1]), flush=True)
        del t
    if LAUNCHED - CHECKED:
        raise AssertionError(f"core_spmm shapes never checked: "
                             f"{sorted(LAUNCHED - CHECKED)}")
    print(f"core_spmm: {len(LAUNCHED)} launched shapes, each held against "
          f"the plain version ({len(out)} of them in this phase)", flush=True)
    torch.cuda.synchronize()
    return out


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
              f"{prof['device_ms']:.3f} ms of device time (core_spmm "
              f"{prof['core_spmm_ms']:.3f}) in "
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
    rel = _rel(f_k, f_p)
    if rel > 2e-2:
        raise AssertionError(f"kernel path vs composed path: rel {rel}")
    print(f"full-width output vs composed path: relative error {rel:.3e}",
          flush=True)
    return ({"run_s": run_s, "run_launches": run_launches,
             "run_launches_by_step": by_step, "steps": steps,
             "losses": losses, "neg_margliks": nms, "output_rel_err": rel},
            (model, final, y, perm))


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


def flash_check(torch, fa, a_src, a_dst, mask, h, gout, attn, label):
    """Both flash kernels against their plain versions on one input:
    (forward outputs, reference forward outputs, backward outputs, errors,
    failures). The backward takes the reference (out, m, l). float32
    results within 1e-4 of the largest reference entry (sums in another
    order: an online softmax with rescaling, split partials merged in a
    fixed order), bf16 operands within 2^-7 of it; m is a max and must be
    exact; a second call of each kernel must give the same bits."""
    tol = 2.0 ** -7 if attn else 1e-4
    got = fa.flash_fwd(a_src, a_dst, mask, h, 0.2, attn)
    again = fa.flash_fwd(a_src, a_dst, mask, h, 0.2, attn)
    want = fa.flash_fwd_reference(a_src, a_dst, mask, h, 0.2, attn)
    got_b = fa.flash_bwd(a_src, a_dst, mask, h, gout, *want, 0.2, attn)
    again_b = fa.flash_bwd(a_src, a_dst, mask, h, gout, *want, 0.2, attn)
    want_b = fa.flash_bwd_reference(a_src, a_dst, mask, h, gout, *want,
                                    0.2, attn)
    torch.cuda.synchronize()
    errs, failures = {}, []
    for kern, names, xs, ys, zs in (
            ("flash_fwd", ("out", "m", "l"), got, want, again),
            ("flash_bwd", ("d_a_src", "d_a_dst", "d_h"), got_b, want_b,
             again_b)):
        for name, x, y, z in zip(names, xs, ys, zs):
            err = float((x - y).abs().max())
            scale = float(y.abs().max())
            errs[f"{kern}.{name}"] = err
            if not (bool(torch.isfinite(x).all())
                    and err <= tol * scale + 1e-6):
                failures.append(f"{kern} {label}: {name} max err {err} "
                                f"(scale {scale})")
            if name == "m" and not torch.equal(x, y):
                failures.append(f"{kern} {label}: m differs from the plain "
                                f"m by {err}")
            if not torch.equal(x, z):
                failures.append(f"{kern} {label}: {name} differs between "
                                "two calls")
    return got, want, got_b, errs, failures


def flash_plans(fa, n, r, heads, f, mask, sms):
    return {d: fa.plan(n, r, heads, f, mask.dtype, mask.data_ptr(), sms,
                       d == "bwd")._asdict() for d in ("fwd", "bwd")}


def phase_flash_kernels(torch, np, fa, bw):
    """Both flash kernels against their plain versions at the GAT path's
    shapes (``flash_check``), timed beside the plain versions and the
    composed chunked attention. Every case runs before the failures, if
    any, are raised together."""
    from laplace_gnn_torch.models.layers import _masked_attention_chunked
    rows, max_err = [], {"flash_fwd": 0.0, "flash_bwd": 0.0}
    failures = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
        got, want, got_b, errs, fails = flash_check(
            torch, fa, a_src, a_dst, mask, h, gout, attn,
            f"{case} n={n} f={f}")
        failures += fails
        if attn is None:
            for k, v in errs.items():
                kern = k.split(".")[0]
                max_err[kern] = max(max_err[kern], v)
        if case == "row_shard" and not (
                float(got[0][ISO_ROW].abs().max()) == 0.0
                and float(got[2][:, ISO_ROW].abs().max()) == 0.0
                and float(got_b[1][ISO_ROW].abs().max()) == 0.0):
            failures.append("a row with no neighbour must give out = 0, "
                            "l = 0 and d_a_dst = 0")
        plans = flash_plans(fa, n, r, H, f, mask, sms)
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
                "plan": plans["bwd" if bwd else "fwd"],
                "ms": cold_ms(torch, run), "plain_ms": cold_ms(torch, plain,
                                                               reps=3),
                "composed_ms": comp_bwd if bwd else comp_fwd,
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "errors": {k: v for k, v in errs.items()
                           if k.startswith(kern)}})
            print(f"{kern} " + json.dumps(rows[-1]), flush=True)
    graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))
    return rows, max_err


# edge cases of both flash kernels, checked against the plain versions by
# flash_check, untimed: (case, N, heads, F, mask, attn_dtype, variant).
# N = 2707 has no 16-byte rows (f32: 4-byte copies; int8: 1-byte loads),
# N = 40 is under one tile; adj[1:] starts one row into its buffer,
# a_offset one element (4-byte copies); H and F at and inside the edges of
# the domain; bf16 operands at Cora's size; a banded graph, where most
# splits of a row hold no edge; source columns with a_src = -80 and -800
# (exp underflows to 0); a row shard with a row that has no edge
FLASH_CHECKS = [
    ("n=2707", 2707, 8, 8, "float32", None, None),
    ("n=2707", 2707, 8, 1, "int8", None, None),
    ("n=40", 40, 8, 8, "float32", None, None),
    ("n=40", 40, 3, 5, "int8", None, None),
    ("adj[1:]", N_NODES, 8, 8, "float32", None, "rows_from_1"),
    ("a_offset", N_NODES, 8, 8, "float32", None, "a_offset"),
    ("h=1", N_NODES, 1, 8, "float32", None, None),
    ("h=3", N_NODES, 3, 8, "float32", None, None),
    ("h=16", N_NODES, 16, 8, "int8", None, None),
    ("h=256", 300, 256, 2, "float32", None, None),
    ("f=5", N_NODES, 8, 5, "float32", None, None),
    ("f=64", N_NODES, 8, 64, "float32", None, None),
    ("bf16", N_NODES, 8, 8, "float32", "bfloat16", None),
    ("banded", N_NODES, 8, 8, "float32", None, "banded"),
    ("a_src=-80", N_NODES, 8, 8, "float32", None, "underflow"),
    ("row_shard", N_NODES, 8, 8, "float32", None, "row_shard"),
]


def flash_check_inputs(torch, n, heads, f, mask_t, variant):
    """(a_src, a_dst, mask, h, gout) of one FLASH_CHECKS case, made on the
    card: a symmetric random graph with self-loops at ~10 edges a row (N =
    40: 15% density), or a band of 8 on each side."""
    g = torch.Generator(device="cuda").manual_seed(n * 7 + heads + f)
    if variant == "banded":
        i = torch.arange(n, device="cuda")
        adj = ((i[:, None] - i[None, :]).abs() <= 8) & (
            torch.rand(n, n, generator=g, device="cuda") < 0.4)
    else:
        adj = torch.rand(n, n, generator=g, device="cuda") < (
            0.15 if n < 100 else 10.0 / n)
    adj = (adj | adj.T).float()
    adj.fill_diagonal_(1.0)
    r = n
    if variant == "rows_from_1":              # rows 1.. of the buffer
        adj, r = adj[1:], n - 1
    elif variant == "row_shard":
        r = n // 3
        adj = adj[:r].clone()
        adj[ISO_ROW] = 0.0
    mask = (adj > 0).to(torch.int8) if mask_t == "int8" else adj
    if variant == "a_offset":                 # one element into its buffer
        buf = torch.empty(mask.numel() + 1, dtype=mask.dtype, device="cuda")
        buf[1:].copy_(mask.reshape(-1))
        mask = buf[1:].view(mask.shape)
    elif variant != "rows_from_1":
        mask = mask.contiguous()
    a_src = torch.randn(n, heads, generator=g, device="cuda")
    if variant == "underflow":
        a_src[5] = -80.0
        a_src[6] = -800.0
    a_dst = torch.randn(r, heads, generator=g, device="cuda")
    h = torch.randn(n, heads, f, generator=g, device="cuda")
    gout = torch.randn(r, heads, f, generator=g, device="cuda")
    return a_src, a_dst, mask, h, gout


def phase_flash_checks(torch, fa):
    """The flash kernels' edge cases (FLASH_CHECKS) against the plain
    versions, untimed, by ``flash_check``; at least one case must split
    each kernel's walked axis. All cases run before the failures, if any,
    are raised together."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, failures = [], []
    for case, n, heads, f, mask_t, attn, variant in FLASH_CHECKS:
        a_src, a_dst, mask, h, gout = flash_check_inputs(
            torch, n, heads, f, mask_t, variant)
        label = f"{case} n={n} h={heads} f={f} {mask_t}"
        got, _, got_b, errs, fails = flash_check(
            torch, fa, a_src, a_dst, mask, h, gout, attn, label)
        if variant == "row_shard" and not (
                float(got[0][ISO_ROW].abs().max()) == 0.0
                and float(got[2][:, ISO_ROW].abs().max()) == 0.0
                and float(got_b[1][ISO_ROW].abs().max()) == 0.0):
            fails.append(f"{label}: a row with no neighbour must give "
                         "out = 0, l = 0 and d_a_dst = 0")
        failures += fails
        plans = flash_plans(fa, n, a_dst.shape[0], heads, f, mask, sms)
        out.append({"case": case, "n": n, "r": a_dst.shape[0],
                    "heads": heads, "f": f, "adj": mask_t,
                    "attn_dtype": attn, "plans": plans, "errors": errs,
                    "ok": not fails})
        print("flash check " + json.dumps(out[-1]), flush=True)
    for d in ("fwd", "bwd"):
        if not any(r["plans"][d]["split"] > 1 for r in out):
            failures.append(f"flash_{d}: no checked case split its axis")
    torch.cuda.synchronize()
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def gat_model(torch, X, adj, impl, n_layers=2, **kw):
    from laplace_gnn_torch.models import GAT
    return GAT(X.shape[1], GAT_HIDDEN, GAT_CLASSES, n_layers, X, adj,
               heads=GAT_HEADS, concat=True, dropout_p=0.0,
               attention_impl=impl, device="cuda",
               generator=torch.Generator().manual_seed(0), **kw)


def gat_programs(model, n_train, **curvature):
    from laplace_gnn_torch.training.marglik_gnn import TrainingPrograms
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.params().items()}
    return TrainingPrograms(
        model, params, lr=1e-2, weight_decay=5e-4, lr_adj=0.1,
        weight_decay_adj=0.0, momentum_adj=0.0, grad_norm=False,
        hessian_structure="kron", subset_of_weights="all",
        prior_precision=1.0, N=n_train, **curvature)


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
        print("  flash kernels: " + json.dumps(prof["flash"]), flush=True)
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
    del progs
    torch.cuda.empty_cache()
    return ({"run_s": run_s, "run_launches": launches,
             "run_launches_by_step": by, "losses": losses,
             "val_losses": val_losses, "neg_margliks": nms,
             "neg_marglik_eval_s": eval_s, "neg_marglik_peak_gb": peak_gb},
            (model, final, y, perm))


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
    rel = {k: _rel(grads["cuda"][k], g) for k, g in grads["cpu"].items()}
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


# the blocked matmul at the shapes of the product it was written for (the
# dense aggregation adj @ s), of the slice's largest product
# (KronDecomposed._bmm on layer 0 for 542 test nodes x 7 classes) and one
# ragged case, then two alignment cases: a view that starts one element
# into its buffer (4-byte copies) and the layer-0 product X @ W at Cora's
# width in bf16 (rows of 1433 bf16: 2-byte loads); last the 16384 shapes
# under the JAX signature's hint bm = 64, which takes the 64 x 64 tile in
# place of the 128 x 64 one: (case, M, K, N, dtype, bm); timed
MM_CASES = [("adj@s", 2708, 2708, 64, "float32", 512),
            ("adj@s", 2708, 2708, 64, "bfloat16", 512),
            ("adj@s", 16384, 16384, 64, "float32", 512),
            ("adj@s", 16384, 16384, 64, "bfloat16", 512),
            ("kron_bmm", 542 * N_CLASS * HIDDEN, N_FEAT, N_FEAT, "float32",
             512),
            ("ragged", 300, 200, 70, "float32", 512),
            ("ragged", 300, 200, 70, "bfloat16", 512),
            ("offset_view", 2708, 2708, 64, "float32", 512),
            ("x@w", N_NODES, N_FEAT, HIDDEN, "bfloat16", 512),
            ("adj@s", 16384, 16384, 64, "float32", 64),
            ("adj@s", 16384, 16384, 64, "bfloat16", 64)]
# edge cases checked against the plain version, not timed: K shorter than
# one K step, fewer than 16 rows, a split-K product and a view a[1:] that
# starts one row into its buffer: (case, M, K, N)
MM_CHECKS = [("k=1", 70, 1, 70), ("m<16", 9, 77, 70),
             ("split_k", 300, 2000, 64), ("row_view", 200, 300, 70)]
N_TEST = 1000               # Cora's test-set size, for the GLM predictive
JAC_CHUNK = 250             # test nodes per vmapped Jacobian pass
GAT_GLM_NODES, GAT_JAC_CHUNK = 100, 4


def _mm_operands(torch, case, M, K, N, dtype):
    """a (M, K) and b (K, N) on the card, from a seed; a is a view into a
    larger buffer for the two view cases."""
    g = torch.Generator(device="cuda").manual_seed(M + N)
    if case == "offset_view":           # one element into its buffer
        a = torch.randn(M * K + 1, generator=g, device="cuda").to(
            dtype)[1:].view(M, K)
    elif case == "row_view":            # a[1:] of an (M + 1, K) matrix
        a = torch.randn(M + 1, K, generator=g, device="cuda").to(dtype)[1:]
    else:
        a = torch.randn(M, K, generator=g, device="cuda").to(dtype)
    return a, torch.randn(K, N, generator=g, device="cuda").to(dtype)


def _mm_check(torch, mm_mod, case, a, b, bm):
    """(plan, max abs error, tolerance) of one kernel call against the plain
    version; raises when it disagrees."""
    (M, K), N = a.shape, b.shape[1]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    p = mm_mod.plan(M, N, K, a.dtype, a.data_ptr(), b.data_ptr(), sms, bm)
    got = mm_mod.matmul(a, b, bm=bm)
    want = mm_mod.matmul_reference(a, b)
    scale = float((a.float().abs() @ b.float().abs()).max())
    err = float((got.float() - want.float()).abs().max())
    tol = (1e-5 if a.dtype == torch.float32 else 2.0 ** -7) * scale
    if not (got.shape == (M, N) and bool(torch.isfinite(got).all())
            and err <= tol):
        raise AssertionError(f"matmul {case} {M}x{K}x{N} {a.dtype} bm={bm}: "
                             f"max err {err} > {tol}")
    return p, err, tol


def phase_matmul(torch, mm_mod, peaks):
    """The matmul kernel against its plain version, timed beside the plain
    version and one torch.matmul (cuBLAS, TF32 off), then the edge cases
    checked alone. Tolerance: f32 within 1e-5 x max(|a| @ |b|) (3xTF32
    products and another summation order); bf16 outputs within 2^-7 x the
    same (one bf16 rounding of the f32 sum). Bound: bytes over the memory
    rate against 2MNK over the bf16 rate, or 3 x 2MNK over the TF32 rate
    for f32 (the kernel's three TF32 products). ``launches`` counts the
    checking calls (one per case); no path of the package calls the
    kernel."""
    bw, bf16_peak = peaks
    mm = mm_mod.matmul
    rows, checked, checks = [], [], 0
    for case, M, K, N, dt, bm in MM_CASES:
        a, b = _mm_operands(torch, case, M, K, N, getattr(torch, dt))
        before = mm.launches
        p, err, tol = _mm_check(torch, mm_mod, case, a, b, bm)
        checks += mm.launches - before
        nbytes = (M * K + K * N + M * N) * a.element_size()
        ops = 2 * M * N * K
        t_b = nbytes / bw
        t_o = (3 * ops / (bf16_peak / 2) if dt == "float32"
               else ops / bf16_peak)
        reps = 10 if ops > 1e11 else 20
        ms = cold_ms(torch, lambda: mm(a, b, bm=bm), reps)
        lib = cold_ms(torch, lambda: torch.matmul(a, b), reps)
        rows.append({
            "case": case, "m": M, "k": K, "n": N, "dtype": dt, "bm": bm,
            "tile": p.tile[:2], "stages": p.stages, "split": p.split,
            "copy_bytes": p.vec, "ms": ms,
            "plain_ms": cold_ms(torch, lambda: mm_mod.matmul_reference(a, b),
                                reps),
            "library_ms": lib, "kernel_over_library": ms / lib,
            "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "max_abs_err": err, "tol": tol,
            "card_after": card_state()})
        print("matmul " + json.dumps(rows[-1]), flush=True)
        del a, b
        torch.cuda.empty_cache()
    for case, M, K, N in MM_CHECKS:
        for dt in ("float32", "bfloat16"):
            a, b = _mm_operands(torch, case, M, K, N, getattr(torch, dt))
            before = mm.launches
            p, err, tol = _mm_check(torch, mm_mod, case, a, b, 512)
            checks += mm.launches - before
            checked.append({"case": case, "m": M, "k": K, "n": N,
                            "dtype": dt, "tile": p.tile[:2],
                            "split": p.split, "copy_bytes": p.vec,
                            "max_abs_err": err, "tol": tol})
            print("matmul check " + json.dumps(checked[-1]), flush=True)
    if not any(r["split"] > 1 for r in checked):
        raise AssertionError("matmul: no checked edge case split K")
    return rows + checked, checks


def timed(torch, fn):
    """(fn(), host seconds, peak GB above what was allocated before); the
    work ends in a synchronize."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() - base) / 1e9)


def run_parts(torch, kernels, card, label):
    """A ``part(name, fn, expect)`` runner: each part is timed alone with
    every kernel's count set to 0 just before and read just after; expect
    maps a kernel name to the launches it must show (None: at least one)."""
    parts = {}

    def part(name, fn, expect):
        for k in kernels:
            k.launches = 0
        out, secs, gb = timed(torch, fn)
        launches = {k.name: k.launches for k in kernels}
        for kname, want in expect.items():
            got = launches[kname]
            if (want is None and got == 0) or (want is not None
                                               and got != want):
                raise AssertionError(f"{label} {name}: {got} {kname} "
                                     f"launches, expected {want or '> 0'}")
        parts[name] = {"s": secs, "peak_gb": gb, "launches": launches}
        print(f"{label} {name}: {secs:.4f} s (host clock), peak {gb:.3f} GB "
              f"above the allocated, launches {launches}  [{card}]",
              flush=True)
        return out
    return part, parts


def _check_probs(np, probs, n):
    p = probs.detach().cpu().numpy()
    if p.shape != (n, N_CLASS) or not np.all(np.isfinite(p)) or \
            np.abs(p.sum(-1) - 1).max() > 1e-4:
        raise AssertionError(f"predictive probabilities: shape {p.shape}, "
                             f"row sums off by {np.abs(p.sum(-1) - 1).max()}")


def phase_laplace_stegcn(torch, np, state, kernels, card):
    """Post-hoc Kron Laplace evaluation of the phase-3 STE-GCN (fused
    kernel path) at Cora's width: each part timed, its peak memory and its
    launches counted."""
    from laplace_gnn_torch.laplace.predictive import probit_predictive
    from laplace_gnn_torch.training.evaluate import (_metrics, evaluate_map,
                                                     evaluate_predictive)
    from laplace_gnn_torch.training.marglik_gnn import fit_laplace, mc_eval
    model, params, y, perm = state
    tr = perm[:N_TRAIN]
    te = perm[N_TRAIN + N_VAL:N_TRAIN + N_VAL + N_TEST]
    idx = torch.as_tensor(te, device="cuda")
    part, parts = run_parts(torch, kernels, card, "STE-GCN Laplace")
    chunks = math.ceil(N_TEST / JAC_CHUNK)
    zero = {"matmul": 0}
    la = part("fit_laplace", lambda: fit_laplace(
        model, params, tr, y[tr],
        backend_kwargs={"jac_chunk_size": JAC_CHUNK}),
        {"core_spmm": None, **zero})
    lml = float(part("log_marglik", la.log_marginal_likelihood,
                     {"core_spmm": 0, **zero}))
    q_map = part("evaluate_map", lambda: evaluate_map(model, params, te,
                                                      y[te]),
                 {"core_spmm": 2, **zero})
    # the GLM predictive's two stages apart, then the call as a user makes it
    Js, f_mu = part("jacobians", lambda: la.backend.jacobians(idx),
                    {"core_spmm": 2 + 2 * chunks, **zero})
    f_var = part("functional_variance", lambda: la.functional_variance(Js),
                 {"core_spmm": 0, **zero})
    del Js
    # the Jacobians' device time by kernel name (one more pass, uncounted)
    jac_prof = profile_step(torch, lambda: la.backend.jacobians(idx), top=12)
    print(f"STE-GCN Laplace jacobians profiled: {jac_prof['device_ms']:.3f} "
          f"ms of device time in {jac_prof['n_kernels']} launches, "
          f"core_spmm {jac_prof['core_spmm_ms']:.3f} ms "
          f"({100 * jac_prof['core_spmm_share']:.1f}%)  [{card}]", flush=True)
    for r in jac_prof["top"]:
        print(f"  {r['ms']:8.3f} ms x{r['count']:<4d} {r['name']}", flush=True)
    torch.cuda.empty_cache()
    probs = probit_predictive(f_mu, f_var)
    _check_probs(np, probs, N_TEST)
    q_bayes = part("evaluate_predictive_probit", lambda: evaluate_predictive(
        la, te, y[te], link_approx="probit"),
        {"core_spmm": 2 + 2 * chunks, **zero})
    staged = _metrics(probs.detach().cpu().numpy(), y[te])
    if abs(staged["nll"] - q_bayes["nll"]) > 1e-5 * abs(q_bayes["nll"]):
        raise AssertionError(f"probit NLL {q_bayes['nll']} vs the staged "
                             f"{staged['nll']}")
    mc = part("mc_eval_nn_100", lambda: mc_eval(la, te, y[te],
                                                pred_type="nn",
                                                n_samples=100),
              {"core_spmm": 2 * 100, **zero})
    vals = [lml, *q_map.values(), *q_bayes.values(), *mc]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"non-finite evaluation: {vals}")
    print(f"STE-GCN Laplace: log marglik {lml:.4f}; MAP {q_map}; probit "
          f"{q_bayes}; nn-MC (loss, acc %) {mc}; P = {la.n_params}, "
          f"J = {N_TEST} x {N_CLASS} x {la.n_params} f32  [{card}]",
          flush=True)
    n_params = la.n_params
    del la, f_var
    torch.cuda.empty_cache()
    return {"parts": parts, "log_marglik": lml, "map": q_map,
            "bayes_probit": q_bayes, "mc_nn": mc, "n_params": n_params,
            "jacobians_profile": jac_prof}


def phase_laplace_small_reference(torch, np):
    """fit_laplace, the log marglik and the probit probabilities on a small
    graph: the kernel path in float32 on the card against the float64 CPU
    path (which the CPU tests hold to the JAX package). The kernel rounds
    its operands to bf16, so both are held at 1e-2."""
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.training.marglik_gnn import fit_laplace
    rng = np.random.default_rng(8)
    n, f = 96, 24
    X = rng.standard_normal((n, f))
    adj = (rng.random((n, n)) < 0.08).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, N_CLASS, n)
    vals, probs = {}, {}
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
        m = STEGCN(f, 16, N_CLASS, 2, X, adj, dropout_p=0.0, fused=True,
                   symmetric=True, device=dev, dtype=dt,
                   generator=torch.Generator().manual_seed(0))
        la = fit_laplace(m, m.params(), np.arange(40), y[:40])
        vals[dev] = float(la.log_marginal_likelihood())
        probs[dev] = la(torch.arange(40, n, device=dev),
                        link_approx="probit").detach().double().cpu()
    rel = abs(vals["cuda"] - vals["cpu"]) / abs(vals["cpu"])
    perr = float((probs["cuda"] - probs["cpu"]).abs().max())
    if not math.isfinite(vals["cuda"]) or rel > 1e-2 or perr > 1e-2:
        raise AssertionError(f"small Laplace: {vals}, probit err {perr}")
    print(f"small-graph Laplace: log marglik card {vals['cuda']:.6f} vs CPU "
          f"f64 {vals['cpu']:.6f} (relative {rel:.2e}); probit "
          f"probabilities max abs diff {perr:.2e}", flush=True)
    return {"log_marglik": vals, "log_marglik_rel": rel, "probit_err": perr}


def phase_laplace_gat(torch, np, state, kernels, card):
    """Post-hoc Kron Laplace evaluation of the phase-6 GAT at N = 2708: the
    fit and the GLM predictive run on the jvp_safe clone (no flash launch),
    the nn predictive's samples through the flash forward (2 per sample)."""
    from laplace_gnn_torch.training.evaluate import evaluate_predictive
    from laplace_gnn_torch.training.marglik_gnn import fit_laplace, mc_eval
    model, params, y, perm = state
    n = GAT_N_TRAIN
    tr = perm[:N_TRAIN]
    rest = perm[N_TRAIN + N_VAL:]
    te = rest[:GAT_GLM_NODES]
    part, parts = run_parts(torch, kernels, card, "GAT Laplace")
    none = {"flash_fwd": 0, "flash_bwd": 0, "matmul": 0}
    la = part("fit_laplace", lambda: fit_laplace(
        model, params, tr, y[tr],
        backend_kwargs={"jac_chunk_size": GAT_JAC_CHUNK}), none)
    lml = float(part("log_marglik", la.log_marginal_likelihood, none))
    mc = part("mc_eval_nn_20", lambda: mc_eval(la, rest, y[rest],
                                              pred_type="nn", n_samples=20),
              {"flash_fwd": 2 * 20, "flash_bwd": 0, "matmul": 0})
    q = part(f"evaluate_predictive_probit_{GAT_GLM_NODES}",
             lambda: evaluate_predictive(la, te, y[te],
                                         link_approx="probit"), none)
    vals = [lml, *mc, *q.values()]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"non-finite GAT evaluation: {vals}")
    print(f"GAT Laplace at N={n}: log marglik {lml:.4f}; nn-MC over "
          f"{len(rest)} nodes (loss, acc %) {mc}; probit on {len(te)} nodes "
          f"{q}; P = {la.n_params}  [{card}]", flush=True)
    del la
    torch.cuda.empty_cache()
    return {"parts": parts, "log_marglik": lml, "mc_nn": mc,
            "bayes_probit": q}


def phase_experiment(torch, np, kernels, card):
    """The experiment entry point as a user runs it, on a Cora-shaped
    synthetic graph written as an npz dataset, with the Cora section of
    configs/knng/stegcn_config.yaml cut to 6 epochs; then a sketched
    Fisher, then LoRA-STE-GCN with the diagonal structure, 2 epochs each.
    It runs fused=False, as the JAX package does, so no kernel
    launches."""
    from laplace_gnn_torch.graph.data import adj_to_edge_index
    from laplace_gnn_torch.training.experiment import main as run_main
    d = os.path.join(ROOT, "chiprun_out", "experiment")
    os.makedirs(d, exist_ok=True)
    X, adj, y = make_graph(np, np.random.default_rng(7))
    np.savez(os.path.join(d, "coralike.npz"), x=X, y=y,
             edge_index=adj_to_edge_index(adj))
    os.environ["LAPLACE_GNN_DATA"] = d
    argv = ["--dataset", "coralike", "--model_type", "stegcn",
            "--init_graph", "knng", "--knng_k", "3",
            "--overwrite_config", "true", "--n_data_rand_splits", "1",
            "--hidden_channels", str(HIDDEN), "--lr", "1e-3",
            "--lr_adj", "0.8", "--momentum_adj", "0.9",
            "--weight_decay", "5e-5", "--weight_decay_adj", "5e-4",
            "--dropout_p", "0.5", "--ste_thresh", "0.5",
            "--symmetric", "true", "--grad_norm", "true", "--res", "false",
            "--norm", "none", "--n_epochs", "6", "--n_epochs_burnin", "2",
            "--marglik_frequency", "2", "--n_hypersteps", "2",
            "--base_out_dir", os.path.join(d, "results")]
    # then 2 epochs with the sketched Fisher in blocks of 2 columns (one
    # hyperstep at epoch 1): the curvature options as a user passes them
    sketch = argv + ["--n_epochs", "2", "--n_epochs_burnin", "1",
                     "--marglik_frequency", "1", "--n_hypersteps", "1",
                     "--fisher_type", "type-2-sketch", "--sketch_size", "4",
                     "--column_chunk", "2", "--fisher_seed", "3",
                     "--base_out_dir", os.path.join(d, "results_sketch")]
    # then LoRA-STE-GCN (r 16, the grid's smallest; the CLI's lora_alpha
    # 16) with the diagonal GGN in its hypersteps and post-hoc fits
    lora = argv + ["--model_type", "lorastegcn", "--lora_r", "16",
                   "--hessian_structure", "diag", "--n_epochs", "2",
                   "--n_epochs_burnin", "1", "--marglik_frequency", "1",
                   "--n_hypersteps", "1",
                   "--base_out_dir", os.path.join(d, "results_lora")]
    runs = {}
    for name, args, label in (
            ("results", argv, "6 epochs"),
            ("results_sketch", sketch, "2 epochs, type-2-sketch k 4, "
             "column_chunk 2, fisher_seed 3"),
            ("results_lora", lora, "lorastegcn r 16, diag, 2 epochs")):
        for k in kernels:
            k.launches = 0
        out, secs, gb = timed(torch, lambda: run_main(args, device="cuda"))
        launches = {k.name: k.launches for k in kernels}
        if any(launches.values()):
            raise AssertionError(f"the fused=False experiment launched "
                                 f"{launches}")
        stats_path = os.path.join(d, name, "coralike", "stats.pkl")
        stats = out["results"][0]["stats"]
        flat = [v for crit in stats.values() for vs in crit.values()
                for split in vs for v in split]
        if not (os.path.exists(stats_path) and stats["marglik"] and flat
                and all(math.isfinite(float(v)) for v in flat)):
            raise AssertionError(f"experiment {name} stats: {stats}")
        # the learned graphs (an N x N array each) would fill most of the
        # run's output directory: check that they were written, then drop
        strucs = [os.path.join(d, name, "coralike", x) for x in os.listdir(
            os.path.join(d, name, "coralike")) if x.endswith("_strucs")]
        if not any(os.listdir(x) for x in strucs):
            raise AssertionError(f"experiment {name} wrote no learned graph")
        for x in strucs:
            shutil.rmtree(x)
        print(f"experiment (coralike, knng k=3, {label}, 1 split): "
              f"{secs:.3f} s (host clock), peak {gb:.3f} GB, launches "
              f"{launches}; stats.pkl written: {os.path.exists(stats_path)};"
              f" summary {out['summary']}  [{card}]", flush=True)
        runs[name] = {"s": secs, "peak_gb": gb, "summary": out["summary"],
                      "stats": stats}
    return {**runs["results"], "sketch": runs["results_sketch"],
            "lora_diag": runs["results_lora"]}


# the hyperstep's curvature options, one hyperstep each: (label, options of
# make_neg_marglik_fn, or "kfac_approx" / "hessian_structure")
CURVATURE_OPTIONS = [
    ("type-2", {}),
    ("type-2, column_chunk 2", {"column_chunk": 2}),
    ("type-2-fork", {"fisher_type": "type-2-fork"}),
    ("type-2-sketch, k 4", {"fisher_type": "type-2-sketch",
                            "sketch_size": 4}),
    ("mc, 2 samples", {"fisher_type": "mc", "mc_samples": 2}),
    ("empirical", {"fisher_type": "empirical"}),
    ("forward-only", {"fisher_type": "forward-only"}),
    ("kfac_approx reduce", {"kfac_approx": "reduce"}),
    ("diag", {"hessian_structure": "diag"}),
]


def kron_default(kfac_approx: str):
    """A context in which ``GGNBackend.kron`` takes ``kfac_approx`` unless
    told otherwise: make_neg_marglik_fn passes none (nor does JAX's)."""
    from laplace_gnn_torch.curvature.interface import GGNBackend
    kron = GGNBackend.kron

    def run(self, X, y, N, **kw):
        kw.setdefault("kfac_approx", kfac_approx)
        return kron(self, X, y, N, **kw)
    return mock.patch.object(GGNBackend, "kron", run)


def loop_kfac_factors(model, params, X, y, likelihood, N=None,
                      return_output=False, **_):
    """Type-2 'expand' factors the way the port ran them before the vmapped
    pullback: a tap forward, then one ``torch.autograd.grad(create_graph=
    True)`` per output column, and X^T X / N formed every call. Patched
    into the backend to count that route's launches beside the new one."""
    import torch
    from laplace_gnn_torch.curvature.kfac import (_input_cov, _owning_site,
                                                  posterior_split)
    from laplace_gnn_torch.curvature.losses import loss_hessian_sqrt
    from laplace_gnn_torch.laplace.kron import Kron
    from laplace_gnn_torch.nn.module import TapCollector
    from laplace_gnn_torch.utils.pytree import merge_split, named_leaves
    w, frozen, sites = posterior_split(model, params)
    names = [s["name"] for s in sites]
    taps = TapCollector(perturb=True)
    out = model.apply(merge_split(w, frozen), X, taps=taps)
    acts = {n: a for n, a, _ in taps.records}
    S = loss_hessian_sqrt(likelihood, out)
    B = {}
    for c in range(S.shape[-1]):
        gs = torch.autograd.grad(out, [taps.eps[n] for n in names],
                                 grad_outputs=S[:, :, c], create_graph=True,
                                 retain_graph=True)
        for n, g in zip(names, gs):
            B[n] = g.T @ g + B.get(n, 0)
    by_prefix = {tuple(s["param_path"]): s for s in sites}
    kfacs = []
    for leaf_name, leaf in named_leaves(w):
        n = _owning_site(leaf_name, by_prefix, sites)["name"]
        kfacs.append([B[n]] if leaf.dim() == 1
                     else [B[n], _input_cov(acts[n], "expand", N)])
    return (Kron(kfacs), out) if return_output else Kron(kfacs)


def time_hyperstep(torch, core, fn, reps: int = 5) -> dict:
    """One hyperstep: median wall ms of ``reps`` (CUDA events), core_spmm
    launches a step (the wrapper's counter, set to 0 just before), device
    ms and device launches (torch.profiler), peak GB above the allocated."""
    fn()
    torch.cuda.synchronize()
    ms = []
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
    prof = profile_step(torch, fn)
    _, _, gb = timed(torch, fn)
    return {"ms": sorted(ms)[reps // 2], "ms_all": ms,
            "core_spmm_launches": launches, "device_ms": prof["device_ms"],
            "device_launches": prof["n_kernels"],
            "core_spmm_ms": prof["core_spmm_ms"], "peak_gb": gb}


def phase_curvature(torch, np, state, card):
    """One hyperstep of the phase-3 STE-GCN (fused kernel path, Cora's
    width) per curvature option, and one on the column loop the vmapped
    pullback replaced; each must launch core_spmm, the vmapped type-2
    fewer times than the loop."""
    from laplace_gnn_torch.curvature import interface
    from laplace_gnn_torch.ops.fused_spmm import core
    from laplace_gnn_torch.training.marglik_gnn import TrainingPrograms
    model, params, y, perm = state
    tr = perm[:N_TRAIN]
    idx = torch.as_tensor(tr, device="cuda")
    yy = torch.as_tensor(y[tr], device="cuda")
    cfg = dict(lr=1e-3, lr_adj=0.8, momentum_adj=0.9, weight_decay=5e-5,
               weight_decay_adj=5e-4, grad_norm=True,
               hessian_structure="kron", subset_of_weights="all")
    loop = mock.patch.object(interface, "compute_kfac_factors",
                             loop_kfac_factors)
    rows = {}
    for label, opts, patch in (
            [(label, opts, None) for label, opts in CURVATURE_OPTIONS]
            + [("type-2, column loop", {}, loop)]):
        opts = dict(opts)
        approx = opts.pop("kfac_approx", "expand")
        p = {k: v.detach().clone().requires_grad_(True) for k, v in
             params.items()}
        progs = TrainingPrograms(model, p, N=N_TRAIN, prior_precision=1.0,
                                 **{**cfg, **opts})
        with kron_default(approx), patch or contextlib.nullcontext():
            r = time_hyperstep(torch, core,
                               lambda: progs.hyperstep(idx, yy))
            nm = float(progs.neg_marglik_eval(idx, yy))
        if r["core_spmm_launches"] <= 0 or not math.isfinite(nm):
            raise AssertionError(f"hyperstep {label}: {r}, value {nm}")
        r["neg_marglik"] = nm
        rows[label] = r
        print(f"hyperstep [{label}]: median {r['ms']:.3f} ms over 5 (CUDA "
              f"events), {r['device_ms']:.3f} ms of device time in "
              f"{r['device_launches']} device launches, "
              f"{r['core_spmm_launches']:g} core_spmm launches "
              f"({r['core_spmm_ms']:.3f} ms), peak {r['peak_gb']:.3f} GB; "
              f"-log marglik {nm:.4f}  [{card}]", flush=True)
        del progs
        torch.cuda.empty_cache()
    vm, lp = rows["type-2"], rows["type-2, column loop"]
    if vm["core_spmm_launches"] >= lp["core_spmm_launches"]:
        raise AssertionError(f"the vmapped pullback launched core_spmm "
                             f"{vm['core_spmm_launches']} times, the loop "
                             f"{lp['core_spmm_launches']}")
    rel = abs(vm["neg_marglik"] - lp["neg_marglik"]) / abs(lp["neg_marglik"])
    if rel > 1e-4:
        raise AssertionError(f"vmapped vs loop -log marglik: relative {rel}")
    print(f"type-2 hyperstep: vmapped pullback {vm['core_spmm_launches']:g} "
          f"core_spmm launches, {vm['device_ms']:.3f} device ms; column loop "
          f"{lp['core_spmm_launches']:g}, {lp['device_ms']:.3f} device ms; "
          f"-log marglik agrees to {rel:.1e}  [{card}]", flush=True)
    return rows


def phase_curvature_small(torch, np):
    """Every option of CURVATURE_OPTIONS and hessian_structure "full" on a
    small graph: the kernel path in float32 on the card against the
    float64 CPU path (which the CPU tests hold to the JAX package), with
    the same draws: the sketch and the probes come from CPU generators,
    and the MC labels of the CPU run are replayed on the card (a label
    drawn at a float32 output could cross a class boundary). Held at 1e-2
    relative, as the kernel rounds its operands to bf16."""
    from laplace_gnn_torch.curvature import kfac
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.training.marglik_gnn import make_neg_marglik_fn
    rng = np.random.default_rng(9)
    n, f = 96, 24
    X = rng.standard_normal((n, f))
    adj = (rng.random((n, n)) < 0.08).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, N_CLASS, n)
    out = {}
    for label, opts in CURVATURE_OPTIONS + [("full", {
            "hessian_structure": "full"})]:
        opts = dict(opts)
        structure = opts.pop("hessian_structure", "kron")
        approx = opts.pop("kfac_approx", "expand")
        labels, vals = [], {}
        draw = kfac._draw_label
        for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
            m = STEGCN(f, 16, N_CLASS, 2, X, adj, dropout_p=0.0, fused=True,
                       symmetric=True, device=dev, dtype=dt,
                       generator=torch.Generator().manual_seed(0))
            fn = make_neg_marglik_fn(m, "classification", structure, "all",
                                     N=40, fisher_seed=3, **opts)
            replay = iter(labels)

            def recorded(seed, i, lik, f_, dev=dev):
                if dev == "cpu":
                    labels.append(draw(seed, i, lik, f_))
                    return labels[-1]
                return next(replay).to(f_.device)

            with mock.patch.object(kfac, "_draw_label", recorded), \
                    kron_default(approx):
                vals[dev] = float(fn(m.params(), torch.arange(40, device=dev),
                                     torch.as_tensor(y[:40], device=dev)
                                     ).detach())
        rel = abs(vals["cuda"] - vals["cpu"]) / abs(vals["cpu"])
        if not math.isfinite(vals["cuda"]) or rel > 1e-2:
            raise AssertionError(f"small-graph {label}: {vals}")
        out[label] = {**vals, "rel": rel}
        print(f"small-graph -log marglik [{label}]: card {vals['cuda']:.6f} "
              f"vs CPU f64 {vals['cpu']:.6f} (relative {rel:.2e}, held at "
              f"1e-2)", flush=True)
    return out


def phase_gat_probes(torch, gat_run, state, kernels, card):
    """The phase-6 GAT's -log marglik at N = 2708 with the Hutchinson
    estimate of the attention parameters' diagonal (8 probes, in sequence
    and 4 a vmapped step) beside the exact blocks' time and memory from
    phase 6; two calls must give the same bits, and no flash kernel runs
    (jvp_safe)."""
    model, _, y, perm = state
    tr = perm[:N_TRAIN]
    part, parts = run_parts(torch, kernels, card, "GAT -log marglik")
    none = {"flash_fwd": 0, "flash_bwd": 0}
    vals = {}
    for probe_batch in (None, 4):
        progs = gat_programs(model, N_TRAIN, diag_probes=8,
                             probe_batch=probe_batch)
        name = f"diag_probes 8, probe_batch {probe_batch}"
        a = part(name, lambda: progs.neg_marglik_eval(tr, y[tr]), none)
        b = progs.neg_marglik_eval(tr, y[tr])
        if not (torch.equal(a, b) and math.isfinite(float(a))):
            raise AssertionError(f"GAT {name}: {float(a)} then {float(b)}")
        vals[name] = float(a)
        del progs
        torch.cuda.empty_cache()
    print(f"GAT -log marglik at N={GAT_N_TRAIN}: probes {vals}; exact "
          f"blocks (phase 6) {gat_run['neg_marglik_eval_s']:.3f} s, "
          f"{gat_run['neg_marglik_peak_gb']:.3f} GB  [{card}]", flush=True)
    return {"parts": parts, "values": vals}


# the other dense models, as marglik_optimization trains them: (label,
# model class, options, model_type, hessian_structure). GCN(res=True)
# cannot take the Kron structure (as in JAX, its residual Linears are
# untapped KFAC sites), so it runs "diag" like STEGCN(res=True)
DENSE_MODELS = [
    ("graphsage", "GraphSAGE", {}, "graphsage", "kron"),
    ("graphsage, k 5", "GraphSAGE", {"num_sampled_nodes_per_hop": 5},
     "graphsage", "kron"),
    ("stegraphsage", "STEGraphSAGE", {"symmetric": True}, "stegraphsage",
     "kron"),
    ("lorastegcn, r 16", "LoRASTEGCN", {"r": 16, "lora_alpha": 16,
                                        "symmetric": True}, "lorastegcn",
     "kron"),
    ("attstegcn, d_k 8", "AttSTEGCN", {"d_k": 8, "symmetric": True},
     "attstegcn", "kron"),
    ("stegcn fused, norm layer", "STEGCN", {"fused": True, "norm": "layer",
                                            "symmetric": True}, "stegcn",
     "kron"),
    ("stegcn fused, norm batch", "STEGCN", {"fused": True, "norm": "batch",
                                            "symmetric": True}, "stegcn",
     "kron"),
    ("gcn fused, res", "GCN", {"fused": True, "res": True}, "gcn", "diag"),
    ("stegcn, res, diag", "STEGCN", {"res": True, "symmetric": True},
     "stegcn", "diag"),
]
# the Cora section of the STE-GCN config, as phase 3 runs it
CORA_CFG = dict(lr=1e-3, lr_adj=0.8, momentum_adj=0.9, weight_decay=5e-5,
                weight_decay_adj=5e-4, grad_norm=True,
                subset_of_weights="all")


def dense_model(torch, cls_name, opts, n_in, hidden, X, adj, dev, dtype,
                dropout_p=0.5):
    from laplace_gnn_torch import models
    return getattr(models, cls_name)(
        n_in, hidden, N_CLASS, 2, X, adj, dropout_p=dropout_p, device=dev,
        dtype=dtype, generator=torch.Generator().manual_seed(0), **opts)


def step_ms(torch, fn, reps: int = 5):
    """Median ms of ``reps`` calls by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return sorted(ms)[reps // 2], ms


def phase_dense_models(torch, np, card):
    """The other dense models under marglik_optimization at Cora's width
    (the phase-3 synthetic graph, 4 epochs, 1 burn-in epoch, one round of 2
    hypersteps), each with its wall time, peak memory and core_spmm
    launches (count set to 0 just before the run and read just after),
    then one train step and one hyperstep timed (median of 5, CUDA
    events)."""
    from laplace_gnn_torch.ops.fused_spmm import core
    from laplace_gnn_torch.training.marglik_gnn import (
        TrainingPrograms, marglik_optimization)
    rng = np.random.default_rng(0)
    X, adj, y = make_graph(np, rng)
    perm = rng.permutation(N_NODES)
    tr, va = perm[:N_TRAIN], perm[N_TRAIN:N_TRAIN + N_VAL]
    idx = torch.as_tensor(tr, device="cuda")
    yy = torch.as_tensor(y[tr], device="cuda")
    rows = {}
    for label, cls_name, opts, model_type, structure in DENSE_MODELS:
        model = dense_model(torch, cls_name, opts, N_FEAT, HIDDEN, X, adj,
                            "cuda", torch.float32)
        params = model.params()
        hypersteps = [0]
        hyperstep = TrainingPrograms.hyperstep

        def counted(self, *args, **kwargs):
            hypersteps[0] += 1
            return hyperstep(self, *args, **kwargs)

        def run():
            with mock.patch.object(TrainingPrograms, "hyperstep", counted):
                return marglik_optimization(
                    model, params, tr, y[tr], va, y[va], y=y, n_epochs=4,
                    n_hypersteps=2, n_epochs_burnin=1, marglik_frequency=2,
                    hessian_structure=structure, model_type=model_type,
                    verbose=False, device="cuda", **CORA_CFG)

        core.launches = 0
        (_, final, losses, val_losses, nms), run_s, gb = timed(torch, run)
        launches = core.launches
        if not all(math.isfinite(v) for v in losses + val_losses + nms) or \
                not all(bool(torch.isfinite(v).all()) for v in final.values()):
            raise AssertionError(f"{label}: non-finite run {losses} {nms}")
        moved = {k for k in final if not torch.equal(final[k], params[k])}
        want_hyper = 0 if model_type in ("gcn", "graphsage") else 2
        if hypersteps[0] != want_hyper:
            raise AssertionError(f"{label}: {hypersteps[0]} hypersteps ran, "
                                 f"expected {want_hyper}")
        if model_type == "lorastegcn" and (
                moved & {"adj", "adj_lora_A", "adj_lora_B"}
                != {"adj_lora_A", "adj_lora_B"}):
            raise AssertionError(f"{label}: adjacency parameters moved: "
                                 f"{sorted(moved)}")
        if (opts.get("fused") and launches == 0) or (
                not opts.get("fused") and launches != 0):
            raise AssertionError(f"{label}: {launches} core_spmm launches")
        p = {k: v.detach().clone().requires_grad_(True) for k, v in
             final.items()}
        progs = TrainingPrograms(model, p, N=N_TRAIN, prior_precision=1.0,
                                 hessian_structure=structure, **CORA_CFG)
        gen = torch.Generator(device="cuda").manual_seed(0)
        core.launches = 0
        train_ms, _ = step_ms(torch, lambda: progs.train_step(idx, yy, gen))
        train_launches = core.launches / 6
        core.launches = 0
        hyper_ms, _ = step_ms(torch, lambda: progs.hyperstep(idx, yy))
        hyper_launches = core.launches / 6
        rows[label] = {"run_s": run_s, "peak_gb": gb,
                       "core_spmm_launches": launches,
                       "hypersteps_run": hypersteps[0],
                       "train_step_ms": train_ms,
                       "train_step_core_spmm": train_launches,
                       "hyperstep_ms": hyper_ms,
                       "hyperstep_core_spmm": hyper_launches,
                       "structure": structure, "moved": sorted(moved),
                       "neg_margliks": nms}
        print(f"dense model [{label}] ({structure}): 4 epochs, "
              f"{hypersteps[0]} hypersteps in {run_s:.3f} s (host clock), "
              f"peak {gb:.3f} GB, {launches} core_spmm launches; train step "
              f"{train_ms:.3f} ms ({train_launches:g} launches), hyperstep "
              f"{hyper_ms:.3f} ms ({hyper_launches:g}) (medians of 5, CUDA "
              f"events); -log marglik {nms[-1]:.4f}  [{card}]", flush=True)
        del model, params, final, progs, p
        torch.cuda.empty_cache()
    return rows


def phase_dense_small(torch, np):
    """Each DENSE_MODELS entry on a small graph, float32 on the card
    against the float64 CPU path (which the CPU tests hold to the JAX
    package): a train-mode CE loss and its weight gradients (dropout 0; the
    neighbour sample's uniforms drawn in float32 on the CPU for both) and
    the -log marglik of the entry's structure. The fused entries are held
    at 1e-2 relative (the kernel rounds its operands to bf16), the composed
    ones at 1e-4 (float32 throughout, TF32 off: a path that computed in
    bf16 or TF32 would miss it)."""
    from laplace_gnn_torch.ops import adjacency
    from laplace_gnn_torch.training.marglik_gnn import (_ce_mean,
                                                        make_neg_marglik_fn)
    rng = np.random.default_rng(12)
    n, f = 96, 24
    X = rng.standard_normal((n, f))
    a = (rng.random((n, n)) < 0.08).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, N_CLASS, n)

    def uniforms(m, generator, dtype, device):
        g = torch.Generator().manual_seed(0)
        return torch.rand((m, m), generator=g).to(device, dtype)

    out = {}
    for label, cls_name, opts, _, structure in DENSE_MODELS:
        vals = {}
        for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
            m = dense_model(torch, cls_name, opts, f, 16, X, adj, dev, dt,
                            dropout_p=0.0)
            p = {k: v.detach().requires_grad_(True)
                 for k, v in m.params().items()}
            idx = torch.arange(40, device=dev)
            yy = torch.as_tensor(y[:40], device=dev)
            with mock.patch.object(adjacency, "_neigh_uniforms", uniforms):
                loss = _ce_mean(m.apply(p, idx, train=True,
                                        generator=torch.Generator(dev)), yy)
            names = [k for k in p if "adj" not in k]
            grads = torch.autograd.grad(loss, [p[k] for k in names])
            fn = make_neg_marglik_fn(m, "classification", structure, "all",
                                     N=40)
            nm = fn({k: v.detach() for k, v in p.items()}, idx, yy)
            vals[dev] = (float(loss.detach()), torch.cat(
                [g.reshape(-1) for g in grads]).double().cpu(),
                float(nm.detach()))
        (lc, gc, nc), (lp, gp, npp) = vals["cuda"], vals["cpu"]
        errs = (abs(lc - lp) / abs(lp), _rel(gc, gp), abs(nc - npp) / abs(npp))
        tol = 1e-2 if opts.get("fused") else 1e-4
        if not all(math.isfinite(v) for v in (lc, nc)) or max(errs) > tol:
            raise AssertionError(f"small-graph [{label}]: loss {lc} vs {lp}, "
                                 f"grad rel {errs[1]}, -log marglik {nc} vs "
                                 f"{npp}")
        out[label] = {"loss_rel": errs[0], "grad_rel": errs[1],
                      "neg_marglik": {"cuda": nc, "cpu": npp},
                      "neg_marglik_rel": errs[2], "tol": tol}
        print(f"small-graph [{label}]: train-mode loss rel {errs[0]:.2e}, "
              f"weight gradients rel {errs[1]:.2e}, -log marglik ({structure})"
              f" card {nc:.6f} vs CPU f64 {npp:.6f} (rel {errs[2]:.2e}; all "
              f"held at {tol:g})", flush=True)
    return out


def phase_laplace_flavors(torch, np, state, kernels, card):
    """DiagLaplace on the phase-3 STE-GCN (fused kernel path, hidden 64)
    and FullLaplace on an STE-GCN of hidden 16 over the same graph: the
    fit, the log marglik, marglik tuning of the prior precision (scalar
    and layerwise), a grid search on the 500 validation nodes, the probit
    predictive on 1000 nodes, 100 GLM predictive samples and a state_dict
    round trip, each part with its time, peak memory and launches."""
    from laplace_gnn_torch.laplace.dispatch import Laplace
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.training.marglik_gnn import fit_laplace
    from laplace_gnn_torch.utils.data import ArrayLoader
    model, params, y, perm = state
    tr, va = perm[:N_TRAIN], perm[N_TRAIN:N_TRAIN + N_VAL]
    te = perm[N_TRAIN + N_VAL:N_TRAIN + N_VAL + N_TEST]
    idx = torch.as_tensor(te, device="cuda")
    val = ArrayLoader(va, y[va], device="cuda")
    chunks = math.ceil(N_TEST / JAC_CHUNK)
    val_chunks = math.ceil(N_VAL / JAC_CHUNK)
    bk = {"backend_kwargs": {"jac_chunk_size": JAC_CHUNK}}
    small = STEGCN(N_FEAT, FULL_HIDDEN, N_CLASS, 2, model.X, model.init_adj,
                   dropout_p=0.5, fused=True, symmetric=True, device="cuda",
                   generator=torch.Generator().manual_seed(0))
    small_params = {**small.params(), "adj": params["adj"]}
    out = {}
    for structure, m, p, steps in (("diag", model, params, 100),
                                   ("full", small, small_params, 5)):
        part, parts = run_parts(torch, kernels, card,
                                f"{structure.capitalize()}Laplace")
        zero = {"core_spmm": 0, "matmul": 0}
        la = part("fit_laplace", lambda: fit_laplace(
            m, p, tr, y[tr], hessian_structure=structure, **bk),
            {"core_spmm": None, "matmul": 0})
        lml = float(part("log_marglik", la.log_marginal_likelihood, zero))
        tuned = {}
        for ps in ("scalar", "layerwise"):
            part(f"marglik_tuning_{ps}_{steps}", lambda: (
                la.optimize_prior_precision(method="marglik", n_steps=steps,
                                            prior_structure=ps)), zero)
            tuned[ps] = la.prior_precision.tolist()
        part("gridsearch_20", lambda: la.optimize_prior_precision(
            method="gridsearch", val_loader=val, grid_size=20),
            {"core_spmm": 20 * (2 + 2 * val_chunks), "matmul": 0})
        tuned["gridsearch"] = la.prior_precision.tolist()
        probs = part(f"probit_{N_TEST}", lambda: la(idx,
                                                    link_approx="probit"),
                     {"core_spmm": 2 + 2 * chunks, "matmul": 0})
        _check_probs(np, probs, N_TEST)
        samples = part("predictive_samples_glm_100", lambda: (
            la.predictive_samples(idx, n_samples=100)),
            {"core_spmm": 2 + 2 * chunks, "matmul": 0})
        if samples.shape != (100, N_TEST, N_CLASS) or \
                not bool(torch.isfinite(samples).all()):
            raise AssertionError(f"{structure} predictive samples: "
                                 f"{tuple(samples.shape)}")
        state_dict = part("state_dict", la.state_dict, zero)
        fresh = Laplace(m, p, "classification", "all", structure, **bk)
        part("load_state_dict", lambda: fresh.load_state_dict(state_dict),
             zero)
        a, b = la.log_marginal_likelihood(), fresh.log_marginal_likelihood()
        if not torch.equal(a, b) or not math.isfinite(float(a)):
            raise AssertionError(f"{structure} state_dict round trip: "
                                 f"{float(a)} then {float(b)}")
        steps_s = {ps: parts[f"marglik_tuning_{ps}_{steps}"]["s"] / steps
                   for ps in ("scalar", "layerwise")}
        print(f"{structure.capitalize()}Laplace: P = {la.n_params}, log "
              f"marglik {lml:.4f} (after tuning {float(a):.4f}); tuned prior "
              f"precision {tuned}; marglik tuning s a step {steps_s}; the "
              f"Jacobians' core_spmm calls are the wide (N, {JAC_CHUNK} x "
              f"{N_CLASS} x hidden) shapes  [{card}]", flush=True)
        out[structure] = {"parts": parts, "log_marglik": lml,
                          "n_params": la.n_params, "tuned": tuned,
                          "tuning_s_per_step": steps_s,
                          "log_marglik_tuned": float(a)}
        del la, fresh, state_dict, samples, probs
        torch.cuda.empty_cache()
    return out


def phase_laplace_flavors_small(torch, np):
    """FullLaplace and DiagLaplace on a small graph: the log marglik, the
    prior precision after 10 steps of marglik tuning and the probit
    probabilities, the kernel path in float32 on the card against the
    float64 CPU path (which the CPU tests hold to the JAX package). Held
    at 1e-2: the kernel rounds its operands to bf16."""
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.training.marglik_gnn import fit_laplace
    rng = np.random.default_rng(13)
    n, f = 96, 24
    X = rng.standard_normal((n, f))
    a = (rng.random((n, n)) < 0.08).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, N_CLASS, n)
    out = {}
    for structure in ("full", "diag"):
        vals = {}
        for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
            m = STEGCN(f, 16, N_CLASS, 2, X, adj, dropout_p=0.0, fused=True,
                       symmetric=True, device=dev, dtype=dt,
                       generator=torch.Generator().manual_seed(0))
            la = fit_laplace(m, m.params(), np.arange(40), y[:40],
                             hessian_structure=structure)
            lml = float(la.log_marginal_likelihood())
            la.optimize_prior_precision(method="marglik", n_steps=10,
                                        prior_structure="layerwise")
            vals[dev] = (lml, la.prior_precision.double().cpu(),
                         la(torch.arange(40, n, device=dev),
                            link_approx="probit").detach().double().cpu())
        (lc, pc, qc), (lp, pp, qp) = vals["cuda"], vals["cpu"]
        errs = (abs(lc - lp) / abs(lp), float(((pc - pp) / pp).abs().max()),
                float((qc - qp).abs().max()))
        if not math.isfinite(lc) or max(errs) > 1e-2:
            raise AssertionError(f"small {structure} Laplace: {vals}")
        out[structure] = {"log_marglik": {"cuda": lc, "cpu": lp},
                          "errors": errs}
        print(f"small-graph {structure} Laplace: log marglik card {lc:.6f} "
              f"vs CPU f64 {lp:.6f} (rel {errs[0]:.2e}); tuned prior "
              f"precision max rel {errs[1]:.2e}; probit max abs diff "
              f"{errs[2]:.2e} (held at 1e-2)", flush=True)
    return out


# phase 14: the rest of the Laplace library at Cora's width
LIB_SUBNET = 4096          # subnetwork size (a 64 MB f32 Full posterior)
LIB_GRID, LIB_SAMPLES, LIB_SWAG = 10, 100, 10
LIB_TRAINING = dict(hessian_structure="kron", prior_structure="layerwise",
                    n_epochs=20, n_epochs_burnin=5, marglik_frequency=5,
                    n_hypersteps=10)
# LeNet's convolutions at MNIST's shape: 1 x 28 x 28 -> 6 -> 16 (5 x 5)
CNN_SPECS, CNN_HEAD_IN, CNN_CLASSES = [(1, 6, 5), (6, 16, 5)], 16 * 20 * 20, 10
CNN_TRAIN, CNN_TEST, CNN_BATCH = 1024, 256, 256
# images per vmapped Jacobian pass: each of its C cotangent columns pulls
# back through the whole batch (~80 MB a column at 256 images)
CNN_JAC_CHUNK = 8


def _fitted(la, loader):
    la.fit(loader)
    return la


def _finite(torch, label, *tensors):
    for t in tensors:
        if not bool(torch.isfinite(torch.as_tensor(t)).all()):
            raise AssertionError(f"{label}: non-finite values")


def phase_library(torch, np, state, kernels, card):
    """The rest of the Laplace library on the phase-3 STE-GCN (fused kernel
    path, Cora's width, its learned adjacency): last-layer Kron (the
    default key), Diag (with ``functional_variance_fast``) and Full; GP
    Laplace over all weights and over the last layer; Full and Diag
    subnetwork Laplace on 4096-parameter masks and a SWAG mask;
    ``marglik_training``; then Kron and last-layer Kron on a LeNet-shaped
    CNN at MNIST's shape. Each part with its time, peak memory and
    launches."""
    from laplace_gnn_torch.laplace import subnet
    from laplace_gnn_torch.laplace.dispatch import Laplace
    from laplace_gnn_torch.laplace.marglik import marglik_training
    from laplace_gnn_torch.nn import CNN
    from laplace_gnn_torch.utils.data import ArrayLoader
    from laplace_gnn_torch.utils.pytree import tree_vector
    model, params, y, perm = state
    dev = params["adj"].device
    params = {k: v.detach() for k, v in params.items()}
    tr, va = perm[:N_TRAIN], perm[N_TRAIN:N_TRAIN + N_VAL]
    te = perm[N_TRAIN + N_VAL:N_TRAIN + N_VAL + N_TEST]
    idx = torch.as_tensor(te, device=dev)
    train = ArrayLoader(tr, y[tr], device=dev)
    val = ArrayLoader(va, y[va], device=dev)
    bk = {"backend_kwargs": {"jac_chunk_size": JAC_CHUNK}}
    on, off = {"core_spmm": None, "matmul": 0}, {"core_spmm": 0, "matmul": 0}
    out = {}

    def probit(part, la, **kw):
        probs = part(f"probit_{len(te)}", lambda: la(idx, link_approx="probit",
                                                     **kw), on)
        _check_probs(np, probs, len(te))
        return probs

    # -- last layer: Kron (the default key), Diag, Full ----------------------
    for structure in ("kron", "diag", "full"):
        label = f"LL-{structure}"
        part, parts = run_parts(torch, kernels, card, label)
        kw = {} if structure == "kron" else {"hessian_structure": structure}
        la = part("fit", lambda: _fitted(Laplace(
            model, params, "classification", **kw, **bk), train), on)
        lml = float(part("log_marglik", la.log_marginal_likelihood, off))
        part("marglik_tuning_scalar_100", lambda: la.optimize_prior_precision(
            method="marglik", n_steps=100), off)
        probit(part, la)
        if structure == "diag":
            f, var = part(f"functional_variance_fast_{len(te)}",
                          lambda: la.functional_variance_fast(idx), on)
            # as in JAX, a GNN's features are the last conv's input over the
            # whole graph: one variance row per node
            if var.shape != (N_NODES, N_CLASS):
                raise AssertionError(f"functional_variance_fast: {var.shape}")
            _finite(torch, label, var)
        _finite(torch, label, lml, la.prior_precision)
        print(f"{label}: {type(la).__name__}, P = {la.n_params}, log marglik "
              f"{lml:.4f}, tuned prior precision "
              f"{la.prior_precision.tolist()}  [{card}]", flush=True)
        out[label] = {"parts": parts, "n_params": la.n_params,
                      "log_marglik": lml}
        del la
    torch.cuda.empty_cache()

    # -- GP over all weights and over the last layer -------------------------
    for subset in ("all", "last_layer"):
        label = f"GP-{subset}"
        part, parts = run_parts(torch, kernels, card, label)
        la = part("fit", lambda: _fitted(Laplace(
            model, params, "classification", subset, "gp",
            n_subset=N_TRAIN, **bk), train), on)
        lml = float(part("log_marglik", la.log_marginal_likelihood, off))
        part(f"gridsearch_{LIB_GRID}", lambda: la.optimize_prior_precision(
            method="gridsearch", val_loader=val, grid_size=LIB_GRID), on)
        probit(part, la)
        s = part(f"predictive_samples_{LIB_SAMPLES}", lambda: (
            la.predictive_samples(idx, n_samples=LIB_SAMPLES)), on)
        if s.shape != (LIB_SAMPLES, len(te), N_CLASS):
            raise AssertionError(f"{label} samples: {tuple(s.shape)}")
        _finite(torch, label, lml, s, la.prior_precision)
        print(f"{label}: P = {la.n_params}, J_M {tuple(la._J_M.shape)} "
              f"{la._J_M.dtype}, K_MM {tuple(la.K_MM.shape)}, log marglik "
              f"{lml:.4f}, grid-searched prior precision "
              f"{la.prior_precision.tolist()}  [{card}]", flush=True)
        out[label] = {"parts": parts, "n_params": la.n_params,
                      "log_marglik": lml, "J_M": list(la._J_M.shape)}
        del la, s
        torch.cuda.empty_cache()

    # -- subnetworks -----------------------------------------------------------
    part, parts = run_parts(torch, kernels, card, "subnet masks")
    masks = {
        "largest_magnitude": part("largest_magnitude", lambda: (
            subnet.LargestMagnitudeSubnetMask(model, params, LIB_SUBNET)
            .select(train)), off),
        "largest_variance_diag": part("largest_variance_diag", lambda: (
            subnet.LargestVarianceDiagLaplaceSubnetMask(
                model, params, LIB_SUBNET).select(train)), on),
        "largest_variance_swag": part(f"largest_variance_swag_{LIB_SWAG}",
                                      lambda: (
            subnet.LargestVarianceSWAGSubnetMask(
                model, params, LIB_SUBNET, swag_n_snapshots=LIB_SWAG)
            .select(train)), on)}
    for name, m in masks.items():
        if m.shape != (LIB_SUBNET,) or not bool((m[1:] > m[:-1]).all()):
            raise AssertionError(f"{name} mask: {tuple(m.shape)}")
    out["subnet masks"] = {"parts": parts}
    for structure, mask in (("full", "largest_magnitude"),
                            ("diag", "largest_variance_diag")):
        label = f"subnet-{structure}"
        part, parts = run_parts(torch, kernels, card, label)
        la = part("fit", lambda: _fitted(Laplace(
            model, params, "classification", "subnetwork", structure,
            subnetwork_indices=masks[mask], **bk), train), on)
        lml = float(part("log_marglik", la.log_marginal_likelihood, off))
        probit(part, la)
        s = part(f"sample_{LIB_SAMPLES}", lambda: la.sample(LIB_SAMPLES), off)
        theta = tree_vector(la.backend.w)
        rest = torch.ones(theta.shape[0], dtype=torch.bool, device=dev)
        rest[masks[mask]] = False
        if s.shape != (LIB_SAMPLES, theta.shape[0]) or not torch.equal(
                s[:, rest], theta[rest].expand(LIB_SAMPLES, -1)):
            raise AssertionError(f"{label} samples: {tuple(s.shape)}")
        _finite(torch, label, lml, s)
        print(f"{label}: P = {la.n_params} of {theta.shape[0]} ({mask} "
              f"mask), log marglik {lml:.4f}  [{card}]", flush=True)
        out[label] = {"parts": parts, "n_params": la.n_params,
                      "log_marglik": lml}
        del la, s
        torch.cuda.empty_cache()

    # -- marglik_training with the adjacency fixed -----------------------------
    part, parts = run_parts(torch, kernels, card, "marglik_training")
    la, best, margliks, losses = part("run", lambda: marglik_training(
        model, params, train, device=dev, **LIB_TRAINING), on)
    final = float(part("refit_log_marglik", la.log_marginal_likelihood, off))
    _finite(torch, "marglik_training", margliks, losses, final)
    if margliks[-1] < margliks[0]:
        raise AssertionError(f"marglik fell: {margliks}")
    if not torch.equal(best["adj"], params["adj"]):
        raise AssertionError("marglik_training moved the adjacency")
    print(f"marglik_training: margliks {margliks}; losses {losses[0]:.4f} .. "
          f"{losses[-1]:.4f}; prior precision {la.prior_precision.tolist()}; "
          f"refit log marglik {final:.4f}  [{card}]", flush=True)
    out["marglik_training"] = {"parts": parts, "margliks": margliks,
                               "losses": losses, "refit_log_marglik": final,
                               "prior_precision": la.prior_precision.tolist()}
    del la, best
    torch.cuda.empty_cache()

    # -- a LeNet-shaped CNN at MNIST's shape (no kernel of the port) -----------
    rng = np.random.default_rng(14)
    Xc = rng.standard_normal((CNN_TRAIN + CNN_TEST, 1, 28, 28)).astype(
        np.float32)
    yc = rng.integers(0, CNN_CLASSES, CNN_TRAIN + CNN_TEST)
    cnn = CNN(CNN_SPECS, CNN_HEAD_IN, CNN_CLASSES, device=dev,
              generator=torch.Generator().manual_seed(0))
    loader = ArrayLoader(Xc[:CNN_TRAIN], yc[:CNN_TRAIN],
                         batch_size=CNN_BATCH, device=dev)
    Xt = torch.as_tensor(Xc[CNN_TRAIN:], device=dev)
    for subset in ("all", "last_layer"):
        label = f"CNN-{subset}-kron"
        part, parts = run_parts(torch, kernels, card, label)
        la = part("fit", lambda: _fitted(Laplace(
            cnn, cnn.params(), "classification", subset, "kron",
            backend_kwargs={"jac_chunk_size": CNN_JAC_CHUNK}), loader), off)
        lml = float(part("log_marglik", la.log_marginal_likelihood, off))
        probs = part(f"probit_{CNN_TEST}", lambda: la(Xt, link_approx="probit"),
                     off)
        p = probs.detach().cpu().numpy()
        if p.shape != (CNN_TEST, CNN_CLASSES) or not np.all(np.isfinite(p)) \
                or np.abs(p.sum(-1) - 1).max() > 1e-4:
            raise AssertionError(f"{label} probit: {p.shape}")
        _finite(torch, label, lml)
        print(f"{label}: P = {la.n_params}, Kron factors "
              f"{[[tuple(f.shape) for f in g] for g in la.H_facs.kfacs]}, "
              f"log marglik {lml:.4f}  [{card}]", flush=True)
        out[label] = {"parts": parts, "n_params": la.n_params,
                      "log_marglik": lml}
        del la
    torch.cuda.empty_cache()
    return out


def phase_library_small(torch, np, devices=None):
    """The same flavours on a small graph, the kernel path in float32 on
    the card against the float64 CPU path (which the CPU tests hold to the
    JAX package): each flavour's log marglik and probit probabilities, and
    marglik_training's trace and final prior, held at 1e-2 (the kernel
    rounds its operands to bf16); then Kron on a small CNN, at 1e-4 (no
    kernel). ``devices`` maps "card" and "ref" to (device, dtype)."""
    from laplace_gnn_torch.laplace import subnet
    from laplace_gnn_torch.laplace.dispatch import Laplace
    from laplace_gnn_torch.laplace.marglik import marglik_training
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.nn import CNN
    from laplace_gnn_torch.training.marglik_gnn import fit_laplace
    from laplace_gnn_torch.utils.data import ArrayLoader
    rng = np.random.default_rng(14)
    n, f = 96, 24
    X = rng.standard_normal((n, f))
    a = (rng.random((n, n)) < 0.08).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, N_CLASS, n)
    tr, te = np.arange(40), np.arange(40, n)
    devices = devices or {"card": ("cuda", torch.float32),
                          "ref": ("cpu", torch.float64)}
    models = {k: STEGCN(f, 16, N_CLASS, 2, X, adj, dropout_p=0.0,
                        fused=True, symmetric=True, device=dev, dtype=dt,
                        generator=torch.Generator().manual_seed(0))
              for k, (dev, dt) in devices.items()}
    cpu = models["ref"]
    subnet_idx = subnet.LargestMagnitudeSubnetMask(
        cpu, cpu.params(), 200).select()
    keys = [("last_layer", "kron", {}), ("last_layer", "diag", {}),
            ("last_layer", "full", {}), ("all", "gp", {"n_subset": 20}),
            ("last_layer", "gp", {"n_subset": 20}),
            ("subnetwork", "full", {"subnetwork_indices": subnet_idx}),
            ("subnetwork", "diag", {"subnetwork_indices": subnet_idx})]
    out = {}
    for subset, structure, kw in keys:
        vals = {}
        for k, m in models.items():
            la = fit_laplace(m, m.params(), tr, y[tr], subset, structure,
                             **kw)
            vals[k] = (float(la.log_marginal_likelihood()),
                       la(torch.as_tensor(te, device=devices[k][0]),
                          link_approx="probit").detach().double().cpu())
        (lc, qc), (lp, qp) = vals["card"], vals["ref"]
        errs = (abs(lc - lp) / abs(lp), float((qc - qp).abs().max()))
        if not math.isfinite(lc) or max(errs) > 1e-2:
            raise AssertionError(f"small {subset} {structure}: {vals}")
        out[f"{subset}-{structure}"] = {"log_marglik": {"card": lc,
                                                        "ref": lp},
                                        "errors": errs}
        print(f"small-graph {subset} {structure}: log marglik card "
              f"{lc:.6f} vs CPU f64 {lp:.6f} (rel {errs[0]:.2e}); probit max "
              f"abs diff {errs[1]:.2e} (held at 1e-2)", flush=True)
    runs = {}
    for k, m in models.items():
        dev = devices[k][0]
        la, _, ml, ls = marglik_training(
            m, m.params(), ArrayLoader(tr, y[tr], device=dev), device=dev,
            n_epochs=4, marglik_frequency=2, n_hypersteps=3)
        runs[k] = (np.array(ml), np.array(ls),
                   la.prior_precision.double().cpu().numpy())
    errs = [float(np.max(np.abs(c - p) / np.abs(p)))
            for c, p in zip(runs["card"], runs["ref"])]
    if max(errs) > 1e-2:
        raise AssertionError(f"small marglik_training: {runs}")
    out["marglik_training"] = {"errors": errs}
    print(f"small-graph marglik_training: margliks, losses, prior "
          f"precision max rel {errs} (held at 1e-2)", flush=True)
    Xc = rng.standard_normal((32, 1, 8, 8))
    yc = rng.integers(0, 4, 32)
    vals = {}
    for k, (dev, dt) in devices.items():
        cnn = CNN([(1, 3, 3), (3, 4, 3)], 4 * 4 * 4, 4, device=dev, dtype=dt,
                  generator=torch.Generator().manual_seed(0))
        la = _fitted(Laplace(cnn, cnn.params(), "classification", "all",
                             "kron"), ArrayLoader(Xc.astype(np.float32 if dt
                                                  == torch.float32 else
                                                  np.float64), yc,
                                                  batch_size=16, device=dev))
        vals[k] = (float(la.log_marginal_likelihood()), la(
            torch.as_tensor(Xc, device=dev, dtype=dt)).double().cpu())
    (lc, qc), (lp, qp) = vals["card"], vals["ref"]
    errs = (abs(lc - lp) / abs(lp), float((qc - qp).abs().max()))
    if max(errs) > 1e-4:
        raise AssertionError(f"small CNN Kron: {vals}")
    out["cnn"] = {"errors": errs}
    print(f"small CNN Kron: log marglik card {lc:.6f} vs CPU f64 {lp:.6f} "
          f"(rel {errs[0]:.2e}); probit max abs diff {errs[1]:.2e} (held at "
          f"1e-4)", flush=True)
    return out


# phase 15: the curvature engine at Cora's width
ENGINE_RANK = 10           # LowRank's Lanczos depth
ENGINE_COLS = 10           # GGN matmat columns
ENGINE_NCV = 64            # spectral density's Lanczos depth
ENGINE_PROBES = 16         # Hutchinson probes
ENGINE_ITERS = 20          # CG and LSMR iterations
ENGINE_DAMP = 1.0          # LSMR's damp, the KFAC inverse's damping
ENGINE_SAMPLES = 100       # LowRank posterior samples (hidden 16)


def _jt_witness(torch, model, composed, params, data, JT, u, jtu, ref,
                composed_model):
    """Where the fused model's J^T u parts from the composed path's
    (``ref``): ``core_spmm`` rounds t, and the transposed call its
    cotangent, to bf16 and sums in f32. The composed path run with that
    rounding (``core`` swapped for its plain version on bf16-rounded
    operands, the same for the pullback's transposed calls) and the f32
    composed path given the kernel's ReLU masks should both land on the
    kernel's ``jtu = JT.matvec(u)``; the masks of the three forwards,
    counted over the hidden layer's N x hidden units, say how many the
    rounding flips."""
    from laplace_gnn_torch import curvature as C
    from laplace_gnn_torch.ops import fused_spmm as fs
    kernel_core = fs.core

    def rounded_core(adj, t, threshold=0.5, binarize=True,
                     transpose=False):
        return fs.core_reference(adj, t.to(torch.bfloat16).to(t.dtype),
                                 threshold, binarize, transpose)

    def masks(m):
        with torch.no_grad():
            return m.features(params)[0] > 0

    m_kernel, m_plain = masks(model), masks(composed)
    fs.core = rounded_core
    try:
        m_rounded = masks(model)
        jtu_rounded = JT.matvec(u)
    finally:
        fs.core = kernel_core
    fixed = composed_model(model.hidden_channels)
    fixed.act = lambda x: x * m_kernel.to(x.dtype)
    bm = C.GGNBackend(fixed, params, "classification")
    jtu_masked = C.TransposedJacobianOperator(bm.model_fn, bm.w,
                                              data).matvec(u)
    return {"rounded_rel": _rel(jtu, jtu_rounded),
            "rounded_vs_composed_rel": _rel(jtu_rounded, ref),
            "kernel_masks_rel": _rel(jtu, jtu_masked),
            "mask_flips": int((m_kernel != m_plain).sum()),
            "rounded_mask_flips": int((m_kernel != m_rounded).sum()),
            "units": m_kernel.numel()}


def phase_curvature_engine(torch, np, state, kernels, card):
    """The curvature engine on the phase-3 graph and learned adjacency:
    on the composed STE-GCN (``fused=False``) at hidden 64 (P = 92,231)
    a GGN matvec and a 10-column matmat, a Hessian and an EF matvec,
    LowRank Laplace of rank 10 (fit, log marglik, 100 steps of marglik
    tuning), the Lanczos spectral density with ncv 64, Hutchinson's trace
    and diagonal with 16 probes, 20 CG iterations on GGN + prior, 20 LSMR
    iterations (damp 1) on the Jacobian, and one activation-Hessian matvec
    at the last tap site (N x C = 18,956 dims); LowRank at hidden 16
    (P = 23,063): the probit predictive on 1000 nodes and 100 samples,
    which form the dense covariance; on the fused STE-GCN (the phase-3
    model) LowRank's fit must raise (no forward-mode rule in the fused
    op), and the transposed-Jacobian matvec, the Kron fit and the KFAC
    inverse (plain, heuristic, exact) with one matvec each run through
    ``core_spmm``; the transposed-Jacobian matvec is held against the
    composed path and the two paths of ``_jt_witness``. Each part with
    its time, peak memory and launches."""
    from laplace_gnn_torch import curvature as C
    from laplace_gnn_torch.curvature.inverse import cg
    from laplace_gnn_torch.laplace.dispatch import Laplace
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.utils.data import ArrayLoader
    model, params, y, perm = state
    dev = params["adj"].device
    params = {k: v.detach() for k, v in params.items()}
    tr = perm[:N_TRAIN]
    te = perm[N_TRAIN + N_VAL:N_TRAIN + N_VAL + N_TEST]
    idx = torch.as_tensor(tr, device=dev)
    yy = torch.as_tensor(y[tr], device=dev)
    train = ArrayLoader(tr, y[tr], device=dev)
    data = [(idx, yy)]
    bk = {"backend_kwargs": {"jac_chunk_size": JAC_CHUNK}}
    zero = {"core_spmm": 0, "matmul": 0}
    on = {"core_spmm": None, "matmul": 0}
    gen = torch.Generator(device=dev).manual_seed(15)
    out = {}

    def composed_model(hidden):
        return STEGCN(N_FEAT, hidden, N_CLASS, 2, model.X, model.init_adj,
                      dropout_p=0.5, fused=False, symmetric=True, device=dev,
                      generator=torch.Generator().manual_seed(0))

    # -- composed STE-GCN, hidden 64 --------------------------------------
    label = f"composed STE-GCN h{HIDDEN}"
    part, parts = run_parts(torch, kernels, card, label)
    composed = composed_model(HIDDEN)
    be = C.GGNBackend(composed, params, "classification")
    P = be.n_params
    v = torch.randn(P, generator=gen, device=dev)
    V = torch.randn(P, ENGINE_COLS, generator=gen, device=dev)
    ggn = C.GGNOperator(be.model_fn, "classification", be.w, data)
    gv = part("ggn_matvec", lambda: ggn.matvec(v), zero)
    GV = part(f"ggn_matmat_{ENGINE_COLS}", lambda: ggn.matmat(V), zero)
    col_err = _rel(GV[:, 1], ggn.matvec(V[:, 1]))
    hv = part("hessian_matvec", lambda: C.HessianOperator(
        be.model_fn, "classification", be.w, data).matvec(v), zero)
    ev = part("ef_matvec", lambda: C.EFOperator(
        be.model_fn, "classification", be.w, data).matvec(v), zero)
    _finite(torch, label, gv, GV, hv, ev)
    if col_err > 1e-4 or float(v @ gv) < 0 or float(v @ ev) < 0:
        raise AssertionError(f"{label}: matmat column vs matvec {col_err}, "
                             f"v.Gv {float(v @ gv)}, v.Fv {float(v @ ev)}")

    la = part(f"lowrank_fit_rank{ENGINE_RANK}", lambda: _fitted(Laplace(
        composed, params, "classification", "all", "lowrank",
        rank=ENGINE_RANK), train), zero)
    lml = float(part("lowrank_log_marglik", la.log_marginal_likelihood,
                     zero))
    part("lowrank_marglik_tuning_scalar_100", lambda: (
        la.optimize_prior_precision(method="marglik", n_steps=100)), zero)
    evals = la.H[1]
    # a Ritz pair's Rayleigh quotient is its Ritz value
    ray_err = abs(float(la.V[:, 0] @ ggn.matvec(la.V[:, 0]))
                  - float(evals[0])) / float(evals[0])
    _finite(torch, label, lml, evals, la.prior_precision)
    if evals.shape[0] < 1 or not bool((evals[:-1] >= evals[1:]).all()) \
            or ray_err > 1e-3:
        raise AssertionError(f"{label} LowRank: eigenvalues "
                             f"{evals.tolist()}, Rayleigh error {ray_err}")

    grid, density = part(f"lanczos_approximate_spectrum_ncv{ENGINE_NCV}",
                         lambda: C.lanczos_approximate_spectrum(
                             ggn, ncv=ENGINE_NCV, seed=15), zero)
    mass = float(np.trapezoid(density, grid))
    tr_est = part(f"hutchinson_trace_{ENGINE_PROBES}", lambda: (
        C.hutchinson_trace(ggn, ENGINE_PROBES, seed=15)), zero)
    diag_est = part(f"hutchinson_diag_{ENGINE_PROBES}", lambda: (
        C.hutchinson_diag(ggn, ENGINE_PROBES, seed=15)), zero)
    # Rademacher probes: sum_i v_i (A v)_i is v^T A v, so the diagonal's
    # sum is the trace estimate of the same probes
    sum_err = abs(float(diag_est.sum()) - float(tr_est)) / float(tr_est)
    if not (np.all(np.isfinite(density)) and abs(mass - 1) < 0.25
            and sum_err < 1e-4):
        raise AssertionError(f"{label}: density mass {mass}, diagonal sum "
                             f"vs trace {sum_err}")

    shifted = C.DiagShiftOperator(ggn, torch.ones(P, device=dev))
    x, k = part(f"cg_{ENGINE_ITERS}", lambda: cg(
        shifted.matvec, v, tol=0.0, maxiter=ENGINE_ITERS), zero)
    cg_res = _rel(shifted.matvec(x), v)
    J = C.JacobianOperator(be.model_fn, be.w, data)
    u = torch.randn(J.shape[0], generator=gen, device=dev)
    xl, kl = part(f"lsmr_jacobian_{ENGINE_ITERS}", lambda: C.lsmr(
        J.matvec, J.rmatvec, u, damp=ENGINE_DAMP, atol=0.0,
        maxiter=ENGINE_ITERS), zero)
    lsmr_res = float(torch.sqrt(((J.matvec(xl) - u) ** 2).sum()
                                + ENGINE_DAMP ** 2 * (xl ** 2).sum())
                     / u.norm())
    _finite(torch, label, x, xl)
    if k != ENGINE_ITERS or kl != ENGINE_ITERS or cg_res >= 1 \
            or lsmr_res >= 1:
        raise AssertionError(f"{label}: CG {k} iterations, residual "
                             f"{cg_res}; LSMR {kl}, residual {lsmr_res}")

    site = f"convs.{composed.num_layers - 1}"
    ah = C.ActivationHessianOperator(composed, params, "classification",
                                     site, idx, yy)
    w = torch.randn(ah.shape[1], generator=gen, device=dev)
    ahv = part("activation_hessian_matvec", lambda: ah.matvec(w), zero)
    _finite(torch, label, ahv)
    if ah.shape != (N_NODES * N_CLASS,) * 2 or float(w @ ahv) < 0:
        raise AssertionError(f"{label}: activation Hessian {ah.shape}, "
                             f"w.Hw {float(w @ ahv)}")
    print(f"{label}: P = {P}; LowRank eigenvalues {evals.tolist()}, log "
          f"marglik {lml:.4f}, tuned prior precision "
          f"{la.prior_precision.tolist()}; spectrum on "
          f"[{grid[0]:.4g}, {grid[-1]:.4g}], mass {mass:.4f}; Hutchinson "
          f"trace {float(tr_est):.6g}; CG residual {cg_res:.3e}; LSMR "
          f"damped residual {lsmr_res:.4f}; activation Hessian {site} "
          f"{ah.shape[0]} dims  [{card}]", flush=True)
    out[label] = {"parts": parts, "n_params": P, "lowrank_evals":
                  evals.tolist(), "log_marglik": lml, "spectrum_mass": mass,
                  "hutchinson_trace": float(tr_est), "cg_residual": cg_res,
                  "lsmr_residual": lsmr_res}
    del la, ggn, shifted, J, GV, V, ah
    torch.cuda.empty_cache()

    # -- composed STE-GCN, hidden 16: LowRank's dense covariance ------------
    label = f"composed STE-GCN h{FULL_HIDDEN}"
    part, parts = run_parts(torch, kernels, card, label)
    small = composed_model(FULL_HIDDEN)
    small_params = {**small.params(), "adj": params["adj"]}
    la = part(f"lowrank_fit_rank{ENGINE_RANK}", lambda: _fitted(Laplace(
        small, small_params, "classification", "all", "lowrank",
        rank=ENGINE_RANK, **bk), train), zero)
    probs = part(f"lowrank_probit_{N_TEST}", lambda: la(
        torch.as_tensor(te, device=dev), link_approx="probit"), zero)
    _check_probs(np, probs, N_TEST)
    s = part(f"lowrank_sample_{ENGINE_SAMPLES}", lambda: la.sample(
        ENGINE_SAMPLES), zero)
    _finite(torch, label, s)
    if s.shape != (ENGINE_SAMPLES, la.n_params):
        raise AssertionError(f"{label} samples: {tuple(s.shape)}")
    print(f"{label}: P = {la.n_params}, dense covariance "
          f"{la.n_params} x {la.n_params} f32  [{card}]", flush=True)
    out[label] = {"parts": parts, "n_params": la.n_params}
    del la, s, probs
    torch.cuda.empty_cache()

    # -- fused STE-GCN, hidden 64: the reverse-mode parts ------------------
    label = f"fused STE-GCN h{HIDDEN}"
    part, parts = run_parts(torch, kernels, card, label)
    try:
        Laplace(model, params, "classification", "all", "lowrank",
                rank=ENGINE_RANK).fit(train)
    except NotImplementedError:
        pass
    else:
        raise AssertionError(f"{label}: LowRank's fit ran forward mode "
                             "through the fused op")
    bf = C.GGNBackend(model, params, "classification")
    JT = C.TransposedJacobianOperator(bf.model_fn, bf.w, data)
    u = torch.randn(JT.shape[1], generator=gen, device=dev)
    jtu = part("transposed_jacobian_matvec", lambda: JT.matvec(u), on)
    ref = C.TransposedJacobianOperator(be.model_fn, be.w, data).matvec(u)
    jt_err = _rel(jtu, ref)
    kron = part("kron_fit", lambda: C.compute_kfac_factors(
        model, params, idx, yy, "classification", N=N_TRAIN), on)
    inv_dots = {}
    for method in ("plain", "heuristic", "exact"):
        inv = part(f"kfac_inverse_{method}", lambda: C.KFACInverseOperator(
            kron, damping=ENGINE_DAMP, damping_method=method), zero)
        x = part(f"kfac_inverse_{method}_matvec", lambda: inv.matvec(v),
                 zero)
        _finite(torch, f"{label} {method}", x)
        inv_dots[method] = float(v @ x)
    wit = _jt_witness(torch, model, composed, params, data, JT, u, jtu,
                      ref, composed_model)
    # J^T u through the kernel lands on the composed path run with the
    # kernel's bf16 operands (read 0.0: the same bits), and on the f32
    # composed path given the kernel's ReLU masks (read 1.9e-3, the
    # rounding alone); the plain composed path flips the masks of the
    # pre-activations that the rounding moves across zero (77 of 173,312),
    # which puts jt_err at 1.485e-2, held at 5e-2
    if jt_err > 5e-2 or wit["rounded_rel"] > 1e-5 \
            or wit["kernel_masks_rel"] > 1e-2 or min(inv_dots.values()) <= 0:
        raise AssertionError(f"{label}: J^T u vs the composed path "
                             f"{jt_err}, {wit}; v.K^-1 v {inv_dots}")
    print(f"{label}: J^T u vs the composed path rel {jt_err:.3e} (held at "
          f"5e-2), vs the composed path with bf16 operands "
          f"{wit['rounded_rel']:.3e} (1e-5), vs the f32 composed path with "
          f"the kernel's ReLU masks {wit['kernel_masks_rel']:.3e} (1e-2); "
          f"ReLU masks that differ from the composed path's "
          f"{wit['mask_flips']} of {wit['units']} (bf16-operand path: "
          f"{wit['rounded_mask_flips']}); v.K^-1 v {inv_dots}; LowRank "
          f"raised NotImplementedError  [{card}]", flush=True)
    out[label] = {"parts": parts, "jt_rel_err": jt_err, "jt_witness": wit,
                  "kfac_inverse_vKv": inv_dots}
    del kron, JT
    torch.cuda.empty_cache()
    return out


def phase_curvature_engine_small(torch, np, devices=None):
    """The curvature engine on a small graph (N = 96), the card in float32
    against the CPU in float64 (which the CPU tests hold to the JAX
    package), with the same draws: the composed STE-GCN's GGN, Hessian and
    EF matvecs, a GGN matmat, Hutchinson's trace, CG and LSMR iterates, an
    activation-Hessian matvec and LowRank's eigenvalues, log marglik and
    probit probabilities, held at 1e-4 relative; the fused STE-GCN's
    transposed-Jacobian matvec and KFAC-inverse matvecs at 1e-2 (the
    kernel rounds its operands to bf16). ``devices`` maps "card" and "ref"
    to (device, dtype)."""
    from laplace_gnn_torch import curvature as C
    from laplace_gnn_torch.curvature.inverse import cg
    from laplace_gnn_torch.laplace.dispatch import Laplace
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.utils.data import ArrayLoader
    rng = np.random.default_rng(15)
    n, f, hid = 96, 24, 16
    X = rng.standard_normal((n, f))
    a = (rng.random((n, n)) < 0.08).astype(float)
    adj = np.minimum(a + a.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, N_CLASS, n)
    tr, te = np.arange(40), np.arange(40, n)
    devices = devices or {"card": ("cuda", torch.float32),
                          "ref": ("cpu", torch.float64)}
    vals = {}
    for key, (dev, dt) in devices.items():
        def model(fused):
            return STEGCN(f, hid, N_CLASS, 2, X, adj, dropout_p=0.0,
                          fused=fused, symmetric=True, device=dev, dtype=dt,
                          generator=torch.Generator().manual_seed(0))

        def draw(seed, *shape):
            g = torch.Generator().manual_seed(seed)
            return torch.randn(*shape, generator=g,
                               dtype=torch.float64).to(dev, dt)

        composed, fused = model(False), model(True)
        params = {k: p.detach() for k, p in composed.params().items()}
        idx = torch.as_tensor(tr, device=dev)
        yy = torch.as_tensor(y[tr], device=dev)
        data = [(idx, yy)]
        be = C.GGNBackend(composed, params, "classification")
        P = be.n_params
        v, V = draw(1, P), draw(2, P, 3)
        ggn = C.GGNOperator(be.model_fn, "classification", be.w, data)
        J = C.JacobianOperator(be.model_fn, be.w, data)
        u = draw(3, J.shape[0])
        ah = C.ActivationHessianOperator(composed, params, "classification",
                                         "convs.1", idx, yy)
        la = Laplace(composed, params, "classification", "all", "lowrank",
                     rank=5, generator=torch.Generator().manual_seed(0))
        la.fit(ArrayLoader(tr, y[tr], device=dev))
        r = {"ggn": ggn.matvec(v), "ggn_matmat": ggn.matmat(V),
             "hessian": C.HessianOperator(be.model_fn, "classification",
                                          be.w, data).matvec(v),
             "ef": C.EFOperator(be.model_fn, "classification", be.w,
                                data).matvec(v),
             "hutchinson_trace": C.hutchinson_trace(ggn, 8, seed=4),
             "cg": cg(C.DiagShiftOperator(ggn, 1.0).matvec, v, tol=0.0,
                      maxiter=10)[0],
             "lsmr": C.lsmr(J.matvec, J.rmatvec, u, damp=ENGINE_DAMP,
                            atol=0.0, maxiter=10)[0],
             "activation_hessian": ah.matvec(draw(5, ah.shape[1])),
             "lowrank_evals": la.H[1],
             "lowrank_log_marglik": la.log_marginal_likelihood(),
             "lowrank_probit": la(torch.as_tensor(te, device=dev),
                                  link_approx="probit")}
        bf = C.GGNBackend(fused, params, "classification")
        r["fused:transposed_jacobian"] = C.TransposedJacobianOperator(
            bf.model_fn, bf.w, data).matvec(u)
        kron = C.compute_kfac_factors(fused, params, idx, yy,
                                      "classification", N=len(tr))
        for method in ("plain", "heuristic", "exact"):
            r[f"fused:kfac_inverse_{method}"] = C.KFACInverseOperator(
                kron, damping=ENGINE_DAMP, damping_method=method).matvec(v)
        vals[key] = r
    errs = {name: _rel(vals["card"][name], ref)
            for name, ref in vals["ref"].items()}
    bad = {name: e for name, e in errs.items()
           if e > (1e-2 if name.startswith("fused:") else 1e-4)
           or not math.isfinite(e)}
    for name, e in errs.items():
        print(f"small-graph {name}: card f32 vs CPU f64 rel {e:.2e} (held "
              f"at {1e-2 if name.startswith('fused:') else 1e-4:g})",
              flush=True)
    if bad:
        raise AssertionError(f"small-graph curvature engine: {bad}")
    return {"errors": errs}


# bench.py::bench_full_train's whole run: 200 epochs, hyper phases at
# epochs 60, 80, ..., 180 (7 phases of 10 hypersteps; its docstring says 80)
WHOLE_RUN = dict(lr=1e-3, lr_adj=0.8, weight_decay=5e-5, n_epochs=200,
                 n_hypersteps=10, n_epochs_burnin=50, marglik_frequency=20,
                 grad_norm=True, model_type="stegcn")
WHOLE_RUN_RTOL, WHOLE_RUN_ADJ_ATOL = 1e-5, 1e-6   # tests/test_training.py

# torch.linalg.eigvalsh under capture, in a process of its own (a refused
# capture leaves the CUDA context unusable): whether the -log marglik
# evaluation and the hyperstep could replay from graphs with a Kron
# curvature
EIGVALSH_CAPTURE = r"""
import torch
a = torch.randn(3, 7, 7, device="cuda")
a = a @ a.transpose(-1, -2) + torch.eye(7, device="cuda")
s = torch.cuda.Stream()
s.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(s):
    torch.linalg.eigvalsh(a)
torch.cuda.current_stream().wait_stream(s)
torch.cuda.synchronize()
g = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(g):
        torch.linalg.eigvalsh(a)
    print("CAPTURED")
except Exception as e:
    print("REFUSED", type(e).__name__, str(e).splitlines()[0][:160])
"""


DEAD_GRAPH_CAPTURE = r"""
import gc
import torch
gc.disable()
x = torch.ones(1024, device="cuda")
s = torch.cuda.Stream()
s.wait_stream(torch.cuda.current_stream())
with torch.cuda.stream(s):
    x * 2
    x + 1
torch.cuda.current_stream().wait_stream(s)
class Run:
    pass
dead = Run()
dead.cycle = dead
dead.graph = torch.cuda.CUDAGraph()
with torch.cuda.graph(dead.graph):
    dead.y = x * 2
del dead
g = torch.cuda.CUDAGraph()
try:
    with torch.cuda.graph(g):
        gc.collect()
        x + 1
    print("CAPTURED")
except Exception as e:
    print("REFUSED", type(e).__name__, str(e).splitlines()[0][:160])
"""


# the small eigensolver's shapes on the main path (Cora's widths: the two
# 64 x 64 factors of a Kron step, and the 7 x 7 one), then edge sizes
SMALL_EIGH_MAIN = ((2, 64), (1, 7))
SMALL_EIGH_CHECKS = (1, 2, 31, 32, 33, 65, 127, 128)


def _small_eigh_inputs(torch, b, n, dtype, seed):
    """(b, n, n) PSD matrices on the card: a random Gram matrix, and in the
    second of a batch (if any) exactly repeated eigenvalues."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(b, n, n, generator=g, dtype=torch.float64)
    M = A @ A.mT / n
    if b > 1:
        Q, _ = torch.linalg.qr(A[1])
        lam = torch.where(torch.arange(n) < n // 2, 2.0, 7.0).double()
        M[1] = (Q * lam) @ Q.T
    return (0.5 * (M + M.mT)).to(device="cuda", dtype=dtype)


def _small_eigh_check(torch, linalg, M):
    """Largest gap of the values kernel from the plain version (float64 on
    the CPU, same rounded input) over ||M||_2, and of the vectors kernel's
    residual ||M V - V diag(w)|| over ||M||_2; raises past 4 n eps."""
    n = M.shape[-1]
    Md = M.double().cpu()
    ref = torch.linalg.eigvalsh(Md)
    norm = max(float(torch.linalg.matrix_norm(Md, 2).max()), 1e-300)
    got = linalg.eigvalsh_kernel(M).double().cpu()
    V = linalg.small_eigenvectors(M).double().cpu()
    err = float((got - ref).abs().max()) / norm
    res = float((Md @ V - V * ref[:, None, :]).abs().max()) / norm
    tol = 4 * n * torch.finfo(M.dtype).eps
    if not (err <= tol and res <= 2 * tol):
        raise AssertionError(f"small eigensolver at {tuple(M.shape)} "
                             f"{M.dtype}: values {err:.3e}, vectors "
                             f"{res:.3e} (limits {tol:.3e}, {2 * tol:.3e})")
    return err, res


def phase_small_eigh(torch, linalg, peaks):
    """The small eigensolver (csrc/small_eigh.cu) at the main path's
    shapes, (2, 64, 64) and (1, 7, 7) in f32: values held to the plain
    version in float64 (within 4 n eps ||M||_2, the backward-stable bound
    of the Householder reduction) and the Jacobi vectors' residual (twice
    that), timed cold beside the plain version (torch.linalg.eigvalsh on
    the CPU, host clock) and torch.linalg.eigvalsh on the card (cuSOLVER)
    as the library's; bound: the bytes in and out over the memory rate
    against (4/3) n^3 a matrix over the f32 rate outside the tensor cores.
    Then the edge sizes in f32 and f64, batches 1-4, and a non-finite
    input, which must set the flag and give NaN values for its matrix
    alone."""
    bw, _ = peaks
    rows, checks = [], []
    for b, n in SMALL_EIGH_MAIN:
        M = _small_eigh_inputs(torch, b, n, torch.float32, seed=n)
        err, res = _small_eigh_check(torch, linalg, M)
        Mc = M.cpu()
        t0 = time.perf_counter()
        for _ in range(100):
            torch.linalg.eigvalsh(Mc)
        plain_ms = (time.perf_counter() - t0) * 10
        t_b = (b * n * n + b * n) * 4 / bw        # M read, values written
        t_o = b * (4.0 / 3.0) * n ** 3 / FP32_PEAK
        rows.append({
            "shape": [b, n, n], "dtype": "float32",
            "ms": cold_ms(torch, lambda: linalg.eigvalsh_kernel(M)),
            "vectors_ms": cold_ms(torch, lambda: linalg.eigh_kernel(M)),
            "plain_ms": plain_ms,
            "library_ms": cold_ms(torch, lambda: torch.linalg.eigvalsh(M)),
            "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "max_rel_err": err, "vectors_residual": res,
            "card_after": card_state()})
        print("small_eigh " + json.dumps(rows[-1]), flush=True)
    for i, n in enumerate(SMALL_EIGH_CHECKS):
        for dt in (torch.float32, torch.float64):
            M = _small_eigh_inputs(torch, 1 + i % 4, n, dt, seed=100 + n)
            err, res = _small_eigh_check(torch, linalg, M)
            checks.append({"n": n, "batch": M.shape[0], "dtype": str(dt),
                           "max_rel_err": err, "vectors_residual": res})
    zero = torch.zeros(1, 33, 33, device="cuda")
    if float(linalg.eigvalsh_kernel(zero).abs().max()) > 1e-30:
        raise AssertionError("small eigensolver: the zero matrix")
    linalg.reset_eigensolve_failures("cuda")
    linalg.raise_on_failed_eigensolve("cuda")
    M = _small_eigh_inputs(torch, 3, 16, torch.float32, seed=3)
    M[1, 5, 2] = float("inf")
    lam = linalg.eigvalsh_kernel(M)
    flagged = False
    try:
        linalg.raise_on_failed_eigensolve("cuda")
    except FloatingPointError:
        flagged = True
    if not (flagged and bool(torch.isnan(lam[1]).all())
            and bool(torch.isfinite(lam[0::2]).all())):
        raise AssertionError("small eigensolver: a non-finite input was "
                             "not flagged, or spread past its matrix")
    print(f"small_eigh: {len(checks)} edge checks within 4 n eps, the "
          f"largest {max(c['max_rel_err'] for c in checks):.3e} (values) "
          f"and {max(c['vectors_residual'] for c in checks):.3e} "
          f"(vectors); zero matrix and a non-finite input flagged",
          flush=True)
    return rows, checks


# -- phase 23: the sparse GAT attention kernels (csrc/gat_attention.cu) ------

# the arxiv cell's attention layers: (heads, head width), bf16 payload
GAT_ATT_SHAPES = ((3, 250), (3, 40))
GAT_ATT_SLOPE = 0.2
# kernel against plain, both on the card: the rounding of f32 sums taken in
# another order (bf16 payload: the plain version rounds the same rows)
GAT_ATT_TOL = {"bfloat16": 1e-4, "float32": 1e-4, "float64": 1e-11}


def _gat_att_inputs(torch, n, heads, width, seed, dtype=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = dtype or torch.float32

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    return draw(n, heads, width), draw(n, heads), draw(n, heads), \
        draw(n, heads, width)


def _gat_att_check(torch, ga, csr, h, a_src, a_dst, g, payload, label):
    """The kernel pair against the plain version on the card: forward
    (out, lse) and backward (dh, da_src, da_dst) relative gaps, each call
    run twice for the same bits. Raises past GAT_ATT_TOL."""
    cd = ga.sums_dtype(payload)
    a_s, a_d = a_src.to(cd), a_dst.to(cd)
    out, lse, xp = ga.forward_kernel(csr, h, a_s, a_d, GAT_ATT_SLOPE,
                                     payload)
    ref, ref_lse, x = ga.forward_plain(csr, h, a_s, a_d, GAT_ATT_SLOPE,
                                       payload)
    grads = ga.backward_kernel(csr, xp, a_s, a_d, out, lse, g,
                               GAT_ATT_SLOPE)
    ref_grads = ga.backward_plain(csr, x, a_s, a_d, ref, ref_lse, g,
                                  GAT_ATT_SLOPE)
    gaps = {"out": _rel(out, ref), "lse": _rel(lse, ref_lse)}
    for name, a, b in zip(("dh", "da_src", "da_dst"), grads, ref_grads):
        gaps[name] = _rel(a, b)
    again = ga.forward_kernel(csr, h, a_s, a_d, GAT_ATT_SLOPE, payload)
    grads2 = ga.backward_kernel(csr, xp, a_s, a_d, out, lse, g,
                                GAT_ATT_SLOPE)
    same = (torch.equal(again[0], out) and torch.equal(again[1], lse)
            and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
    tol = GAT_ATT_TOL[str(payload).split(".")[-1]]
    if max(gaps.values()) > tol or not same:
        raise AssertionError(f"gat_attention {label}: kernel vs plain "
                             f"{gaps} (tolerance {tol}), same bits {same}")
    return {"label": label, "gaps": gaps, "same_bits": same}


def _gat_att_small(torch, ga):
    """Edge cases on a small graph: a hub row and a hub source longer than
    a chunk (three chunks each), a node with only its self-loop, a node
    with no edge at all; every payload, head widths 1, 5, 40 and 250, 1
    and 8 heads (f64: 2 x 250, its widest row); then the raises on an f16
    payload and on CPU tensors."""
    n = 300
    src = torch.cat([torch.arange(1, n - 1), torch.randint(
        0, n - 1, (900,), generator=torch.Generator().manual_seed(0)),
        torch.zeros(150, dtype=torch.long), torch.arange(n - 1)])
    dst = torch.cat([torch.zeros(n - 2, dtype=torch.long), torch.randint(
        0, n - 1, (900,), generator=torch.Generator().manual_seed(1)),
        torch.arange(1, 151), torch.arange(n - 1)])
    keep = (src != 7) & (dst != 7) | (src == dst)
    src, dst = src[keep], dst[keep]
    order = torch.argsort(dst, stable=True)
    csr = ga.attention_csr(src[order].cuda(), dst[order].cuda(), n)
    if not (csr.fwd.merges.shape[0] and csr.bwd.merges.shape[0]):
        raise AssertionError("gat_attention: the small graph splits no row")
    rows = []
    for payload in (torch.bfloat16, torch.float32, torch.float64):
        # the widest row each payload takes: 4096 bytes (f64: 2 x 250)
        widest = (2, 250) if payload == torch.float64 else (3, 250)
        for heads, width in ((3, 1), (3, 5), (1, 40), (8, 40), widest):
            dt = torch.float64 if payload == torch.float64 else None
            h, a_s, a_d, g = _gat_att_inputs(torch, n, heads, width,
                                             seed=heads * width, dtype=dt)
            rows.append(_gat_att_check(
                torch, ga, csr, h, a_s, a_d, g, payload,
                f"small {str(payload)[6:]} H={heads} F={width}"))
    h, a_s, a_d, _ = _gat_att_inputs(torch, n, 3, 8, seed=0)
    for bad, err in (((csr, h, a_s, a_d, GAT_ATT_SLOPE, torch.float16),
                      TypeError),
                     ((csr, h.cpu(), a_s, a_d, GAT_ATT_SLOPE,
                       torch.float32), ValueError)):
        try:
            ga.forward_kernel(*bad)
        except err:
            continue
        raise AssertionError(f"gat_attention: no {err.__name__} on "
                             f"{bad[-1]} / {bad[1].device}")
    return rows


def phase_gat_attention(torch, np, ga, peaks):
    """The sparse GAT attention kernel pair (csrc/gat_attention.cu) held to
    its plain version on the card: the small edge cases, then the
    ``sparsegat-arxiv`` cell's shapes (ogbn-arxiv-shaped graph with a
    self-loop on every node, 2.34 M stored edges; H 3 of F 250 and 40,
    bf16 payload): forward and backward gaps, two runs the same bits, one
    launch of each entry a call, and each direction timed cold (the
    wrapper's call: pack, pass, merge) beside the benchmark's bound
    (``benchmark/benchlib/gat_counts.py``: each edge's bf16 row and 8-byte
    index, the f32 output and destination scores; the backward twice the
    forward), the plain version's time and the composed ELL body's. No
    library computes this function. Then one SparseGAT training step at
    the cell's widths: every layer through the kernels (``gat.kernel`` ==
    ``gat.calls``, ``gat.composed`` 0), and two identical steps give the
    same gradient bits."""
    import dataclasses
    from laplace_gnn_torch import profiling
    from laplace_gnn_torch.graph import container as C
    from laplace_gnn_torch.models import SparseGAT
    bw, _ = peaks
    out = {"small": _gat_att_small(torch, ga)}
    print(f"gat_attention small: {len(out['small'])} cases within "
          f"tolerance, the same bits twice, f16 and CPU raised", flush=True)

    x, y, ei = arxiv_like(np)
    g = C.sparse_from_edge_index(ei, ARXIV_N, normalize=None, fmt="ell",
                                 device="cuda")
    g_bf = dataclasses.replace(g, agg_dtype="bfloat16")
    t0 = time.perf_counter()
    layout = C.ell_gat_layout(g)
    torch.cuda.synchronize()
    csr = layout["csr"]
    E, n = g.n_edges, g.n_nodes
    out["graph"] = {"N": n, "E": E, "layout_s": time.perf_counter() - t0,
                    "fwd_items": csr.fwd.items.shape[0],
                    "fwd_split_rows": csr.fwd.merges.shape[0],
                    "bwd_split_sources": csr.bwd.merges.shape[0]}
    print(f"gat_attention graph: {out['graph']}", flush=True)
    rows = []
    bf = torch.bfloat16
    for heads, width in GAT_ATT_SHAPES:
        h, a_s, a_d, gout = _gat_att_inputs(torch, n, heads, width, seed=23)
        check = _gat_att_check(torch, ga, csr, h, a_s, a_d, gout, bf,
                               f"arxiv H={heads} F={width}")
        f0, b0 = ga.gat_fwd.launches, ga.gat_bwd.launches
        hh = h.clone().requires_grad_(True)
        o = ga.gat_attention(csr, hh, a_s, a_d, GAT_ATT_SLOPE, bf)
        torch.autograd.grad(o, hh, gout)
        launches = (ga.gat_fwd.launches - f0, ga.gat_bwd.launches - b0)
        if launches != (1, 1):
            raise AssertionError(f"gat_attention: one call launched "
                                 f"{launches} (forward, backward)")
        o_k, lse_k, xp = ga.forward_kernel(csr, h, a_s, a_d, GAT_ATT_SLOPE,
                                           bf)
        fwd_ms = cold_ms(torch, lambda: ga.forward_kernel(
            csr, h, a_s, a_d, GAT_ATT_SLOPE, bf))
        bwd_ms = cold_ms(torch, lambda: ga.backward_kernel(
            csr, xp, a_s, a_d, o_k, lse_k, gout, GAT_ATT_SLOPE))
        kernels = profile_step(torch, lambda: ga.backward_kernel(
            csr, xp, a_s, a_d, o_k, lse_k, gout, GAT_ATT_SLOPE), top=6)
        kernels_fwd = profile_step(torch, lambda: ga.forward_kernel(
            csr, h, a_s, a_d, GAT_ATT_SLOPE, bf), top=6)
        o_p, lse_p, x_p = ga.forward_plain(csr, h, a_s, a_d, GAT_ATT_SLOPE,
                                           bf)
        plain_fwd = cold_ms(torch, lambda: ga.forward_plain(
            csr, h, a_s, a_d, GAT_ATT_SLOPE, bf), reps=5)
        plain_bwd = cold_ms(torch, lambda: ga.backward_plain(
            csr, x_p, a_s, a_d, o_p, lse_p, gout, GAT_ATT_SLOPE), reps=5)
        del o_p, lse_p, x_p

        def composed():
            hc = h.clone().requires_grad_(True)
            oc = C._ell_gat_attention_composed(g_bf, layout, hc, a_s, a_d,
                                               GAT_ATT_SLOPE)
            torch.autograd.grad(oc, hc, gout)
        composed_ms = cold_ms(torch, composed, reps=5)
        fwd_bytes = E * ((heads * width + heads) * 2 + 8) \
            + n * (heads * width + heads) * 4
        row = {"heads": heads, "width": width, "fwd_ms": fwd_ms,
               "bwd_ms": bwd_ms, "bound_fwd_ms": fwd_bytes / bw * 1e3,
               "bound_bwd_ms": 2 * fwd_bytes / bw * 1e3,
               "bound_by": "bytes", "plain_fwd_ms": plain_fwd,
               "plain_bwd_ms": plain_bwd, "composed_fwd_bwd_ms": composed_ms,
               "library_ms": None, "launches": list(launches),
               "kernels_fwd": kernels_fwd["top"],
               "kernels_bwd": kernels["top"], "check": check,
               "card_after": card_state()}
        row["roofline_pct"] = 100 * (row["bound_fwd_ms"]
                                     + row["bound_bwd_ms"]) / (fwd_ms
                                                               + bwd_ms)
        rows.append(row)
        print("gat_attention " + json.dumps(
            {k: v for k, v in row.items()
             if k not in ("kernels_fwd", "kernels_bwd")}), flush=True)
        print("gat_attention kernels: fwd "
              + json.dumps(kernels_fwd["top"]) + " bwd "
              + json.dumps(kernels["top"]), flush=True)
        del h, a_s, a_d, gout, o_k, lse_k, xp
        torch.cuda.empty_cache()
    out["rows"] = rows

    # one training step of the cell's model, the route's counters, and two
    # identical steps to the same bits
    torch.cuda.reset_peak_memory_stats()
    model = SparseGAT(ARXIV_F, 750, ARXIV_C, 3, x, g_bf, heads=3,
                      dropout_p=0.0, device="cuda", norm="batch", res=True,
                      mean_output_heads=True)
    params = {k: v.requires_grad_(True) for k, v in model.init().items()}
    yt = torch.as_tensor(y, device="cuda")
    idx = torch.arange(0, n, 5, device="cuda")

    def step():
        loss = torch.nn.functional.cross_entropy(model.apply(params, idx),
                                                 yt[idx])
        return torch.autograd.grad(loss, list(params.values()))
    first = step()
    profiling.reset_counters()
    f0, b0 = ga.gat_fwd.launches, ga.gat_bwd.launches
    with torch.profiler.profile():
        second = step()
    counts = profiling.counters()
    route = {"gat.calls": counts.get("gat.calls", 0),
             "gat.kernel": counts.get("gat.kernel", 0),
             "gat.composed": counts.get("gat.composed", 0),
             "fwd_launches": ga.gat_fwd.launches - f0,
             "bwd_launches": ga.gat_bwd.launches - b0}
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    t_step = cold_ms(torch, step, reps=5)
    out["train_step"] = {"route": route, "same_bits": same,
                         "step_ms_cold": t_step,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"gat_attention train step: {out['train_step']}", flush=True)
    if (route["gat.kernel"] != route["gat.calls"] or route["gat.calls"] != 3
            or route["gat.composed"] or route["fwd_launches"] != 3
            or route["bwd_launches"] != 3 or not same):
        raise AssertionError(f"gat_attention: the training step's route "
                             f"{route}, same bits {same}")
    return out


# -- phase 24: the sparse SpMM kernel (csrc/spmm.cu) -------------------------

# the kernel against the float64 product of the operands it reads (x and
# the weights rounded to the operand dtype): f32 sums in another order, f64
SPMM_TOL = {"bfloat16": 2e-6, "float32": 2e-6, "float64": 1e-13}
# against the plain route, which rounds the sums to bf16 as well
SPMM_PLAIN_TOL = 1e-2
SPMM_WIDTHS = (256, 40)             # the cell's hidden and output widths
SPMM_SLAB_LANES = (32, 16, 8)       # one pass; slabs of 128 and 64 columns


def _spmm_rounded(torch, C, g, x, op):
    """The float64 product of ``x`` and the weights rounded to ``op``, by
    the segment path on the graph's device."""
    ref = C.SparseGraph(src=g.src, dst=g.dst,
                        weights=g.weights.to(op).double(), n_nodes=g.n_nodes,
                        dst_sorted=True)
    return ref._aggregate(x.to(op).double())


def _spmm_small(torch, C, SK):
    """Edge cases on a small graph: a hub of 600 edges (ten chunks), nodes
    with no edge, self-loops; bf16, f32 and f64 operands at d = 1, 3, 40,
    128, 256 and 1200; two calls the same bits; then the raises on an f16
    operand and on CPU tensors."""
    import dataclasses
    n = 400
    gen = torch.Generator().manual_seed(24)
    src = torch.cat([torch.randint(0, n, (3000,), generator=gen),
                     torch.randint(0, n, (600,), generator=gen)])
    dst = torch.cat([torch.randint(0, n, (3000,), generator=gen),
                     torch.full((600,), 5)])
    keep = (src != 9) & (dst != 9) & (src != 11) & (dst != 11)
    ei = torch.stack([torch.cat([src[keep], dst[keep]]),
                      torch.cat([dst[keep], src[keep]])]).numpy()
    base = C.sparse_from_edge_index(ei, n, normalize="sym",
                                    add_self_loops=False, device="cuda")
    if not base.csr().work.merges.shape[0]:
        raise AssertionError("spmm: the small graph splits no row")
    rows = []
    for op in ("bfloat16", "float32", "float64"):
        dt = getattr(torch, op)
        g = dataclasses.replace(base, agg_dtype=op,
                                weights=base.weights.to(
                                    torch.float64 if op == "float64"
                                    else torch.float32))
        for d in (1, 3, 40, 128, 256, 1200):
            x = torch.randn(n, d, device="cuda", dtype=torch.float64
                            if op == "float64" else torch.float32)
            out = g.spmm(x)
            gap = _rel(out, _spmm_rounded(torch, C, g, x, dt))
            same = torch.equal(out, g.spmm(x))
            if gap > SPMM_TOL[op] or not same or out.dtype != x.dtype:
                raise AssertionError(f"spmm small {op} d={d}: gap {gap} "
                                     f"(tolerance {SPMM_TOL[op]}), same "
                                     f"bits {same}, dtype {out.dtype}")
            rows.append({"op": op, "d": d, "gap": gap})
    x = torch.randn(n, 8, device="cuda")
    for bad, err in (((base.csr(), x, torch.float16), TypeError),
                     ((base.csr(), x.cpu(), None), ValueError)):
        try:
            SK.spmm(*bad)
        except err:
            continue
        raise AssertionError(f"spmm: no {err.__name__} on {bad[2]} / "
                             f"{bad[1].device}")
    return rows


def _route_counts(torch, profiling, fn):
    """``fn()`` under the profiler, and the SpMM route's counters."""
    profiling.reset_counters()
    with torch.profiler.profile():
        out = fn()
    counts = profiling.counters()
    return out, {k: counts.get(k, 0) for k in ("spmm.calls", "spmm.kernel")}


def phase_spmm(torch, np, peaks):
    """The sparse SpMM kernel (csrc/spmm.cu) held to the float64 product of
    the operands it reads and to the plain route on the card: the small
    edge cases, then the ``sparsegcn-arxiv`` cell's graph (the sparse
    CLI's ``build_graph``: ogbn-arxiv-shaped, 'sym' weights, ELL, bf16
    aggregation) at d = 256 and 40: gaps, two calls the same bits, one
    launch a call, and cold times of the SpMM's whole call (cast, kernel,
    merge), of the kernel alone on the rounded operand, of the plain route
    and of ``torch.sparse.mm`` on the same CSR (``library_ms``), beside the
    benchmark's bound (``benchmark/benchlib/counts.py::spmm_bound_s``:
    each edge's 8-byte index and bf16 weight, the bf16 input and output
    once); at d = 256 the kernel alone in one pass and in slabs of 128 and
    64 columns. Then the route on the cell's paths: a SparseGCN training
    step at the cell's widths and a last-layer Kron fit with its prior
    tuning must launch the kernel for every SpMM (``spmm.kernel`` ==
    ``spmm.calls``), and two training steps give the same gradient
    bits."""
    from laplace_gnn_torch import profiling
    from laplace_gnn_torch.graph import container as C
    from laplace_gnn_torch.ops import spmm_kernel as SK
    from laplace_gnn_torch.training import sparse_experiment as se
    bw, _ = peaks
    out = {"small": _spmm_small(torch, C, SK)}
    print(f"spmm small: {len(out['small'])} cases within tolerance, the "
          f"same bits twice, f16 and CPU raised; worst "
          f"{max(r['gap'] for r in out['small']):.3e}", flush=True)

    x_np, y_np, ei = arxiv_like(np)
    args = se.argument_parser().parse_args(
        ["--hidden_channels", "256", "--num_layers", "3"])
    data = argparse.Namespace(edge_index=ei, num_nodes=ARXIV_N,
                              num_features=ARXIV_F, num_classes=ARXIV_C,
                              x=x_np)
    t0 = time.perf_counter()
    g = se.build_graph(args, data, device="cuda")
    torch.cuda.synchronize()
    csr = g.csr()
    E, n = g.n_edges, g.n_nodes
    out["graph"] = {"N": n, "E": E, "build_s": time.perf_counter() - t0,
                    "items": csr.work.items.shape[0],
                    "split_rows": csr.work.merges.shape[0],
                    "slots": csr.work.n_slots, "format": g.format,
                    "agg_dtype": g.agg_dtype}
    print(f"spmm graph: {out['graph']}", flush=True)
    bf = torch.bfloat16
    w = csr.weights[bf]
    A = torch.sparse_csr_tensor(csr.indptr.long(), csr.src.long(),
                                csr.weights[torch.float32], (n, n))
    rows = []
    for d in SPMM_WIDTHS:
        x = torch.randn(n, d, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(d))
        n0 = SK.spmm_launch.launches
        got = g.spmm(x)
        launches = SK.spmm_launch.launches - n0
        gap = _rel(got, _spmm_rounded(torch, C, g, x, bf))
        plain = g._aggregate(x.to(bf)).float()
        gap_plain = _rel(got, plain)
        same = torch.equal(got, g.spmm(x))
        if (gap > SPMM_TOL["bfloat16"] or gap_plain > SPMM_PLAIN_TOL
                or not same or launches != 1):
            raise AssertionError(f"spmm arxiv d={d}: gap {gap}, plain "
                                 f"{gap_plain}, same bits {same}, "
                                 f"launches {launches}")
        xo = SK.operand(x, bf)
        lanes = SK.lanes_for(xo.shape[1] // 8)
        slabs = {}
        for ln in (SPMM_SLAB_LANES if d == 256 else (lanes,)):
            # another slab width sums each row in another order
            slab_gap = _rel(SK.launch(csr, xo, w, d, ln), got)
            if slab_gap > SPMM_TOL["bfloat16"]:
                raise AssertionError(f"spmm arxiv d={d}: {ln} lanes a slab "
                                     f"{slab_gap} from one pass")
            slabs[ln] = cold_ms(torch, lambda: SK.launch(csr, xo, w, d, ln))
        kernels = profile_step(torch, lambda: g.spmm(x), top=4)
        row = {"d": d, "ms": cold_ms(torch, lambda: g.spmm(x)),
               "kernel_ms": slabs[lanes], "lanes": lanes,
               "slab_ms": slabs,
               "bound_ms": (E * (8 + 2) + 2 * n * d * 2) / bw * 1e3,
               "bound_by": "bytes",
               "gather_tb_s": E * d * 2 / (slabs[lanes] * 1e-3) / 1e12,
               "plain_ms": cold_ms(torch, lambda: g._aggregate(
                   x.to(bf)).float(), reps=5),
               "library_ms": cold_ms(torch, lambda: torch.sparse.mm(A, x)),
               "library": "torch.sparse.mm, f32 CSR",
               "gap": gap, "gap_plain": gap_plain, "launches": launches,
               "kernels": kernels["top"], "card_after": card_state()}
        row["roofline_pct"] = 100 * row["bound_ms"] / row["ms"]
        rows.append(row)
        print("spmm " + json.dumps({k: v for k, v in row.items()
                                    if k != "kernels"}), flush=True)
        print("spmm kernels: " + json.dumps(kernels["top"]), flush=True)
        del x, got, plain, xo
        torch.cuda.empty_cache()
    out["rows"] = rows

    # the route on the cell's paths: a training step and a last-layer fit
    model = se.build_model(args, data, g, device="cuda")
    params = {k: v.requires_grad_(True) for k, v in model.init().items()}
    yt = torch.as_tensor(y_np, device="cuda")
    idx = torch.arange(0, n, 5, device="cuda")

    def step():
        loss = torch.nn.functional.cross_entropy(model.apply(params, idx),
                                                 yt[idx])
        return torch.autograd.grad(loss, list(params.values()))
    first = step()
    n0 = SK.spmm_launch.launches
    second, counts = _route_counts(torch, profiling, step)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    out["train_step"] = {"route": counts, "same_bits": same,
                         "launches": SK.spmm_launch.launches - n0,
                         "step_ms_cold": cold_ms(torch, step, reps=5)}
    print(f"spmm train step: {out['train_step']}", flush=True)
    # three layers: three SpMMs forward, three transposed backward
    if (counts["spmm.kernel"] != counts["spmm.calls"]
            or counts["spmm.calls"] != 6
            or out["train_step"]["launches"] != 6 or not same):
        raise AssertionError(f"spmm: the training step's route "
                             f"{out['train_step']}")
    fit_params = {k: v.detach() for k, v in params.items()}
    n0 = SK.spmm_launch.launches
    t0 = time.perf_counter()
    la, counts = _route_counts(torch, profiling, lambda: se.fit_posterior(
        args, model, fit_params, idx, yt[idx]))
    torch.cuda.synchronize()
    out["fit"] = {"route": counts, "s": time.perf_counter() - t0,
                  "launches": SK.spmm_launch.launches - n0}
    probs, pcounts = _route_counts(torch, profiling, lambda: la(
        idx[:1000], pred_type="nn", link_approx="mc", n_samples=4))
    out["predictive"] = {"route": pcounts,
                         "rows_sum_to_1": bool(torch.allclose(
                             probs.sum(-1), torch.ones_like(probs[:, 0]),
                             atol=1e-5))}
    print(f"spmm fit: {out['fit']}; predictive {out['predictive']}",
          flush=True)
    if (counts["spmm.kernel"] != counts["spmm.calls"]
            or not counts["spmm.calls"]
            or pcounts["spmm.kernel"] != pcounts["spmm.calls"]
            or not pcounts["spmm.calls"]
            or not out["predictive"]["rows_sum_to_1"]):
        raise AssertionError(f"spmm: the fit's route {out['fit']}, the "
                             f"predictive's {out['predictive']}")
    return out


def _trace_gap(a, b) -> float:
    """Largest |a - b| / |b| over two traces."""
    return max(abs(float(x) - float(z)) / max(abs(float(z)), 1e-30)
               for x, z in zip(a, b))


def _run_pair(torch, scan, eager, label):
    """Hold a whole run to the eager loop's: traces within
    WHOLE_RUN_RTOL, the same best epochs, the final adjacency within
    WHOLE_RUN_ADJ_ATOL; returns the gaps."""
    (r1, p1, l1, v1, n1), (r2, p2, l2, v2, n2) = eager, scan
    gaps = {"loss": _trace_gap(l2, l1), "val_loss": _trace_gap(v2, v1),
            "neg_marglik": _trace_gap(n2, n1),
            "adj_abs": float((p2["adj"] - p1["adj"]).abs().max()),
            "params_rel": max(_rel(p2[k], p1[k]) for k in p1)}
    epochs = {c: (r2[c]["epoch"], r1[c]["epoch"])
              for c in ("marglik", "valloss")}
    print(f"{label}: whole run vs eager loop, largest gaps {gaps}; best "
          f"epochs (whole, eager) {epochs}", flush=True)
    if (max(gaps["loss"], gaps["val_loss"], gaps["neg_marglik"])
            > WHOLE_RUN_RTOL or gaps["adj_abs"] > WHOLE_RUN_ADJ_ATOL
            or any(a != b for a, b in epochs.values())
            or not all(bool(torch.isfinite(v).all()) for v in p2.values())):
        raise AssertionError(f"{label}: the whole run parts from the eager "
                             f"loop: {gaps} {epochs}")
    return {"gaps": gaps, "best_epochs": epochs}


def _step_launches(run):
    return {name: dict(step.launches) for name, step in run.steps.items()}


def phase_whole_run(torch, np, card):
    """bench.py::bench_full_train's configuration through
    marglik_optimization_scan on the phase-3 graph at Cora's width, with
    fused=False (the configuration bench.py runs) and fused=True
    (core_spmm): a cold call (build, warm-up and capture), a warm call
    that must hit the program cache, the eager loop on the same inputs
    (traces within 1e-5, the same best epochs, the final adjacency within
    1e-6), core_spmm's launches per step kind and replayed, and one warm
    run under torch.profiler; then a 16-epoch dropout run and a 20-epoch
    run with snapshots against the eager loop."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.ops import linalg
    from laplace_gnn_torch.ops.fused_spmm import core
    from laplace_gnn_torch.training.marglik_gnn import (
        _model_program_cache, marglik_optimization,
        marglik_optimization_scan)
    eig_kernels = (linalg.eigvalsh_kernel, linalg.eigh_kernel)

    try:
        r = subprocess.run([sys.executable, "-c", EIGVALSH_CAPTURE],
                           capture_output=True, text=True, timeout=120)
        eig = next((l for l in r.stdout.splitlines()
                    if l.startswith(("CAPTURED", "REFUSED"))),
                   f"no answer: {r.stderr[-300:]}")
    except subprocess.TimeoutExpired:   # a report only: nothing depends on it
        eig = "no answer in 120 s"
    print(f"torch.linalg.eigvalsh under CUDA-graph capture: {eig} (torch "
          f"{torch.__version__})", flush=True)

    X, adj, y = make_graph(np, np.random.default_rng(0))
    tr, va = np.arange(N_TRAIN), np.arange(N_TRAIN, N_TRAIN + N_VAL)
    split = (tr, y[tr], va, y[va])
    out = {"config": WHOLE_RUN, "eigvalsh_capture": eig}

    def timed_run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    for fused in (False, True):
        label = f"whole run fused={fused}"
        model = STEGCN(N_FEAT, HIDDEN, N_CLASS, 2, X, adj, dropout_p=0.0,
                       fused=fused, device="cuda",
                       generator=torch.Generator().manual_seed(0))
        params = model.params()

        def scan():
            return marglik_optimization_scan(model, params, *split,
                                             device="cuda", **WHOLE_RUN)

        core.launches = core.replayed = 0
        cold, cold_s = timed_run(scan)
        cold_launches = core.launches
        cache = _model_program_cache(model)
        (run,) = cache.values()
        graphs = {k: s.graph for k, s in run.steps.items()}
        before = _step_launches(run)
        core.launches = core.replayed = 0
        eig_before = [k.launches for k in eig_kernels]
        warm, warm_s = timed_run(scan)
        launches, replayed = core.launches, core.replayed
        eig_launches = {k.name: k.launches - n
                        for k, n in zip(eig_kernels, eig_before)}
        if not all(run.captured.values()):
            raise AssertionError(f"{label}: captured {run.captured}")
        after = _step_launches(run)
        if len(cache) != 1 or next(iter(cache.values())) is not run or any(
                s.graph is not graphs[k] for k, s in run.steps.items()):
            raise AssertionError(f"{label}: the warm call missed the cache")
        if fused and launches == 0:
            raise AssertionError(f"{label}: no core_spmm launch")
        if not fused and launches:
            raise AssertionError(f"{label}: {launches} core_spmm launches")
        if len(run.hyper_epochs) != 7:
            raise AssertionError(f"{label}: hyper phases at "
                                 f"{run.hyper_epochs}, not 7")
        calls = {"train_step": WHOLE_RUN["n_epochs"],
                 "neg_marglik": WHOLE_RUN["n_epochs"],
                 "tracking": WHOLE_RUN["n_epochs"],
                 "hyperstep": 7 * WHOLE_RUN["n_hypersteps"]}
        per_step = {k: {name: (after[k].get(name, 0)
                               - before[k].get(name, 0)) / calls[k]
                        for name in set(after[k]) | set(before[k])}
                    for k in calls}
        for k in calls:
            if run.steps[k].calls != 2 * calls[k]:
                raise AssertionError(f"{label}: {k} ran "
                                     f"{run.steps[k].calls} times in two "
                                     f"calls, not {2 * calls[k]}")
        # the same program on the same inputs: the same numbers
        cold_gap = max(_trace_gap(b, a) for a, b in zip(cold[2:], warm[2:]))
        if cold_gap > WHOLE_RUN_RTOL:
            raise AssertionError(f"{label}: the warm call's traces part "
                                 f"from the cold call's by {cold_gap}")

        core.launches = core.replayed = 0
        eager, eager_s = timed_run(lambda: marglik_optimization(
            model, params, *split, verbose=False, device="cuda",
            **WHOLE_RUN))
        eager_launches = core.launches
        check = _run_pair(torch, warm, eager, label)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            scan()
            torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        device_ms = sum(x[1] for x in rows)
        n_kernels = sum(x[2] for x in rows)
        rows.sort(key=lambda x: -x[1])
        prof_out = {"device_ms": device_ms, "device_launches": n_kernels,
                    "wall_ms_under_profiler": prof_wall,
                    "busy_share": device_ms / (warm_s * 1e3),
                    "core_spmm_ms": sum(x[1] for x in rows
                                        if "core_" in x[0]),
                    "top": [{"name": k[:70], "ms": ms, "count": c}
                            for k, ms, c in rows[:8]]}
        print(f"{label}: cold {cold_s:.3f} s (build, warm-up, capture and "
              f"the run), warm {warm_s:.3f} s (cache hit), eager loop "
              f"{eager_s:.3f} s (host clock); warm vs cold traces "
              f"{'bit-equal' if cold_gap == 0 else cold_gap}; captured "
              f"{run.captured}; "
              f"small eigensolver launches in the warm call "
              f"{eig_launches}; "
              f"core_spmm launches: cold {cold_launches}, warm {launches} "
              f"({replayed} replayed from graphs, {launches - replayed} "
              f"from Python), eager {eager_launches}; per call of each "
              f"step {per_step}  [{card}]", flush=True)
        print(f"{label}: one warm run under torch.profiler: "
              f"{device_ms:.3f} ms of device time in {n_kernels} device "
              f"launches, busy share {prof_out['busy_share']:.3f} of the "
              f"warm call's {warm_s * 1e3:.3f} ms (core_spmm "
              f"{prof_out['core_spmm_ms']:.3f} ms)  [{card}]", flush=True)
        for x in prof_out["top"]:
            print(f"  {x['ms']:9.3f} ms x{x['count']:<6d} {x['name']}",
                  flush=True)
        out[f"fused={fused}"] = {
            "cold_s": cold_s, "warm_s": warm_s, "eager_s": eager_s,
            "warm_vs_cold_gap": cold_gap,
            "captured": run.captured, "small_eigh": eig_launches,
            "core_spmm": {
                "cold": cold_launches, "warm": launches,
                "warm_replayed": replayed, "eager": eager_launches,
                "per_step_call": per_step},
            "profile": prof_out, "check": check,
            "losses": [float(v) for v in warm[2]],
            "neg_margliks": [float(v) for v in warm[4]]}
        del model, run, cache, cold, warm, eager
        torch.cuda.empty_cache()

    # dropout: a mask frozen by the capture would part the runs
    model = STEGCN(N_FEAT, HIDDEN, N_CLASS, 2, X, adj, dropout_p=0.5,
                   fused=True, device="cuda",
                   generator=torch.Generator().manual_seed(0))
    params = model.params()
    short = dict(WHOLE_RUN, n_epochs=16, n_hypersteps=2, n_epochs_burnin=4,
                 marglik_frequency=4)
    scan = marglik_optimization_scan(model, params, *split, device="cuda",
                                     **short)
    eager = marglik_optimization(model, params, *split, verbose=False,
                                 device="cuda", **short)
    out["dropout"] = _run_pair(torch, scan, eager,
                               "whole run, dropout 0.5, 16 epochs")

    # snapshots: the eager loop's files, kept small and then deleted; the
    # composed model's hypersteps move the graph
    model = STEGCN(N_FEAT, HIDDEN, N_CLASS, 2, X, adj, dropout_p=0.0,
                   fused=False, device="cuda",
                   generator=torch.Generator().manual_seed(0))
    params = model.params()
    snap = dict(WHOLE_RUN, n_epochs=20, n_hypersteps=2, n_epochs_burnin=4,
                marglik_frequency=4)
    d = os.path.join(ROOT, "chiprun_out", "whole_run_snapshots")
    dirs = {k: os.path.join(d, k) for k in ("scan", "eager")}
    marglik_optimization_scan(model, params, *split, y=y, device="cuda",
                              learned_graphs_dir=dirs["scan"], **snap)
    marglik_optimization(model, params, *split, y=y, verbose=False,
                         device="cuda", learned_graphs_dir=dirs["eager"],
                         **snap)
    files = {}
    for k, path in dirs.items():
        files[k] = {}
        for fn in sorted(os.listdir(path)):
            if fn.startswith("epoch_"):
                with open(os.path.join(path, fn), "rb") as f:
                    files[k][fn] = pickle.load(f)
    if sorted(files["scan"]) != sorted(files["eager"]) or not files["scan"]:
        raise AssertionError(f"snapshot files {sorted(files['scan'])} vs "
                             f"{sorted(files['eager'])}")
    for fn, a in files["scan"].items():
        b = files["eager"][fn]
        if (a["epoch"] != b["epoch"] or a["num_edges"] != b["num_edges"]
                or not np.array_equal(a["edge_index"], b["edge_index"])):
            raise AssertionError(f"snapshot {fn}: whole run and eager loop "
                                 "differ")
    print(f"snapshots: {sorted(files['scan'])} equal in epoch, num_edges "
          f"and edge_index ({[a['num_edges'] for a in files['scan'].values()]}"
          f" edges)", flush=True)
    out["snapshots"] = sorted(files["scan"])
    shutil.rmtree(d)
    return out


def _dead_run_at_capture(torch, run):
    """``run()`` twice, the first run dead (its model, program and CUDA
    graphs freed only by a collection: they refer to each other) when the
    second captures, and a collection forced at the start of each capture,
    as an automatic one may fall there: freeing a dead graph during a
    capture invalidates it (shown first with torch alone, in a process of
    its own: a report). The second run must capture and give the first
    one's traces. Returns the objects those collections found."""
    import gc

    # why: torch alone, a dead captured graph collected during a capture
    r = subprocess.run([sys.executable, "-c", DEAD_GRAPH_CAPTURE],
                       capture_output=True, text=True, timeout=120)
    raw = next((l for l in r.stdout.splitlines()
                if l.startswith(("CAPTURED", "REFUSED"))),
               f"no answer: {r.stderr[-300:]}")
    print(f"a dead CUDA graph collected during a capture (torch alone): "
          f"{raw}", flush=True)
    enabled = gc.isenabled()
    enter = torch.cuda.graph.__enter__
    found = []

    def collecting_enter(self):
        out = enter(self)
        found.append(gc.collect())
        return out

    gc.disable()
    try:
        first = run()[2:]
        torch.cuda.graph.__enter__ = collecting_enter
        second = run()[2:]
    finally:
        torch.cuda.graph.__enter__ = enter
        if enabled:
            gc.enable()
    gap = max(_trace_gap(a, b) for a, b in zip(second, first))
    print(f"dead whole run pending at the next capture: {len(found)} "
          f"captures, each with a collection at its start finding "
          f"{sorted(set(found))} objects; traces against the first run's "
          f"{gap}", flush=True)
    if gap != 0:
        raise AssertionError(f"dead run at capture: traces part by {gap}")
    return {"captures": len(found), "collected": found,
            "torch_alone": raw}


def phase_whole_run_small(torch, np):
    """The whole run on a small graph, the card in float32 against the CPU
    in float64 (1e-4 relative on the traces for the composed model, 1e-2
    through the kernel); a run that captures while a dead one awaits
    collection (``_dead_run_at_capture``); and the diagonal curvature,
    whose -log marglik evaluation and hyperstep replay from graphs too,
    against the eager loop on the card; and a small GAT (hidden 8, 2
    heads), whose Kron evaluation is captured, against its eager loop."""
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.training.marglik_gnn import (
        _model_program_cache, marglik_optimization,
        marglik_optimization_scan)

    rng = np.random.default_rng(5)
    n, f = 96, 24
    X = rng.standard_normal((n, f))
    adj = (rng.random((n, n)) < 0.08).astype(float)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = rng.integers(0, N_CLASS, n)
    split = (np.arange(40), y[:40], np.arange(40, 70), y[40:70])
    kw = dict(WHOLE_RUN, n_epochs=10, n_hypersteps=2, n_epochs_burnin=2,
              marglik_frequency=4)
    out = {}
    for fused, tol in ((False, 1e-4), (True, 1e-2)):
        traces = {}
        for dev, dt in (("cuda", torch.float32), ("cpu", torch.float64)):
            m = STEGCN(f, 16, N_CLASS, 2, X, adj, dropout_p=0.0, fused=fused,
                       device=dev, dtype=dt,
                       generator=torch.Generator().manual_seed(0))
            _, _, losses, _, nms = marglik_optimization_scan(
                m, m.params(), *split, device=dev, **kw)
            traces[dev] = (losses, nms)
        gap = max(_trace_gap(traces["cuda"][i], traces["cpu"][i])
                  for i in (0, 1))
        print(f"small whole run fused={fused}: card f32 vs CPU f64 traces, "
              f"largest relative gap {gap:.3e} (held at {tol})", flush=True)
        if not gap <= tol:
            raise AssertionError(f"small whole run fused={fused}: {gap}")
        out[f"fused={fused}"] = gap

    def composed_run():
        m = STEGCN(f, 16, N_CLASS, 2, X, adj, dropout_p=0.0, device="cuda",
                   generator=torch.Generator().manual_seed(0))
        return marglik_optimization_scan(m, m.params(), *split,
                                         device="cuda", **kw)

    out["dead_run_at_capture"] = _dead_run_at_capture(torch, composed_run)
    m = STEGCN(f, 16, N_CLASS, 2, X, adj, dropout_p=0.0, fused=True,
               device="cuda", generator=torch.Generator().manual_seed(0))
    diag = dict(kw, hessian_structure="diag")
    scan = marglik_optimization_scan(m, m.params(), *split, device="cuda",
                                     **diag)
    (run,) = _model_program_cache(m).values()
    if not all(run.captured.values()):
        raise AssertionError(f"diag whole run captured {run.captured}")
    eager = marglik_optimization(m, m.params(), *split, verbose=False,
                                 device="cuda", **diag)
    out["diag"] = _run_pair(torch, scan, eager,
                            "small whole run, diag curvature, all captured")
    # GAT at a width whose Kron factors fit the small eigensolver: its -log
    # marglik evaluation (Kron type-2, exact diagonal blocks for the
    # attention vectors, through jvp_safe) replays from a graph too
    from laplace_gnn_torch.models import GAT
    g = GAT(f, 8, 8, 2, X, adj, heads=2, concat=True, dropout_p=0.0,
            attention_impl="flash", device="cuda",
            generator=torch.Generator().manual_seed(0))
    gkw = dict(kw, model_type="gat")
    scan = marglik_optimization_scan(g, g.params(), *split, device="cuda",
                                     **gkw)
    (run,) = _model_program_cache(g).values()
    if not all(run.captured.values()):
        raise AssertionError(f"small GAT whole run captured {run.captured}")
    eager = marglik_optimization(g, g.params(), *split, verbose=False,
                                 device="cuda", **gkw)
    out["gat"] = _run_pair(torch, scan, eager,
                           "small whole run, GAT, all captured")
    return out


# ogbn-arxiv's published shape (OGB: 169,343 nodes, 1,166,243 undirected
# edges, 128 features, 40 classes, largest degree ~13k) and the model of
# scripts/bench_laplace_scale.py (hidden 256, 2 layers)
ARXIV_N, ARXIV_F, ARXIV_C, ARXIV_E = 169343, 128, 40, 1166243
ARXIV_MAX_DEG = 13000
SPARSE_HIDDEN, SPARSE_LAYERS = 256, 2


def arxiv_like(np, seed: int = 13):
    """(x, y, edge_index) of ogbn-arxiv's shape: class-informative Gaussian
    features as ``sbm_dataset`` makes them (signal 3 / sqrt(F)), and a
    Chung-Lu graph whose expected degrees follow a power law (exponent 2.5,
    capped at ARXIV_MAX_DEG, which three hubs reach) with 65% of the edges
    inside a class; the undirected edges are deduplicated and stored both
    ways."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, ARXIV_C, ARXIV_N)
    means = rng.normal(0, 1.0, (ARXIV_C, ARXIV_F)) * 3 / math.sqrt(ARXIV_F)
    x = (means[y] + rng.normal(0, 1.0, (ARXIV_N, ARXIV_F))).astype(
        np.float32)
    w = (1 - rng.random(ARXIV_N)) ** (-1 / 1.5)
    cap = ARXIV_MAX_DEG * w.sum() / (2 * ARXIV_E)
    w = np.minimum(w, cap)
    # three hubs near the largest degree, once their repeated draws are
    # dropped as duplicates
    w[np.argsort(w)[-3:]] = 2.2 * cap
    cum = np.cumsum(w)
    a = np.searchsorted(cum, rng.random(ARXIV_E) * cum[-1])
    b = np.searchsorted(cum, rng.random(ARXIV_E) * cum[-1])
    # the homophilous edges draw their second end by weight within a's class
    order = np.argsort(y, kind="stable")
    ccum = np.cumsum(w[order])
    ends = np.searchsorted(y[order], np.arange(ARXIV_C + 1))
    lo = np.where(ends[:-1] > 0, ccum[np.maximum(ends[:-1] - 1, 0)], 0.0)
    hi = ccum[ends[1:] - 1]
    homo = rng.random(ARXIV_E) < 0.65
    c = y[a[homo]]
    t = lo[c] + rng.random(len(c)) * (hi[c] - lo[c])
    b[homo] = order[np.minimum(np.searchsorted(ccum, t), ARXIV_N - 1)]
    keep = a != b
    pairs = np.unique(np.minimum(a, b)[keep] * ARXIV_N
                      + np.maximum(a, b)[keep])
    u, v = pairs // ARXIV_N, pairs % ARXIV_N
    return x, y, np.stack([np.concatenate([u, v]), np.concatenate([v, u])])


def _spmm_checks(torch, np, C, g, label, tol):
    """The SpMM of ``g`` on the card (forward, backward, vmap over 3 and
    jvp) against the dense float64 product; two forward calls must give
    the same bits. Returns the largest relative error."""
    f = C.make_spmm(g)
    dense = g.to_dense().double()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(g.n_nodes, 9, device="cuda", generator=gen)
    ct = torch.randn(g.n_nodes, 9, device="cuda", generator=gen)
    xb = torch.randn(3, g.n_nodes, 9, device="cuda", generator=gen)
    out = f(x.requires_grad_(True))
    (gx,) = torch.autograd.grad(out, x, ct)
    _, tang = torch.func.jvp(f, (x.detach(),), (ct,))
    errs = {"forward": _rel(out, dense @ x.double()),
            "backward": _rel(gx, dense.T @ ct.double()),
            "vmap": _rel(torch.func.vmap(f)(xb), dense @ xb.double()),
            "jvp": _rel(tang, dense @ ct.double())}
    if not torch.equal(f(x.detach()), f(x.detach())):
        raise AssertionError(f"sparse {label}: two SpMM calls differ")
    if max(errs.values()) > tol:
        raise AssertionError(f"sparse {label}: {errs} above {tol}")
    return errs


def phase_sparse_small(torch, np):
    """Phase 18's small checks: the C++ packer is built; the SpMM on each
    tier (segment, ELL, ELL + levels + remainder) in float32 and bf16
    against the dense float64 product; the ELL GAT attention against the
    segment path."""
    import dataclasses
    from laplace_gnn_torch import native
    from laplace_gnn_torch.graph import container as C
    from laplace_gnn_torch.models import SparseGAT
    if not native.available():
        raise AssertionError("the C++ graph packer did not build")
    rng = np.random.default_rng(0)
    n = 120             # a hub, a mid-degree cluster and random edges
    src = np.concatenate([np.arange(1, n), rng.integers(0, n, 300),
                          np.tile(np.arange(40, 60), 3)])
    dst = np.concatenate([np.zeros(n - 1, int), rng.integers(0, n, 300),
                          np.repeat(np.arange(1, 4), 20)])
    ei = np.stack([src, dst])
    out = {}
    for norm in ("sym", "row"):
        g = C.sparse_from_edge_index(ei, n, normalize=norm, device="cuda")
        three = C.add_ell_format(g, max_k=2, pad_budget=1.2)
        if not (three.ell_levels and three.has_remainder()):
            raise AssertionError("the small graph has no level or remainder")
        for tier, gt in (("segment", g), ("ell", C.add_ell_format(g)),
                         ("three-tier", three)):
            for agg, tol in ((None, 1e-5), ("bfloat16", 3e-2)):
                label = f"{norm} {tier} {agg or 'float32'}"
                out[label] = _spmm_checks(
                    torch, np, C, dataclasses.replace(gt, agg_dtype=agg),
                    label, tol)
    # GAT: the ELL attention (levels and remainder) against the segment path
    X = rng.standard_normal((n, 6))
    g_seg = C.sparse_from_edge_index(ei, n, normalize=None, device="cuda")
    outs = {}
    for name, gg in (("segment", g_seg),
                     ("ell", C.add_ell_format(g_seg, max_k=2))):
        m = SparseGAT(6, 8, 4, 2, X, gg, heads=2, dropout_p=0.0,
                      device="cuda")
        outs[name] = m.apply(m.params())
    out["gat ell vs segment"] = _rel(outs["ell"], outs["segment"])
    if out["gat ell vs segment"] > 1e-5:
        raise AssertionError(f"sparse GAT: ELL vs segment "
                             f"{out['gat ell vs segment']}")
    worst = max(max(v.values()) if isinstance(v, dict) else v
                for v in out.values())
    print(f"sparse small: C++ packer {native.library_path().name}; SpMM "
          f"forward / backward / vmap / jvp on 3 tiers x 2 dtypes x 2 "
          f"normalizations against dense f64, worst {worst:.3e}; two calls "
          f"the same bits; GAT ELL vs segment "
          f"{out['gat ell vs segment']:.3e}", flush=True)
    return out


def _graph_stats(torch, g) -> dict:
    """The ELL shape of a packed graph: K, each level's (rows, K), the
    remainder's edges and the largest degree."""
    return {"E": g.n_edges, "K": int(g.ell_cols.shape[1]),
            "levels": [list(c.shape) for _, c, _ in g.ell_levels],
            "remainder_edges": int(g.rem_src.shape[0]),
            "max_degree": int(torch.bincount(g.dst).max())}


def phase_sparse(torch, np, kernels, card):
    """Phase 18: the sparse scale path through its CLI
    (``training/sparse_experiment.py::main``) on an ogbn-arxiv-shaped npz
    at the width of scripts/bench_laplace_scale.py: the full-size SpMM
    (two calls the same bits, against the float64 segment path), then the
    runs of SPARSE_RUNS with every kernel count set to 0 just before each
    and read just after (the path reaches no kernel, as in JAX), each with
    its graph's ELL shape, train-step ms (CUDA events), fit-and-tuning and
    predictive seconds and peak memory; the checkpointed run resumed must
    end within 1e-5 of the straight run; and whether SparseGAT's weight
    gradient is the same bits twice."""
    import dataclasses
    from laplace_gnn_torch import native
    from laplace_gnn_torch.graph import container as C
    from laplace_gnn_torch.training import sparse_experiment as se
    d = os.path.join(ROOT, "chiprun_out", "sparse")
    ckpt = os.path.join(d, "checkpoints")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    t0 = time.perf_counter()
    x, y, ei = arxiv_like(np)
    np.savez(os.path.join(d, "arxivlike.npz"), x=x, y=y, edge_index=ei)
    made = time.perf_counter() - t0
    os.environ["LAPLACE_GNN_DATA"] = d
    common = ["--dataset", "arxivlike", "--hidden_channels",
              str(SPARSE_HIDDEN), "--num_layers", str(SPARSE_LAYERS)]
    out = {"data_s": made, "n_nodes": ARXIV_N,
           "directed_edges": int(ei.shape[1]),
           "packer": "C++" if native.available() else "numpy"}
    try:
        # the full-size SpMM at the hidden width, bf16 aggregation (the
        # CLI's default) and float32, against the float64 segment path
        args = se.argument_parser().parse_args(common)
        data_g = se.build_graph(args, argparse.Namespace(
            edge_index=ei, num_nodes=ARXIV_N), device="cuda")
        f = C.make_spmm(data_g)
        f32 = C.make_spmm(dataclasses.replace(data_g, agg_dtype=None))
        ref = dataclasses.replace(data_g, format="segment", agg_dtype=None)
        xs = torch.randn(ARXIV_N, SPARSE_HIDDEN, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(1))
        want = C.make_spmm(dataclasses.replace(
            ref, weights=ref.weights.double()))(xs.double())
        same = torch.equal(f(xs), f(xs)) and torch.equal(f32(xs), f32(xs))
        gx = [torch.autograd.grad(f(xs.requires_grad_(True)), xs,
                                  torch.ones_like(xs))[0] for _ in range(2)]
        same = same and torch.equal(gx[0], gx[1])
        xs = xs.detach()
        out["spmm"] = {
            **_graph_stats(torch, data_g), "same_bits": same,
            "bf16_rel": _rel(f(xs), want), "f32_rel": _rel(f32(xs), want),
            "ms_bf16": cold_ms(torch, lambda: f(xs)),
            "ms_f32": cold_ms(torch, lambda: f32(xs)),
            "ms_segment_f32": cold_ms(torch, lambda: ref.spmm(xs))}
        if not same:
            raise AssertionError("the full-size SpMM gave other bits on a "
                                 "second call")
        if out["spmm"]["f32_rel"] > 1e-5 or out["spmm"]["bf16_rel"] > 3e-2:
            raise AssertionError(f"full-size SpMM: {out['spmm']}")
        if not (data_g.ell_levels and data_g.has_remainder()):
            raise AssertionError(f"the arxiv-shaped graph has no overflow "
                                 f"level or remainder: {out['spmm']}")
        print(f"sparse data: N={ARXIV_N}, {ei.shape[1]} directed edges "
              f"({made:.1f} s to make), packed by "
              f"{out['packer']}; SpMM (N, {SPARSE_HIDDEN}) "
              f"{out['spmm']}  [{card}]", flush=True)
        del data_g, f, f32, ref, xs, want, gx
        torch.cuda.empty_cache()
        out["runs"] = _sparse_runs(torch, np, se, common, ckpt, kernels,
                                   card)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return out


# the CLI runs of phase 18: (label, extra flags)
SPARSE_RUNS = [
    ("sparsegcn 400 steps", ["--n_steps", "400"]),
    ("sparsegcn all, type-2-sketch k 8, column_chunk 4, 50 steps",
     ["--n_steps", "50", "--subset_of_weights", "all", "--fisher_type",
      "type-2-sketch", "--sketch_size", "8", "--column_chunk", "4"]),
    ("sparsesage 100 steps", ["--model_type", "sparsesage",
                              "--n_steps", "100"]),
    # over all weights, so the attention vectors' diagonal takes the
    # probes (the last layer's posterior has no attention vector)
    ("sparsegat all, mc, 2 probes a batch of 2, 50 steps",
     ["--model_type", "sparsegat", "--n_steps", "50", "--fisher_type",
      "mc", "--diag_probes", "2", "--probe_batch", "2",
      "--subset_of_weights", "all"]),
]


def _sparse_runs(torch, np, se, common, ckpt, kernels, card):
    seen = {}

    def wrap(name, fn, clock):
        def wrapped(*args, **kwargs):
            if clock == "events":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args, **kwargs)
                b.record()
                b.synchronize()
                seen.setdefault(name, []).append(
                    (a.elapsed_time(b), args[-1]))
                return out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seen.setdefault(name, []).append(time.perf_counter() - t0)
            if name == "build_graph":
                seen["graph"] = out
            if name == "build_model":
                seen["model"] = out
            return out
        return wrapped

    def run(label, argv):
        seen.clear()
        for k in kernels:
            k.launches = 0
        with mock.patch.object(se, "train_steps", wrap(
                "train", se.train_steps, "events")), \
                mock.patch.object(se, "fit_posterior", wrap(
                    "fit", se.fit_posterior, "host")), \
                mock.patch.object(se, "predict", wrap(
                    "predict", se.predict, "host")), \
                mock.patch.object(se, "build_graph", wrap(
                    "build_graph", se.build_graph, "host")), \
                mock.patch.object(se, "build_model", wrap(
                    "build_model", se.build_model, "host")):
            res, secs, gb = timed(torch, lambda: se.main(argv,
                                                         device="cuda"))
        launches = {k.name: k.launches for k in kernels}
        if any(launches.values()):
            raise AssertionError(f"sparse {label}: kernel launches "
                                 f"{launches}")
        steps = sum(n for _, n in seen["train"])
        row = {"s": secs, "peak_gb": gb, "launches": launches,
               **_graph_stats(torch, seen["graph"]),
               "graph_s": sum(seen["build_graph"]),
               "train_steps": steps,
               "train_step_ms": sum(ms for ms, _ in seen["train"]) / steps,
               "fit_and_tuning_s": sum(seen["fit"]),
               "predictive_s": sum(seen["predict"]), "results": res}
        for name in ("map", "laplace"):
            r = res[name]
            if not all(math.isfinite(r[k]) for k in ("acc", "nll", "ece")):
                raise AssertionError(f"sparse {label}: {res}")
        if res["map"]["acc"] < 1.0 / ARXIV_C + 0.2:
            raise AssertionError(f"sparse {label}: MAP accuracy "
                                 f"{res['map']['acc']} (1/C = "
                                 f"{1 / ARXIV_C:.3f})")
        print(f"sparse {label}: K={row['K']}, levels {row['levels']}, "
              f"remainder {row['remainder_edges']} edges (graph "
              f"{row['graph_s']:.2f} s); train step "
              f"{row['train_step_ms']:.3f} ms (CUDA events, {steps} steps); "
              f"fit + tuning {row['fit_and_tuning_s']:.3f} s; predictive "
              f"{row['predictive_s']:.3f} s; run {secs:.2f} s, peak "
              f"{gb:.2f} GB; launches {launches}; map {res['map']}, laplace "
              f"{res['laplace']}  [{card}]", flush=True)
        return row

    rows = {}
    gcn = common + SPARSE_RUNS[0][1]
    rows[SPARSE_RUNS[0][0]] = run(SPARSE_RUNS[0][0], gcn)
    # the same run in two checkpointed halves: 200 steps, then a restart
    # that resumes at step 200 from the checkpoint, optimizer state and all
    every = ["--checkpoint_dir", ckpt, "--checkpoint_every", "200"]
    rows["checkpointed 200"] = run("sparsegcn 200 steps, checkpointed",
                                   common + ["--n_steps", "200"] + every)
    rows["resumed 200"] = run("sparsegcn resumed to 400 steps",
                              gcn + every)
    straight = rows[SPARSE_RUNS[0][0]]["results"]
    resumed = rows["resumed 200"]["results"]
    gap = max(abs(straight[k]["nll"] - resumed[k]["nll"])
              for k in ("map", "laplace"))
    rows["resume_nll_gap"] = gap
    if gap > 1e-5:
        raise AssertionError(f"resumed run {resumed} vs straight {straight}")
    print(f"sparse resume: the NLLs of the resumed run are within {gap:.3e}"
          f" of the straight run's", flush=True)
    for label, extra in SPARSE_RUNS[1:]:
        rows[label] = run(label, common + extra)
    # SparseGAT's weight gradient twice on the last run's model (its
    # gathers' backward adds rows with atomics)
    model = seen["model"]
    params = {k: v.requires_grad_(True) for k, v in model.init().items()}
    yt = torch.as_tensor(np.arange(ARXIV_N) % ARXIV_C, device="cuda")
    grads = [torch.autograd.grad(
        torch.nn.functional.cross_entropy(model.apply(params), yt),
        list(params.values())) for _ in range(2)]
    rows["gat_grad_same_bits"] = all(
        torch.equal(a, b) for a, b in zip(*grads))
    rows["gat_grad_rel_gap"] = max(_rel(a, b) for a, b in zip(*grads))
    print(f"sparse GAT gradient twice: same bits "
          f"{rows['gat_grad_same_bits']}, largest relative gap "
          f"{rows['gat_grad_rel_gap']:.3e}", flush=True)
    return rows


# -- phase 19: the single-axis scale-out layer (laplace_gnn_torch/parallel) --

P_CARD = 4                  # the parts held by calling each rank's body
SHARD_STEPS = 20            # timed train steps of the row-sharded GAT
STEP_REF_MS = 7.168         # PERF.md: the flash GAT train step, N = 16384
SPARSE_REF_MS = 12.183      # PERF.md: phase 18's SparseGCN train step
F32_ATTN_TOL = 1e-4         # flash kernels against the plain attention,
                            # relative to the largest entry (phase 4)
F32_SPMM_TOL = 1e-5         # f32 SpMM against the f32 segment path (18)
F32_GAT_NM_TOL = 1e-3       # the GAT -log marglik, relative (phase 6)
F32_GRAD_TOL = 1e-4         # gradients, relative (phases 6 and 12)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _events_ms(torch, fn, reps: int):
    """(median, all) CUDA-event ms of ``reps`` calls of ``fn``."""
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    return sorted(ms)[len(ms) // 2], ms


def _same_params(torch, a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _rel_max(a, b) -> float:
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def parallel_gat(torch, P, fa, mesh, card):
    """(a): GAT at N = 16384 (scripts/bench_gat_scale.py's configuration)
    on the row-sharded attention with the flash kernels against the
    unsharded flash attention: one step from the same parameters to the
    same bits, then SHARD_STEPS timed steps of each with the flash launches
    counted; and one Kron hyperstep at N = 2708 through ``jvp_safe()``."""
    from laplace_gnn_torch.training.marglik_gnn import make_neg_marglik_fn
    n = GAT_N_KERNEL
    X, adj, y = gat_graph(torch, n, seed=4)
    idx = torch.randperm(n, generator=torch.Generator().manual_seed(0))[
        :n // 10].to("cuda")
    yy = y[idx]
    impl = P.make_row_sharded_gat_attention(mesh, use_flash=True)
    rows = P.graph_sharding(mesh)
    out = {}
    progs = {}
    for name, attn in (("sharded", impl), ("unsharded", "flash")):
        model = gat_model(torch, X, adj, attn)
        # the sharded model runs on its row block (at world size 1, all
        # the rows)
        progs[name] = gat_programs(model.placed(rows) if attn is impl
                                   else model, int(idx.shape[0]))
        progs[name].train_step(idx, yy)
    torch.cuda.synchronize()
    same = _same_params(torch, progs["sharded"].params,
                        progs["unsharded"].params)
    if not same:
        raise AssertionError("row-sharded GAT step at world size 1: other "
                             "bits than the unsharded flash step")
    for name, pr in progs.items():
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        med, ms = _events_ms(torch, lambda: pr.train_step(idx, yy),
                             SHARD_STEPS)
        launches = {"flash_fwd": fa.flash_fwd.launches,
                    "flash_bwd": fa.flash_bwd.launches}
        if launches != {"flash_fwd": 2 * SHARD_STEPS,
                        "flash_bwd": 2 * SHARD_STEPS}:
            raise AssertionError(f"{name} GAT steps launched {launches}")
        out[name] = {"median_ms": med, "ms": ms, "launches": launches,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["same_bits_one_step"] = same
    del pr
    print(f"parallel (a) row-sharded GAT N={n}, P={mesh.size(0)} (NCCL): "
          f"train step median {out['sharded']['median_ms']:.3f} ms over "
          f"{SHARD_STEPS} (CUDA events), unsharded flash "
          f"{out['unsharded']['median_ms']:.3f} ms (PERF.md {STEP_REF_MS} "
          f"ms); peak {out['sharded']['peak_gb']:.2f} / "
          f"{out['unsharded']['peak_gb']:.2f} GB; flash launches "
          f"{out['sharded']['launches']}; one step the same bits as the "
          f"unsharded step: {same}  [{card}]", flush=True)
    del progs, X, adj
    torch.cuda.empty_cache()
    # one Kron hyperstep at N = 2708 through jvp_safe(): the sharded
    # model's curvature takes the plain twin with the same sharding
    X, adj, y = gat_graph(torch, GAT_N_TRAIN, seed=5)
    idx = torch.arange(N_TRAIN, device="cuda")
    nm = {}
    for name, attn in (("sharded", impl), ("unsharded", "flash")):
        model = gat_model(torch, X, adj, attn)
        if attn is impl:
            model = model.placed(rows)
        twin = model.jvp_safe().convs[0].attention_impl
        if name == "sharded" and not (isinstance(
                twin, type(impl)) and twin.use_flash is False):
            raise AssertionError(f"jvp_safe kept {twin}")
        fn = make_neg_marglik_fn(model, "classification", "kron", "all",
                                 N=N_TRAIN)
        # the trainer's hyperstep: the -log marglik and its gradient in
        # the adjacency (structurally zero for GAT: a mask), the weights
        # held fixed
        p = {k: v.detach().requires_grad_(k == "adj")
             for k, v in model.params().items()}
        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        val = fn(p, idx, y[:N_TRAIN])
        (g,) = torch.autograd.grad(val, [p["adj"]], allow_unused=True) \
            if val.requires_grad else (None,)
        torch.cuda.synchronize()
        nm[name] = float(val.detach())
        out[f"hyperstep_{name}"] = {
            "s": time.perf_counter() - t0, "neg_marglik": nm[name],
            "adj_grad_zero": g is None or not bool(g.any()),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "flash_launches": fa.flash_fwd.launches + fa.flash_bwd.launches}
        del model, fn, p, val, g
    nm_rel = abs(nm["sharded"] - nm["unsharded"]) / abs(nm["unsharded"])
    out["hyperstep_rel"] = nm_rel
    if not (math.isfinite(nm["sharded"]) and nm_rel <= F32_GAT_NM_TOL
            and out["hyperstep_sharded"]["adj_grad_zero"]
            and out["hyperstep_sharded"]["flash_launches"] == 0):
        raise AssertionError(f"sharded GAT hyperstep: {out}")
    print(f"parallel (a) GAT Kron hyperstep N={GAT_N_TRAIN} via jvp_safe: "
          f"sharded {out['hyperstep_sharded']['s']:.2f} s "
          f"({out['hyperstep_sharded']['peak_gb']:.2f} GB), unsharded "
          f"{out['hyperstep_unsharded']['s']:.2f} s "
          f"({out['hyperstep_unsharded']['peak_gb']:.2f} GB); -log marglik "
          f"relative gap {nm_rel:.2e} (bound {F32_GAT_NM_TOL}); d/d adj "
          f"zero; flash launches 0", flush=True)
    del X, adj
    torch.cuda.empty_cache()
    return out


def parallel_gat_p4(torch, S, fa, bw, card):
    """(b): P = 4 row blocks of the N = 16384 attention on the one card:
    each rank's post-collective body (``row_attention`` on the flash
    kernels, R = 4096) with a_src and h gathered by hand; the rows
    concatenated, and the gradients summed as the all-gather's transpose
    sums them, against the unsharded flash call (f32 bound
    F32_ATTN_TOL of the largest entry); each block's kernels against
    their plain versions (``flash_check``) and timed at R = 4096."""
    n, H, F = GAT_N_KERNEL, GAT_HEADS, GAT_HIDDEN // GAT_HEADS
    _, adj, _ = gat_graph(torch, n, seed=4)
    adj.fill_diagonal_(1.0)
    gen = torch.Generator(device="cuda").manual_seed(7)
    a_src = torch.randn(n, H, device="cuda", generator=gen)
    a_dst = torch.randn(n, H, device="cuda", generator=gen)
    h = torch.randn(n, H, F, device="cuda", generator=gen)
    g = torch.randn(n, H, F, device="cuda", generator=gen)
    r = n // P_CARD
    leaves = [t.clone().requires_grad_(True) for t in (a_src, a_dst, h)]
    whole = fa.flash_masked_attention(leaves[0], leaves[1], adj, leaves[2],
                                      0.2)
    want_g = torch.autograd.grad(whole, leaves, g)
    outs, d_src, d_dst, d_h = [], 0, [], 0
    errs, failures, rows = {}, [], []
    for p in range(P_CARD):
        blk = slice(p * r, (p + 1) * r)
        leaves_p = [t.clone().requires_grad_(True)
                    for t in (a_src, a_dst[blk], h)]
        o = S.row_attention(leaves_p[0], leaves_p[1], adj[blk], leaves_p[2],
                            0.2, use_flash=True)
        gs = torch.autograd.grad(o, leaves_p, g[blk])
        outs.append(o.detach())
        d_src = d_src + gs[0]
        d_dst.append(gs[1])
        d_h = d_h + gs[2]
        _, _, _, e, fl = flash_check(torch, fa, a_src, a_dst[blk], adj[blk],
                                     h, g[blk], None, f"row block {p}")
        errs[p] = e
        failures += fl
    got = {"out": torch.cat(outs), "d_a_src": d_src,
           "d_a_dst": torch.cat(d_dst), "d_h": d_h}
    want = {"out": whole.detach(), "d_a_src": want_g[0],
            "d_a_dst": want_g[1], "d_h": want_g[2]}
    rel = {k: _rel_max(got[k], want[k]) for k in got}
    if failures or max(rel.values()) > F32_ATTN_TOL:
        raise AssertionError(f"P = {P_CARD} row blocks: {rel} {failures}")
    # the pair at R = 4096 (block 0), timed beside the plain versions
    blk = slice(0, r)
    mask = adj[blk]
    nnz = int((mask > 0).sum())
    fwd = fa.flash_fwd(a_src, a_dst[blk], mask, h, 0.2)
    timing = {}
    for kern, call, plain, backward in (
            ("flash_fwd",
             lambda: fa.flash_fwd(a_src, a_dst[blk], mask, h, 0.2),
             lambda: fa.flash_fwd_reference(a_src, a_dst[blk], mask, h,
                                            0.2), False),
            ("flash_bwd",
             lambda: fa.flash_bwd(a_src, a_dst[blk], mask, h, g[blk], *fwd,
                                  0.2),
             lambda: fa.flash_bwd_reference(a_src, a_dst[blk], mask, h,
                                            g[blk], *fwd, 0.2), True)):
        bound, by = flash_bound(n, r, H, F, nnz, 4 * r * n, bw, backward)
        timing[kern] = {"r": r, "ms": cold_ms(torch, call),
                        "plain_ms": cold_ms(torch, plain, reps=5),
                        "bound_ms": bound, "bound_by": by, "nnz": nnz}
    print(f"parallel (b) P={P_CARD} row blocks of R={r} on one card: "
          f"concatenated rows and summed gradients vs the unsharded flash "
          f"call, max relative {max(rel.values()):.2e} (bound "
          f"{F32_ATTN_TOL}); each block's kernels vs plain, worst "
          f"{max(max(e.values()) for e in errs.values()):.2e}, two calls "
          f"the same bits; at R={r}: fwd {timing['flash_fwd']['ms']:.3f} "
          f"ms (plain {timing['flash_fwd']['plain_ms']:.3f}, bound "
          f"{timing['flash_fwd']['bound_ms']:.4f}), bwd "
          f"{timing['flash_bwd']['ms']:.3f} ms (plain "
          f"{timing['flash_bwd']['plain_ms']:.3f}, bound "
          f"{timing['flash_bwd']['bound_ms']:.4f})  [{card}]", flush=True)
    del adj, a_src, a_dst, h, g, leaves, whole, want_g, got, want, fwd
    torch.cuda.empty_cache()
    return {"rel": rel, "kernel_errs": errs, "timing": timing}


def _halo_bodies(torch, S, x, plan, ring: bool):
    """Every rank's post-collective SpMM rows on one card: rank p's halo
    table from the buffers the other blocks send it."""
    B = int(plan["block"])
    rps = [S.rank_plan(plan, p, "cuda") for p in range(P_CARD)]
    blocks = [x[p * B:(p + 1) * B] for p in range(P_CARD)]
    bufs = [S.halo_send(blocks[q], rps[q]) for q in range(P_CARD)]
    outs = []
    for p in range(P_CARD):
        if ring:
            halo = torch.cat([bufs[(p - s) % P_CARD][s - 1]
                              for s in range(1, P_CARD)])
        else:
            halo = torch.stack([bufs[q][0][p] for q in range(P_CARD)]
                               ).reshape((-1,) + tuple(x.shape[1:]))
        outs.append(S.halo_rows(blocks[p], halo, rps[p]))
    return torch.cat(outs)


def parallel_sparse(torch, np, P, S, mesh, card):
    """(c): SparseGCN at ogbn-arxiv's shape through HaloAggGraph on the
    world-size-1 mesh (the local path), its train step timed; then P = 4
    on the card: RCM order, edge-balanced blocks padded to one width, both
    halo plans, every rank's post-collective body against the SpMM of
    the whole graph, twice to the same bits; the schedules' volumes and
    the projected scaling from the measured one-card SpMM; the halo GAT's
    P = 4 bodies on a 4096-node cut."""
    from laplace_gnn_torch.graph import container as C
    from laplace_gnn_torch.models import SparseGCN
    from laplace_gnn_torch.parallel import scaling
    from laplace_gnn_torch.training import sparse_experiment as se
    from laplace_gnn_torch.training.marglik_gnn import DeviceAdam
    out = {}
    t0 = time.perf_counter()
    x, y, ei = arxiv_like(np)
    out["data_s"] = time.perf_counter() - t0
    common = ["--dataset", "arxivlike", "--hidden_channels",
              str(SPARSE_HIDDEN), "--num_layers", str(SPARSE_LAYERS)]
    g = se.build_graph(se.argument_parser().parse_args(common),
                       argparse.Namespace(edge_index=ei, num_nodes=ARXIV_N),
                       device="cuda")
    hg = P.HaloAggGraph(mesh, g)
    model = SparseGCN(ARXIV_F, SPARSE_HIDDEN, ARXIV_C, SPARSE_LAYERS,
                      hg.put(torch.as_tensor(x)), hg, dropout_p=0.0,
                      device="cuda")
    params = {k: v.requires_grad_(True) for k, v in model.params().items()}
    opt = DeviceAdam(params.values(), lr=1e-2)
    tr = torch.arange(0, ARXIV_N, 10, device="cuda")
    ytr = torch.as_tensor(y, device="cuda")[tr]
    se.train_steps(model, params, opt, tr, ytr, 3)
    torch.cuda.synchronize()
    med, ms = _events_ms(
        torch, lambda: se.train_steps(model, params, opt, tr, ytr, 1), 20)
    out["halo_train_step"] = {"median_ms": med, "ms": ms,
                              "schedule": hg.schedule, "stats": hg.stats}
    print(f"parallel (c) SparseGCN at arxiv's shape through HaloAggGraph "
          f"(world size 1, {hg.schedule}, local path): train step median "
          f"{med:.3f} ms over 20 (CUDA events; phase 18's CLI step "
          f"{SPARSE_REF_MS} ms)  [{card}]", flush=True)
    del model, params, opt, hg, g
    torch.cuda.empty_cache()
    # P = 4 on the card, on the RCM-ordered graph padded to equal blocks
    t0 = time.perf_counter()
    ei_r, ei_p, n_p, node_map, x_p, _ = arxiv_blocks(np, P, x, y, ei)
    g4 = C.sparse_from_edge_index(ei_p, n_p, normalize="sym", device="cuda")
    plans = {"alltoall": P.build_halo_exchange(g4, P_CARD),
             "ring": P.build_ring_halo_exchange(g4, P_CARD)}
    out["plan_s"] = time.perf_counter() - t0
    xs = torch.randn(n_p, SPARSE_HIDDEN, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(3))
    f = C.make_spmm(g4)
    want = f(xs)
    for name, plan in plans.items():
        got = _halo_bodies(torch, S, xs, plan, name == "ring")
        again = _halo_bodies(torch, S, xs, plan, name == "ring")
        B = int(plan["block"])
        cross = ((P_CARD - 1) * int(plan["H"]) if name == "alltoall"
                 else int(sum(plan["H_s"])))
        row = {"rel": _rel(got, want), "same_bits": torch.equal(got, again),
               "block": B, **S.halo_stats(n_p, P_CARD, cross)}
        if name == "ring":
            row["H_s"] = plan["H_s"]
        out[f"p4_{name}"] = row
        if row["rel"] > F32_SPMM_TOL or not row["same_bits"]:
            raise AssertionError(f"P = {P_CARD} halo SpMM ({name}): {row}")
    spmm_ms = cold_ms(torch, lambda: f(xs))
    proj = scaling.projected_scaling(g4, SPARSE_HIDDEN, spmm_ms / 1e3,
                                     n_chips=(2, 4, 8))
    out["spmm_ms"], out["projected"] = spmm_ms, proj
    print(f"parallel (c) P={P_CARD} halo SpMM on one card (RCM, "
          f"edge-balanced blocks padded to {n_p} nodes, plans "
          f"{out['plan_s']:.1f} s): all_to_all rel "
          f"{out['p4_alltoall']['rel']:.2e}, ring rel "
          f"{out['p4_ring']['rel']:.2e} (bound {F32_SPMM_TOL}, against the "
          f"whole SpMM), twice the same bits; rows that cross per rank "
          f"against one all-gather (comm_volume_ratio; the bodies return "
          f"their blocks) all_to_all "
          f"{out['p4_alltoall']['comm_volume_ratio']:.4f}, ring "
          f"{out['p4_ring']['comm_volume_ratio']:.4f} (H_s "
          f"{out['p4_ring']['H_s']}); one-card SpMM {spmm_ms:.3f} ms  "
          f"[{card}]", flush=True)
    print("  projected (H100 NVLink 4.5e11 B/s, not measured):\n"
          + scaling.format_table(proj), flush=True)
    # the halo GAT's P = 4 bodies on a 4096-node cut of the ordered graph
    n_c = 4096
    keep = (ei_r[0] < n_c) & (ei_r[1] < n_c)
    gc = C.sparse_from_edge_index(ei_r[:, keep], n_c, normalize=None,
                                  device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    hgat = torch.randn(n_c, GAT_HEADS, 8, device="cuda", generator=gen)
    att_s = torch.randn(1, GAT_HEADS, 8, device="cuda", generator=gen)
    att_d = torch.randn(1, GAT_HEADS, 8, device="cuda", generator=gen)
    ref = P.make_halo_gat_aggregate(mesh, gc)[0](hgat, att_s, att_d, 0.2)
    for name, build in (("alltoall", P.build_halo_exchange),
                        ("ring", P.build_ring_halo_exchange)):
        plan = build(gc, P_CARD)
        B = n_c // P_CARD
        rps = [S.rank_plan(plan, p, "cuda") for p in range(P_CARD)]
        blocks = [hgat[p * B:(p + 1) * B] for p in range(P_CARD)]
        bufs = [S.halo_send(blocks[q], rps[q]) for q in range(P_CARD)]
        rows = []
        for p in range(P_CARD):
            halo = (torch.cat([bufs[(p - s) % P_CARD][s - 1]
                               for s in range(1, P_CARD)])
                    if name == "ring" else
                    torch.stack([bufs[q][0][p] for q in range(P_CARD)]
                                ).reshape(-1, GAT_HEADS, 8))
            rows.append(S.halo_gat_rows(blocks[p], halo, rps[p], att_s,
                                        att_d, 0.2))
        rel = _rel(torch.cat(rows), ref)
        out[f"gat_p4_{name}"] = rel
        if rel > F32_SPMM_TOL:
            raise AssertionError(f"halo GAT P = {P_CARD} ({name}): {rel}")
    print(f"parallel (c) halo GAT P={P_CARD} bodies on a {n_c}-node cut: "
          f"all_to_all rel {out['gat_p4_alltoall']:.2e}, ring rel "
          f"{out['gat_p4_ring']:.2e} against the one-part edge softmax "
          f"(bound {F32_SPMM_TOL})", flush=True)
    del g4, xs, want, f, gc
    torch.cuda.empty_cache()
    return out


def arxiv_blocks(np, P, x, y, ei):
    """The arxiv-shaped graph in RCM order, cut into P_CARD edge-balanced
    blocks padded to one width: (the ordered edges, the padded edges, the
    padded node count, each node's new id, the padded x and y)."""
    order = P.rcm_order(ei, ARXIV_N)
    ei_r, x_r, y_r = P.apply_node_order(ei, order, x, y)
    offsets = P.edge_balanced_blocks(ei_r, ARXIV_N, P_CARD)
    ei_p, n_p, node_map, x_p, y_p = P.pad_to_blocks(ei_r, offsets, x_r, y_r)
    return ei_r, ei_p, n_p, node_map, x_p, y_p


def parallel_stegcn(torch, np, P, fs, mesh, card):
    """(d): make_sharded_train_step at Cora's width (phase 3's graph), 10
    steps with fused=True (core_spmm) and fused=False, each the same bits
    as 10 plain autograd SGD steps on the model's ``apply``, written here
    apart from the factory. The composed step runs on the rank's row
    block (at world size 1 all the rows: the same arithmetic as the
    unsharded step); the fused one keeps the square adjacency, so it is by
    design the unsharded step, run on each rank. Then the composed Kron
    hyperstep on its row block against the unsharded one (the same bits),
    and one AttSTEGCN hyperstep with ``adj_constraint`` (its rows of the
    score matrix built per rank) against the unsharded one."""
    from laplace_gnn_torch.models import AttSTEGCN, STEGCN
    from laplace_gnn_torch.training.marglik_gnn import (_ce_mean,
                                                        make_neg_marglik_fn)
    rng = np.random.default_rng(0)
    X, adj, y = make_graph(np, rng)
    tr = torch.as_tensor(rng.permutation(N_NODES)[:N_TRAIN], device="cuda")
    yt = torch.as_tensor(y, device="cuda")[tr]
    out = {}
    for fused in (True, False):
        model = STEGCN(N_FEAT, HIDDEN, N_CLASS, 2, X, adj, dropout_p=0.0,
                       fused=fused, device="cuda",
                       generator=torch.Generator().manual_seed(0))
        step, shard = P.make_sharded_train_step(model, mesh, _ce_mean,
                                                lr=0.1)

        def plain(params, idx, y):
            leaves = [v.detach().requires_grad_(True)
                      for v in params.values()]
            p = dict(zip(params, leaves))
            loss = _ce_mean(model.apply(p, idx), y)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return ({k: (v if gr is None else v - 0.1 * gr).detach()
                     for (k, v), gr in zip(p.items(), grads)},
                    loss.detach())

        p_sh, shardings = shard(model.params())
        p_un = model.params()
        fs.core.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for _ in range(10):
            p_sh, loss = step(p_sh, tr, yt)
            losses.append(float(loss))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = fs.core.launches
        for _ in range(10):
            p_un, loss_un = plain(p_un, tr, yt)
        same = _same_params(torch, p_sh, p_un) and float(loss_un) == \
            losses[-1]
        row = {"s_10_steps": secs, "losses": losses, "same_bits": same,
               "core_spmm_launches": launches,
               "adj_spec": shardings["adj"].spec}
        out[f"fused={fused}"] = row
        if not same:
            raise AssertionError(f"sharded STE-GCN step fused={fused}: "
                                 f"other bits than the unsharded step")
        if fused and launches == 0:
            raise AssertionError("the sharded fused STE-GCN step launched "
                                 "no core_spmm")
        print(f"parallel (d) make_sharded_train_step STE-GCN fused={fused} "
              f"(adj placed {row['adj_spec']}): 10 steps {secs:.3f} s, "
              f"losses {losses[0]:.5f} -> {losses[-1]:.5f}, the same bits "
              f"as plain autograd SGD steps: {same}; core_spmm launches "
              f"{launches}  [{card}]", flush=True)
        del model, p_sh, p_un
    # the composed Kron hyperstep on the row block against the unsharded
    model = STEGCN(N_FEAT, HIDDEN, N_CLASS, 2, X, adj, dropout_p=0.0,
                   device="cuda", generator=torch.Generator().manual_seed(0))
    hs = {}
    for name, m in (("sharded", model.placed(P.graph_sharding(mesh))),
                    ("unsharded", model)):
        fn = make_neg_marglik_fn(m, "classification", "kron", "all",
                                 N=N_TRAIN)
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in model.params().items()}
        t0 = time.perf_counter()
        val = fn(p, tr, yt)
        (g,) = torch.autograd.grad(val, [p["adj"]])
        torch.cuda.synchronize()
        hs[name] = (time.perf_counter() - t0, val.detach(), g)
    # the vmapped pullback's collectives move the batch axis (dim 1), so
    # cuBLAS meets other layouts than in the unsharded pullback: rounding
    same = bool(torch.equal(hs["sharded"][1], hs["unsharded"][1])
                and torch.equal(hs["sharded"][2], hs["unsharded"][2]))
    nm_rel = _rel(hs["sharded"][1], hs["unsharded"][1])
    g_rel = _rel(hs["sharded"][2], hs["unsharded"][2])
    out["composed_hyperstep"] = {
        "s": {k: v[0] for k, v in hs.items()}, "same_bits": same,
        "neg_marglik": float(hs["sharded"][1]), "neg_marglik_rel": nm_rel,
        "adj_grad_rel": g_rel}
    if not (nm_rel <= F32_GRAD_TOL and g_rel <= F32_GRAD_TOL):
        raise AssertionError(f"composed STE-GCN hyperstep on the row "
                             f"block: {out['composed_hyperstep']}")
    print(f"parallel (d) composed STE-GCN Kron hyperstep on the row block: "
          f"{hs['sharded'][0]:.3f} s (unsharded {hs['unsharded'][0]:.3f} "
          f"s); -log marglik relative gap {nm_rel:.2e}, d/d adj relative "
          f"{g_rel:.2e} (bound {F32_GRAD_TOL}), the same bits: {same}  "
          f"[{card}]", flush=True)
    del model, hs
    # one AttSTEGCN hyperstep, the score matrix's rows on the graph axis
    model = AttSTEGCN(N_FEAT, HIDDEN, N_CLASS, 2, X, adj, dropout_p=0.0,
                      device="cuda",
                      generator=torch.Generator().manual_seed(0))
    vals, grads, secs = {}, {}, {}
    for name, constraint in (("unsharded", None),
                             ("sharded", P.graph_sharding(mesh))):
        model.adj_constraint = constraint
        fn = make_neg_marglik_fn(model, "classification", "kron", "all",
                                 N=N_TRAIN)
        p = {k: v.detach().requires_grad_(k == "adj_W.weight")
             for k, v in model.params().items()}
        t0 = time.perf_counter()
        val = fn(p, tr, yt)
        (g,) = torch.autograd.grad(val, [p["adj_W.weight"]])
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        vals[name], grads[name] = float(val.detach()), g
    model.adj_constraint = None
    nm_rel = abs(vals["sharded"] - vals["unsharded"]) / abs(
        vals["unsharded"])
    g_rel = _rel(grads["sharded"], grads["unsharded"])
    out["attstegcn"] = {"s": secs, "neg_marglik": vals,
                        "neg_marglik_rel": nm_rel, "adj_W_grad_rel": g_rel,
                        "adj_W_grad_norm": float(grads["sharded"].norm())}
    if not (math.isfinite(vals["sharded"]) and nm_rel <= F32_GRAD_TOL
            and g_rel <= F32_GRAD_TOL and out["attstegcn"][
                "adj_W_grad_norm"] > 0):
        raise AssertionError(f"AttSTEGCN adj_constraint hyperstep: "
                             f"{out['attstegcn']}")
    print(f"parallel (d) AttSTEGCN Kron hyperstep with adj_constraint: "
          f"{secs['sharded']:.3f} s (unsharded {secs['unsharded']:.3f} s); "
          f"-log marglik relative gap {nm_rel:.2e}, d/d adj_W relative "
          f"{g_rel:.2e} (bound {F32_GRAD_TOL})  [{card}]", flush=True)
    return out


def phase_parallel(torch, np, fa, fs, mm, card, peaks):
    """Phase 19: the single-axis scale-out layer on a real NCCL group of
    world size ``torch.cuda.device_count()`` (one card: 1), parts (a)-(d);
    every kernel's count (flash, core_spmm, matmul) set to 0 just before
    the parts and read just after them (``launches``: the flash pair's
    from part (a)'s timed sharded steps, core_spmm's from part (d)'s
    fused sharded steps, matmul's over all four parts)."""
    import torch.distributed as dist
    from laplace_gnn_torch import parallel as P
    from laplace_gnn_torch.parallel import sharded as S
    world = torch.cuda.device_count()
    if world != 1:
        raise AssertionError(f"phase 19 runs one process, and this machine "
                             f"has {world} cards")
    P.initialize(f"tcp://127.0.0.1:{_free_port()}", world, 0,
                 device="cuda")
    out, secs = {}, {}
    try:
        mesh = P.make_mesh()
        if str(dist.get_backend()) != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}")
        fs.core.launches = fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        mm.matmul.launches = 0
        for key, fn, args in (
                ("gat", parallel_gat, (torch, P, fa, mesh, card)),
                ("gat_p4", parallel_gat_p4, (torch, S, fa, peaks[0], card)),
                ("sparse", parallel_sparse, (torch, np, P, S, mesh, card)),
                ("stegcn", parallel_stegcn, (torch, np, P, fs, mesh, card))):
            t0 = time.perf_counter()
            out[key] = fn(*args)
            torch.cuda.synchronize()
            secs[key] = time.perf_counter() - t0
            print(f"parallel part {key}: {secs[key]:.3f} s", flush=True)
        matmul_launches = mm.matmul.launches
    finally:
        dist.destroy_process_group()
    out["seconds"] = secs
    out["launches"] = {
        "flash_fwd": out["gat"]["sharded"]["launches"]["flash_fwd"],
        "flash_bwd": out["gat"]["sharded"]["launches"]["flash_bwd"],
        "core_spmm": out["stegcn"]["fused=True"]["core_spmm_launches"]}
    if not all(out["launches"].values()):
        raise AssertionError(f"sharded paths' launches {out['launches']}")
    # matmul is on no path, sharded or not: counted, not required
    out["launches"]["matmul"] = matmul_launches
    print(f"parallel launches on the sharded paths: {out['launches']}",
          flush=True)
    return out


# phase 20: per-rank memory on row blocks, and the DCN bodies
MEM_N, MEM_D, MEM_HIDDEN, MEM_C = 8192, 32, 32, 7   # shard_scale_bench.py
MEM_DENSITY, MEM_TRAIN = 14e-4, 1024
MEM_RATIO_MIN = 3.0         # rank 0's footprint, unsharded over sharded at
                            # P = 4: 75 % of the ideal 4x (JAX's slow test
                            # asks > 6 of 8)
DCN_SLICES = 2              # (dcn, graph) = (2, 2) on the one card


def _footprint(torch, fn):
    """(fn's result, the bytes it allocated at its peak above what was
    allocated before it): its inputs made inside, its temporaries and its
    outputs, as JAX's memory analysis counts a program's argument +
    temporary + output bytes."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def memory_stegcn(torch, np, P, mesh, card):
    """(a) the composed STE-GCN Kron hyperstep (value and every gradient)
    at scripts/shard_scale_bench.py's size, unsharded and as rank 0 of a
    4-rank group (``mesh``, a fake group: its collectives move nothing,
    every tensor has its real shape). A footprint counts the step's inputs
    (the parameters, ``adj`` whole or its row block), temporaries and
    outputs; the model object's own whole adjacency (its ``adj``
    parameter and ``init_adj``, which the functional step does not read)
    is held before, on both sides."""
    from laplace_gnn_torch.models import STEGCN
    from laplace_gnn_torch.training.marglik_gnn import make_neg_marglik_fn
    rng = np.random.default_rng(0)
    X = rng.standard_normal((MEM_N, MEM_D)).astype(np.float32)
    adj = (rng.random((MEM_N, MEM_N)) < MEM_DENSITY).astype(np.float32)
    adj = np.minimum(adj + adj.T, 1.0)
    np.fill_diagonal(adj, 0.0)
    y = torch.as_tensor(rng.integers(0, MEM_C, MEM_TRAIN), device="cuda")
    idx = torch.arange(MEM_TRAIN, device="cuda")
    model = STEGCN(MEM_D, MEM_HIDDEN, MEM_C, 2, X, adj, dropout_p=0.0,
                   device="cuda", generator=torch.Generator().manual_seed(0))
    del adj
    rows = P.graph_sharding(mesh)
    whole = model.params()
    out = {}
    for name, m, place in (
            ("unsharded", model, lambda k, v: v.detach().clone()),
            ("rank0_of_4", model.placed(rows),
             lambda k, v: rows.put(v) if k == "adj" else v.detach().clone())):
        fn = make_neg_marglik_fn(m, "classification", "kron", "all",
                                 N=MEM_TRAIN)

        def hyperstep():
            p = {k: place(k, v).requires_grad_(True)
                 for k, v in whole.items()}
            val = fn(p, idx, y)
            grads = dict(zip(p, torch.autograd.grad(val, list(p.values()))))
            return (float(val.detach()), tuple(p["adj"].shape),
                    tuple(grads["adj"].shape))

        t0 = time.perf_counter()
        (val, adj_shape, g_shape), nbytes = _footprint(torch, hyperstep)
        out[name] = {"bytes": nbytes, "gb": nbytes / 1e9,
                     "s": time.perf_counter() - t0, "adj_shape": adj_shape,
                     "adj_grad_shape": g_shape, "finite": math.isfinite(val)}
    ratio = out["unsharded"]["bytes"] / out["rank0_of_4"]["bytes"]
    out["ratio"] = ratio
    r = MEM_N // P_CARD
    if not (out["rank0_of_4"]["adj_shape"] == (r, MEM_N)
            and out["rank0_of_4"]["adj_grad_shape"] == (r, MEM_N)
            and out["unsharded"]["finite"] and out["rank0_of_4"]["finite"]):
        raise AssertionError(f"phase 20 (a) STE-GCN hyperstep: {out}")
    print(f"phase 20 (a) composed STE-GCN Kron hyperstep N={MEM_N} "
          f"(d={MEM_D}, hidden {MEM_HIDDEN}, {MEM_C} classes, {MEM_TRAIN} "
          f"train, f32): unsharded {out['unsharded']['gb']:.3f} GB, rank 0 "
          f"of {P_CARD} (fake group, adj block {r}x{MEM_N}) "
          f"{out['rank0_of_4']['gb']:.3f} GB: per-rank memory ratio "
          f"{ratio:.3f}x (bound {MEM_RATIO_MIN}x; torch.cuda."
          f"max_memory_allocated)  [{card}]", flush=True)
    if ratio < MEM_RATIO_MIN:
        raise AssertionError(f"per-rank memory ratio {ratio:.3f} below "
                             f"{MEM_RATIO_MIN}")
    del model, whole, m, fn
    torch.cuda.empty_cache()
    return out


def memory_sparse(torch, P, C, mesh, blocks, card):
    """(a) the SparseGCN train step (forward, cross entropy on every
    tenth node, gradients, the SGD update) at phase 18's width on the
    padded arxiv-shaped graph, unsharded (FastAggGraph) and as rank 0 of
    4 (HaloAggGraph on the fake group). A footprint is the step's
    allocations plus the features the rank holds (whole, or its block);
    the graph's edge lists and plans are held before, on both sides."""
    from laplace_gnn_torch.models import SparseGCN
    from laplace_gnn_torch.training.marglik_gnn import _ce_mean
    _, ei_p, n_p, node_map, x_p, y_p = blocks
    g = C.sparse_from_edge_index(ei_p, n_p, normalize="sym", device="cuda")
    tr = torch.as_tensor(node_map[::10], device="cuda")
    ytr = torch.as_tensor(y_p, device="cuda")[tr]
    out = {}
    for name, graph in (("unsharded", g),
                        ("rank0_of_4", P.HaloAggGraph(mesh, g,
                                                      device="cuda"))):
        put = graph.put if name != "unsharded" else (
            lambda v: torch.as_tensor(v).to("cuda", copy=True))
        model = SparseGCN(ARXIV_F, SPARSE_HIDDEN, ARXIV_C, SPARSE_LAYERS,
                          put(x_p), graph, dropout_p=0.0, device="cuda",
                          generator=torch.Generator().manual_seed(0))
        params = model.params()

        def step():
            p = {k: v.detach().clone().requires_grad_(True)
                 for k, v in params.items()}
            loss = _ce_mean(model.apply(p, tr), ytr)
            grads = torch.autograd.grad(loss, list(p.values()))
            return {k: (v - 0.01 * gr).detach()
                    for (k, v), gr in zip(p.items(), grads)}, loss.detach()

        t0 = time.perf_counter()
        (_, loss), nbytes = _footprint(torch, step)
        x_bytes = model.X.numel() * model.X.element_size()
        out[name] = {"step_bytes": nbytes, "x_bytes": x_bytes,
                     "bytes": nbytes + x_bytes,
                     "gb": (nbytes + x_bytes) / 1e9,
                     "s": time.perf_counter() - t0,
                     "x_rows": int(model.X.shape[0]),
                     "finite": bool(torch.isfinite(loss))}
        if name != "unsharded":
            out[name]["schedule"] = graph.schedule
            out[name]["stats"] = graph.stats
        del model, params
    ratio = out["unsharded"]["bytes"] / out["rank0_of_4"]["bytes"]
    out["ratio"] = ratio
    if not (out["rank0_of_4"]["x_rows"] == n_p // P_CARD
            and out["unsharded"]["finite"]):
        raise AssertionError(f"phase 20 (a) SparseGCN step: {out}")
    print(f"phase 20 (a) SparseGCN train step at arxiv's shape ({n_p} "
          f"nodes padded, hidden {SPARSE_HIDDEN}): unsharded "
          f"{out['unsharded']['gb']:.3f} GB, rank 0 of {P_CARD} (fake "
          f"group, {out['rank0_of_4']['schedule']}, block of "
          f"{n_p // P_CARD} rows) {out['rank0_of_4']['gb']:.3f} GB: "
          f"per-rank memory ratio {ratio:.3f}x  [{card}]", flush=True)
    torch.cuda.empty_cache()
    return out


def dcn_bodies(torch, np, P, S, C, blocks, card):
    """(b) the DCN bodies at (dcn, graph) = (2, 2) on the one card, rank
    by rank: each slice's edge stripe with its halo plan (common paddings),
    every rank's partial rows, summed over the slices and stacked over
    the graph ranks, against the unsharded SpMM (the normalized graph)
    and GAT edge softmax (the graph with self-loops) at the arxiv shape;
    the GAT's maxima taken over the slices before the exponentials."""
    from laplace_gnn_torch.parallel import distributed as D
    _, ei_p, n_p, _, _, _ = blocks
    n_g = P_CARD // DCN_SLICES
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    # the SpMM
    g = C.sparse_from_edge_index(ei_p, n_p, normalize="sym", device="cuda")
    t0 = time.perf_counter()
    slices = D.stripe_edges(g, DCN_SLICES)
    plans, H = D.dcn_halo_plans(g, slices, n_g)
    out["plan_s"] = time.perf_counter() - t0
    B = int(plans[0]["block"])
    xs = torch.randn(n_p, SPARSE_HIDDEN, device="cuda", generator=gen)
    want = C.make_spmm(g)(xs)
    rps = [[S.rank_plan(pl, p, "cuda") for p in range(n_g)] for pl in plans]
    blk = [xs[p * B:(p + 1) * B] for p in range(n_g)]
    rows = []
    for p in range(n_g):
        part = 0
        for k in range(DCN_SLICES):
            bufs = [S.halo_send(blk[q], rps[k][q]) for q in range(n_g)]
            halo = torch.stack([bufs[q][0][p] for q in range(n_g)]
                               ).reshape(-1, SPARSE_HIDDEN)
            part = part + S.halo_rows(blk[p], halo, rps[k][p])
        rows.append(part)
    got = torch.cat(rows)
    out["spmm_rel"] = _rel(got, want)
    out["stats"] = {"halo_rows_per_device": (n_g - 1) * H,
                    "dcn_psum_rows_per_device": B, "H": H,
                    "n_dcn": DCN_SLICES, "n_graph": n_g}
    if out["spmm_rel"] > F32_SPMM_TOL:
        raise AssertionError(f"DCN SpMM bodies: {out}")
    del g, want, got, rows
    # the GAT edge softmax, with self-loops and no normalization
    gg = C.sparse_from_edge_index(ei_p, n_p, normalize=None, device="cuda")
    slices = D.stripe_edges(gg, DCN_SLICES)
    plans, Hg = D.dcn_halo_plans(gg, slices, n_g)
    rps = [[S.rank_plan(pl, p, "cuda") for p in range(n_g)] for pl in plans]
    h = torch.randn(n_p, GAT_HEADS, 8, device="cuda", generator=gen)
    att_s = torch.randn(1, GAT_HEADS, 8, device="cuda", generator=gen)
    att_d = torch.randn(1, GAT_HEADS, 8, device="cuda", generator=gen)
    from laplace_gnn_torch.models.sparse_gnn import segment_attention
    want = segment_attention(gg, h, torch.sum(h * att_s, -1),
                             torch.sum(h * att_d, -1), 0.2)
    hb = [h[p * B:(p + 1) * B] for p in range(n_g)]
    rows = []
    for p in range(n_g):
        parts = []
        for k in range(DCN_SLICES):
            bufs = [S.halo_send(hb[q], rps[k][q]) for q in range(n_g)]
            halo = torch.stack([bufs[q][0][p] for q in range(n_g)]
                               ).reshape(-1, GAT_HEADS, 8)
            parts.append(D.dcn_gat_sets(hb[p], halo, rps[k][p], att_s,
                                        att_d, 0.2))
        smax = parts[0][1]
        for _, m in parts[1:]:
            smax = torch.maximum(smax, m)             # the max over 'dcn'
        smax = D.finite_shift(smax)
        both = sum(D.dcn_gat_partial(sets, smax, hb[p])
                   for sets, _ in parts)              # the sum over 'dcn'
        rows.append(D.dcn_gat_quotient(both, hb[p].dtype))
    out["gat_rel"] = _rel(torch.cat(rows), want)
    out["gat_H"] = Hg
    if out["gat_rel"] > F32_SPMM_TOL:
        raise AssertionError(f"DCN GAT bodies: {out}")
    st = out["stats"]
    print(f"phase 20 (b) DCN bodies at (dcn, graph) = ({DCN_SLICES}, "
          f"{n_g}) on one card, arxiv's shape ({n_p} nodes, edges striped "
          f"over the slices, plans {out['plan_s']:.1f} s): SpMM rel "
          f"{out['spmm_rel']:.2e}, GAT rel {out['gat_rel']:.2e} (bound "
          f"{F32_SPMM_TOL}, against the unsharded SpMM / edge softmax); "
          f"per rank and application, halo rows over 'graph' "
          f"{st['halo_rows_per_device']} (H = {st['H']}), dcn_psum rows "
          f"{st['dcn_psum_rows_per_device']}  [{card}]", flush=True)
    del gg, h, want, rows
    torch.cuda.empty_cache()
    return out


def phase_memory_dcn(torch, np, card):
    """Phase 20: (a) rank 0 of a 4-rank group alone on the card (a fake
    group, ``allow_fake=True``) against the unsharded step, for the
    composed STE-GCN Kron hyperstep and the SparseGCN train step; (b) the
    DCN bodies rank by rank. No kernel is on these paths but the ``spmm``
    kernel of the unsharded SpMMs."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from laplace_gnn_torch import parallel as P
    from laplace_gnn_torch.graph import container as C
    from laplace_gnn_torch.parallel import sharded as S
    x, y, ei = arxiv_like(np)
    blocks = arxiv_blocks(np, P, x, y, ei)
    out = {}
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=P_CARD)
    try:
        mesh = P.make_mesh(P_CARD, device="cuda", allow_fake=True)
        out["stegcn"] = memory_stegcn(torch, np, P, mesh, card)
        out["sparse"] = memory_sparse(torch, P, C, mesh, blocks, card)
    finally:
        dist.destroy_process_group()
    out["dcn"] = dcn_bodies(torch, np, P, S, C, blocks, card)
    return out



# phase 21: the examples (examples/torch/) as a user runs them, in-process
EXAMPLES_DIR = os.path.join(ROOT, "examples", "torch")
# in the order of the slice; each with the markers the JAX examples' tests
# assert (tests/test_examples.py)
EXAMPLES_ON_CARD = (
    ("01_laplace_quickstart", ("marglik after tuning", "should be larger")),
    ("06_regression", ("regression example OK",)),
    ("03_calibration", ("Laplace probit",)),
    ("07_bayesopt", ("bayesopt example OK",)),
    ("08_reward_modeling", ("reward modeling example OK",)),
    ("12_dict_input_llm_head", ("dict-input predictive sums to 1: OK",)),
    ("09_gp_calibration", ("gp calibration example OK",)),
    ("02_graph_structure_learning", ("learned graph",
                                     "Bayes test metrics")),
    ("13_flash_attention_gat", ("flash GAT marglik training",
                                "predictive rows")),
    ("04_sparse_scale", ("30 steps, final loss",)),
    ("10_multihost_launch", ("[single process]", "neg_marglik=")))
# not run here, and why (the CPU tests run them)
EXAMPLES_OFF_CARD = {
    "05_distributed_marglik": "needs scikit-learn (graph.moons_dataset), "
                              "which this machine lacks",
    "11_learned_graph_evolution": "needs matplotlib (graph/plots.py), "
                                  "which this machine lacks"}


def _example_checks(np, name, out) -> list:
    """The example's own checks on what its ``main`` returned."""
    bad = []
    if name == "01_laplace_quickstart":
        if out["f_var_shape"] != (200, 1, 1):
            bad.append(f"f_var shape {out['f_var_shape']}")
        if not out["std_gap"] > out["std_data"]:
            bad.append("std in the gap not larger")
        if not out["marglik_after"] >= out["marglik_before"]:
            bad.append("marglik fell in tuning")
    if name in ("02_graph_structure_learning", "13_flash_attention_gat"):
        if not np.all(np.isfinite(out["neg_margliks"])):
            bad.append("neg marglik trace not finite")
    if name == "12_dict_input_llm_head":
        if not np.allclose(out["probs"].sum(-1), 1.0, atol=1e-5):
            bad.append("predictive rows do not sum to 1")
    if name == "13_flash_attention_gat":
        if not np.allclose(out["row_sums"], 1.0, atol=1e-5):
            bad.append("predictive rows do not sum to 1")
    if name == "10_multihost_launch":
        if not all(np.isfinite(out)):
            bad.append(f"scalars {out}")
    return bad


def phase_examples(torch, np, fa, fs, mm, card, out_dir):
    """Phase 21: each example of EXAMPLES_ON_CARD through its ``main(
    ["--device", "cuda"])`` (``runpy``), with every kernel's count set to
    0 just before and read just after; its output goes to
    ``chiprun_out/examples/<name>.txt``, its markers and own checks must
    hold. The flash pair must launch in example 13, and is then held
    against its plain versions at every shape that example launched."""
    import io
    import runpy
    counted = {"core_spmm": fs.core, "flash_fwd": fa.flash_fwd,
               "flash_bwd": fa.flash_bwd, "matmul": mm.matmul}
    ex_dir = os.path.join(out_dir, "examples")
    os.makedirs(ex_dir, exist_ok=True)
    for name, why in EXAMPLES_OFF_CARD.items():
        print(f"example {name}: not run on the card, {why}", flush=True)

    # the forward's inputs at each shape the examples launch it with
    seen = {}
    fwd_call = fa.FlashForwardKernel.__call__

    def recorded(self, a_src, a_dst, adj, h, negative_slope=0.2,
                 attn_dtype=None):
        if h.is_cuda:
            key = (tuple(adj.shape), tuple(h.shape), str(adj.dtype),
                   str(attn_dtype))
            seen.setdefault(key, tuple(t.detach().clone() for t in
                                       (a_src, a_dst, adj, h))
                            + (attn_dtype,))
        return fwd_call(self, a_src, a_dst, adj, h, negative_slope,
                        attn_dtype)

    rows = {}
    for name, markers in EXAMPLES_ON_CARD:
        main = runpy.run_path(os.path.join(EXAMPLES_DIR, name + ".py"))[
            "main"]
        buf = io.StringIO()
        for k in counted.values():
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), mock.patch.object(
                fa.FlashForwardKernel, "__call__", recorded):
            out = main(["--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counted.items()}
        text = buf.getvalue()
        with open(os.path.join(ex_dir, name + ".txt"), "w") as f:
            f.write(text)
        bad = [f"marker {m!r} not printed" for m in markers
               if m not in text] + _example_checks(np, name, out)
        if bad:
            raise AssertionError(f"example {name}: {bad}")
        rows[name] = {"seconds": secs, "launches": launches}
        print(f"example {name}: {secs:.3f} s, launches {launches}  "
              f"[{card}]", flush=True)
    ex13 = rows["13_flash_attention_gat"]["launches"]
    if not (ex13["flash_fwd"] > 0 and ex13["flash_bwd"] > 0):
        raise AssertionError(f"example 13 launched no flash kernel: {ex13}")
    if not seen:
        raise AssertionError("no flash launch was recorded")
    gen = torch.Generator(device="cuda").manual_seed(21)
    checks = []
    for (adj_shape, h_shape, *_), (a_src, a_dst, adj, h, attn) in \
            seen.items():
        gout = torch.randn((adj_shape[0],) + h_shape[1:], generator=gen,
                           device="cuda", dtype=h.dtype)
        *_, errs, failures = flash_check(torch, fa, a_src, a_dst, adj, h,
                                         gout, attn, f"example 13 {h_shape}")
        if failures:
            raise AssertionError(failures)
        checks.append({"adj": adj_shape, "h": h_shape, "errors": errs})
        print(f"example 13 flash shapes adj {adj_shape} h {h_shape}: "
              f"max abs err {max(errs.values()):.3g}, two calls the same "
              f"bits", flush=True)
    return {"examples": rows, "not_run": EXAMPLES_OFF_CARD,
            "flash_checks": checks}


def build_kernels(cuda_build, out_dir, names=None):
    """Phase 1: build the named sources (default all), one nvcc each, all at
    once; each ptxas report goes to ``build_<source>.log``."""
    t0 = time.perf_counter()
    report = cuda_build.build(names)
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["matmul", "core_spmm", "flash",
                                           "sparse", "parallel", "examples",
                                           "small_eigh", "gat_attention",
                                           "spmm"],
                        help="build and run this kernel's phase alone; "
                             "prints no ok line")
    args = parser.parse_args(argv)
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
    from laplace_gnn_torch.ops import gat_attention as ga
    from laplace_gnn_torch.ops import linalg
    from laplace_gnn_torch.ops import matmul as mm

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
    if args.only == "matmul":
        build_kernels(cuda_build, out_dir, ["matmul"])
        mm_rows, _ = phase_matmul(torch, mm, peaks)
        with open(os.path.join(out_dir, "chip_smoke_matmul.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "peaks": peak_name,
                       "matmul": mm_rows}, f, indent=1)
        print(card, flush=True)
        print(json.dumps({"partial": ["matmul"]}), flush=True)
        return 0
    if args.only == "small_eigh":
        build_kernels(cuda_build, out_dir, ["small_eigh"])
        rows, checks = phase_small_eigh(torch, linalg, peaks)
        with open(os.path.join(out_dir, "chip_smoke_small_eigh.json"),
                  "w") as f:
            json.dump({"card": card, "kind": kind, "peaks": peak_name,
                       "small_eigh": rows, "checks": checks}, f, indent=1)
        print(card, flush=True)
        print(json.dumps({"partial": ["small_eigh"]}), flush=True)
        return 0
    if args.only == "gat_attention":
        build_kernels(cuda_build, out_dir, ["gat_attention"])
        t0 = time.perf_counter()
        gat_att = phase_gat_attention(torch, np, ga, peaks)
        print(f"phase 23 phase_gat_attention: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        with open(os.path.join(out_dir, "chip_smoke_gat_attention.json"),
                  "w") as f:
            json.dump({"card": card, "kind": kind, "peaks": peak_name,
                       "gat_attention": gat_att}, f, indent=1, default=str)
        print(card, flush=True)
        print(json.dumps({"partial": ["gat_attention"]}), flush=True)
        return 0
    if args.only == "spmm":
        build_kernels(cuda_build, out_dir, ["spmm"])
        t0 = time.perf_counter()
        spmm = phase_spmm(torch, np, peaks)
        print(f"phase 24 phase_spmm: {time.perf_counter() - t0:.3f} s",
              flush=True)
        with open(os.path.join(out_dir, "chip_smoke_spmm.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "peaks": peak_name,
                       "spmm": spmm}, f, indent=1, default=str)
        print(card, flush=True)
        print(json.dumps({"partial": ["spmm"]}), flush=True)
        return 0
    if args.only == "core_spmm":
        build_kernels(cuda_build, out_dir, ["core_spmm"])
        rows, _ = phase_kernel(torch, fs, peaks)
        checks = phase_core_checks(torch, fs)
        with open(os.path.join(out_dir, "chip_smoke_core_spmm.json"),
                  "w") as f:
            json.dump({"card": card, "kind": kind, "peaks": peak_name,
                       "core_spmm": rows, "checks": checks}, f, indent=1)
        print(card, flush=True)
        print(json.dumps({"partial": ["core_spmm"]}), flush=True)
        return 0
    if args.only == "flash":
        build_kernels(cuda_build, out_dir, ["flash_attention"])
        rows, _ = phase_flash_kernels(torch, np, fa, peaks[0])
        checks = phase_flash_checks(torch, fa)
        with open(os.path.join(out_dir, "chip_smoke_flash.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "peaks": peak_name,
                       "flash": rows, "checks": checks}, f, indent=1)
        print(card, flush=True)
        print(json.dumps({"partial": ["flash"]}), flush=True)
        return 0
    counted = (fs.core, fa.flash_fwd, fa.flash_bwd, mm.matmul)
    if args.only == "parallel":
        build_kernels(cuda_build, out_dir, ["core_spmm", "flash_attention"])
        t0 = time.perf_counter()
        parallel = phase_parallel(torch, np, fa, fs, mm, card, peaks)
        print(f"phase 19 phase_parallel: {time.perf_counter() - t0:.3f} s",
              flush=True)
        t0 = time.perf_counter()
        memory = phase_memory_dcn(torch, np, card)
        print(f"phase 20 phase_memory_dcn: {time.perf_counter() - t0:.3f} "
              f"s", flush=True)
        with open(os.path.join(out_dir, "chip_smoke_parallel.json"),
                  "w") as f:
            json.dump({"card": card, "kind": kind, "parallel": parallel,
                       "memory_dcn": memory}, f, indent=1, default=str)
        print(card, flush=True)
        print(json.dumps({"partial": ["parallel"]}), flush=True)
        return 0
    if args.only == "examples":
        build_kernels(cuda_build, out_dir, ["flash_attention"])
        t0 = time.perf_counter()
        examples = phase_examples(torch, np, fa, fs, mm, card, out_dir)
        print(f"phase 21 phase_examples: {time.perf_counter() - t0:.3f} s",
              flush=True)
        with open(os.path.join(out_dir, "chip_smoke_examples.json"),
                  "w") as f:
            json.dump({"card": card, "kind": kind, "examples": examples},
                      f, indent=1, default=str)
        print(card, flush=True)
        print(json.dumps({"partial": ["examples"]}), flush=True)
        return 0
    if args.only == "sparse":
        sparse_small = phase_sparse_small(torch, np)
        sparse = phase_sparse(torch, np, counted, card)
        with open(os.path.join(out_dir, "chip_smoke_sparse.json"), "w") as f:
            json.dump({"card": card, "kind": kind, "sparse": sparse,
                       "sparse_small": sparse_small}, f, indent=1,
                      default=str)
        print(card, flush=True)
        print(json.dumps({"partial": ["sparse"]}), flush=True)
        return 0
    seconds = {}

    def phase(number, fn, *args):
        """Run one part of a phase and print its seconds (host clock)."""
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        key = f"{number} {fn.__name__}"
        seconds[key] = time.perf_counter() - t0
        print(f"phase {key}: {seconds[key]:.3f} s", flush=True)
        return out

    phase("1", build_kernels, cuda_build, out_dir)
    record_launches(fs)

    rows, max_err = phase("2", phase_kernel, torch, fs, peaks)
    core_checks = phase("2", phase_core_checks, torch, fs)
    eig_rows, eig_checks = phase("22", phase_small_eigh, torch, linalg,
                                 peaks)
    gat_att = phase("23", phase_gat_attention, torch, np, ga, peaks)
    torch.cuda.empty_cache()
    spmm = phase("24", phase_spmm, torch, np, peaks)
    torch.cuda.empty_cache()
    small = phase("3", phase_small_reference, torch, np)
    run, stegcn_state = phase("3", phase_trainer, torch, np, card)

    flash_rows, flash_err = phase("4", phase_flash_kernels, torch, np, fa,
                                  peaks[0])
    flash_checks = phase("4", phase_flash_checks, torch, fa)
    gat_step = phase("5", phase_gat_step, torch, card)
    gat_run, gat_state = phase("6", phase_gat_trainer, torch, np, fa, card)
    gat_small = phase("6", phase_gat_small_reference, torch, np)

    mm_rows, mm_checks = phase("7", phase_matmul, torch, mm, peaks)
    laplace = phase("8", phase_laplace_stegcn, torch, np, stegcn_state,
                    counted, card)
    laplace_small = phase("8", phase_laplace_small_reference, torch, np)
    gat_laplace = phase("9", phase_laplace_gat, torch, np, gat_state,
                        counted, card)
    torch.cuda.empty_cache()
    experiment = phase("10", phase_experiment, torch, np, counted, card)

    curvature = phase("11", phase_curvature, torch, np, stegcn_state, card)
    curvature_small = phase("11", phase_curvature_small, torch, np)
    gat_probes = phase("11", phase_gat_probes, torch, gat_run, gat_state,
                       counted, card)
    del gat_state
    torch.cuda.empty_cache()

    dense = phase("12", phase_dense_models, torch, np, card)
    dense_small = phase("12", phase_dense_small, torch, np)
    flavors = phase("13", phase_laplace_flavors, torch, np, stegcn_state,
                    counted, card)
    flavors_small = phase("13", phase_laplace_flavors_small, torch, np)
    library = phase("14", phase_library, torch, np, stegcn_state, counted,
                    card)
    library_small = phase("14", phase_library_small, torch, np)
    engine = phase("15", phase_curvature_engine, torch, np, stegcn_state,
                   counted, card)
    engine_small = phase("15", phase_curvature_engine_small, torch, np)
    del stegcn_state
    torch.cuda.empty_cache()
    whole = phase("16", phase_whole_run, torch, np, card)
    whole_small = phase("16", phase_whole_run_small, torch, np)
    torch.cuda.empty_cache()
    launched = phase("17", phase_core_launched, torch, fs)
    torch.cuda.empty_cache()
    sparse_small = phase("18", phase_sparse_small, torch, np)
    sparse = phase("18", phase_sparse, torch, np, counted, card)
    torch.cuda.empty_cache()
    parallel = phase("19", phase_parallel, torch, np, fa, fs, mm, card,
                     peaks)
    torch.cuda.empty_cache()
    memory = phase("20", phase_memory_dcn, torch, np, card)
    torch.cuda.empty_cache()
    examples = phase("21", phase_examples, torch, np, fa, fs, mm, card,
                     out_dir)

    main_row = rows[0]                  # d = 64, forward: the widest call
    kernels = [{
        "name": fs.core.name, "route": "cuda", "source": fs.core.source,
        "replaces": "laplace_gnn_tpu/ops/pallas_spmm.py:43",
        "redesigned": "PR 6",
        "launches": run["run_launches"], "max_abs_err": max_err,
        "whole_run": whole["fused=True"]["core_spmm"],
        "sharded_launches": parallel["launches"]["core_spmm"],
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
            "replaces": replaces, "redesigned": "PR 7",
            "launches": gat_run["run_launches"][kern.name],
            "sharded_launches": parallel["launches"][kern.name],
            "example_launches": examples["examples"][
                "13_flash_attention_gat"]["launches"][kern.name],
            "ms_r4096": parallel["gat_p4"]["timing"][kern.name]["ms"],
            "max_abs_err": flash_err[kern.name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    # the product matmul.py exists for, at Cora's size: (2708, 2708) @
    # (2708, 64) in f32
    r = mm_rows[0]
    kernels.append({
        "name": mm.matmul.name, "route": "cuda", "source": mm.matmul.source,
        "replaces": "laplace_gnn_tpu/ops/pallas_matmul.py:21",
        "launches": mm_checks,
        "sharded_launches": parallel["launches"]["matmul"],
        "note": "on no path of the package, as in JAX (0 launches in "
                "phases 8-10); launches are phase 7's checking calls",
        "redesigned": "PR 5",
        "max_abs_err": max(x["max_abs_err"] for x in mm_rows
                           if x["dtype"] == "float32"),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the small eigensolver replaces no Pallas kernel (XLA's eigvalsh in
    # laplace_gnn_tpu/ops/linalg.py); its row is the (2, 64, 64) call
    r = eig_rows[0]
    kernels.append({
        "name": linalg.eigvalsh_kernel.name, "route": "cuda",
        "source": linalg.eigvalsh_kernel.source,
        "replaces": "none: XLA's eigvalsh (laplace_gnn_tpu/ops/linalg.py)",
        "launches": whole["fused=True"]["small_eigh"],
        "launches_composed": whole["fused=False"]["small_eigh"],
        "max_rel_err": max(x["max_rel_err"] for x in eig_rows + eig_checks),
        "ms": r["ms"], "ms_7": eig_rows[1]["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": r["library_ms"]})
    # the sparse GAT attention replaces no Pallas kernel (the JAX package's
    # ELL attention is plain XLA); its row is the hidden layer's shape
    r = gat_att["rows"][0]
    kernels.append({
        "name": "gat_fwd + gat_bwd", "route": "cuda",
        "source": ga.gat_fwd.source,
        "replaces": "none: the JAX package's ELL GAT attention is plain XLA",
        "launches": gat_att["train_step"]["route"],
        "max_rel_err": max(max(c["gaps"].values()) for c in
                           gat_att["small"] + [x["check"] for x in
                                               gat_att["rows"]]),
        "ms": r["fwd_ms"] + r["bwd_ms"], "fwd_ms": r["fwd_ms"],
        "bwd_ms": r["bwd_ms"],
        "plain_ms": r["plain_fwd_ms"] + r["plain_bwd_ms"],
        "bound_ms": r["bound_fwd_ms"] + r["bound_bwd_ms"],
        "bound_by": r["bound_by"], "library_ms": None})
    # the sparse SpMM replaces no Pallas kernel (the JAX package's sparse
    # aggregation is plain XLA); its row is the cell's hidden width
    r = spmm["rows"][0]
    kernels.append({
        "name": "spmm", "route": "cuda", "source": "laplace_gnn_torch/csrc/"
        "spmm.cu",
        "replaces": "none: the JAX package's sparse aggregation is plain "
                    "XLA",
        "launches": {"train_step": spmm["train_step"]["route"],
                     "fit": spmm["fit"]["route"]},
        "max_rel_err": max(x["gap"] for x in spmm["small"] + spmm["rows"]),
        "ms": r["ms"], "kernel_ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kind": kind, "peaks": peak_name,
                   "small_eigh": eig_rows, "small_eigh_checks": eig_checks,
                   "gat_attention": gat_att, "spmm": spmm,
                   "core_spmm": rows, "core_spmm_checks": core_checks,
                   "trainer": run, "small": small,
                   "flash": flash_rows, "flash_checks": flash_checks,
                   "gat_step": gat_step,
                   "gat_trainer": gat_run, "gat_small": gat_small,
                   "matmul": mm_rows, "laplace_stegcn": laplace,
                   "laplace_small": laplace_small,
                   "laplace_gat": gat_laplace, "experiment": experiment,
                   "curvature": curvature,
                   "curvature_small": curvature_small,
                   "gat_probes": gat_probes,
                   "dense_models": dense, "dense_small": dense_small,
                   "laplace_flavors": flavors,
                   "laplace_flavors_small": flavors_small,
                   "library": library, "library_small": library_small,
                   "curvature_engine": engine,
                   "curvature_engine_small": engine_small,
                   "whole_run": whole, "whole_run_small": whole_small,
                   "core_spmm_launched": launched,
                   "sparse": sparse, "sparse_small": sparse_small,
                   "parallel": parallel, "memory_dcn": memory,
                   "examples": examples, "phase_seconds": seconds,
                   "kernels": kernels}, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
