#!/usr/bin/env python3
"""Design probes of the sparse SpMM CUDA kernel (``csrc/spmm.cu``) on one
GPU, at the ``sparsegcn-arxiv`` cell's graph (ogbn-arxiv-shaped, 'sym'
weights, bf16 operands).

    python3 scripts/probe_spmm.py [variant ...]   # from the repo root

Each variant is a text-edited copy of ``laplace_gnn_torch/csrc/spmm.cu``
built into ``chiprun_out/probe/`` (the edited copy removed after the
build) and timed cold (``chip_smoke.cold_ms``: L2 evicted, CUDA events, GC
off) at d = 256 and 40 beside the kernel as it is, its output held to the
kernel's. Variants (default: all):

  lb_none, lb3  no bound on the registers, or 85 a thread (3 blocks an
               SM), where the kernel takes at most 64 (4 blocks);
  u2, u8       2 / 8 source rows in flight a group, where the kernel
               keeps 4 (the groups of 4 lanes or more);
  cached       the indices, weights and output through the caches as any
               load and store, where the kernel streams them past the L2.

With ``--slabs ROUNDS`` it times instead the kernel as it is at d = 256
in one pass (32 lanes a slab) and in slabs of 128 and 64 columns (16
and 8 lanes), cold and warm (``chip_smoke.warm_ms``), in ROUNDS rounds
whose order turns.

Prints one JSON object a measurement, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from laplace_gnn_torch.ops import cuda_build  # noqa: E402
from laplace_gnn_torch.ops import spmm_kernel as SK  # noqa: E402
from laplace_gnn_torch.training import sparse_experiment as se  # noqa: E402

SRC_PATH = os.path.join(ROOT, "laplace_gnn_torch", "csrc", "spmm.cu")
OUT = os.path.join(ROOT, "chiprun_out", "probe")
BOUNDS = "__launch_bounds__(THREADS, 4)\n    spmm_kernel("
FLIGHT = "constexpr int IN_FLIGHT = (32 / LPE) * 4 <= 32 ? 4 : LPE;"
CACHED = ("#include <type_traits>\n",
          "#include <type_traits>\n#define __ldcs(p) __ldg(p)\n"
          "#define __stcs(p, v) (*(p) = (v))\n")


def _flight(u):
    return (FLIGHT, FLIGHT.replace("* 4 <= 32 ? 4", f"* {u} <= 32 ? {u}"))


VARIANTS = {
    "lb_none": [(BOUNDS, BOUNDS.replace("(THREADS, 4)", "(THREADS)"))],
    "lb3": [(BOUNDS, BOUNDS.replace("(THREADS, 4)", "(THREADS, 3)"))],
    "u2": [_flight(2)],
    "u8": [_flight(8)],
    "cached": [CACHED],
}


def build(names):
    """Each variant's library, built concurrently: {name: path}."""
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC_PATH).read()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"probe {name}: edit target not found: "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"spmm_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"libspmm_{name}.so")
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib, cu)
    libs = {}
    for name, (proc, lib, cu) in procs.items():
        log, _ = proc.communicate()
        os.remove(cu)
        if proc.returncode != 0:
            raise RuntimeError(f"probe {name}: nvcc failed:\n{log}")
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line]
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--slabs", type=int, default=0, metavar="ROUNDS")
    args = parser.parse_args(argv)
    card = cs.card_info()
    print(card, flush=True)
    x_np, _, ei = cs.arxiv_like(np)
    cli = se.argument_parser().parse_args(
        ["--hidden_channels", "256", "--num_layers", "3"])
    g = se.build_graph(cli, types.SimpleNamespace(
        edge_index=ei, num_nodes=cs.ARXIV_N), device="cuda")
    csr = g.csr()
    w = csr.weights[torch.bfloat16]
    if args.slabs:
        return slabs(csr, w, g.n_nodes, args.slabs, card)
    libs = build(args.variants)
    base = SK.spmm_launch
    kernels = {"kernel": base}
    for name, lib in libs.items():
        k = cuda_build.Kernel(f"spmm_{name}", "spmm", "spmm_launch",
                              base.argtypes)
        k.bind(ctypes.CDLL(lib))
        kernels[name] = k
    for d in (256, 40):
        x = torch.randn(g.n_nodes, d, device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(d))
        xo = SK.operand(x, torch.bfloat16)
        lanes = SK.lanes_for(xo.shape[1] // 8)
        want = SK.launch(csr, xo, w, d, lanes)
        # the kernel as it is first and last, the variants between
        for name in list(kernels) + ["kernel"]:
            SK.spmm_launch = kernels[name]
            try:
                gap = cs._rel(SK.launch(csr, xo, w, d, lanes), want)
                ms = cs.cold_ms(torch, lambda: SK.launch(csr, xo, w, d,
                                                         lanes))
            finally:
                SK.spmm_launch = base
            print(json.dumps({"variant": name, "d": d, "lanes": lanes,
                              "ms": ms, "gap": gap, "card": card}),
                  flush=True)
    return 0


def slabs(csr, w, n, rounds, card) -> int:
    """The kernel at d = 256 with 32, 16 and 8 lanes a slab, cold and
    warm, in turns."""
    x = torch.randn(n, 256, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(256))
    xo = SK.operand(x, torch.bfloat16)
    order = [32, 16, 8]
    for r in range(rounds):
        for lanes in order[r % 3:] + order[:r % 3]:
            def run():
                return SK.launch(csr, xo, w, 256, lanes)
            print(json.dumps({"round": r, "lanes": lanes,
                              "cold_ms": cs.cold_ms(torch, run),
                              "warm_ms": cs.warm_ms(torch, run),
                              "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
