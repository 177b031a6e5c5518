#!/usr/bin/env python3
"""Design probes of the flash-attention kernels on one GPU.

    python3 scripts/probe_flash.py [probe ...]   # from the repo root

Each probe times the kernels cold (``chip_smoke.cold_ms``: L2 evicted,
CUDA events, GC off) at the GAT path's shapes (H = 8, f32 mask unless
named). Variants that need other code are built from a text-edited copy of
``laplace_gnn_torch/csrc/flash_attention.cu`` into ``chiprun_out/probe/``
(all at once, one nvcc each); the edited copies are removed after the
build. Probes (default: all):

  rows      the forward on blocks of 8 rows and of 4, in the order 8, 4,
            4, 8 (the plan takes 4 where such blocks fill a wave);
  ablation  the kernels with their gathered arrays marked evict-last in
            L2 (a prefetch at block start), the forward batching 8 edges
            (not 4), then with parts taken out
            (timing only; the results are wrong): the forward with its bits
            but no edge work, and its adjacency stream alone; the backward
            without its row fold, without its column fold, with its bits but
            no edge work, and its stream alone; then the kernels
            themselves.

Prints one JSON object a measurement, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from laplace_gnn_torch.ops import cuda_build  # noqa: E402
from laplace_gnn_torch.ops import flash_attention as fa  # noqa: E402

SRC_PATH = os.path.join(ROOT, "laplace_gnn_torch", "csrc",
                        "flash_attention.cu")
OUT = os.path.join(ROOT, "chiprun_out", "probe")

FWD_EDGES = ("    if (!active) continue;\n    const int cb = c_begin + t * TN;",
             "    continue;\n    const int cb = c_begin + t * TN;")
FWD_BITS = ("    const bool any =\n        row_bits<T>(st, FWD_ROW_BYTES, rows, "
            "TN, WORDS, bits, nt);", "    const bool any = false;")
BWD_ROW_FOLD = ("        ws_d[(size_t)row0 * heads + p] = sum;", "")
BWD_COL_FOLD = ("      for (int k = 0; k < PAIRS; ++k) {\n"
                "        const int q = k * THREADS + tid;",
                "      for (int k = 0; k < 0; ++k) {\n"
                "        const int q = k * THREADS + tid;")
BWD_EDGES = ("    index_rows(rowb, TR, wpr, start);\n    __syncthreads();",
             "    continue;")
BWD_BITS = ("    const bool any = row_bits<T>(st, ld, TR, cols, wpr, rowb, "
            "THREADS);\n"
            "    col_bits<T>(st, ld, GROUPS, cols, colb);",
            "    const bool any = false;")

# the gathered arrays marked evict-last in L2 at block start, each block
# prefetching its share of their 128-byte lines
PREFETCH = r"""
__device__ __forceinline__ void keep_in_l2(const void* p, size_t bytes) {
  const size_t per = (bytes + gridDim.x - 1) / gridDim.x;
  const size_t end = min(bytes, (blockIdx.x + 1) * per);
  for (size_t off = blockIdx.x * per + threadIdx.x * 128; off < end;
       off += (size_t)blockDim.x * 128)
    asm volatile("prefetch.global.L2::evict_last [%0];" ::
                 "l"(static_cast<const char*>(p) + off));
}
"""
FWD_KEEP = ("  const float adst = active ? a_dst[(size_t)i * heads + hd] : 0.f;",
            "  const float adst = active ? a_dst[(size_t)i * heads + hd] : 0.f;\n"
            "  keep_in_l2(x, (size_t)n * heads * f * 4);\n"
            "  keep_in_l2(a_src, (size_t)n * heads * 4);")
BWD_KEEP = ("  float* ws_d = ws_adst + (size_t)cblk * r * heads;",
            "  float* ws_d = ws_adst + (size_t)cblk * r * heads;\n"
            "  keep_in_l2(x, (size_t)n * heads * f * 4);\n"
            "  keep_in_l2(g, (size_t)r * heads * f * 4);\n"
            "  keep_in_l2(a_src, (size_t)n * heads * 4);\n"
            "  keep_in_l2(a_dst, (size_t)r * heads * 4);\n"
            "  keep_in_l2(m, (size_t)r * heads * 4);\n"
            "  keep_in_l2(linv, (size_t)r * heads * 4);\n"
            "  keep_in_l2(dvec, (size_t)r * heads * 4);")
KEEP_FN = ("// ---- the adjacency stream ----",
           PREFETCH + "\n// ---- the adjacency stream ----")

FWD_BATCH8 = ("  static constexpr int BATCH = FB <= 8 ? 4 : (FB <= 16 ? 2 : 1);",
              "  static constexpr int BATCH = FB <= 8 ? 8 : (FB <= 16 ? 4 : 2);")

VARIANTS = {
    "keep_in_l2": [KEEP_FN, FWD_KEEP, BWD_KEEP],
    "fwd_batch8": [FWD_BATCH8],
    "fwd_bits_only": [FWD_EDGES],
    "fwd_stream_only": [FWD_EDGES, FWD_BITS],
    "bwd_no_row_fold": [BWD_ROW_FOLD],
    "bwd_no_col_fold": [BWD_COL_FOLD],
    "bwd_bits_only": [BWD_EDGES],
    "bwd_stream_only": [BWD_BITS],
}


def build_variants(names):
    """{name: (forward wrapper, backward wrapper)} for the VARIANTS named,
    built concurrently from edited copies of the source."""
    src = open(SRC_PATH).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"probe {name}: edit target not found: "
                                   f"{old!r}")
            text = text.replace(old, new)
        cu = os.path.join(os.path.dirname(SRC_PATH), f"probe_{name}.cu")
        lib = os.path.join(OUT, f"lib_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            cu, lib)
    kernels = {}
    for name, (proc, cu, lib) in procs.items():
        log, _ = proc.communicate()
        os.remove(cu)
        if proc.returncode:
            raise RuntimeError(f"probe {name}: nvcc failed\n{log[-3000:]}")
        spills = sum(int(x) for x in
                     re.findall(r"(\d+) bytes spill stores", log))
        print(json.dumps({"built": name, "spill_bytes": spills}), flush=True)
        pair = (fa.FlashForwardKernel(), fa.FlashBackwardKernel())
        for k in pair:
            k.bind(ctypes.CDLL(lib))
        kernels[name] = pair
    return kernels


def operands(n, f, dtype=torch.float32):
    """(a_src, a_dst, mask, h, gout) of the timed flash cases."""
    H = cs.GAT_HEADS
    _, adj, _ = cs.gat_graph(torch, n, seed=3)
    adj.fill_diagonal_(1.0)
    mask = (adj > 0).to(dtype).contiguous()
    del adj
    g = torch.Generator(device="cuda").manual_seed(n + f)
    a_src = torch.randn(n, H, generator=g, device="cuda")
    a_dst = torch.randn(n, H, generator=g, device="cuda")
    h = torch.randn(n, H, f, generator=g, device="cuda")
    gout = torch.randn(n, H, f, generator=g, device="cuda")
    return a_src, a_dst, mask, h, gout


def probe_ablation():
    """Each variant, then the kernel itself, at N = 16384 and 2708 (F = 8);
    one line a (variant, shape), printed as it is measured."""
    kernels = build_variants(list(VARIANTS))
    kernels["kernel"] = (fa.flash_fwd, fa.flash_bwd)
    for n, f in ((16384, 8), (2708, 8)):
        a_src, a_dst, mask, h, gout = operands(n, f)
        saved = fa.flash_fwd_reference(a_src, a_dst, mask, h)
        for name in list(VARIANTS) + ["kernel"]:
            fwd, bwd = kernels[name]
            for d in ("fwd", "bwd"):
                if name.startswith("fwd" if d == "bwd" else "bwd"):
                    continue
                run = (lambda: bwd(a_src, a_dst, mask, h, gout, *saved)) \
                    if d == "bwd" else (lambda: fwd(a_src, a_dst, mask, h))
                print(json.dumps({"probe": "ablation", "variant": name,
                                  "kernel": d, "n": n, "f": f,
                                  "ms": cs.cold_ms(torch, run)}), flush=True)
        del a_src, a_dst, mask, h, gout, saved
        torch.cuda.empty_cache()


def probe_rows():
    """The forward with blocks of 8 and of 4 rows (the plan halves the
    rows when the smaller blocks still fill a wave) at the main shapes."""
    real = fa.plan
    for n, f in ((16384, 8), (16384, 1), (2708, 8), (2708, 1)):
        a_src, a_dst, mask, h, _ = operands(n, f)
        row = {"probe": "rows", "n": n, "f": f,
               "plan_rows": real(n, n, cs.GAT_HEADS, f, mask.dtype,
                                 mask.data_ptr(), 132, False).block}
        for rows in (8, 4, 4, 8):
            fa.plan = lambda *a, rows=rows: real(*a)._replace(
                block=rows, tile=(rows, real(*a).tile[1]))
            row.setdefault(f"rows{rows}", []).append(cs.cold_ms(
                torch, lambda: fa.flash_fwd(a_src, a_dst, mask, h)))
        fa.plan = real
        print(json.dumps(row), flush=True)
        del a_src, a_dst, mask, h
        torch.cuda.empty_cache()


PROBES = {"ablation": probe_ablation, "rows": probe_rows}


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(PROBES)
    if not torch.cuda.is_available():
        print("probe_flash: no CUDA device", file=sys.stderr)
        return 1
    cuda_build.build(["flash_attention"])
    for name in names:
        PROBES[name]()
    print(cs.card_info(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
