#!/usr/bin/env python3
"""Design probes of the ``core_spmm`` CUDA kernel on one GPU.

    python3 scripts/probe_core_spmm.py [probe ...]   # from the repo root

Each probe times the kernel cold (``chip_smoke.cold_ms``: L2 evicted, CUDA
events, GC off) against a variant that differs in one design decision.
Variants that need other code are built from a text-edited copy of
``laplace_gnn_torch/csrc/core_spmm.cu`` (f32 and int8 A, f32 t instances
only) into ``chiprun_out/probe/``; the edited copy is removed after the
build. Probes (default: all):

  splits     the split of j forced to 1, 2, 4, 6, 8 (N = 2708, d = 64);
  blocks     two skinny blocks an SM (3 stages, int8 K step 64: the
             kernel) against one (4 stages, int8 K step 128), each with the
             split filling its wave;
  reduce     the split's sum in one thread-block cluster (the kernel)
             against an f32 workspace summed in order by a second kernel;
  wide_tile  the wide calls on the 128 x 256 tile (the kernel) and on
             128 x 128;
  wide_bytes the wide tile with int8 A and with bf16 t (fewer bytes);
  ablation   the wide tile with its loads, its conversions or its MMAs
             taken out (timing only; the results are wrong).

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
from laplace_gnn_torch.ops import fused_spmm as fs  # noqa: E402

SRC_PATH = os.path.join(ROOT, "laplace_gnn_torch", "csrc", "core_spmm.cu")
OUT = os.path.join(ROOT, "chiprun_out", "probe")
N = 2708
# only the f32- and int8-A instances with an f32 t: a quarter of the build
F32_T_ONLY = [("by_trans<float, __nv_bfloat16>", "by_trans<float, float>"),
              ("by_trans<int8_t, __nv_bfloat16>", "by_trans<int8_t, float>")]


def build_variant(name, edits):
    """core_spmm.cu with ``edits`` (old, new) applied, built; its kernel
    wrapper (a CoreKernel bound to the variant's entry point)."""
    src = open(SRC_PATH).read()
    for old, new in edits + F32_T_ONLY:
        if old not in src:
            raise RuntimeError(f"probe {name}: edit target not found: {old}")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(os.path.dirname(SRC_PATH), f"probe_{name}.cu")
    lib = os.path.join(OUT, f"lib_{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    try:
        r = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                            "-o", lib, cu], capture_output=True, text=True)
    finally:
        os.remove(cu)
    if r.returncode:
        raise RuntimeError(f"probe {name}: nvcc failed\n{r.stderr[-3000:]}")
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             r.stdout + r.stderr))
    print(json.dumps({"built": name, "spill_bytes": spills}), flush=True)
    k = fs.CoreKernel()
    k.bind(ctypes.CDLL(lib))
    return k, ctypes.CDLL(lib)


def forced_plan(split=None, bk_int8=None, bn=None, blocks=None):
    """fs.plan with the split, the int8 skinny K step, the wide column tile
    or the blocks an SM of the split's wave replaced."""
    real = fs.plan

    def plan(n, d, a_dtype, t_dtype, a_ptr, t_ptr, sms):
        p = real(n, d, a_dtype, t_dtype, a_ptr, t_ptr, sms)
        tile_bn = bn if bn is not None and p.tile[1] in fs.WIDE_BN else p.tile[1]
        bk = p.tile[2]
        if bk_int8 is not None and a_dtype == torch.int8 \
                and tile_bn in fs.SKINNY_BN:
            bk = bk_int8
        k_steps = -(-n // bk)
        tiles = -(-n // fs.BM) * -(-d // tile_bn)
        wave = (blocks or fs.BLOCKS_PER_SM[tile_bn]) * sms
        s = split or max(1, min(fs.MAX_SPLIT, wave // tiles,
                                k_steps // fs.MIN_STEPS_PER_SPLIT))
        kps = -(-k_steps // s) * bk
        return p._replace(tile=(fs.BM, tile_bn, bk), split=-(-n // kps),
                          k_per_split=kps)
    return plan


def timed(kern, a, t, binarize, transpose, reps=20):
    return cs.cold_ms(torch, lambda: kern(a, t, 0.5, binarize, transpose),
                      reps)


def operands(n, kind, d):
    a, _ = cs.core_adjacency(torch, n, kind, seed=1)
    t = torch.randn(n, d, device="cuda")
    if kind == "int8":
        t = torch.round(t * 8) / 8
    return a, t


def with_plan(plan, fn):
    real = fs.plan
    fs.plan = plan
    try:
        return fn()
    finally:
        fs.plan = real


def probe_splits():
    a, t = operands(N, "f32_bin", 64)
    for s in (1, 2, 4, 6, 8):
        for tr in (False, True):
            ms = with_plan(forced_plan(split=s),
                           lambda: timed(fs.core, a, t, True, tr))
            print(json.dumps({"probe": "splits", "d": 64, "transpose": tr,
                              "split": s, "ms": ms}), flush=True)


def probe_blocks():
    one, _ = build_variant("one_block", [
        ("static constexpr int STAGES = C::WIDE ? 4 : 3;",
         "static constexpr int STAGES = !C::WIDE && AES == 1 ? 3 : 4;"),
        ("BK = C::WIDE ? 16 : (AES == 4 ? 32 : 64);",
         "BK = C::WIDE ? 16 : (AES == 4 ? 32 : 128);"),
        ("MIN_BLOCKS = BN == 256 ? 1 : 2;",
         "MIN_BLOCKS = WIDE && BN == 128 ? 2 : 1;")])
    for n, kind, d in ((N, "f32_bin", 64), (N, "f32_bin", 7), (N, "int8", 64),
                       (16384, "int8", 64)):
        a, t = operands(n, kind, d)
        for tr in (False, True) if n == N else (False,):
            row = {"probe": "blocks", "n": n, "adj": kind, "d": d,
                   "transpose": tr}
            for name, kern, plan in (
                    ("two_blocks", fs.core, fs.plan),
                    ("one_block", one, forced_plan(bk_int8=128, blocks=1))):
                row[name] = with_plan(plan, lambda: timed(
                    kern, a, t, kind == "f32_bin", tr))
            print(json.dumps(row), flush=True)
        del a, t


def probe_reduce():
    src = open(SRC_PATH).read()
    begin = src.index("  // split-K: the partial tile in this block's")
    tail = "  cluster.sync();                        // the partials stay until read\n}"
    end = src.index(tail) + len(tail)
    epilogue = src[begin:end]
    ws_epilogue = """  // split-K (workspace): the partial tile to g_ws[part]
  float* part_ws = g_ws + static_cast<long long>(part) * n * d;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long i = i0 + im + mi * 16 + g + 8 * h;
      if (i >= n) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + cn + ni * 8 + 2 * tq + e;
          if (c < d) part_ws[i * d + c] = acc[mi][ni][2 * h + e];
        }
    }
}

template <typename TT>
__global__ void ws_reduce(TT* __restrict__ out, long long mn, int S) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x; i < mn; i += stride) {
    float s = g_ws[i];
    for (int z = 1; z < S; ++z) s += g_ws[z * mn + i];
    store(out + i, s);
  }
}"""
    launch_end = """  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}"""
    ws_launch_end = """  if (e != cudaSuccess) return e;
  if (a.split > 1) {
    const long long mn = static_cast<long long>(a.n) * a.d;
    const long long blocks = (mn + 255) / 256;
    ws_reduce<TT><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                    256, 0, a.stream>>>(static_cast<TT*>(a.out), mn,
                                        a.split);
  }
  return cudaGetLastError();
}"""
    ws_kern, lib = build_variant("workspace", [
        (epilogue, ws_epilogue),
        ("// ---- the kernel ----",
         "__device__ float* g_ws;\n\n// ---- the kernel ----"),
        ("  cfg.numAttrs = a.split > 1 ? 1 : 0;", "  cfg.numAttrs = 0;"),
        (launch_end, ws_launch_end),
        ('extern "C" {', 'extern "C" {\n\nint probe_set_ws(void* p) {\n'
         '  return (int)cudaMemcpyToSymbol(g_ws, &p, sizeof(p));\n}\n')])
    ws = torch.empty(fs.MAX_SPLIT * N * 256, device="cuda")
    lib.probe_set_ws.argtypes = [ctypes.c_void_p]
    if lib.probe_set_ws(ws.data_ptr()) != 0:
        raise RuntimeError("probe reduce: workspace not set")
    for kind, d, tr in (("f32_bin", 64, False), ("f32_bin", 64, True),
                        ("f32_bin", 7, False), ("f32_bin", 7, True),
                        ("int8", 64, False), ("f32_bin", 65, False),
                        ("f32_bin", 200, True)):
        a, t = operands(N, kind, d)
        binz = kind == "f32_bin"
        p = fs.plan(N, d, a.dtype, t.dtype, a.data_ptr(), t.data_ptr(),
                    torch.cuda.get_device_properties(0).multi_processor_count)
        row = {"probe": "reduce", "adj": kind, "d": d, "transpose": tr,
               "split": p.split, "same_bits": bool(torch.equal(
                   fs.core(a, t, 0.5, binz, tr), ws_kern(a, t, 0.5, binz, tr)))}
        # cluster, workspace, workspace, cluster
        for order in ((("cluster", fs.core), ("workspace", ws_kern)),
                      (("workspace", ws_kern), ("cluster", fs.core))):
            for name, kern in order:
                row.setdefault(name, []).append(timed(kern, a, t, binz, tr))
        print(json.dumps(row), flush=True)


def probe_wide_tile():
    for d in (12250, 112000):
        a, t = operands(N, "f32_bin", d)
        for bn in (256, 128):
            ms = with_plan(forced_plan(bn=bn),
                           lambda: timed(fs.core, a, t, True, True, 5))
            print(json.dumps({"probe": "wide_tile", "d": d, "bn": bn,
                              "ms": ms}), flush=True)
        del a, t


def probe_wide_bytes():
    for d in (12250, 112000):
        a, t = operands(N, "f32_bin", d)
        a8, t16 = (a > 0.5).to(torch.int8), t.to(torch.bfloat16)
        b16 = fs.core_reference(a, torch.eye(N, device="cuda"), 0.5, True,
                                False).T.contiguous().to(torch.bfloat16)
        for name, fn in (
                ("f32_a_f32_t", lambda: fs.core(a, t, 0.5, True, True)),
                ("int8_a_f32_t", lambda: fs.core(a8, t, 0.5, False, True)),
                ("f32_a_bf16_t", lambda: fs.core(a, t16, 0.5, True, True)),
                ("cublas_bf16", lambda: torch.matmul(b16, t16))):
            ms = cs.cold_ms(torch, fn, 5)
            print(json.dumps({"probe": "wide_bytes", "d": d, "case": name,
                              "ms": ms, "tflops": 2 * N * N * d / ms / 1e9}),
                  flush=True)
        del a, t, a8, t16, b16


def probe_ablation():
    loop = "if (nk < k_tiles) load_stage(nk % STAGES, j_begin + nk * BK);"
    fast = ("        mma_step(kt % STAGES, kt & 1, jb, Fast{});\n"
            "        convert(st, buf, jb + BK, Fast{});")
    slow = ("        mma_step(kt % STAGES, kt & 1, jb, Fast{});\n"
            "        convert(st, buf, jb + BK, Slow{});")
    variants = {
        "no_loads": [(loop, "")],
        "no_conversion": [(fast, "        mma_step(kt % STAGES, kt & 1, jb, "
                           "Fast{});"),
                          (slow, "        mma_step(kt % STAGES, kt & 1, jb, "
                           "Fast{});")],
        "no_mma": [(fast, "        convert(st, buf, jb + BK, Fast{});"),
                   (slow, "        convert(st, buf, jb + BK, Slow{});")],
        "loads_only": [(fast, ""), (slow, "")],
    }
    kerns = {name: build_variant(name, edits)[0]
             for name, edits in variants.items()}
    a, t = operands(N, "f32_bin", 112000)
    print(json.dumps({"probe": "ablation", "variant": "kernel",
                      "ms": timed(fs.core, a, t, True, True, 5)}), flush=True)
    for name, kern in kerns.items():
        print(json.dumps({"probe": "ablation", "variant": name,
                          "ms": timed(kern, a, t, True, True, 5)}),
              flush=True)


PROBES = {"splits": probe_splits, "blocks": probe_blocks,
          "reduce": probe_reduce, "wide_tile": probe_wide_tile,
          "wide_bytes": probe_wide_bytes, "ablation": probe_ablation}


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(PROBES)
    if not torch.cuda.is_available():
        print("probe_core_spmm: no CUDA device", file=sys.stderr)
        return 1
    cuda_build.build(["core_spmm"])
    print(cs.card_info(), flush=True)
    for name in names:
        PROBES[name]()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
