// Fused binarize + forced self-loop + transposed aggregation for Hopper.
//
// Replaces the Pallas TPU kernel laplace_gnn_tpu/ops/pallas_spmm.py::_core_kernel
// (launched by _core). It computes
//
//     out[i, c] = sum_j B[j, i] * t[j, c]
//
// where, with binarize != 0, B = bin_diag(M): (M[j, i] > threshold) evaluated
// on the f32 value of M (strict '>', before any cast), the true diagonal
// forced to 1, and everything outside the N x N matrix zero. With
// binarize == 0, B = M, upcast from f32 or int8 in registers. M is A itself,
// or A^T when transpose != 0: the backward call core(A^T, g) reads A in
// place and no transposed copy of A is made. Operands enter the tensor
// cores as bf16 (exact for a 0/1 B) and products accumulate in f32, as in
// the TPU kernel.
//
// Bound: at the shapes of the STE-GCN trainer (N = 2708, d = 64 or 7) the
// call is bound by reading A once: 29 MB of f32 (7.3 MB of int8) against
// 2 N^2 d = 0.94 GFLOP of bf16 tensor-core work, i.e. ~9 us of HBM time at
// 3.35 TB/s and ~1 us of math at 989 TFLOP/s. So the design is about
// keeping enough bytes of A in flight, not about the MMA.
//
// Design (wgmma/TMA come later):
//  - a block of 128 threads (4 warps) owns a 64-row slice of i and a column
//    tile of BN <= 64 of t (BN in {8, 16, 32, 64}, the smallest that covers
//    d, so the 7-wide pullbacks do not pay for 64 columns);
//  - the j (reduction) axis is split over gridDim.z so that every SM gets
//    blocks although N / 64 = 43; partial sums go to the f32 output with
//    atomicAdd (the wrapper zero-fills it), so f32 summation order varies
//    from run to run;
//  - per 64-wide j step each thread loads eight 4-element groups of A
//    along A's contiguous axis (16-byte float4 / 4-byte char4 loads when
//    N % 4 == 0 and A is 16-byte aligned, else element by element), and
//    the next step's loads are issued before this step's MMAs, so global
//    latency overlaps the tensor-core work;
//  - the groups are binarized, diagonal-forced and masked in f32 registers
//    and stored as bf16 into shared memory in A's own orientation (the
//    MMA fragment loads do the transpose); t is staged the same way;
//  - each warp runs mma.sync m16n8k16 (bf16 in, f32 accumulate) over its
//    16 rows and the BN/8 column tiles.
//
// The C entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so the wrapper can raise on a failed
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of i per block
constexpr int BK = 64;        // reduction (j) step
constexpr int THREADS = 128;  // 4 warps, 16 rows each
constexpr int LDS = 64 + 8;   // shared row stride (bf16) of the A tile
constexpr int A_GROUPS = BM * BK / 4 / THREADS;   // 8 groups of 4 per thread

template <typename TA> struct V4;
template <> struct V4<float> { using T = float4; };
template <> struct V4<int8_t> { using T = char4; };

template <typename V>
__device__ __forceinline__ float comp(const V& v, int e) {
  return e == 0 ? static_cast<float>(v.x) : e == 1 ? static_cast<float>(v.y)
       : e == 2 ? static_cast<float>(v.z) : static_cast<float>(v.w);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// Group r of this thread: (row, first contiguous index) inside the tile.
__device__ __forceinline__ void group_pos(int tid, int r, int& row, int& col) {
  const int g = tid + r * THREADS;
  row = g / (BK / 4);
  col = (g % (BK / 4)) * 4;
}

template <int BN, bool TRANS, typename TA, typename TT>
__global__ void __launch_bounds__(THREADS)
core_kernel(const TA* __restrict__ A, const TT* __restrict__ t,
            float* __restrict__ out, int n, int d, int k_per_split,
            float threshold, int binarize, int vec_a, int vec_t) {
  using VA = typename V4<TA>::T;
  // A tile in A's own orientation: TRANS -> [i][j], else [j][i]
  __shared__ __align__(16) __nv_bfloat16 sA[64][LDS];
  __shared__ __align__(16) __nv_bfloat16 sT[BK][BN + 8];   // [j][c]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma group id
  const int tq = lane & 3;   // mma thread in group
  const int i0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * BN;
  const int j_begin = blockIdx.z * k_per_split;
  const int j_end = min(n, j_begin + k_per_split);

  constexpr int T_PER_THREAD = BK * BN / THREADS;   // t elements per thread
  VA ra[A_GROUPS];
  float rt[T_PER_THREAD];

  // ---- global -> registers for the j step starting at jb ----
  auto load = [&](int jb) {
#pragma unroll
    for (int r = 0; r < A_GROUPS; ++r) {
      int row, col;
      group_pos(tid, r, row, col);
      // TRANS: row = i, col = j (A[i, j]); else row = j, col = i (A[j, i])
      const int rg = TRANS ? i0 + row : jb + row;
      const int cg = TRANS ? jb + col : i0 + col;
      const int row_lim = TRANS ? n : j_end;
      const int col_lim = TRANS ? j_end : n;
      const size_t off = (size_t)rg * n + cg;
      VA v;
      v.x = v.y = v.z = v.w = 0;
      if (rg < row_lim) {
        if (vec_a) {
          if (cg < col_lim) v = __ldg(reinterpret_cast<const VA*>(A + off));
        } else {
          if (cg + 0 < col_lim) v.x = A[off + 0];
          if (cg + 1 < col_lim) v.y = A[off + 1];
          if (cg + 2 < col_lim) v.z = A[off + 2];
          if (cg + 3 < col_lim) v.w = A[off + 3];
        }
      }
      ra[r] = v;
    }
    if (vec_t) {   // d % 4 == 0, float t: 4 consecutive columns per load
#pragma unroll
      for (int q = 0; q < T_PER_THREAD / 4; ++q) {
        const int idx = (tid + q * THREADS) * 4;
        const int jl = idx / BN, cl = idx % BN;
        const int j = jb + jl, c = c0 + cl;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (j < j_end && c < d)
          v = __ldg(reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(t) + (size_t)j * d + c));
        rt[4 * q + 0] = v.x; rt[4 * q + 1] = v.y;
        rt[4 * q + 2] = v.z; rt[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < T_PER_THREAD; ++q) {
        const int idx = tid + q * THREADS;
        const int jl = idx / BN, cl = idx % BN;
        const int j = jb + jl, c = c0 + cl;
        rt[q] = (j < j_end && c < d) ? to_f32(t[(size_t)j * d + c]) : 0.f;
      }
    }
  };

  // ---- registers -> shared: binarize, force diagonal, mask, to bf16 ----
  auto store = [&](int jb) {
#pragma unroll
    for (int r = 0; r < A_GROUPS; ++r) {
      int row, col;
      group_pos(tid, r, row, col);
      float b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = TRANS ? i0 + row : i0 + col + e;
        const int j = TRANS ? jb + col + e : jb + row;
        float v = comp(ra[r], e);
        if (binarize) v = (i == j) ? 1.f : (v > threshold ? 1.f : 0.f);
        b[e] = (i < n && j < j_end) ? v : 0.f;
      }
      uint2 packed = make_uint2(pack2f(b[0], b[1]), pack2f(b[2], b[3]));
      *reinterpret_cast<uint2*>(&sA[row][col]) = packed;
    }
    if (vec_t) {
#pragma unroll
      for (int q = 0; q < T_PER_THREAD / 4; ++q) {
        const int idx = (tid + q * THREADS) * 4;
        const int jl = idx / BN, cl = idx % BN;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sT[jl][cl + e] = __float2bfloat16_rn(rt[4 * q + e]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < T_PER_THREAD; ++q) {
        const int idx = tid + q * THREADS;
        sT[idx / BN][idx % BN] = __float2bfloat16_rn(rt[q]);
      }
    }
  };

  float acc[BN / 8][4];
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;

  if (j_begin < j_end) load(j_begin);
  for (int jb = j_begin; jb < j_end; jb += BK) {
    __syncthreads();             // the previous step's MMAs are done
    store(jb);
    __syncthreads();
    if (jb + BK < j_end) load(jb + BK);   // in flight during the MMAs

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const int r0 = warp * 16 + g;
      const int kc = kk + tq * 2;
      uint32_t a0, a1, a2, a3;
      if (TRANS) {   // sA[i][j]: k pairs are adjacent
        a0 = *reinterpret_cast<const uint32_t*>(&sA[r0][kc]);
        a1 = *reinterpret_cast<const uint32_t*>(&sA[r0 + 8][kc]);
        a2 = *reinterpret_cast<const uint32_t*>(&sA[r0][kc + 8]);
        a3 = *reinterpret_cast<const uint32_t*>(&sA[r0 + 8][kc + 8]);
      } else {       // sA[j][i]
        a0 = pack2(sA[kc][r0], sA[kc + 1][r0]);
        a1 = pack2(sA[kc][r0 + 8], sA[kc + 1][r0 + 8]);
        a2 = pack2(sA[kc + 8][r0], sA[kc + 9][r0]);
        a3 = pack2(sA[kc + 8][r0 + 8], sA[kc + 9][r0 + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int cn = nt * 8 + g;
        const uint32_t b0 = pack2(sT[kc][cn], sT[kc + 1][cn]);
        const uint32_t b1 = pack2(sT[kc + 8][cn], sT[kc + 9][cn]);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[nt][0]), "+f"(acc[nt][1]), "+f"(acc[nt][2]),
              "+f"(acc[nt][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }

  // ---- epilogue: accumulate this split's partial sums into out ----
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + warp * 16 + g + (r >= 2 ? 8 : 0);
      const int c = c0 + nt * 8 + tq * 2 + (r & 1);
      if (i < n && c < d) atomicAdd(out + (size_t)i * d + c, acc[nt][r]);
    }
  }
}

struct Args {
  const void* A; const void* t; float* out;
  int n, d, splits, k_per_split;
  float threshold;
  int binarize, transpose, vec_a, vec_t;
  cudaStream_t stream;
};

template <int BN, bool TRANS, typename TA, typename TT>
void launch(const Args& a) {
  dim3 grid((a.n + BM - 1) / BM, (a.d + BN - 1) / BN, a.splits);
  core_kernel<BN, TRANS, TA, TT><<<grid, THREADS, 0, a.stream>>>(
      static_cast<const TA*>(a.A), static_cast<const TT*>(a.t), a.out, a.n,
      a.d, a.k_per_split, a.threshold, a.binarize, a.vec_a, a.vec_t);
}

template <int BN, typename TA, typename TT>
void dispatch_trans(const Args& a) {
  if (a.transpose) launch<BN, true, TA, TT>(a);
  else             launch<BN, false, TA, TT>(a);
}

template <typename TA, typename TT>
void dispatch_bn(const Args& a) {
  if (a.d <= 8)       dispatch_trans<8, TA, TT>(a);
  else if (a.d <= 16) dispatch_trans<16, TA, TT>(a);
  else if (a.d <= 32) dispatch_trans<32, TA, TT>(a);
  else                dispatch_trans<64, TA, TT>(a);
}

}  // namespace

extern "C" {

// a_dtype: 0 = float32, 1 = int8.  t_dtype: 0 = float32, 1 = bfloat16.
// out: float32 (n, d), zero-filled by the caller. k_per_split: a multiple
// of 64; splits = ceil(n / k_per_split). vec_a: N % 4 == 0 and A 16-byte
// aligned; vec_t: d % 4 == 0, float32 t, 16-byte aligned.
int core_spmm_launch(const void* A, int a_dtype, const void* t, int t_dtype,
                     float* out, int n, int d, int splits, int k_per_split,
                     float threshold, int binarize, int transpose, int vec_a,
                     int vec_t, void* stream) {
  if (n <= 0 || d <= 0 || splits <= 0 || k_per_split <= 0 ||
      k_per_split % BK != 0 || (vec_a && n % 4 != 0) ||
      (vec_t && (d % 4 != 0 || t_dtype != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{A, t, out, n, d, splits, k_per_split, threshold, binarize,
         transpose, vec_a, vec_t, static_cast<cudaStream_t>(stream)};
  if (a_dtype == 0 && t_dtype == 0)      dispatch_bn<float, float>(a);
  else if (a_dtype == 0 && t_dtype == 1) dispatch_bn<float, __nv_bfloat16>(a);
  else if (a_dtype == 1 && t_dtype == 0) dispatch_bn<int8_t, float>(a);
  else if (a_dtype == 1 && t_dtype == 1) dispatch_bn<int8_t, __nv_bfloat16>(a);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
