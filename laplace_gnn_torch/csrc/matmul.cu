// Blocked matrix product for Hopper: out = a @ b with f32 accumulation.
//
// Replaces the Pallas TPU kernel laplace_gnn_tpu/ops/pallas_matmul.py::
// _matmul_kernel (launched by matmul). It computes
//
//     out[m, n] = sum_k a[m, k] * b[k, n]      a (M, K), b (K, N), row-major
//
// for f32 or bf16 operands, summing in f32 and writing out in the operands'
// dtype (bf16 rounded to nearest). bf16 operands are upcast exactly to f32
// when staged, so every product is exact and only the f32 sums round, as on
// the TPU's matrix unit.
//
// Bound: at the shapes it is timed at, two regimes. The skinny aggregation
// (N, N) @ (N, 64) does 2 N^2 64 operations on N^2 elements of a, i.e. 32
// f32 operations per byte of a: below the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 per byte) it is bound by reading a once; at
// (242816, 1433) @ (1433, 1433) (the Kron posterior's layer-0 product) it
// is bound by the f32 operations (1.0e12 over 67 TFLOP/s = 15 ms).
//
// Design (wgmma, TMA and tensor cores come later; this is the simple,
// right version):
//  - a block owns a BM x BN tile of out and walks K in steps of BK; each
//    step stages a's (BM, BK) tile transposed and b's (BK, BN) tile into
//    shared memory as f32, two buffers deep: the next step's global loads
//    go to registers before this step's arithmetic and to the other buffer
//    after it, so global latency overlaps the FMAs and one barrier per step
//    suffices;
//  - each thread keeps a TM x TN register micro-tile of out; its rows are
//    ty + i * (BM / TM) and its columns tx + j * (BN / TN), so a warp reads
//    consecutive shared addresses (no bank conflicts on b, broadcasts on
//    a) and writes out in coalesced rows;
//  - ragged M, N and K are guarded loads that read 0 outside the matrix and
//    guarded stores, so nothing is padded or copied;
//  - two tiles are compiled: 128 x 128 (8 x 8 per thread) for wide outputs
//    and 64 x 64 (4 x 4 per thread) for the skinny (N, N) @ (N, d) products,
//    where a 128-wide tile would leave half its columns empty.
//
// The C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the wrapper can raise on a failed launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ out, int M, int N, int K) {
  constexpr int NT = (BM / TM) * (BN / TN);   // threads per block
  constexpr int RA = BM * BK / NT;            // a elements per thread per step
  constexpr int RB = BK * BN / NT;            // b elements per thread per step
  constexpr int SM_ROWS = BM / TM, SN_COLS = BN / TN;
  static_assert(BM * BK % NT == 0 && BK * BN % NT == 0, "tile split");

  // a transposed ([k][m], one pad word: conflict-free transposed stores)
  __shared__ float As[2][BK][BM + 1];
  __shared__ float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % SN_COLS, ty = tid / SN_COLS;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;

  float ra[RA], rb[RB];
  auto load = [&](int k0) {
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int e = tid + r * NT;
      const long long m = m0 + e / BK;
      const int k = k0 + e % BK;
      ra[r] = (m < M && k < K) ? to_f32(a[m * K + k]) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int e = tid + r * NT;
      const int k = k0 + e / BN;
      const long long n = n0 + e % BN;
      rb[r] = (k < K && n < N) ? to_f32(b[static_cast<long long>(k) * N + n])
                               : 0.0f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int e = tid + r * NT;
      As[buf][e % BK][e / BK] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int e = tid + r * NT;
      Bs[buf][e / BN][e % BN] = rb[r];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int steps = (K + BK - 1) / BK;
  load(0);
  stage(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load((s + 1) * BK);   // in flight during the FMAs
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[buf][k][ty + i * SM_ROWS];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[buf][k][tx + j * SN_COLS];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (s + 1 < steps) {
      // the other buffer was last read in step s - 1, before the barrier
      // that ended it
      stage(buf ^ 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + i * SM_ROWS;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long n = n0 + tx + j * SN_COLS;
      if (n < N) store(out + m * N + n, acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* a, const void* b, void* out, int M, int N, int K,
            cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<T*>(out), M, N, K);
}

template <typename T>
void dispatch(const void* a, const void* b, void* out, int M, int N, int K,
              int wide, cudaStream_t stream) {
  if (wide) launch<T, 128, 128, 8, 8, 8>(a, b, out, M, N, K, stream);
  else      launch<T, 64, 64, 16, 4, 4>(a, b, out, M, N, K, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and out alike, all contiguous
// row-major). wide: 1 = the 128 x 128 tile, 0 = the 64 x 64 tile.
// (M + tile - 1) / tile must fit gridDim.y (65535 blocks).
int matmul_launch(const void* a, const void* b, void* out, int M, int N,
                  int K, int dtype, int wide, void* stream) {
  const int bm = wide ? 128 : 64;
  if (M <= 0 || N <= 0 || K <= 0 || (M + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)      dispatch<float>(a, b, out, M, N, K, wide, s);
  else if (dtype == 1) dispatch<__nv_bfloat16>(a, b, out, M, N, K, wide, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
