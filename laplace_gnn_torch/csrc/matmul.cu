// Blocked matrix product for Hopper's tensor cores: out = a @ b, f32 sums.
//
// Replaces the Pallas TPU kernel laplace_gnn_tpu/ops/pallas_matmul.py::
// _matmul_kernel (launched by matmul). It computes
//
//     out[m, n] = sum_k a[m, k] * b[k, n]      a (M, K), b (K, N), row-major
//
// for f32 or bf16 operands, summing in f32 and writing out in the operands'
// dtype (bf16 rounded once, to nearest, from the f32 total).
//
// Bounds on an H100 SXM: the larger of the bytes (a, b read once, out
// written once) over 3.35 TB/s and the operations over the tensor-core
// rate of the type that does them: 2MNK over 989 TFLOP/s for bf16, and
// 3 x 2MNK over 495 TFLOP/s for f32, which runs as three TF32 products.
// The skinny aggregation (2708 or 16384)^2 @ (., 64) is bound by reading a
// once (f32: 9.2 us and 0.32 ms); the Kron posterior's layer-0 product
// (242816, 1433) @ (1433, 1433) in f32 by the operations (6.0 ms).
//
// Design, in three stages:
//  1. bf16 on tensor cores. A block owns a BM x BN tile of out and walks its
//     K range in steps of 128 bytes of a's rows (64 bf16, 32 f32: a DRAM
//     page serves a whole line; 64-byte pieces of many rows held bf16 at
//     half the memory rate) through a ring of 3-4 shared-memory stages
//     filled by cp.async (16-byte .cg copies, commit_group / wait_group;
//     the copy for step s + STAGES - 1 is issued before the MMAs of step s,
//     one barrier a step). Fragments come from ldmatrix (ldmatrix.trans for
//     the row-major b) and feed mma.sync m16n8k16 bf16 with f32
//     accumulators in registers. Shared rows are padded by 16 bytes, so the
//     eight 16-byte rows an ldmatrix phase reads fall into distinct banks.
//     bf16 products are exact in the tensor core and sums are f32, as with
//     an exact upcast. Three tiles, chosen by the wrapper from the JAX
//     signature's hints: 128 x 128 (8 warps of 64 x 32, one block an SM),
//     128 x 64 for N <= 64 (8 warps of 32 x 32, two an SM: half the b
//     traffic of a 64-row tile per byte of a) and 64 x 64 (4 warps of
//     32 x 32, three an SM). __launch_bounds__ caps registers so that many
//     blocks fit; the ring is the deepest that fits beside them.
//  2. Split-K. When the output tiles fill at most half of one wave of
//     blocks, the wrapper splits K over gridDim.y so that the grid fills
//     that wave and no more: each block writes an f32 partial tile to a
//     workspace (S, M, N), and splitk_reduce sums the S partials in a fixed
//     order and rounds once into out. No atomics: the result is
//     deterministic, and a bf16 out is never rounded from a partial sum.
//  3. f32 as 3xTF32 on the same pipeline (mma.sync m16n8k8 tf32). Each
//     operand is split when its fragment is read from shared memory,
//     hi = rna_tf32(x), lo = rna_tf32(x - hi), with cvt.rna.tf32.f32's
//     rounding done by an integer add and mask (cvt itself runs on the
//     conversion pipe and held the MMAs to 28% of the TF32 rate), and the
//     accumulator takes a_hi b_lo + a_lo b_hi + a_hi b_hi in that order:
//     about 2^-21 relative error a product, against 2^-11 for one TF32
//     pass. ldmatrix.trans moves 16-bit elements and cannot build the TF32
//     B fragment of a row-major b, so f32 fragments are 32-bit shared loads
//     from a layout padded for them (a rows by 4 words, b rows by 8): the
//     32 lanes of each load hit 32 distinct banks.
//
// Ragged M, N and K: a copy that reaches past the matrix (or past its
// split's K range) is the zero-fill form of cp.async (src-size 0 or
// partial), and stores are guarded; nothing is padded or copied.
//
// Alignment: a 16-byte cp.async needs 16-byte aligned sources, which rows
// of 1433 f32 (5732 bytes) or 2708 bf16 (5416 bytes) are not, nor a view
// that starts inside a buffer. The wrapper takes the copy width from
// (a pointer | b pointer | row bytes of a | row bytes of b): 16, 8 or 4
// bytes by cp.async, or, for bf16 rows of odd length, guarded 2-byte
// register loads, fetched before a step's MMAs and stored to shared memory
// after them. Each width is its own template instance.
//
// Not yet wgmma or TMA: the skinny shapes are bound by bytes, which
// mma.sync fed by a cp.async ring can reach, and TF32 wgmma reads B from
// shared memory only K-major, which would need a transposed copy of b.
//
// The C entry point launches on the caller's stream, allocates nothing
// (the wrapper passes the split-K workspace), and returns the first CUDA
// error so the wrapper can raise on a failed launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "sm90_mma.cuh"

namespace {

// PTX wrappers (cp.async, ldmatrix, mma.sync) and the output store
using namespace sm90;

// cvt.rna.tf32.f32 (nearest, ties away from zero) on the bits: adding half
// a TF32 ulp to the magnitude and clearing the 13 low bits gives the same
// result for every finite x. Two integer operations on the full-rate ALU;
// cvt runs on the conversion pipe, which capped the 3xTF32 MMAs.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), hi and lo TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// ---- tiles ----

template <int BM_, int BN_, int WARPS_M, int WARPS_N, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WM = WARPS_M, WN = WARPS_N;
  // blocks an SM must hold at once: registers are capped for it, and the
  // ring fits it (the wrapper's one-wave split-K relies on it)
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int WTM = BM / WM, WTN = BN / WN;   // warp sub-tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;    // MMA tiles a warp
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "warp tile");
};
// (2 wide blocks an SM would cap registers at 128, where the f32 instance
// spills)
using Wide = Tile<128, 128, 2, 4, 1>;    // 8 warps of 64 x 32
using Skinny = Tile<128, 64, 4, 2, 2>;   // 8 warps of 32 x 32, for N <= 64
using Narrow = Tile<64, 64, 2, 2, 3>;    // 4 warps of 32 x 32

// Shared layout and ring depth of one (dtype, tile): a K step of 128 bytes
// of each row of a (32 f32 or 64 bf16: a DRAM page serves a whole line, where
// 64-byte pieces of many rows left bf16 at half the memory rate); row
// strides padded for conflict-free fragment reads (see the header note);
// the deepest ring of which MIN_BLOCKS fit an SM's 228 KB (1 KB of it
// reserved a block). Both dtypes have the same layout in bytes. The
// wrapper's plan reports STAGES and mirrors MIN_BLOCKS (ops/matmul.py:
// RING_STAGES, BLOCKS_PER_SM).
template <typename T, class C>
struct Layout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int BK = 128 / static_cast<int>(sizeof(T));
  static constexpr int LDA = BK + 16 / static_cast<int>(sizeof(T));
  static constexpr int LDB = C::BN + 8;
  static constexpr int STAGES = C::BN == 128 ? 3 : 4;
  static constexpr int SMEM =
      STAGES * (C::BM * LDA + BK * LDB) * static_cast<int>(sizeof(T));
  static_assert(C::MIN_BLOCKS * (SMEM + 1024) <= 228 * 1024, "ring size");
};

// One chunk of VEC bytes (VEC / sizeof(T) elements) of a row whose next
// `avail` elements lie inside the matrix; the rest of the chunk reads 0.
template <typename T, int VEC>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int avail,
                                           const T* base) {
  if constexpr (VEC >= 4) {   // (the 2-byte path never calls it)
    constexpr int E = VEC / static_cast<int>(sizeof(T));
    const int n = avail <= 0 ? 0 : (avail < E ? avail : E);
    cp_async<VEC>(dst, n > 0 ? src : base, n * static_cast<int>(sizeof(T)));
  }
}

// one bf16 element of the 2-byte path, fetched into a register
__device__ __forceinline__ unsigned short fetch16(const void* src, int avail) {
  return avail > 0 ? __ldg(static_cast<const unsigned short*>(src))
                   : static_cast<unsigned short>(0);
}

template <typename T, class C, int VEC>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ out, float* __restrict__ ws, int M, int N,
              int K, int n_tiles, int k_per_split) {
  using L = Layout<T, C>;
  constexpr int LDA = L::LDA, LDB = L::LDB, STAGES = L::STAGES;
  constexpr int BM = C::BM, BN = C::BN, BK = L::BK;
  constexpr int E = VEC >= static_cast<int>(sizeof(T))
                        ? VEC / static_cast<int>(sizeof(T)) : 1;
  // a thread copies the chunks at one column of a stage's rows, every
  // A_STEP-th row of the a tile and every B_STEP-th row of the b tile
  constexpr int A_ROW = BK / E, B_ROW = BN / E;           // chunks a row
  static_assert(C::THREADS % A_ROW == 0 && C::THREADS % B_ROW == 0,
                "stage split");
  constexpr int A_STEP = C::THREADS / A_ROW, B_STEP = C::THREADS / B_ROW;
  constexpr int A_N = BM / A_STEP, B_N = BK / B_STEP;    // chunks a thread
  static_assert(BM % A_STEP == 0 && BK % B_STEP == 0, "stage split");
  static_assert(VEC >= 4 || (VEC == 2 && sizeof(T) == 2),
                "2-byte copies are for bf16");

  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + STAGES * BM * LDA;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int g = lane >> 2, t = lane & 3;      // MMA group, thread in group
  // n tiles fastest: neighbouring blocks share a's row tile through L2
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * BN;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int k_tiles = (k_end - k_begin + BK - 1) / BK;

  const int a_r = tid / A_ROW, a_c = (tid % A_ROW) * E;
  const int b_r = tid / B_ROW, b_c = (tid % B_ROW) * E;
  const int a_rows_left = static_cast<int>(M - m0) - a_r;   // rows of this
  const T* a_src = a + (m0 + a_r) * K + a_c;    // thread's chunks in a
  const int b_cols_left = N - n0 - b_c;
  const T* b_src = b + static_cast<long long>(b_r) * N + n0 + b_c;

  // One pointer per operand, stepped: an address per chunk would hold two
  // registers each across the unrolled loop. copy(i, src, avail) takes
  // chunk i of a (i < A_N) or b (i >= A_N).
  auto each_chunk = [&](int k0, auto&& copy) {
    const T* pa = a_src + k0;
    const int a_avail = k_end - k0 - a_c;
#pragma unroll
    for (int i = 0; i < A_N; ++i) {
      copy(i, pa, i * A_STEP < a_rows_left ? a_avail : 0);
      pa += static_cast<long long>(A_STEP) * K;
    }
    const T* pb = b_src + static_cast<long long>(k0) * N;
    const int b_rows_left = k_end - k0 - b_r;
#pragma unroll
    for (int i = 0; i < B_N; ++i) {
      copy(A_N + i, pb, i * B_STEP < b_rows_left ? b_cols_left : 0);
      pb += static_cast<long long>(B_STEP) * N;
    }
  };
  auto chunk_dst = [&](int st, int i) {
    return i < A_N ? sA + st * BM * LDA + (a_r + i * A_STEP) * LDA + a_c
                   : sB + st * BK * LDB + (b_r + (i - A_N) * B_STEP) * LDB
                         + b_c;
  };
  // cp.async widths: straight into the stage
  auto load_stage = [&](int st, int k0) {
    each_chunk(k0, [&](int i, const T* src, int avail) {
      copy_chunk<T, VEC>(chunk_dst(st, i), src, avail, i < A_N ? a : b);
    });
  };
  // the 2-byte path: fetched into registers (two elements to one) before a
  // step's MMAs and stored after them, so the MMAs cover the loads' latency
  uint32_t staged[VEC == 2 ? (A_N + B_N) / 2 : 1];
  auto fetch = [&](int k0) {
    each_chunk(k0, [&](int i, const T* src, int avail) {
      const uint32_t v = fetch16(src, avail);
      staged[i / 2] = i % 2 ? staged[i / 2] | (v << 16) : v;
    });
  };
  auto put = [&](int st) {
#pragma unroll
    for (int i = 0; i < A_N + B_N; ++i)
      *reinterpret_cast<unsigned short*>(chunk_dst(st, i)) =
          static_cast<unsigned short>(staged[i / 2] >> (i % 2 ? 16 : 0));
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if constexpr (VEC == 2) {
      if (s < k_tiles) {
        fetch(k_begin + s * BK);
        put(s);
      }
    } else {
      if (s < k_tiles) load_stage(s, k_begin + s * BK);
      cp_async_commit();
    }
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();   // step kt's copies have landed
    // ... for every thread; and every thread is done with step kt - 1,
    // whose stage the next copy refills
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if constexpr (VEC == 2) {
      if (nk < k_tiles) fetch(k_begin + nk * BK);
    } else {
      if (nk < k_tiles) load_stage(nk % STAGES, k_begin + nk * BK);
      cp_async_commit();
    }

    const int st = kt % STAGES;
    const T* tA = sA + st * BM * LDA + wm * C::WTM * LDA;
    const T* tB = sB + st * BK * LDB + wn * C::WTN;
    if constexpr (L::F32) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t bh[C::NT][2], bl[C::NT][2];
#pragma unroll
        for (int j = 0; j < C::NT; ++j) {
          const float* q = tB + (kk + t) * LDB + j * 8 + g;
          split_tf32(q[0], bh[j][0], bl[j][0]);
          split_tf32(q[4 * LDB], bh[j][1], bl[j][1]);
        }
        // one 16-row tile of a at a time (fewer live registers), three
        // passes over its MMA tiles, so consecutive MMAs write different
        // accumulators
#pragma unroll
        for (int i = 0; i < C::MT; ++i) {
          uint32_t ah[4], al[4];
          const float* p = tA + (i * 16 + g) * LDA + kk + t;
          split_tf32(p[0], ah[0], al[0]);
          split_tf32(p[8 * LDA], ah[1], al[1]);
          split_tf32(p[4], ah[2], al[2]);
          split_tf32(p[8 * LDA + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < C::NT; ++j)
            mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);
#pragma unroll
          for (int j = 0; j < C::NT; ++j)
            mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);
#pragma unroll
          for (int j = 0; j < C::NT; ++j)
            mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[C::MT][4], bf[C::NT][2];
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
          ldmatrix_x4(af[i], tA + (i * 16 + (lane & 15)) * LDA + kk
                                 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < C::NT; j += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, tB + (kk + (lane & 15)) * LDB + j * 8
                                   + (lane >> 4) * 8);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          bf[j + 1][0] = r[2];
          bf[j + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int j = 0; j < C::NT; ++j)
            mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
      }
    }
    if constexpr (VEC == 2) {
      // stage nk % STAGES was last read in step kt - 1, before this
      // step's barrier
      if (nk < k_tiles) put(nk % STAGES);
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: c0, c1 at (row g, cols 2t, 2t + 1); c2, c3 at row g + 8
  float* part = ws ? ws + static_cast<long long>(blockIdx.y) * M * N
                   : nullptr;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * C::WTM + i * 16 + g + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int n = n0 + wn * C::WTN + j * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e >= N) continue;
          const float v = acc[i][j][2 * h + e];
          if (part) part[m * N + n + e] = v;
          else      store(out + m * N + n + e, v);
        }
      }
    }
}

// out = sum over s = 0 .. S-1, in that order, of ws[s]; rounded once.
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ ws,
                              T* __restrict__ out, long long mn, int S) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                     + threadIdx.x; i < mn; i += stride) {
    float s = ws[i];
    for (int z = 1; z < S; ++z) s += ws[z * mn + i];
    store(out + i, s);
  }
}

template <typename T, class C, int VEC>
cudaError_t launch(const void* a, const void* b, void* out, float* ws, int M,
                   int N, int K, int split, int k_per_split,
                   cudaStream_t stream) {
  using L = Layout<T, C>;
  auto kernel = matmul_kernel<T, C, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return e;
  const long long m_tiles = (M + C::BM - 1) / C::BM;
  const long long n_tiles = (N + C::BN - 1) / C::BN;
  if (m_tiles * n_tiles > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(m_tiles * n_tiles), split);
  kernel<<<grid, C::THREADS, L::SMEM, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      split > 1 ? ws : nullptr, M, N, K, static_cast<int>(n_tiles),
      k_per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return e;
  const long long mn = static_cast<long long>(M) * N;
  const long long blocks = (mn + 255) / 256;
  splitk_reduce<T><<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                     256, 0, stream>>>(ws, static_cast<T*>(out), mn, split);
  return cudaGetLastError();
}

template <typename T, class C>
cudaError_t by_vec(int vec, const void* a, const void* b, void* out,
                   float* ws, int M, int N, int K, int split, int kps,
                   cudaStream_t s) {
  switch (vec) {
    case 16: return launch<T, C, 16>(a, b, out, ws, M, N, K, split, kps, s);
    case 8:  return launch<T, C, 8>(a, b, out, ws, M, N, K, split, kps, s);
    case 4:  return launch<T, C, 4>(a, b, out, ws, M, N, K, split, kps, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch<T, C, 2>(a, b, out, ws, M, N, K, split, kps, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_tile(int bm, int bn, int vec, const void* a, const void* b,
                    void* out, float* ws, int M, int N, int K, int split,
                    int kps, cudaStream_t s) {
  if (bm == 128 && bn == 128)
    return by_vec<T, Wide>(vec, a, b, out, ws, M, N, K, split, kps, s);
  if (bm == 128 && bn == 64)
    return by_vec<T, Skinny>(vec, a, b, out, ws, M, N, K, split, kps, s);
  if (bm == 64 && bn == 64)
    return by_vec<T, Narrow>(vec, a, b, out, ws, M, N, K, split, kps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and out alike, contiguous
// row-major). (bm, bn): the tile, 128 x 128, 128 x 64 or 64 x 64, each
// with the ring depth compiled for it (Layout::STAGES). vec: copy width in
// bytes (16, 8, 4; 2 for bf16 only), which must divide both pointers and
// both row lengths in bytes. K is split into `split` ranges of k_per_split
// (a multiple of the K step: 32 f32, 64 bf16), none empty; with
// split > 1, ws holds split * M * N float32 partials.
int matmul_launch(const void* a, const void* b, void* out, void* ws, int M,
                  int N, int K, int dtype, int bm, int bn, int vec, int split,
                  int k_per_split, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  const uintptr_t align = reinterpret_cast<uintptr_t>(a)
                          | reinterpret_cast<uintptr_t>(b)
                          | static_cast<uintptr_t>(K) * es
                          | static_cast<uintptr_t>(N) * es;
  if (M <= 0 || N <= 0 || K <= 0 || (dtype != 0 && dtype != 1) ||
      vec < es || align % vec != 0 || split < 1 || split > 65535 ||
      k_per_split <= 0 || k_per_split % (128 / es) != 0 ||
      static_cast<long long>(split - 1) * k_per_split >= K ||
      static_cast<long long>(split) * k_per_split < K ||
      (split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  cudaError_t e = dtype == 0
      ? by_tile<float>(bm, bn, vec, a, b, out, w, M, N, K, split,
                       k_per_split, s)
      : by_tile<__nv_bfloat16>(bm, bn, vec, a, b, out, w, M, N, K, split,
                               k_per_split, s);
  return static_cast<int>(e);
}

}  // extern "C"
