// Fused binarize + forced self-loop + transposed aggregation for Hopper.
//
// Replaces the Pallas TPU kernel laplace_gnn_tpu/ops/pallas_spmm.py::
// _core_kernel (launched by _core). It computes
//
//     out[i, c] = sum_j B[j, i] * t[j, c]
//
// where, with binarize != 0, B = bin_diag(M): (M[j, i] > threshold) on the
// f32 value of M (strict '>', before any cast), the true diagonal forced to
// 1, and everything outside the N x N matrix zero. With binarize == 0,
// B = M, from f32 or int8. M is A itself, or A^T when transpose != 0: the
// backward call reads A in place. Operands enter the tensor cores as bf16
// (exact for a 0/1 B or an int8 A) and products sum in f32; out is written
// once, in t's dtype (f32 or bf16, rounded once from the f32 total).
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16). Two regimes:
//  - skinny, d <= 64 (the trainer, the KFAC pullback columns, GCN): bound by
//    reading A once. N = 2708 in f32: 29 MB, 9 us, against 1 us of MMA;
//    int8 at N = 16384: 268 MB, 83 us;
//  - wide, d in the thousands (the Jacobians' vmapped pullbacks, folded
//    into the feature axis: d = 12250 and 112000 at N = 2708): bound by the
//    operations, 2 N^2 d (1.66 ms at d = 112000). A (29 MB) stays in L2; t
//    and out stream from and to HBM.
//
// Design. A block of 256 threads (8 warps) owns a 128-row tile of out (i)
// and a column tile of BN columns (c), and walks its range of j in K steps
// through a ring of STAGES shared-memory stages of raw A and t, filled by
// cp.async (commit_group / wait_group; the copy for step s + STAGES - 1 is
// issued before the MMAs of step s). Each copy fills 16 bytes of shared
// memory: one 16-byte copy, or two 8-byte or four 4-byte ones, as the
// plan's copy width allows (pointer | row bytes); the zero-fill form covers
// ragged edges. Below 4 bytes (int8 rows of odd length, bf16 t of odd
// width) the 16 bytes come from guarded register loads. An f32 t is
// rounded to a bf16 tile once a step; a bf16 t is read from its stage.
// t's fragments come from ldmatrix.trans; products are mma.sync m16n8k16.
//  - Skinny tiles, BN in {8, 32, 64}, d <= 64: each warp owns 16 rows and
//    every column, so each element of A feeds one MMA fragment, built
//    straight from the raw stage: a compare and a select give the bf16
//    bits of 0 or 1 (or one paired rounding, raw), and the index checks
//    (diagonal, ragged edges) run only on the steps that need them. K
//    steps of 128 bytes of an f32 A's rows (32) and 64 of an int8 A's, 3
//    stages: two blocks fit an SM, which the card needs here (one block an
//    SM left clusters unplaced and ran slower at every trainer shape).
//  - Wide tiles, 128 x 128 (d <= 128) or 128 x 256, K steps of 16: A is
//    read by 4 warps, so one pass binarizes it into a bf16 tile for
//    ldmatrix. Step s + 1 is converted after step s's MMAs, into the other
//    of two bf16 buffers, so one barrier a step serves both. Neighbouring
//    blocks take the row tiles of one column tile, so t is read from HBM
//    about once and A from L2. These calls are bound on this design by the
//    L2 -> shared-memory traffic of f32 operands and the conversion work,
//    not by the tensor cores (PERF.md).
//  - Split-K. When the tiles fill less than one wave, the plan splits j
//    over S <= 8 blocks that form one thread-block cluster. Each block puts
//    its f32 partial tile in its own shared memory; after a cluster barrier
//    block r sums rows r/S of the tile over the S partials, read through
//    distributed shared memory in the order 0 .. S-1, and writes them to
//    out once. No atomics, no zero fill and no cast launch: one launch a
//    call, and two calls give the same bits.
//
// The wrapper's plan (ops/fused_spmm.py::plan) chooses the tile, split and
// copy widths; this file owns the K step and ring depth, which the plan
// mirrors. The C entry point launches on the caller's stream, allocates
// nothing and returns the first CUDA error so the wrapper can raise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "sm90_mma.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sm90;

constexpr int BM = 128;        // rows of out (i) a block
constexpr int THREADS = 256;   // 8 warps
constexpr int MAX_SPLIT = 8;   // the portable cluster size
constexpr uint32_t BF16_ONE = 0x3F80u;

// ---- tiles ----

// Skinny tiles (BN <= 64): 8 warps of 16 rows and every column. Wide
// tiles (BN = 128 or 256): 8 warps as 2 x 4, of 64 x 32 or 64 x 64. An SM
// holds two blocks of each tile but the 128 x 256 one (the plan mirrors
// MIN_BLOCKS: ops/fused_spmm.py::BLOCKS_PER_SM).
template <int BN_, bool WIDE_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr bool WIDE = WIDE_;
  static constexpr int WM = WIDE ? 2 : 8, WN = WIDE ? 4 : 1;   // warps
  static constexpr int WTM = BM / WM, WTN = BN / WN;            // warp tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;             // MMA tiles
  static constexpr int MIN_BLOCKS = BN == 256 ? 1 : 2;
};

// Shared-memory layout of one (A type, t type, tile, orientation): a ring
// of STAGES raw (A, t) stages; the wide tile adds two bf16 A tiles and,
// for an f32 t, two bf16 t tiles (step k + 1 is converted while step k's
// MMAs run). Raw A is in A's own orientation: [i][j] when TRANS (A[i, j]
// feeds B[j, i]), else [j][i]. Row strides are padded so that fragment
// reads from the raw stages hit distinct banks (f32 [i][j]: 8-byte reads
// of 4 rows a half-warp, stride = 8 words mod 32; f32 [j][i] and f32 t:
// rows 2 tq apart, stride = 4 mod 8 words; int8: 16 bytes; bf16 t and the
// bf16 tiles: 16 bytes, for ldmatrix), and stay 16-byte aligned.
template <typename TA, typename TT, class C, bool TRANS>
struct Layout {
  static constexpr int AES = static_cast<int>(sizeof(TA));
  static constexpr int TES = static_cast<int>(sizeof(TT));
  static constexpr bool T_F32 = TES == 4;
  // K step: skinny, 128 bytes of an f32 A's rows (32) and 64 of an int8
  // A's (64 rows of f32 t: a stage of 128 would leave one block an SM);
  // wide, 16
  static constexpr int BK = C::WIDE ? 16 : (AES == 4 ? 32 : 64);
  static constexpr int STAGES = C::WIDE ? 4 : 3;
  static constexpr int A_ROWS = TRANS ? BM : BK;
  static constexpr int A_COLS = TRANS ? BK : BM;
  static constexpr int A_LD = A_COLS + (AES == 4 ? (TRANS ? 8 : 4) : 16);
  static constexpr int A_STAGE = A_ROWS * A_LD * AES;            // bytes
  static constexpr int T_LD = C::BN + 16 / TES;
  static constexpr int T_STAGE = BK * T_LD * TES;
  static constexpr int STAGE = A_STAGE + T_STAGE;
  static constexpr int RING = STAGES * STAGE;
  // bf16 tiles (elements): the wide tile's A, two; an f32 t's, two on
  // the wide tile (converted a step ahead), one on the skinny ones
  static constexpr int AB_LD = A_COLS + 8, B_LD = C::BN + 8;
  static constexpr int AB_TILE = C::WIDE ? A_ROWS * AB_LD : 0;
  static constexpr int B_TILE = T_F32 ? BK * B_LD : 0;
  static constexpr int B_TILES = C::WIDE ? 2 : 1;
  static constexpr int SMEM_MAIN =
      RING + (2 * AB_TILE + B_TILES * B_TILE) * 2;
  static constexpr int PARTIAL = BM * C::BN * 4;     // split-K partial tile
  static constexpr int SMEM = SMEM_MAIN > PARTIAL ? SMEM_MAIN : PARTIAL;
  static_assert(C::MIN_BLOCKS * (SMEM + 1024) <= 228 * 1024, "smem");
  static_assert(A_STAGE % 16 == 0 && T_STAGE % 16 == 0, "alignment");
};

// ---- copies ----

// The 16-byte chunks of a (rows x row_bytes) tile of a row-major matrix
// into a stage of row stride ld_bytes, THREADS threads each taking every
// (THREADS / chunks a row)-th row at one column: row r of the tile is
// matrix row row0 + r (inside the matrix while < row_lim), its bytes start
// at column byte col0 and the row has col_bytes of data; vec is uniform.
template <int ROWS, int ROW_BYTES>
__device__ __forceinline__ void copy_tile(unsigned char* stage, int ld_bytes,
                                          const unsigned char* m,
                                          long long pitch, long long row0,
                                          long long row_lim, long long col0,
                                          long long col_bytes, int vec) {
  constexpr int CPR = ROW_BYTES / 16;                // chunks a row
  constexpr int CHUNKS = ROWS * CPR;
  constexpr int STEP = THREADS / CPR;                // rows between chunks
  static_assert(THREADS % CPR == 0, "chunk split");
  static_assert(CHUNKS < THREADS || CHUNKS % THREADS == 0, "chunk split");
  const int tid = threadIdx.x;
  const int r0 = tid / CPR, c = (tid % CPR) * 16;
  if (CHUNKS < THREADS && tid >= CHUNKS) return;
  const int avail = static_cast<int>(min(max(col_bytes - c, 0LL), 16LL));
  unsigned char* dst = stage + r0 * ld_bytes + c;
  const unsigned char* src = m + (row0 + r0) * pitch + col0 + c;
  auto run = [&](auto vec_c) {
    constexpr int V = decltype(vec_c)::value;
#pragma unroll
    for (int q = 0; q < (CHUNKS + THREADS - 1) / THREADS; ++q) {
      const bool in = row0 + r0 + q * STEP < row_lim;
      fill16<V>(dst + q * STEP * ld_bytes, src + q * STEP * pitch,
                in ? avail : 0, m);
    }
  };
  switch (vec) {
    case 16: run(std::integral_constant<int, 16>{}); break;
    case 8:  run(std::integral_constant<int, 8>{}); break;
    case 4:  run(std::integral_constant<int, 4>{}); break;
    case 2:  run(std::integral_constant<int, 2>{}); break;
    default: run(std::integral_constant<int, 1>{}); break;
  }
}

// ---- values of B ----

__device__ __forceinline__ float to_f32(float v) { return v; }
// exact, on the full-rate pipes: 2^23 + 128 + v has v in its low bits
__device__ __forceinline__ float to_f32(int8_t v) {
  return __int_as_float(0x4B000080 + v) - 8388736.0f;
}

// bf16 bits of B's entry for the raw value x at (i, j): 0 outside the
// matrix or the split's j range; binarized, (i == j) | (x > threshold)
// selects 1.0 or 0; raw, x rounded to bf16 (exact for int8)
__device__ __forceinline__ uint32_t b_bits(float x, bool inside, bool diag,
                                          float threshold, int binarize) {
  if (!inside) return 0u;
  if (binarize) return (diag || x > threshold) ? BF16_ONE : 0u;
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// bf16 bits of two entries of B (x0 low, x1 high) inside the matrix and
// off the diagonal: a compare and a select each, or one paired rounding
__device__ __forceinline__ uint32_t pair_bits(float x0, float x1,
                                             float threshold, int binarize) {
  if (binarize)
    return (x0 > threshold ? BF16_ONE : 0u) |
           (x1 > threshold ? BF16_ONE << 16 : 0u);
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two adjacent entries of out, at an even offset
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// ---- the kernel ----

template <typename TA, typename TT, class C, bool TRANS>
__global__ void __launch_bounds__(THREADS, C::MIN_BLOCKS)
core_kernel(const TA* __restrict__ A, const TT* __restrict__ t,
            TT* __restrict__ out, int n, int d, int split, int k_per_split,
            float threshold, int binarize, int vec_a, int vec_t) {
  using L = Layout<TA, TT, C, TRANS>;
  constexpr int BN = C::BN, BK = L::BK, STAGES = L::STAGES;
  constexpr int A_LD = L::A_LD, T_LD = L::T_LD;
  constexpr int AB_LD = L::AB_LD, B_LD = L::B_LD;
  constexpr int MT = C::MT, NT = C::NT;

  extern __shared__ __align__(16) unsigned char smem[];
  auto a_stage = [&](int st) {
    return reinterpret_cast<const TA*>(smem + st * L::STAGE);
  };
  auto t_stage = [&](int st) {
    return reinterpret_cast<const TT*>(smem + st * L::STAGE + L::A_STAGE);
  };
  __nv_bfloat16* sAb = reinterpret_cast<__nv_bfloat16*>(smem + L::RING);
  __nv_bfloat16* sTb = sAb + 2 * L::AB_TILE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int g = lane >> 2, tq = lane & 3;       // MMA group, thread in group
  const int part = blockIdx.x % split;          // rank in the cluster
  const int i0 = (blockIdx.x / split) * BM;
  const int c0 = blockIdx.y * BN;
  const int j_begin = part * k_per_split;
  const int j_end = min(n, j_begin + k_per_split);
  const int k_tiles = j_end > j_begin ? (j_end - j_begin + BK - 1) / BK : 0;

  // ---- global -> ring: A's tile and t's tile of the step at jb ----
  auto load_stage = [&](int st, int jb) {
    unsigned char* sa = smem + st * L::STAGE;
    const unsigned char* a = reinterpret_cast<const unsigned char*>(A);
    const long long pitch = static_cast<long long>(n) * L::AES;
    if constexpr (TRANS)    // rows i, columns j
      copy_tile<L::A_ROWS, L::A_COLS * L::AES>(
          sa, A_LD * L::AES, a, pitch, i0, n,
          static_cast<long long>(jb) * L::AES,
          static_cast<long long>(j_end - jb) * L::AES, vec_a);
    else                    // rows j, columns i
      copy_tile<L::A_ROWS, L::A_COLS * L::AES>(
          sa, A_LD * L::AES, a, pitch, jb, j_end,
          static_cast<long long>(i0) * L::AES,
          static_cast<long long>(n - i0) * L::AES, vec_a);
    copy_tile<BK, BN * L::TES>(
        sa + L::A_STAGE, T_LD * L::TES,
        reinterpret_cast<const unsigned char*>(t),
        static_cast<long long>(d) * L::TES, jb, j_end,
        static_cast<long long>(c0) * L::TES,
        static_cast<long long>(d - c0) * L::TES, vec_t);
  };

  // ---- fragments straight from the raw stage (skinny tiles) ----
  // A: rows (g, g + 8) of the warp's 16, k (2 tq, + 1; + 8, + 9) of kk
  // (fast: the step's tile lies inside the matrix and off the diagonal)
  auto a_frag_raw = [&](uint32_t (&af)[4], const TA* sa, int kk, int jb,
                        auto fast_c) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        const int il = wm * 16 + g + 8 * h, jl = kk + 2 * tq + 8 * hk;
        float x0, x1;
        if constexpr (TRANS) {          // [i][j]: the pair is adjacent
          if constexpr (L::AES == 4) {
            const float2 v =
                *reinterpret_cast<const float2*>(sa + il * A_LD + jl);
            x0 = v.x; x1 = v.y;
          } else {
            const char2 v =
                *reinterpret_cast<const char2*>(sa + il * A_LD + jl);
            x0 = to_f32(static_cast<int8_t>(v.x));
            x1 = to_f32(static_cast<int8_t>(v.y));
          }
        } else {                        // [j][i]: two rows
          x0 = to_f32(sa[jl * A_LD + il]);
          x1 = to_f32(sa[(jl + 1) * A_LD + il]);
        }
        if constexpr (decltype(fast_c)::value) {
          af[h + 2 * hk] = pair_bits(x0, x1, threshold, binarize);
        } else {
          const int gi = i0 + il, gj = jb + jl;
          const bool row_in = gi < n;
          af[h + 2 * hk] =
              b_bits(x0, row_in && gj < j_end, gi == gj, threshold, binarize)
              | (b_bits(x1, row_in && gj + 1 < j_end, gi == gj + 1,
                        threshold, binarize) << 16);
        }
      }
  };

  // ---- raw stage -> bf16 tiles: the wide tile's A (binarized), an f32
  // t on every tile ----
  auto convert = [&](int st, int buf, int jb, auto fast_c) {
    if constexpr (C::WIDE) {
      const TA* sa = a_stage(st);
      __nv_bfloat16* ab = sAb + buf * L::AB_TILE;
      constexpr int A_GROUPS = L::A_ROWS * L::A_COLS / 4;
      static_assert(A_GROUPS % THREADS == 0, "conversion split");
#pragma unroll
      for (int q = 0; q < A_GROUPS / THREADS; ++q) {
        const int grp = tid + q * THREADS;
        const int r = grp / (L::A_COLS / 4);
        const int col = (grp % (L::A_COLS / 4)) * 4;
        float x[4];
        if constexpr (L::AES == 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(sa + r * A_LD + col);
          x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
        } else {
          const char4 v =
              *reinterpret_cast<const char4*>(sa + r * A_LD + col);
          x[0] = to_f32(static_cast<int8_t>(v.x));
          x[1] = to_f32(static_cast<int8_t>(v.y));
          x[2] = to_f32(static_cast<int8_t>(v.z));
          x[3] = to_f32(static_cast<int8_t>(v.w));
        }
        uint2 bits;
        if constexpr (decltype(fast_c)::value) {
          bits = make_uint2(pair_bits(x[0], x[1], threshold, binarize),
                            pair_bits(x[2], x[3], threshold, binarize));
        } else {
          uint32_t b[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gi = TRANS ? i0 + r : i0 + col + e;
            const int gj = TRANS ? jb + col + e : jb + r;
            b[e] = b_bits(x[e], gi < n && gj < j_end, gi == gj, threshold,
                          binarize);
          }
          bits = make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
        }
        *reinterpret_cast<uint2*>(ab + r * AB_LD + col) = bits;
      }
    }
    if constexpr (L::T_F32) {
      const float* stt = reinterpret_cast<const float*>(t_stage(st));
      __nv_bfloat16* tb = sTb + buf * L::B_TILE;
      constexpr int GROUPS = BK * BN / 4;
      static_assert(GROUPS < THREADS || GROUPS % THREADS == 0, "split");
#pragma unroll
      for (int q = 0; q < (GROUPS + THREADS - 1) / THREADS; ++q) {
        const int grp = tid + q * THREADS;
        if (GROUPS < THREADS && grp >= GROUPS) break;
        const int r = grp / (BN / 4), col = (grp % (BN / 4)) * 4;
        const float4 v =
            *reinterpret_cast<const float4*>(stt + r * T_LD + col);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
        *reinterpret_cast<uint2*>(tb + r * B_LD + col) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  };

  // ---- MMAs of one step: out += B^T t ----
  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

  auto mma_step = [&](int st, int buf, int jb, auto fast_c) {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
      if constexpr (C::WIDE) {
        const __nv_bfloat16* ab = sAb + buf * L::AB_TILE;
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int m0 = wm * C::WTM + mi * 16;
          if constexpr (TRANS)          // [i][j]
            ldmatrix_x4(af[mi], ab + (m0 + (lane & 15)) * AB_LD + kk
                                    + (lane >> 4) * 8);
          else                          // [j][i]
            ldmatrix_x4_trans(af[mi],
                              ab + (kk + (lane & 7) + ((lane >> 4) << 3))
                                       * AB_LD
                                 + m0 + ((lane >> 3) & 1) * 8);
        }
      } else {
        a_frag_raw(af[0], a_stage(st), kk, jb, fast_c);
      }
      {
        // t's bf16 tile: converted from f32, or a bf16 t's stage in place
        const __nv_bfloat16* tb =
            L::T_F32 ? sTb + buf * L::B_TILE
                     : reinterpret_cast<const __nv_bfloat16*>(t_stage(st));
        constexpr int LD = L::T_F32 ? B_LD : T_LD;
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, tb + (kk + (lane & 15)) * LD + wn * C::WTN
                                   + j * 8 + (lane >> 4) * 8);
          bf[j][0] = r[0];
          bf[j][1] = r[1];
          if (j + 1 < NT) {
            bf[j + 1][0] = r[2];
            bf[j + 1][1] = r[3];
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni][0], bf[ni][1]);
    }
  };

  // ---- the pipeline: the copy for step k + STAGES - 1 is issued after
  // step k's first barrier. The wide tile converts step k + 1 after step
  // k's MMAs, into the other bf16 buffers, so one barrier a step serves
  // both; the skinny tiles convert an f32 t's step k between two ----
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, j_begin + s * BK);
    cp_async_commit();
  }
  using Fast = std::true_type;
  using Slow = std::false_type;
  // A's tile of the step at jb lies inside the matrix and off the
  // diagonal: no index checks
  auto interior = [&](int jb) {
    return i0 + BM <= n && jb + BK <= j_end &&
           (jb + BK <= i0 || jb >= i0 + BM);
  };
  if constexpr (C::WIDE) {
    cp_async_wait<STAGES - 2>();       // step 0
    __syncthreads();
    if (k_tiles > 0) convert(0, 0, j_begin, Slow{});
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    // landed for every thread: step kt (skinny) or kt + 1 (wide); and
    // every thread is done with step kt - 1, whose stage and bf16 tiles
    // are rewritten below
    if constexpr (C::WIDE) cp_async_wait<STAGES - 3>();
    else                   cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < k_tiles) load_stage(nk % STAGES, j_begin + nk * BK);
    cp_async_commit();
    const int jb = j_begin + kt * BK;
    if constexpr (C::WIDE) {
      // one straight-line block, so the compiler interleaves the two; past
      // the last step the conversion reads a spent stage into a tile that
      // is never used
      const int st = (kt + 1) % STAGES, buf = (kt + 1) & 1;
      if (interior(jb + BK)) {
        mma_step(kt % STAGES, kt & 1, jb, Fast{});
        convert(st, buf, jb + BK, Fast{});
      } else {
        mma_step(kt % STAGES, kt & 1, jb, Fast{});
        convert(st, buf, jb + BK, Slow{});
      }
    } else {
      if constexpr (L::T_F32) {
        convert(kt % STAGES, 0, jb, Fast{});
        __syncthreads();
      }
      if (interior(jb)) mma_step(kt % STAGES, 0, jb, Fast{});
      else              mma_step(kt % STAGES, 0, jb, Slow{});
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: acc[mi][ni] holds rows g, g + 8 and columns 2 tq, + 1 of
  // its 16 x 8 tile ----
  const int im = wm * C::WTM, cn = wn * C::WTN;
  const bool even = d % 2 == 0;     // pairs of out are aligned: 2-wide stores
  if (split == 1) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long i = i0 + im + mi * 16 + g + 8 * h;
        if (i >= n) continue;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int c = c0 + cn + ni * 8 + 2 * tq;
          const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
          if (even && c + 1 < d) {
            store2(out + i * d + c, v0, v1);
          } else {
            if (c < d) store(out + i * d + c, v0);
            if (c + 1 < d) store(out + i * d + c + 1, v1);
          }
        }
      }
    return;
  }
  // split-K: the partial tile in this block's shared memory, then rows
  // part / split of the tile summed over the cluster in rank order
  __syncthreads();                       // every warp is done with the ring
  float* partial = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        *reinterpret_cast<float2*>(
            partial + (im + mi * 16 + g + 8 * h) * BN + cn + ni * 8
            + 2 * tq) = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = (BM + split - 1) / split;
  const int r_begin = part * rows;
  const int r_end = min(BM, r_begin + rows);
  for (int idx = tid; idx < (r_end - r_begin) * BN; idx += THREADS) {
    const int il = r_begin + idx / BN, cl = idx % BN;
    const long long i = i0 + il;
    const int c = c0 + cl;
    if (i >= n || c >= d) continue;
    float v[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      v[q] = q < split ? cluster.map_shared_rank(partial, q)[il * BN + cl]
                       : 0.f;
    float s = v[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q)
      if (q < split) s += v[q];
    store(out + i * d + c, s);
  }
  cluster.sync();                        // the partials stay until read
}

// ---- launch ----

struct Args {
  const void* A; const void* t; void* out;
  int n, d, split, k_per_split;
  float threshold;
  int binarize, vec_a, vec_t;
  cudaStream_t stream;
};

template <typename TA, typename TT, class C, bool TRANS>
cudaError_t launch(const Args& a) {
  using L = Layout<TA, TT, C, TRANS>;
  if (a.k_per_split % L::BK != 0) return cudaErrorInvalidValue;
  auto kernel = core_kernel<TA, TT, C, TRANS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return e;
  const long long row_tiles = (a.n + BM - 1) / BM;
  const long long col_tiles = (a.d + C::BN - 1) / C::BN;
  if (row_tiles * a.split > INT_MAX || col_tiles > 65535)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(row_tiles * a.split),
                     static_cast<unsigned>(col_tiles), 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TA*>(a.A),
                         static_cast<const TT*>(a.t), static_cast<TT*>(a.out),
                         a.n, a.d, a.split, a.k_per_split, a.threshold,
                         a.binarize, a.vec_a, a.vec_t);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename TA, typename TT, bool TRANS>
cudaError_t by_tile(int bn, const Args& a) {
  switch (bn) {
    case 8:   return launch<TA, TT, Tile<8, false>, TRANS>(a);
    case 32:  return launch<TA, TT, Tile<32, false>, TRANS>(a);
    case 64:  return launch<TA, TT, Tile<64, false>, TRANS>(a);
    case 128: return launch<TA, TT, Tile<128, true>, TRANS>(a);
    case 256: return launch<TA, TT, Tile<256, true>, TRANS>(a);
    default:  return cudaErrorInvalidValue;
  }
}

template <typename TA, typename TT>
cudaError_t by_trans(int transpose, int bn, const Args& a) {
  return transpose ? by_tile<TA, TT, true>(bn, a)
                   : by_tile<TA, TT, false>(bn, a);
}

}  // namespace

extern "C" {

// a_dtype: 0 = float32, 1 = int8. t_dtype: 0 = float32, 1 = bfloat16; out
// (n, d) has t's dtype. bn: the column tile, 8, 32 or 64 (skinny) or 128
// or 256 (wide). j is split into `split` ranges of k_per_split (a multiple
// of the tile's K step: skinny 32 for f32 A, 64 for int8; wide 16), none
// empty, split <= 8 (one cluster). vec_a, vec_t: copy widths in bytes (A:
// 16, 8, 4, or 2 and 1 for int8; t: 16, 8, 4, or 2 for bf16), which must
// divide the pointer and the row length in bytes.
int core_spmm_launch(const void* A, int a_dtype, const void* t, int t_dtype,
                     void* out, int n, int d, int bn, int split,
                     int k_per_split, int vec_a, int vec_t, float threshold,
                     int binarize, int transpose, void* stream) {
  const int aes = a_dtype == 0 ? 4 : 1, tes = t_dtype == 0 ? 4 : 2;
  auto legal = [](int vec, int es, const void* p, long long row_bytes) {
    return (vec == 1 || vec == 2 || vec == 4 || vec == 8 || vec == 16) &&
           vec >= es &&
           ((reinterpret_cast<uintptr_t>(p) |
             static_cast<uintptr_t>(row_bytes)) % vec) == 0;
  };
  if (n <= 0 || d <= 0 || (a_dtype != 0 && a_dtype != 1) ||
      (t_dtype != 0 && t_dtype != 1) || split < 1 || split > MAX_SPLIT ||
      k_per_split <= 0 ||
      static_cast<long long>(split - 1) * k_per_split >= n ||
      static_cast<long long>(split) * k_per_split < n ||
      !legal(vec_a, aes, A, static_cast<long long>(n) * aes) ||
      !legal(vec_t, tes, t, static_cast<long long>(d) * tes))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{A, t, out, n, d, split, k_per_split, threshold, binarize, vec_a,
         vec_t, static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (a_dtype == 0 && t_dtype == 0)
    e = by_trans<float, float>(transpose, bn, a);
  else if (a_dtype == 0)
    e = by_trans<float, __nv_bfloat16>(transpose, bn, a);
  else if (t_dtype == 0)
    e = by_trans<int8_t, float>(transpose, bn, a);
  else
    e = by_trans<int8_t, __nv_bfloat16>(transpose, bn, a);
  return static_cast<int>(e);
}

}  // extern "C"
