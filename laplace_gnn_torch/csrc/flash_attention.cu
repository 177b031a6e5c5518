// Masked GAT attention for Hopper: an online-softmax forward and a flash
// backward, both reading the dense adjacency only through adj > 0.
//
// Replaces the Pallas TPU kernels of laplace_gnn_tpu/ops/pallas_attention.py:
//   flash_fwd_kernel  <- _flash_kernel      (launched by _flash_fwd_pallas_aux)
//   flash_bwd_kernel  <- _flash_bwd_kernel  (launched by _flash_bwd_pallas)
//
// Forward, for target row i < R, head h and source column j < N:
//   s = leaky_relu(a_src[j, h] + a_dst[i, h]) on the entries with adj[i, j] > 0
//   m[h, i] = max(max_j s, -1e30),  l[h, i] = sum_j exp(s - m),
//   out[i, h, :] = sum_j exp(s - m) x[j, h, :] / l   (0 where l = 0).
// Backward, from the saved m, linv = 1/l (0 where l = 0) and D = rowsum(g out):
//   p = exp(act - m) linv,  dp = g[i, h] . x[j, h],  dz = p (dp - D) leaky'(z),
//   d_a_src[j, h] = sum_i dz,  d_a_dst[i, h] = sum_j dz,
//   d_x[j, h] = sum_i p g[i, h].
//
// What bounds it on this card. On the dense-GAT graphs (N = 2708 and 16384,
// ~9 and ~47 edges a row with self-loops) the arithmetic is a few million
// (edge, head) pairs, and each kernel is bound by reading the R x N
// adjacency once: 1.07 GB of float32 at N = 16384 (0.27 GB of int8), 0.32 ms
// at 3.35 TB/s; 29 MB at N = 2708, 9 us. So the design keeps enough of the
// adjacency in flight on enough SMs, and keeps the edges' gathers (a_src,
// x, g and the row statistics, from L2) off the stream's critical path:
//  - The adjacency stream. Each block walks its axis in tiles that pass
//    through a ring of STAGES shared-memory slots filled by cp.async (16,
//    8 or 4 bytes a copy, or 2- and 1-byte register loads, from the plan's
//    copy width: pointer | row bytes), two tiles in flight while the third
//    is worked on. A warp builds a 32-column word of a row with one ballot;
//    the backward also builds 32-row words of a column from 16-byte (f32)
//    or 4-byte (int8, __vcmpgts4) reads of 32 rows and a ballot a column.
//    __syncthreads_or skips the rest of a tile with no edge.
//  - The edges of a tile. The forward's (row, head) threads take their
//    row's edges BATCH at a time, the loads of a batch (a_src and the x
//    row) in flight together. In the backward, one warp turns the row bits
//    into a row-major index (a prefix sum of the rows' edge counts); each
//    (edge, head) item, its dz and p g, is computed by one thread with the
//    loads of every item in flight at once, into the tile's slot, which
//    its bits have replaced; the folds then read shared memory in a fixed
//    order. The items go in chunks of whole rows when a tile holds more
//    than a slot (dense graphs).
//  - The forward. A block owns up to 8 target rows x every head, one
//    thread a (row, head) pair (64 threads at 8 heads: an SM holds 8 such
//    blocks, or 16 of 4 rows where the plan halves them, so one block's
//    wait on its gathers hides behind the others' streams), and walks
//    source tiles of 1 KB of each row (256 f32 or 1024
//    int8 columns); each thread folds its row's edges into (m, l, acc[F])
//    in column order, rescaling when the running max grows. When the row
//    blocks fill less than a wave (N = 2708: 339 blocks for 1056 places),
//    the plan splits the source axis into S <= 8 ranges of whole tiles
//    (flash decoding); the S blocks of a row block form one
//    thread-block cluster, and after a cluster barrier block s merges its
//    share of the pairs over the S partials, read through distributed
//    shared memory in rank order: m = max_s m_s, l = sum_s l_s e^(m_s - m),
//    out = sum_s acc_s e^(m_s - m) / l. An empty range has m_s = -1e30,
//    l_s = 0, so m stays exact and a row with no edge gets l = 0 and
//    out = 0. Every output is written once.
//  - The backward. A block owns up to 128 source columns (512 bytes of an
//    f32 row) x every head and walks target tiles of 64 (f32) or 128 (int8)
//    rows. A row fold sums dz of (row, head) over the block's columns into
//    a partial of d_a_dst, written to a workspace (n_col_blocks, R, H) (0
//    for a tile without an edge); a column fold sums d_a_src and d_x of a
//    thread's few (column, head) pairs in registers over the block's target
//    range. When the column blocks fill less than a wave, the target axis
//    is split into S <= 8 ranges, whose partials of d_a_src and d_x go to
//    a workspace. A second small kernel sums the d_a_dst partials over the
//    column blocks and those over the S ranges, each in order (measured
//    faster than a sum in one cluster through distributed shared memory:
//    the d_a_dst partials need the second launch anyway). No atomics: two
//    calls give the same bits.
// With bf16 != 0 the operands of the p.x, g.x and p.g products are rounded
// to bf16 before float32 FMAs; else all is float32, with no TF32.
//
// The wrapper's plan (ops/flash_attention.py::plan) chooses the block,
// split and copy width; this file owns the tiles and the ring depth, which
// the plan mirrors. The C entry points launch on the caller's stream,
// allocate nothing and return the first CUDA error.

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

constexpr int THREADS = 256;        // a backward block; a forward one at most
constexpr int STAGES = 3;           // the adjacency ring
constexpr int MAX_SPLIT = 8;        // the portable cluster size
constexpr int FWD_MAX_ROWS = 8;     // target rows a forward block
constexpr int FWD_ROW_BYTES = 1024; // bytes of a row in a forward tile
constexpr int BWD_MAX_COLS = 128;   // source columns a backward block
constexpr float NEG_BIG = -1e30f;

template <typename T> struct Adj;
template <> struct Adj<float> {
  static constexpr int BWD_ROWS = 64;     // target rows a backward tile
};
template <> struct Adj<int8_t> {
  static constexpr int BWD_ROWS = 128;
};

// compiled feature width FB: (column, head) pairs a backward thread
// accumulates, edges whose loads a forward thread issues together, and
// the blocks of 256 threads an SM holds (the plan mirrors PAIRS and
// MIN_BLOCKS)
template <int FB> struct Feat {
  static constexpr int PAIRS = FB <= 8 ? 4 : (FB <= 16 ? 2 : 1);
  static constexpr int BATCH = FB <= 8 ? 4 : (FB <= 16 ? 2 : 1);
  static constexpr int MIN_BLOCKS = FB <= 16 ? 2 : 1;
};

__device__ __forceinline__ float leaky(float z, float slope) {
  return z >= 0.f ? z : slope * z;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---- the adjacency stream ----

// Rows [row0, row0 + rows) x bytes [cb0, cb0 + seg) of the row-major
// matrix m (pitch bytes a row; rows below row_lim and bytes below row_end
// exist, the rest read 0) into a stage of ld bytes a row, in 16-byte
// chunks of copies of VEC bytes (seg a multiple of 16).
template <int VEC>
__device__ __forceinline__ void copy_rows(unsigned char* stage, int ld,
                                          const unsigned char* m,
                                          long long pitch, long long row0,
                                          long long row_lim, long long cb0,
                                          long long row_end, int rows,
                                          int seg, int nt) {
  const int cpr = seg / 16;
  for (int c = threadIdx.x; c < rows * cpr; c += nt) {
    const int rr = c / cpr, cb = (c - rr * cpr) * 16;
    const long long row = row0 + rr, col = cb0 + cb;
    const int avail =
        row < row_lim ? static_cast<int>(min(max(row_end - col, 0LL), 16LL))
                      : 0;
    fill16<VEC>(stage + rr * ld + cb, m + row * pitch + col, avail, m);
  }
}

__device__ __forceinline__ void copy_tile(int vec, unsigned char* stage,
                                          int ld, const unsigned char* m,
                                          long long pitch, long long row0,
                                          long long row_lim, long long cb0,
                                          long long row_end, int rows,
                                          int seg, int nt) {
  switch (vec) {
    case 16: copy_rows<16>(stage, ld, m, pitch, row0, row_lim, cb0, row_end,
                           rows, seg, nt); break;
    case 8:  copy_rows<8>(stage, ld, m, pitch, row0, row_lim, cb0, row_end,
                          rows, seg, nt); break;
    case 4:  copy_rows<4>(stage, ld, m, pitch, row0, row_lim, cb0, row_end,
                          rows, seg, nt); break;
    case 2:  copy_rows<2>(stage, ld, m, pitch, row0, row_lim, cb0, row_end,
                          rows, seg, nt); break;
    default: copy_rows<1>(stage, ld, m, pitch, row0, row_lim, cb0, row_end,
                          rows, seg, nt); break;
  }
}

// v[0, f) = p[0, f), in 16-byte loads when f is a multiple of 4 (the rows of
// x and g then start 16-byte aligned), the rest of v[FB] zero
template <int FB>
__device__ __forceinline__ void load_row(const float* __restrict__ p, int f,
                                         float (&v)[FB]) {
  if constexpr (FB % 4 == 0) {
    if (f % 4 == 0) {
#pragma unroll
      for (int q = 0; q < FB; q += 4) {
        const float4 w = q < f ? __ldg(reinterpret_cast<const float4*>(p + q))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        v[q] = w.x; v[q + 1] = w.y; v[q + 2] = w.z; v[q + 3] = w.w;
      }
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < FB; ++q) v[q] = q < f ? __ldg(p + q) : 0.f;
}

// ---- bits and the tile's edge index ----

// bits[rr * wpr + w], bit b = (row rr, column 32 w + b) of the stage has
// a > 0, for columns below cols; one ballot a word, warp w of the block's
// nt / 32 taking rows w, w + nt / 32, ... Returns whether this warp saw an
// edge.
template <typename T>
__device__ __forceinline__ bool row_bits(const unsigned char* stage, int ld,
                                         int rows, int cols, int wpr,
                                         uint32_t* bits, int nt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool any = false;
  for (int rr = warp; rr < rows; rr += nt / 32) {
    const T* row = reinterpret_cast<const T*>(stage + rr * ld);
    for (int w = 0; w < wpr; ++w) {
      const int c = w * 32 + lane;
      const uint32_t word =
          __ballot_sync(0xffffffffu, c < cols && row[c] > 0);
      if (lane == 0) bits[rr * wpr + w] = word;
      any |= word != 0;
    }
  }
  return any;
}

// bits[c * groups + rg], bit b = (row 32 rg + b, column c) of the stage has
// a > 0, for columns below cols: lane b reads 4 columns of row 32 rg + b
// (16 bytes of f32, 4 of int8) and a ballot a column makes the word.
template <typename T>
__device__ __forceinline__ void col_bits(const unsigned char* stage, int ld,
                                         int groups, int cols,
                                         uint32_t* bits) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int quads = (cols + 3) / 4;
  for (int rg = 0; rg < groups; ++rg) {
    const unsigned char* p = stage + (rg * 32 + lane) * ld;
    for (int qd = warp; qd < quads; qd += THREADS / 32) {
      const int c0 = qd * 4;
      uint32_t w[4];
      if constexpr (std::is_same<T, float>::value) {
        const float4 v = *reinterpret_cast<const float4*>(p + c0 * 4);
        w[0] = __ballot_sync(0xffffffffu, v.x > 0.f);
        w[1] = __ballot_sync(0xffffffffu, v.y > 0.f);
        w[2] = __ballot_sync(0xffffffffu, v.z > 0.f);
        w[3] = __ballot_sync(0xffffffffu, v.w > 0.f);
      } else {
        const uint32_t v =
            __vcmpgts4(*reinterpret_cast<const uint32_t*>(p + c0), 0u);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          w[k] = __ballot_sync(0xffffffffu, (v >> (8 * k)) & 0x80u);
      }
      if (lane < 4 && c0 + lane < cols) {
        const uint32_t word = lane == 0 ? w[0] : lane == 1 ? w[1]
                            : lane == 2 ? w[2] : w[3];
        bits[(c0 + lane) * groups + rg] = word;
      }
    }
  }
}

// start[rr] = the edges of rows < rr (rows <= 128), start[rows] = all the
// tile's edges: the row-major index of the tile's edges. One warp.
__device__ __forceinline__ void index_rows(const uint32_t* bits, int rows,
                                           int wpr, int* start) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int c[4], sum = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int rr = lane * 4 + k;
    int v = 0;
    if (rr < rows)
      for (int w = 0; w < wpr; ++w) v += __popc(bits[rr * wpr + w]);
    c[k] = v;
    sum += v;
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  int run = incl - sum;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int rr = lane * 4 + k;
    if (rr < rows) start[rr] = run;
    run += c[k];
  }
  if (lane == 31) start[rows] = run;
}

// (row, column) of the tile's edge e < start[rows] in row-major order
__device__ __forceinline__ void locate(const uint32_t* bits, const int* start,
                                       int rows, int wpr, int e, int& rr,
                                       int& col) {
  int lo = 0, hi = rows - 1;         // the last row that starts at or before e
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= e) lo = mid;
    else                 hi = mid - 1;
  }
  rr = lo;
  int k = e - start[lo];
  const uint32_t* row = bits + lo * wpr;
  for (int w = 0;; ++w) {
    uint32_t b = row[w];
    const int c = __popc(b);
    if (k < c) {
      for (; k > 0; --k) b &= b - 1;        // drop the k lowest edges
      col = w * 32 + __ffs(b) - 1;
      return;
    }
    k -= c;
  }
}

// ---- forward ----

// smem: a ring of STAGES tiles (rows x 1 KB) and the tile's bits; with a
// split, reused for each pair's (m, l, acc[FB]) partial
template <typename T, int FB>
struct FwdLayout {
  static constexpr int TN = FWD_ROW_BYTES / static_cast<int>(sizeof(T));
  static constexpr int WORDS = TN / 32;
  static int bytes(int rows, int split, int nt) {
    const int main = STAGES * rows * FWD_ROW_BYTES + rows * WORDS * 4;
    const int partial = split > 1 ? nt * (FB + 2) * 4 : 0;
    return main > partial ? main : partial;
  }
};

// Block b: target rows (b / split) * rows .. + rows, every head, source
// columns [part * per_split, + per_split) with part = b % split; rows x
// heads pairs rounded up to whole warps of threads (64 at 8 heads), so an
// SM holds many small blocks whose barriers span few warps. Thread t owns
// (row t / heads, head t % heads) and walks its row's edges in a tile
// BATCH at a time, the loads of a batch issued together.
template <typename T, int FB>
__global__ void __launch_bounds__(THREADS, Feat<FB>::MIN_BLOCKS)
flash_fwd_kernel(const float* __restrict__ a_src,
                 const float* __restrict__ a_dst, const T* __restrict__ adj,
                 const float* __restrict__ x, float* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int n,
                 int r, int heads, int f, int rows, int split, int per_split,
                 float slope, int bf16, int vec) {
  using L = FwdLayout<T, FB>;
  constexpr int TN = L::TN, WORDS = L::WORDS;
  constexpr int BATCH = Feat<FB>::BATCH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int slot = rows * FWD_ROW_BYTES;
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + STAGES * slot);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int part = blockIdx.x % split;
  const int row0 = (blockIdx.x / split) * rows;
  const int c_begin = part * per_split;
  const int c_end = min(n, c_begin + per_split);
  const int tiles = (c_end - c_begin + TN - 1) / TN;
  const int rr = tid / heads, hd = tid - rr * heads;
  const int i = row0 + rr;
  const bool active = rr < rows && i < r;
  const float adst = active ? a_dst[(size_t)i * heads + hd] : 0.f;
  float mrun = NEG_BIG, lrun = 0.f, acc[FB];
#pragma unroll
  for (int q = 0; q < FB; ++q) acc[q] = 0.f;

  const unsigned char* a = reinterpret_cast<const unsigned char*>(adj);
  const long long pitch = static_cast<long long>(n) * sizeof(T);
  auto load = [&](int t) {
    copy_tile(vec, smem + (t % STAGES) * slot, FWD_ROW_BYTES, a, pitch,
              row0, r, static_cast<long long>(c_begin + t * TN) * sizeof(T),
              pitch, rows, FWD_ROW_BYTES, nt);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    // tile t has landed for every thread, and every thread is done with
    // tile t - 1 (its slot is refilled below, its bits rewritten)
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < tiles) load(t + STAGES - 1);
    cp_async_commit();
    unsigned char* st = smem + (t % STAGES) * slot;
    const bool any =
        row_bits<T>(st, FWD_ROW_BYTES, rows, TN, WORDS, bits, nt);
    if (!__syncthreads_or(any)) continue;     // no edge in this tile
    if (!active) continue;
    const int cb = c_begin + t * TN;
    // the row's edges in this tile, BATCH at a time: a batch's loads are
    // issued together, then folded in column order
    int js[BATCH];
    int nb = 0;
    auto fold = [&](int cnt) {
      float sv[BATCH], xv[BATCH][FB];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        if (k < cnt) {
          const size_t jh = (size_t)js[k] * heads + hd;
          sv[k] = __ldg(a_src + jh);
          load_row<FB>(x + jh * f, f, xv[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        if (k < cnt) {
          const float s = leaky(sv[k] + adst, slope);
          if (s > mrun) {                     // the running max grows
            const float c = expf(mrun - s);
            lrun *= c;
#pragma unroll
            for (int q = 0; q < FB; ++q) acc[q] *= c;
            mrun = s;
          }
          const float p = expf(s - mrun);
          lrun += p;
          const float pc = bf16 ? round_bf16(p) : p;
#pragma unroll
          for (int q = 0; q < FB; ++q)
            if (q < f)
              acc[q] = fmaf(pc, bf16 ? round_bf16(xv[k][q]) : xv[k][q],
                            acc[q]);
        }
      }
    };
#pragma unroll 1
    for (int w = 0; w < WORDS; ++w) {
      uint32_t b = bits[rr * WORDS + w];
      while (b) {
        const int j = cb + w * 32 + __ffs(b) - 1;
        b &= b - 1;
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
          if (k == nb) js[k] = j;
        if (++nb == BATCH) {
          fold(BATCH);
          nb = 0;
        }
      }
    }
    if (nb) fold(nb);
  }
  cp_async_wait<0>();

  if (split == 1) {
    if (active) {
      const float den = lrun == 0.f ? 1.f : lrun;
      float* o = out + ((size_t)i * heads + hd) * f;
#pragma unroll
      for (int q = 0; q < FB; ++q)
        if (q < f) o[q] = acc[q] / den;
      m_out[(size_t)hd * r + i] = mrun;
      l_out[(size_t)hd * r + i] = lrun;
    }
    return;
  }
  // the split: each block's partials in its shared memory, then block
  // `part` merges pairs [part * share, + share) over the cluster's ranks in
  // order 0 .. split - 1
  __syncthreads();                            // the ring is spent
  float* pm = reinterpret_cast<float*>(smem);
  float* pl = pm + nt;
  float* pacc = pl + nt;
  pm[tid] = mrun;
  pl[tid] = lrun;
#pragma unroll
  for (int q = 0; q < FB; ++q) pacc[tid * FB + q] = acc[q];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int pairs = rows * heads;
  const int share = (pairs + split - 1) / split;
  const int p = part * share + tid;
  if (tid < share && p < pairs && row0 + p / heads < r) {
    const int ii = row0 + p / heads, hh = p % heads;
    float ms[MAX_SPLIT];
    float mx = NEG_BIG;
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      ms[s] = s < split ? cluster.map_shared_rank(pm, s)[p] : NEG_BIG;
      mx = fmaxf(mx, ms[s]);
    }
    float l = 0.f, o[FB];
#pragma unroll
    for (int q = 0; q < FB; ++q) o[q] = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLIT; ++s) {
      if (s < split) {
        const float c = expf(ms[s] - mx);
        l = fmaf(cluster.map_shared_rank(pl, s)[p], c, l);
        const float* ac = cluster.map_shared_rank(pacc, s) + p * FB;
#pragma unroll
        for (int q = 0; q < FB; ++q)
          if (q < f) o[q] = fmaf(ac[q], c, o[q]);
      }
    }
    const float den = l == 0.f ? 1.f : l;
    float* op = out + ((size_t)ii * heads + hh) * f;
#pragma unroll
    for (int q = 0; q < FB; ++q)
      if (q < f) op[q] = o[q] / den;
    m_out[(size_t)hh * r + ii] = mx;
    l_out[(size_t)hh * r + ii] = l;
  }
  cluster.sync();                             // partials stay until read
}

// ---- backward ----

// smem: a ring of STAGES slots, each the larger of a tile (BWD_ROWS rows of
// ld bytes: the block's columns rounded up to 16 bytes, + 16 so that
// 16-byte reads of 32 rows hit distinct banks) and the items of one full
// row (cols x heads, d_z then p g[FB] each); the row bits, the column bits
// and the row index.
template <typename T, int FB>
struct BwdLayout {
  static constexpr int TR = Adj<T>::BWD_ROWS;
  static constexpr int GROUPS = TR / 32;
  __host__ __device__ static int seg(int cols) {
    return (cols * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  }
  __host__ __device__ static int ld(int cols) { return seg(cols) + 16; }
  __host__ __device__ static int wpr(int cols) { return (cols + 31) / 32; }
  __host__ __device__ static int slot(int cols, int heads) {
    const int tile = TR * ld(cols), items = cols * heads * (FB + 1) * 4;
    return ((tile > items ? tile : items) + 15) / 16 * 16;
  }
  __host__ __device__ static int rowb_at(int cols, int heads) {
    return STAGES * slot(cols, heads);
  }
  __host__ __device__ static int colb_at(int cols, int heads) {
    return rowb_at(cols, heads) + TR * wpr(cols) * 4;
  }
  __host__ __device__ static int start_at(int cols, int heads) {
    return colb_at(cols, heads) + cols * GROUPS * 4;
  }
  static int bytes(int cols, int heads) {
    return start_at(cols, heads) + (TR + 4) / 4 * 16;
  }
};

// Block b: source columns (b / split) * cols .. + cols, every head, target
// rows [part * per_split, + per_split) with part = b % split. A tile: its
// row and column bits; the row index of its edges; each (edge, head) item's
// d_z and p g, computed by one thread with every other item's loads in
// flight, into the tile's slot (in chunks of whole rows); then a row fold
// (d_a_dst of (row, head) over the block's columns, in column order, to
// the workspace) and a column fold (d_a_src and d_x of the thread's
// (column, head) pairs k * THREADS + t, k < PAIRS, in row order, in
// registers).
template <typename T, int FB>
__global__ void __launch_bounds__(THREADS, Feat<FB>::MIN_BLOCKS)
flash_bwd_kernel(const float* __restrict__ a_src,
                 const float* __restrict__ a_dst, const T* __restrict__ adj,
                 const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ m, const float* __restrict__ linv,
                 const float* __restrict__ dvec, float* __restrict__ d_asrc,
                 float* __restrict__ d_x, float* __restrict__ ws_adst,
                 float* __restrict__ ws_src, int n, int r, int heads, int f,
                 int cols, int split, int per_split, float slope, int bf16,
                 int vec) {
  using L = BwdLayout<T, FB>;
  constexpr int TR = L::TR, GROUPS = L::GROUPS;
  constexpr int PAIRS = Feat<FB>::PAIRS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = L::ld(cols), wpr = L::wpr(cols);
  const int slot = L::slot(cols, heads);
  uint32_t* rowb = reinterpret_cast<uint32_t*>(smem + L::rowb_at(cols, heads));
  uint32_t* colb = reinterpret_cast<uint32_t*>(smem + L::colb_at(cols, heads));
  int* start = reinterpret_cast<int*>(smem + L::start_at(cols, heads));
  // a chunk of items: ce >= cols edges x every head
  const int ce = slot / ((FB + 1) * 4) / heads;
  const int tid = threadIdx.x;
  const int part = blockIdx.x % split;
  const int cblk = blockIdx.x / split;
  const int col0 = cblk * cols;
  const int r_begin = part * per_split;
  const int r_end = min(r, r_begin + per_split);
  const int tiles = (r_end - r_begin + TR - 1) / TR;
  float* ws_d = ws_adst + (size_t)cblk * r * heads;

  float das[PAIRS], dx[PAIRS][FB];
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    das[k] = 0.f;
#pragma unroll
    for (int e = 0; e < FB; ++e) dx[k][e] = 0.f;
  }

  const unsigned char* a = reinterpret_cast<const unsigned char*>(adj);
  const long long pitch = static_cast<long long>(n) * sizeof(T);
  auto load = [&](int t) {
    copy_tile(vec, smem + (t % STAGES) * slot, ld, a, pitch,
              r_begin + t * TR, r,
              static_cast<long long>(col0) * sizeof(T), pitch, TR,
              L::seg(cols), THREADS);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < tiles) load(t + STAGES - 1);
    cp_async_commit();
    unsigned char* st = smem + (t % STAGES) * slot;
    const int row0 = r_begin + t * TR;
    const bool any = row_bits<T>(st, ld, TR, cols, wpr, rowb, THREADS);
    col_bits<T>(st, ld, GROUPS, cols, colb);
    if (!__syncthreads_or(any)) {             // no edge: a zero partial
      for (int p = tid; p < TR * heads; p += THREADS)
        if (row0 + p / heads < r) ws_d[(size_t)row0 * heads + p] = 0.f;
      continue;
    }
    index_rows(rowb, TR, wpr, start);
    __syncthreads();
    float* item_dz = reinterpret_cast<float*>(st);  // the tile is spent
    float* item_pg = item_dz + ce * heads;
    for (int r_lo = 0; r_lo < TR;) {
      // rows [r_lo, r_hi): the most whose edges fit one chunk (a row has at
      // most cols <= ce edges)
      const int e0 = start[r_lo];
      int lo = r_lo + 1, hi = TR;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (start[mid] - e0 <= ce) lo = mid;
        else                       hi = mid - 1;
      }
      const int r_hi = lo;
      const int ne = start[r_hi] - e0;
      if (r_lo > 0) __syncthreads();          // the last chunk is folded
      for (int it = tid; it < ne * heads; it += THREADS) {
        const int eh = it / heads, h = it - eh * heads;
        int er, col;
        locate(rowb, start, TR, wpr, e0 + eh, er, col);
        const int i = row0 + er;
        const size_t ih = (size_t)i * heads + h;
        const size_t jh = (size_t)(col0 + col) * heads + h;
        const size_t st_i = (size_t)h * r + i;
        const float z = __ldg(a_src + jh) + __ldg(a_dst + ih);
        const float mi = __ldg(m + st_i), li = __ldg(linv + st_i);
        const float di = __ldg(dvec + st_i);
        float gv[FB], xv[FB];
        load_row<FB>(g + ih * f, f, gv);
        load_row<FB>(x + jh * f, f, xv);
        if (bf16) {
#pragma unroll
          for (int q = 0; q < FB; ++q) {
            gv[q] = round_bf16(gv[q]);
            xv[q] = round_bf16(xv[q]);
          }
        }
        const float pr = expf(leaky(z, slope) - mi) * li;
        float dp = 0.f;
#pragma unroll
        for (int q = 0; q < FB; ++q) dp = fmaf(gv[q], xv[q], dp);
        item_dz[it] = pr * (dp - di) * (z >= 0.f ? 1.f : slope);
        const float pc = bf16 ? round_bf16(pr) : pr;
#pragma unroll
        for (int q = 0; q < FB; ++q)
          if (q < f) item_pg[it * FB + q] = pc * gv[q];
      }
      __syncthreads();
      // row fold: d_a_dst of (row, head) over the block's columns
      for (int p = r_lo * heads + tid; p < r_hi * heads; p += THREADS) {
        const int rr = p / heads, hd = p - rr * heads;
        if (row0 + rr >= r) continue;
        float sum = 0.f;
        for (int e = start[rr]; e < start[rr + 1]; ++e)
          sum += item_dz[(e - e0) * heads + hd];
        ws_d[(size_t)row0 * heads + p] = sum;
      }
      // column fold: d_a_src and d_x of (column, head) over the rows
#pragma unroll
      for (int k = 0; k < PAIRS; ++k) {
        const int q = k * THREADS + tid;
        const int cc = q / heads, hd = q - cc * heads;
        if (cc >= cols) continue;
        const int cw = cc >> 5;
        const uint32_t below = (1u << (cc & 31)) - 1u;
#pragma unroll
        for (int rg = 0; rg < GROUPS; ++rg) {
          uint32_t b = colb[cc * GROUPS + rg];
          while (b) {
            const int rr = rg * 32 + __ffs(b) - 1;
            b &= b - 1;
            if (rr < r_lo || rr >= r_hi) continue;   // not in this chunk
            // the edge's rank in its row: the row's bits before column cc
            const uint32_t* row = rowb + rr * wpr;
            int e = start[rr] + __popc(row[cw] & below);
            for (int w = 0; w < cw; ++w) e += __popc(row[w]);
            const int it = (e - e0) * heads + hd;
            das[k] += item_dz[it];
#pragma unroll
            for (int v = 0; v < FB; ++v)
              if (v < f) dx[k][v] += item_pg[it * FB + v];
          }
        }
      }
      r_lo = r_hi;
    }
  }
  cp_async_wait<0>();

  // d_a_src and d_x: written once (no split), or this range's partials,
  // which the reduce kernel sums in order
  const size_t nh = (size_t)n * heads;
  float* o_src = split == 1 ? d_asrc : ws_src + (size_t)part * nh * (f + 1);
  float* o_x = split == 1 ? d_x : o_src + nh;
#pragma unroll
  for (int k = 0; k < PAIRS; ++k) {
    const int q = k * THREADS + tid;
    const int cc = q / heads, hd = q - cc * heads;
    const int j = col0 + cc;
    if (cc >= cols || j >= n) continue;
    const size_t jh = (size_t)j * heads + hd;
    o_src[jh] = das[k];
#pragma unroll
    for (int e = 0; e < FB; ++e)
      if (e < f) o_x[jh * f + e] = dx[k][e];
  }
}

// d_a_dst[i, h] = sum over the column blocks c, in order, of ws_adst[c, i, h];
// with S > 1 target ranges, also d_a_src and d_x as the sums over s, in
// order, of their partials in ws_src
__global__ void __launch_bounds__(THREADS)
flash_bwd_reduce(const float* __restrict__ ws_adst, int col_blocks,
                 const float* __restrict__ ws_src, int split,
                 float* __restrict__ d_adst, float* __restrict__ d_asrc,
                 float* __restrict__ d_x, long long rh, long long nh,
                 long long nhf) {
  const long long total = rh + (split > 1 ? nh + nhf : 0);
  for (long long idx = blockIdx.x * (long long)THREADS + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * THREADS) {
    if (idx < rh) {
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < col_blocks; ++c) s += ws_adst[c * rh + idx];
      d_adst[idx] = s;
    } else {
      const long long e = idx - rh;
      float s = 0.f;
      for (int p = 0; p < split; ++p) s += ws_src[p * (nh + nhf) + e];
      if (e < nh) d_asrc[e] = s;
      else        d_x[e - nh] = s;
    }
  }
}

// ---- launch ----

struct Args {
  const float *a_src, *a_dst;
  const void* adj;
  const float *x, *g, *m, *linv, *dvec;
  float *out, *m_out, *l_out, *d_asrc, *d_adst, *d_x, *ws;
  int n, r, heads, f;
  float slope;
  int bf16, block, split, per_split, vec;
  cudaStream_t stream;
};

// a launch of `blocks` blocks of `threads`, in clusters of `cluster`
template <typename K, typename... A>
cudaError_t launch(K kernel, int blocks, int threads, int cluster, int smem,
                   cudaStream_t stream, A... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(static_cast<unsigned>(threads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int FB>
cudaError_t launch_fwd(const Args& a) {
  using L = FwdLayout<T, FB>;
  if (a.per_split % L::TN != 0) return cudaErrorInvalidValue;
  const long long blocks =
      static_cast<long long>((a.r + a.block - 1) / a.block) * a.split;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int nt = (a.block * a.heads + 31) / 32 * 32;
  return launch(flash_fwd_kernel<T, FB>, static_cast<int>(blocks), nt,
                      a.split, L::bytes(a.block, a.split, nt),
                      a.stream, a.a_src,
                      a.a_dst, static_cast<const T*>(a.adj), a.x, a.out,
                      a.m_out, a.l_out, a.n, a.r, a.heads, a.f, a.block,
                      a.split, a.per_split, a.slope, a.bf16, a.vec);
}

template <typename T, int FB>
cudaError_t launch_bwd(const Args& a) {
  using L = BwdLayout<T, FB>;
  if (a.per_split % L::TR != 0 ||
      static_cast<long long>(a.block) * a.heads >
          static_cast<long long>(THREADS) * Feat<FB>::PAIRS)
    return cudaErrorInvalidValue;
  const int col_blocks = (a.n + a.block - 1) / a.block;
  const long long blocks = static_cast<long long>(col_blocks) * a.split;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const long long rh = static_cast<long long>(a.r) * a.heads;
  const long long nh = static_cast<long long>(a.n) * a.heads;
  float* ws_src = a.ws + col_blocks * rh;
  cudaError_t e = launch(
      flash_bwd_kernel<T, FB>, static_cast<int>(blocks), THREADS, 1,
      L::bytes(a.block, a.heads), a.stream, a.a_src, a.a_dst,
      static_cast<const T*>(a.adj), a.x, a.g, a.m, a.linv, a.dvec, a.d_asrc,
      a.d_x, a.ws, ws_src, a.n, a.r, a.heads, a.f, a.block, a.split,
      a.per_split, a.slope, a.bf16, a.vec);
  if (e != cudaSuccess) return e;
  const long long total = rh + (a.split > 1 ? nh * (a.f + 1) : 0);
  const long long want = (total + THREADS - 1) / THREADS;
  const long long grid = want < 132LL * 16 ? want : 132LL * 16;
  flash_bwd_reduce<<<static_cast<unsigned>(grid), THREADS, 0, a.stream>>>(
      a.ws, col_blocks, ws_src, a.split, a.d_adst, a.d_asrc, a.d_x, rh, nh,
      nh * a.f);
  return cudaGetLastError();
}

// FB: the smallest of 1, 8, 16, 32, 64 that covers f
template <bool BWD, typename T>
cudaError_t dispatch_f(const Args& a) {
#define LAUNCH(FB) return BWD ? launch_bwd<T, FB>(a) : launch_fwd<T, FB>(a)
  if (a.f == 1)       LAUNCH(1);
  else if (a.f <= 8)  LAUNCH(8);
  else if (a.f <= 16) LAUNCH(16);
  else if (a.f <= 32) LAUNCH(32);
  else                LAUNCH(64);
#undef LAUNCH
}

template <bool BWD>
int dispatch(const Args& a, int adj_int8) {
  const int es = adj_int8 ? 1 : 4;
  const long long walked = BWD ? a.r : a.n;
  const bool legal_vec =
      (a.vec == 1 || a.vec == 2 || a.vec == 4 || a.vec == 8 || a.vec == 16) &&
      a.vec >= es &&
      ((reinterpret_cast<uintptr_t>(a.adj) |
        static_cast<uintptr_t>(static_cast<long long>(a.n) * es) |
        static_cast<uintptr_t>(BWD ? a.block * es : 0)) % a.vec) == 0;
  const bool legal_block = BWD
      ? a.block >= 1 && a.block <= BWD_MAX_COLS
      : a.block >= 1 && a.block <= FWD_MAX_ROWS && a.block * a.heads <= THREADS;
  if (a.n <= 0 || a.r <= 0 || a.heads <= 0 || a.heads > THREADS || a.f <= 0 ||
      a.f > 64 || !legal_vec || !legal_block || a.split < 1 ||
      a.split > MAX_SPLIT || a.per_split <= 0 ||
      static_cast<long long>(a.split - 1) * a.per_split >= walked ||
      static_cast<long long>(a.split) * a.per_split < walked)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = adj_int8 ? dispatch_f<BWD, int8_t>(a)
                                 : dispatch_f<BWD, float>(a);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// a_src (n, heads), a_dst (r, heads), adj (r, n) float32 or int8
// (adj_int8 = 1), x (n, heads, f) -> out (r, heads, f), m and l (heads, r),
// all float32 and contiguous, each written once. rows: target rows a block
// (a power of two <= 32, rows * heads <= 256); the source axis is split
// into `split` <= 8 ranges of per_split columns (whole tiles of 256 f32 or
// 1024 int8 columns), none empty; vec: the copy width in bytes, which
// divides the pointer and the row length in bytes.
int flash_fwd_launch(const float* a_src, const float* a_dst, const void* adj,
                     const float* x, float* out, float* m, float* l,
                     int adj_int8, int n, int r, int heads, int f,
                     float slope, int bf16, int rows, int split,
                     int per_split, int vec, void* stream) {
  Args a{};
  a.a_src = a_src; a.a_dst = a_dst; a.adj = adj; a.x = x;
  a.out = out; a.m_out = m; a.l_out = l;
  a.n = n; a.r = r; a.heads = heads; a.f = f; a.slope = slope; a.bf16 = bf16;
  a.block = rows; a.split = split; a.per_split = per_split; a.vec = vec;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(a, adj_int8);
}

// the forward's inputs, g (r, heads, f), m, linv and dvec = rowsum(g out)
// (heads, r) -> d_a_src (n, heads), d_a_dst (r, heads), d_x (n, heads, f),
// each written once. cols: source columns a block (<= 128, cols * heads
// within the threads' pairs); the target axis is split into `split` <= 8
// ranges of per_split rows (whole tiles of 64 f32 or 128 int8 rows), none
// empty. ws: ceil(n / cols) * r * heads floats, + split * n * heads *
// (f + 1) when split > 1. Two launches: the kernel and the reduce.
int flash_bwd_launch(const float* a_src, const float* a_dst, const void* adj,
                     const float* x, const float* g, const float* m,
                     const float* linv, const float* dvec, float* d_asrc,
                     float* d_adst, float* d_x, float* ws, int adj_int8, int n,
                     int r, int heads, int f, float slope, int bf16, int cols,
                     int split, int per_split, int vec, void* stream) {
  Args a{};
  a.a_src = a_src; a.a_dst = a_dst; a.adj = adj; a.x = x; a.g = g;
  a.m = m; a.linv = linv; a.dvec = dvec;
  a.d_asrc = d_asrc; a.d_adst = d_adst; a.d_x = d_x; a.ws = ws;
  a.n = n; a.r = r; a.heads = heads; a.f = f; a.slope = slope; a.bf16 = bf16;
  a.block = cols; a.split = split; a.per_split = per_split; a.vec = vec;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(a, adj_int8);
}

}  // extern "C"
