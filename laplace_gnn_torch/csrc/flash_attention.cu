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
// What bounds it on this card. On the dense-GAT configuration's graph
// (N = 16384, density 14e-4, symmetric, plus self-loops) only ~0.3% of the
// N^2 entries are edges, so the arithmetic of either direction is a few
// million (row, column, head) triples, and each kernel is bound by reading
// the N x N adjacency once: 1.07 GB of float32 (0.27 GB of int8), ~0.32 ms
// at 3.35 TB/s. The Pallas
// kernels evaluate every entry of a tile and mask afterwards; that is a TPU's
// way (vector lanes, no cheap gather). Here the design is about streaming
// the adjacency and touching only its edges:
//  - each tile of the adjacency is read with 16-byte evict-first loads (when
//    a row is 16-byte aligned; else element by element), four loads in
//    flight per thread, and turned in registers into a bitmask of the entries
//    with a > 0 (float32 and int8 alike), ragged rows and columns masked there;
//    nothing is padded in device memory;
//  - __syncthreads_or over the tile skips a tile without an edge (this takes
//    the place of the separate _tile_occupancy pass);
//  - each thread owns one (row, head) pair in the forward and one (column,
//    head) pair in the backward, and walks only the set bits of its row or
//    column (__ffs), gathering a_src, x or g from L2 for those entries;
//  - one block covers all heads of its rows (forward) or columns (backward),
//    so each adjacency tile is read once, not once per head.
// The forward keeps m, l and the F accumulators of its pair in registers and
// rescales them when the running max grows. The backward accumulates d_x and
// d_a_src in registers and adds d_a_dst with float32 atomicAdd into a zeroed
// (R, H) output, so that sum's order changes from run to run. With bf16
// != 0 the operands of the p.x, g.x and p.g products are rounded to bf16
// before float32 FMAs (a bf16 product with float32 accumulation); else all is
// float32, with no TF32.
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;       // both kernels
constexpr int FWD_COLS = 256;      // source columns per forward tile
constexpr int FWD_WORDS = FWD_COLS / 32;
constexpr int BWD_ROWS = 256;      // target rows per backward tile
constexpr int BWD_GROUPS = BWD_ROWS / 32;
constexpr int UNROLL = 4;          // 16-byte loads in flight per thread
constexpr float NEG_BIG = -1e30f;

__device__ __forceinline__ float leaky(float z, float slope) {
  return z >= 0.f ? z : slope * z;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16-byte loads of the adjacency and their a > 0 bits (bit e = element e)
template <typename T> struct V16;
template <> struct V16<float> {
  using type = float4;
  static constexpr int E = 4;
  __device__ static float4 load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static uint32_t bits(float4 v) {
    return (v.x > 0.f) | ((v.y > 0.f) << 1) | ((v.z > 0.f) << 2) |
           ((v.w > 0.f) << 3);
  }
};
template <> struct V16<int8_t> {
  using type = int4;
  static constexpr int E = 16;
  __device__ static int4 load(const int8_t* p) {
    return __ldcs(reinterpret_cast<const int4*>(p));
  }
  __device__ static int4 zero() { return make_int4(0, 0, 0, 0); }
  __device__ static uint32_t bits(int4 v) {
    const int w[4] = {v.x, v.y, v.z, v.w};
    uint32_t b = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        b |= (static_cast<int8_t>(w[q] >> (8 * k)) > 0 ? 1u : 0u)
             << (4 * q + k);
    return b;
  }
};

// Load rows [row0, row0 + rows) x columns [col0, col0 + 32 * wpr) of the
// (r, n) adjacency into bits[rr * wpr + w], bit b = column col0 + 32 w + b.
// Entries outside the matrix are 0. Returns whether this thread saw an edge.
// A 32-column word is built by 32 / E lanes (each loads E elements, 16
// bytes) and OR-ed together with shuffles; the loop bounds are warp-uniform.
template <typename T, bool VEC>
__device__ __forceinline__ bool load_mask(const T* __restrict__ adj, int n,
                                          int r, int row0, int col0, int rows,
                                          int wpr, uint32_t* bits) {
  using V = V16<T>;
  constexpr int E = V::E;
  constexpr int LPW = 32 / E;      // lanes per word
  constexpr int WPI = 32 / LPW;    // words per warp and step
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int stride = (THREADS / 32) * WPI;
  const int total = rows * wpr;
  bool any = false;
  for (int base = warp * WPI; base < total; base += stride * UNROLL) {
    typename V::type raw[UNROLL];
    uint32_t v[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int u = base + k * stride + lane / LPW;
      const int row = row0 + u / wpr;
      const int col = col0 + (u % wpr) * 32 + (lane % LPW) * E;
      const T* p = adj + (size_t)row * n + col;
      const bool in = u < total && row < r;
      raw[k] = V::zero();
      v[k] = 0;
      if (VEC) {
        // rows are 16-byte aligned and n is a multiple of E, so a vector
        // that starts inside the row ends inside it
        if (in && col < n) raw[k] = V::load(p);
      } else if (in) {
        for (int e = 0; e < E; ++e)
          if (col + e < n && p[e] > 0) v[k] |= 1u << e;
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int u = base + k * stride + lane / LPW;
      uint32_t w = (VEC ? V::bits(raw[k]) : v[k]) << ((lane % LPW) * E);
#pragma unroll
      for (int off = 1; off < LPW; off <<= 1)
        w |= __shfl_xor_sync(0xffffffffu, w, off);
      if (u < total && lane % LPW == 0) bits[u] = w;
      any |= w != 0;
    }
  }
  return any;
}

// One block: `bm` target rows x all heads (bm * heads <= THREADS), looping
// over source tiles of FWD_COLS columns. Thread t owns (row t / heads,
// head t % heads).
template <typename T, bool VEC, int FB>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ a_src,
                 const float* __restrict__ a_dst, const T* __restrict__ adj,
                 const float* __restrict__ x, float* __restrict__ out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int n,
                 int r, int heads, int f, int bm, float slope, int bf16) {
  __shared__ uint32_t bits[THREADS * FWD_WORDS];
  const int row0 = blockIdx.x * bm;
  const int rr = threadIdx.x / heads, hd = threadIdx.x % heads;
  const int i = row0 + rr;
  const bool active = rr < bm && i < r;
  const float adst = active ? a_dst[(size_t)i * heads + hd] : 0.f;
  float mrun = NEG_BIG, lrun = 0.f, acc[FB];
#pragma unroll
  for (int q = 0; q < FB; ++q) acc[q] = 0.f;

  for (int col0 = 0; col0 < n; col0 += FWD_COLS) {
    const bool any =
        load_mask<T, VEC>(adj, n, r, row0, col0, bm, FWD_WORDS, bits);
    if (!__syncthreads_or(any)) continue;     // no edge in this tile
    if (active) {
      for (int w = 0; w < FWD_WORDS; ++w) {
        uint32_t b = bits[rr * FWD_WORDS + w];
        while (b) {
          const int j = col0 + w * 32 + __ffs(b) - 1;
          b &= b - 1;
          const float s =
              leaky(__ldg(a_src + (size_t)j * heads + hd) + adst, slope);
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
          const float* xj = x + ((size_t)j * heads + hd) * f;
#pragma unroll
          for (int q = 0; q < FB; ++q) {
            if (q < f) {
              const float xv = __ldg(xj + q);
              acc[q] = fmaf(pc, bf16 ? round_bf16(xv) : xv, acc[q]);
            }
          }
        }
      }
    }
    __syncthreads();                          // bits are rewritten next
  }

  if (active) {
    const float den = lrun == 0.f ? 1.f : lrun;
    float* o = out + ((size_t)i * heads + hd) * f;
#pragma unroll
    for (int q = 0; q < FB; ++q)
      if (q < f) o[q] = acc[q] / den;
    m_out[(size_t)hd * r + i] = mrun;
    l_out[(size_t)hd * r + i] = lrun;
  }
}

// One block: `bs` source columns x all heads (bs * heads <= THREADS),
// looping over target tiles of BWD_ROWS rows. Thread t owns (column
// t / heads, head t % heads). The row-major tile bitmask is transposed with
// ballots into per-column words, so a thread walks its column's edges.
template <typename T, bool VEC, int FB>
__global__ void __launch_bounds__(THREADS)
flash_bwd_kernel(const float* __restrict__ a_src,
                 const float* __restrict__ a_dst, const T* __restrict__ adj,
                 const float* __restrict__ x, const float* __restrict__ g,
                 const float* __restrict__ m, const float* __restrict__ linv,
                 const float* __restrict__ dvec, float* __restrict__ d_asrc,
                 float* __restrict__ d_adst, float* __restrict__ d_x, int n,
                 int r, int heads, int f, int bs, float slope, int bf16) {
  __shared__ uint32_t rowbits[BWD_ROWS * (THREADS / 32)];
  __shared__ uint32_t colbits[THREADS * BWD_GROUPS];
  const int wpr = (bs + 31) / 32;
  const int col0 = blockIdx.x * bs;
  const int cc = threadIdx.x / heads, hd = threadIdx.x % heads;
  const int j = col0 + cc;
  const bool active = cc < bs && j < n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const float asrc = active ? a_src[(size_t)j * heads + hd] : 0.f;
  float xj[FB], dx[FB], das = 0.f;
#pragma unroll
  for (int q = 0; q < FB; ++q) {
    const float xv =
        active && q < f ? x[((size_t)j * heads + hd) * f + q] : 0.f;
    xj[q] = bf16 ? round_bf16(xv) : xv;
    dx[q] = 0.f;
  }

  for (int row0 = 0; row0 < r; row0 += BWD_ROWS) {
    const bool any =
        load_mask<T, VEC>(adj, n, r, row0, col0, BWD_ROWS, wpr, rowbits);
    if (!__syncthreads_or(any)) continue;     // no edge in this tile
    // transpose: colbits[c * BWD_GROUPS + rg] bit k = row row0 + 32 rg + k
    for (int task = warp; task < BWD_GROUPS * wpr; task += THREADS / 32) {
      const int rg = task / wpr, wc = task % wpr;
      const uint32_t w = rowbits[(rg * 32 + lane) * wpr + wc];
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const uint32_t col = __ballot_sync(0xffffffffu, (w >> c) & 1u);
        if (lane == c && wc * 32 + c < bs)
          colbits[(wc * 32 + c) * BWD_GROUPS + rg] = col;
      }
    }
    __syncthreads();
    if (active) {
      for (int rg = 0; rg < BWD_GROUPS; ++rg) {
        uint32_t b = colbits[cc * BWD_GROUPS + rg];
        while (b) {
          const int i = row0 + rg * 32 + __ffs(b) - 1;
          b &= b - 1;
          const size_t st = (size_t)hd * r + i;
          const size_t ih = (size_t)i * heads + hd;
          const float z = asrc + __ldg(a_dst + ih);
          const float p =
              expf(leaky(z, slope) - __ldg(m + st)) * __ldg(linv + st);
          // g[i, h] is read twice (the second time from L1) rather than
          // held in FB more registers
          const float* gi = g + ih * f;
          float dp = 0.f;
#pragma unroll
          for (int q = 0; q < FB; ++q) {
            if (q < f) {
              const float v = __ldg(gi + q);
              dp = fmaf(bf16 ? round_bf16(v) : v, xj[q], dp);
            }
          }
          const float dz =
              p * (dp - __ldg(dvec + st)) * (z >= 0.f ? 1.f : slope);
          das += dz;
          atomicAdd(d_adst + ih, dz);
          const float pc = bf16 ? round_bf16(p) : p;
#pragma unroll
          for (int q = 0; q < FB; ++q) {
            if (q < f) {
              const float v = __ldg(gi + q);
              dx[q] = fmaf(pc, bf16 ? round_bf16(v) : v, dx[q]);
            }
          }
        }
      }
    }
    __syncthreads();                          // bits are rewritten next
  }

  if (active) {
    d_asrc[(size_t)j * heads + hd] = das;
    float* o = d_x + ((size_t)j * heads + hd) * f;
#pragma unroll
    for (int q = 0; q < FB; ++q)
      if (q < f) o[q] = dx[q];
  }
}

// rows (forward) or columns (backward) per block: the largest power of two
// whose (row, head) pairs fit in THREADS
int tile_for(int heads) {
  int t = 1;
  while (2 * t * heads <= THREADS) t *= 2;
  return t;
}

struct Args {
  const float *a_src, *a_dst;
  const void* adj;
  const float *x, *g, *m, *linv, *dvec;
  float *out, *m_out, *l_out, *d_asrc, *d_adst, *d_x;
  int n, r, heads, f;
  float slope;
  int bf16;
  cudaStream_t stream;
};

template <typename T, bool VEC, int FB>
void launch_fwd(const Args& a) {
  const int bm = tile_for(a.heads);
  flash_fwd_kernel<T, VEC, FB><<<(a.r + bm - 1) / bm, THREADS, 0, a.stream>>>(
      a.a_src, a.a_dst, static_cast<const T*>(a.adj), a.x, a.out, a.m_out,
      a.l_out, a.n, a.r, a.heads, a.f, bm, a.slope, a.bf16);
}

template <typename T, bool VEC, int FB>
void launch_bwd(const Args& a) {
  const int bs = tile_for(a.heads);
  flash_bwd_kernel<T, VEC, FB><<<(a.n + bs - 1) / bs, THREADS, 0, a.stream>>>(
      a.a_src, a.a_dst, static_cast<const T*>(a.adj), a.x, a.g, a.m, a.linv,
      a.dvec, a.d_asrc, a.d_adst, a.d_x, a.n, a.r, a.heads, a.f, bs, a.slope,
      a.bf16);
}

// FB: the smallest of 1, 8, 16, 32, 64 that covers f
template <bool BWD, typename T, bool VEC>
void dispatch_f(const Args& a) {
#define LAUNCH(FB) (BWD ? launch_bwd<T, VEC, FB>(a) : launch_fwd<T, VEC, FB>(a))
  if (a.f == 1)       LAUNCH(1);
  else if (a.f <= 8)  LAUNCH(8);
  else if (a.f <= 16) LAUNCH(16);
  else if (a.f <= 32) LAUNCH(32);
  else                LAUNCH(64);
#undef LAUNCH
}

template <bool BWD>
int dispatch(const Args& a, int adj_int8, int vec) {
  if (a.n <= 0 || a.r <= 0 || a.heads <= 0 || a.heads > THREADS || a.f <= 0 ||
      a.f > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  // a backward block starts at column blockIdx.x * tile: its 16-byte loads
  // are aligned only when the tile is a multiple of a vector
  if (BWD && tile_for(a.heads) % (adj_int8 ? 16 : 4) != 0) vec = 0;
  if (adj_int8) {
    if (vec) dispatch_f<BWD, int8_t, true>(a);
    else     dispatch_f<BWD, int8_t, false>(a);
  } else {
    if (vec) dispatch_f<BWD, float, true>(a);
    else     dispatch_f<BWD, float, false>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a_src (n, heads), a_dst (r, heads), adj (r, n) float32 or int8
// (adj_int8 = 1), x (n, heads, f) -> out (r, heads, f), m and l (heads, r),
// all float32 and contiguous. vec = 1: every adjacency row is 16-byte
// aligned (n a multiple of 4 for float32, of 16 for int8).
int flash_fwd_launch(const float* a_src, const float* a_dst, const void* adj,
                     const float* x, float* out, float* m, float* l,
                     int adj_int8, int n, int r, int heads, int f,
                     float slope, int bf16, int vec, void* stream) {
  Args a{};
  a.a_src = a_src; a.a_dst = a_dst; a.adj = adj; a.x = x;
  a.out = out; a.m_out = m; a.l_out = l;
  a.n = n; a.r = r; a.heads = heads; a.f = f; a.slope = slope; a.bf16 = bf16;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<false>(a, adj_int8, vec);
}

// the forward's inputs, g (r, heads, f), m, linv and dvec = rowsum(g out)
// (heads, r) -> d_a_src (n, heads), d_a_dst (r, heads; zero-filled by the
// caller, accumulated with atomics), d_x (n, heads, f).
int flash_bwd_launch(const float* a_src, const float* a_dst, const void* adj,
                     const float* x, const float* g, const float* m,
                     const float* linv, const float* dvec, float* d_asrc,
                     float* d_adst, float* d_x, int adj_int8, int n, int r,
                     int heads, int f, float slope, int bf16, int vec,
                     void* stream) {
  Args a{};
  a.a_src = a_src; a.a_dst = a_dst; a.adj = adj; a.x = x; a.g = g;
  a.m = m; a.linv = linv; a.dvec = dvec;
  a.d_asrc = d_asrc; a.d_adst = d_adst; a.d_x = d_x;
  a.n = n; a.r = r; a.heads = heads; a.f = f; a.slope = slope; a.bf16 = bf16;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<true>(a, adj_int8, vec);
}

}  // extern "C"
