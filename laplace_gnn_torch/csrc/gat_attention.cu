// GAT's edge softmax and aggregation over a dst-sorted CSR, forward and
// backward, for Hopper:
//
//     out[i] = sum_{e: dst_e = i} alpha_e h[src_e],
//     alpha_e = softmax over row i of s_e, s_e = leaky_relu(a_src[src_e]
//               + a_dst[i]), per head,
//
// for (N, H, F) h and (N, H) a_src, a_dst.
//
// Replaces no Pallas kernel: the JAX package's ELL GAT attention
// (laplace_gnn_tpu/graph/container.py::ell_gat_attention) is plain XLA. It
// was added because the composed PyTorch version of that function writes
// every ELL tier's gathered (R, K, H, F) payload and its weighted products
// to device memory and reads them again in the backward: ~76% of the busy
// time of a full-batch GAT epoch at ogbn-arxiv's shape (PERF.md).
//
// What bounds it on an H100 (3.35 TB/s): bytes. The forward reads each
// stored edge's source row (H * F payload values: 1.5 KB in bf16 at H = 3,
// F = 250) and writes (N, H, F) f32; the operations (2 E H F) are ~0.02%
// of the card's rate. The backward reads each source row once and each
// edge's destination gradient row (the same 1.5 KB in the payload type).
//
// Design. Nothing the size of the edges times the features ever reaches
// device memory: intermediates stay in registers and shared memory.
//  - Work items are (row, chunk of at most CHUNK edges), built once by the
//    wrapper's layout: a hub row (~13k edges at ogbn-arxiv's shape) is
//    split, so no warp walks it alone. One warp takes an item; the warps
//    are persistent (the grid fills the card once and each warp walks the
//    items a grid apart), since a block of one-warp items of 1 to 64
//    edges would otherwise stay resident for its longest item.
//  - Forward, pass 1: lanes take the chunk's edges, compute the scores in
//    f32 (f64 for an f64 payload) into shared memory with the sources'
//    indices, and reduce the maximum and the sum of the exponentials per
//    head across the warp. Pass 2: lane groups of LPE lanes take an edge
//    each, VPL 16-byte vectors of its source row a lane (rows padded to a
//    16-byte stride), U steps of loads in flight, and accumulate
//    p_e * h[src_e] in f32 registers. The item writes out / l and the
//    log-sum-exp (the backward's only saved statistic), or, for a chunk of
//    a split row, its (m, l, sum) to a workspace that a second kernel
//    merges chunk by chunk in order, a warp a row and 32 columns.
//  - Backward, over the transposed CSR (edges sorted by source, a
//    permutation built once by the layout): a pack pass rounds dout to the
//    payload type (as the composed version carried the payload's gradient)
//    and forms D[i] = dout[i] . out[i] per head. Then one warp a source
//    item holds h[src] in registers, recomputes alpha = exp(s - lse[dst])
//    and alpha * D[dst] for its out-edges into shared memory, gathers each
//    out-edge's dout[dst], and accumulates
//    dh[src] += alpha dout[dst] and da_src[src] += ds leaky'(z), with
//    ds = alpha (dout[dst] . h[src] - D[dst]); each edge's ds leaky'(z) is
//    written (E x H) for a last pass that sums it per destination into
//    da_dst. Split sources merge like split rows.
//  - No atomics: every sum runs in a fixed order (in-lane sequences, then
//    xor butterflies, then the chunks in order), so two calls give the
//    same bits.
//
// Payloads: bf16 (sums in f32), f32, f64 (everything in f64). The wrapper
// (ops/gat_attention.py) checks shapes, types and devices and raises on
// what these kernels do not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int WARPS = 8;                 // warps a block, one item each
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 64;                // most edges an item
constexpr int MAX_HEADS = 8;
constexpr int MAX_VECTORS = 256;         // 16-byte vectors a payload row
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Payload;

template <>
struct Payload<__nv_bfloat16> {
  using C = float;
  static constexpr int VEC = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* o) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 round(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float widen(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

template <>
struct Payload<float> {
  using C = float;
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float widen(float x) { return x; }
};

template <>
struct Payload<double> {
  using C = double;
  static constexpr int VEC = 2;
  static __device__ __forceinline__ void unpack(const uint4& u, double* o) {
    o[0] = __hiloint2double(static_cast<int>(u.y), static_cast<int>(u.x));
    o[1] = __hiloint2double(static_cast<int>(u.w), static_cast<int>(u.z));
  }
  static __device__ __forceinline__ double round(double x) { return x; }
  static __device__ __forceinline__ double widen(double x) { return x; }
};

__device__ __forceinline__ float cmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double cmax(double a, double b) { return fmax(a, b); }
__device__ __forceinline__ float cexp(float x) { return expf(x); }
__device__ __forceinline__ double cexp(double x) { return exp(x); }
__device__ __forceinline__ float clog(float x) { return logf(x); }
__device__ __forceinline__ double clog(double x) { return log(x); }

template <typename C>
__device__ __forceinline__ C warp_max(C v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = cmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

template <typename C>
__device__ __forceinline__ C warp_sum(C v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// a[h] for a head known only at run time, without indexing a register
// array (which would move it to local memory)
template <typename C>
__device__ __forceinline__ C pick(const C (&a)[MAX_HEADS], int h) {
  C r = a[0];
#pragma unroll
  for (int t = 1; t < MAX_HEADS; ++t)
    if (t == h) r = a[t];
  return r;
}

// steps of edge loads in flight a lane
template <int VPL>
constexpr int IN_FLIGHT = VPL >= 3 ? 2 : 4;

// ---------------------------------------------------------------------------
// pack: xp[r, :] = round(x[r, :F]) padded with zeros to Fp, for the rows
// r = (node, head); with y, also d[r] = sum_f widen(xp[r, f]) y[r, f]. One
// warp a row.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
    gat_pack_kernel(const typename Payload<T>::C* __restrict__ x,
                    const typename Payload<T>::C* __restrict__ y, int rows,
                    int F, int Fp, T* __restrict__ xp,
                    typename Payload<T>::C* __restrict__ d) {
  using P = Payload<T>;
  using C = typename P::C;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const C* xr = x + static_cast<size_t>(r) * F;
  T* pr = xp + static_cast<size_t>(r) * Fp;
  C acc = 0;
  for (int f = lane; f < Fp; f += 32) {
    const T t = P::round(f < F ? xr[f] : C(0));
    pr[f] = t;
    if (y != nullptr && f < F)
      acc += P::widen(t) * y[static_cast<size_t>(r) * F + f];
  }
  if (d != nullptr) {
    acc = warp_sum(acc);
    if (lane == 0) d[r] = acc;
  }
}

// ---------------------------------------------------------------------------
// forward: one warp an item {row, beg, end, slot} over the dst-sorted edges;
// es / ep: the warp's shared rows of CHUNK sources and scores
// ---------------------------------------------------------------------------
template <typename T, int LPE, int VPL>
__device__ __forceinline__ void fwd_item(
    const int4 it, const int lane, int* es, typename Payload<T>::C* ep,
    const T* __restrict__ x, const typename Payload<T>::C* __restrict__ a_src,
    const typename Payload<T>::C* __restrict__ a_dst,
    const int* __restrict__ src, int H, int F, int Fp,
    typename Payload<T>::C slope, typename Payload<T>::C* __restrict__ out,
    typename Payload<T>::C* __restrict__ lse,
    typename Payload<T>::C* __restrict__ ws_acc,
    typename Payload<T>::C* __restrict__ ws_ml) {
  using P = Payload<T>;
  using C = typename P::C;
  constexpr int VEC = P::VEC;
  constexpr int EPW = 32 / LPE;          // edges a warp step
  constexpr int U = IN_FLIGHT<VPL>;
  const int row = it.x, beg = it.y, len = it.z - it.y, slot = it.w;

  // pass 1: scores, the row's maximum and the sum of its exponentials
  C ad[MAX_HEADS], m[MAX_HEADS], l[MAX_HEADS];
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h) {
    ad[h] = h < H ? a_dst[static_cast<size_t>(row) * H + h] : C(0);
    m[h] = -INFINITY;
    l[h] = 0;
  }
  for (int k = lane; k < len; k += 32) {
    const int j = src[beg + k];
    es[k] = j;
#pragma unroll
    for (int h = 0; h < MAX_HEADS; ++h) {
      if (h < H) {
        const C z = a_src[static_cast<size_t>(j) * H + h] + ad[h];
        const C s = z >= C(0) ? z : slope * z;
        ep[k * H + h] = s;
        m[h] = cmax(m[h], s);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h)
    if (h < H) m[h] = warp_max(m[h]);
  for (int k = lane; k < len; k += 32) {
#pragma unroll
    for (int h = 0; h < MAX_HEADS; ++h) {
      if (h < H) {
        const C p = cexp(ep[k * H + h] - m[h]);
        ep[k * H + h] = p;
        l[h] += p;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h)
    if (h < H) l[h] = warp_sum(l[h]);
  __syncwarp();

  // pass 2: sum p_e x[src_e], a group of LPE lanes an edge
  const int nvec = H * Fp / VEC;
  const int group = lane / LPE, gl = lane % LPE;
  int hv[VPL];
  bool ok[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int q = v * LPE + gl;
    ok[v] = q < nvec;
    hv[v] = ok[v] ? q * VEC / Fp : 0;
  }
  C acc[VPL][VEC];
#pragma unroll
  for (int v = 0; v < VPL; ++v)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[v][i] = 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int k0 = 0; k0 < len; k0 += EPW * U) {
    uint4 buf[U][VPL];
    C w[U][VPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * EPW + group;
      const bool in = k < len;
      const uint4* xr = xv + static_cast<size_t>(in ? es[k] : 0) * nvec;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        buf[u][v] = (in && ok[v]) ? __ldg(xr + v * LPE + gl)
                                  : make_uint4(0u, 0u, 0u, 0u);
        w[u][v] = in ? ep[k * H + hv[v]] : C(0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        C e[VEC];
        P::unpack(buf[u][v], e);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[v][i] += w[u][v] * e[i];
      }
    }
  }
#pragma unroll
  for (int off = LPE; off < 32; off <<= 1)
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[v][i] += __shfl_xor_sync(FULL, acc[v][i], off);

  if (slot < 0) {
    if (group == 0) {
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        if (!ok[v]) continue;
        const int hh = hv[v], f0 = (v * LPE + gl) * VEC - hh * Fp;
        const C lh = pick(l, hh);
        const C inv = lh > C(0) ? C(1) / lh : C(0);
        C* o = out + (static_cast<size_t>(row) * H + hh) * F;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          if (f0 + i < F) o[f0 + i] = acc[v][i] * inv;
      }
    }
    if (lane < H) {
      const C lh = pick(l, lane);
      lse[static_cast<size_t>(row) * H + lane] =
          lh > C(0) ? pick(m, lane) + clog(lh) : C(0);
    }
  } else {
    if (group == 0) {
      C* wp = ws_acc + static_cast<size_t>(slot) * H * Fp;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        if (!ok[v]) continue;
        const int c0 = (v * LPE + gl) * VEC;
#pragma unroll
        for (int i = 0; i < VEC; ++i) wp[c0 + i] = acc[v][i];
      }
    }
    if (lane < H) {
      ws_ml[static_cast<size_t>(slot) * 2 * H + lane] = pick(m, lane);
      ws_ml[static_cast<size_t>(slot) * 2 * H + H + lane] = pick(l, lane);
    }
  }
}

// Persistent warps: the grid fills the card once and each warp walks the
// items n_warps apart, so a warp whose item is long does not hold up
// seven finished neighbours in its block.
template <typename T, int LPE, int VPL>
__global__ void __launch_bounds__(THREADS)
    gat_fwd_kernel(const T* __restrict__ x,
                   const typename Payload<T>::C* __restrict__ a_src,
                   const typename Payload<T>::C* __restrict__ a_dst,
                   const int* __restrict__ src,
                   const int4* __restrict__ items, int n_items, int H, int F,
                   int Fp, typename Payload<T>::C slope,
                   typename Payload<T>::C* __restrict__ out,
                   typename Payload<T>::C* __restrict__ lse,
                   typename Payload<T>::C* __restrict__ ws_acc,
                   typename Payload<T>::C* __restrict__ ws_ml) {
  using C = typename Payload<T>::C;
  __shared__ int s_src[WARPS][CHUNK];
  __shared__ C s_p[WARPS][CHUNK * MAX_HEADS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = blockIdx.x * WARPS + warp; item < n_items;
       item += gridDim.x * WARPS) {
    fwd_item<T, LPE, VPL>(items[item], lane, s_src[warp], s_p[warp], x,
                          a_src, a_dst, src, H, F, Fp, slope, out, lse,
                          ws_acc, ws_ml);
    __syncwarp();       // every lane is done with the item's shared rows
  }
}

// The split rows {row, first slot, chunks}: the chunks' (m, l, sum) merged
// in chunk order. One warp a row and 32 of its columns (a hub's ~200 chunks
// are read by as many warps as the row has 32-column slices); each lane
// merges its column's head, and the first slice's lanes < H write the
// log-sum-exp.
template <typename C>
__device__ __forceinline__ void merge_head(const C* __restrict__ ws_ml,
                                           size_t first, int n, int H,
                                           int h, C& M, C& L) {
  M = -INFINITY;
#pragma unroll 8
  for (int s = 0; s < n; ++s) M = cmax(M, ws_ml[(first + s) * 2 * H + h]);
  L = 0;
#pragma unroll 8
  for (int s = 0; s < n; ++s) {
    const C* ml = ws_ml + (first + s) * 2 * H;
    L += ml[H + h] * cexp(ml[h] - M);
  }
}

template <typename C>
__global__ void __launch_bounds__(THREADS)
    gat_fwd_merge_kernel(const int4* __restrict__ merges, int n_merges,
                         int H, int F, int Fp,
                         const C* __restrict__ ws_acc,
                         const C* __restrict__ ws_ml, C* __restrict__ out,
                         C* __restrict__ lse) {
  const int lane = threadIdx.x & 31;
  const int row_len = H * Fp;
  const int slices = (row_len + 31) / 32;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= n_merges * slices) return;
  const int4 it = merges[w / slices];
  const int slice = w % slices;
  const int row = it.x, n = it.z;
  const size_t first = static_cast<size_t>(it.y);
  const int c = slice * 32 + lane;
  const int hh = c / Fp, f = c - hh * Fp;
  if (c < row_len && f < F) {
    C M, L, a = 0;
    merge_head(ws_ml, first, n, H, hh, M, L);
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const size_t at = first + s;
      a += ws_acc[at * row_len + c] * cexp(ws_ml[at * 2 * H + hh] - M);
    }
    out[(static_cast<size_t>(row) * H + hh) * F + f] = a / L;
  }
  if (slice == 0 && lane < H) {
    C M, L;
    merge_head(ws_ml, first, n, H, lane, M, L);
    lse[static_cast<size_t>(row) * H + lane] = M + clog(L);
  }
}

// ---------------------------------------------------------------------------
// backward: one warp an item {source, beg, end, slot} over the transposed
// CSR (t_dst, t_eid: each out-edge's destination and dst-sorted edge id)
// ---------------------------------------------------------------------------

// A warp's shared rows for one item: its CHUNK out-edges' destinations, edge
// ids, signs of z (bit h for head h), alpha and alpha * D per head.
template <typename C>
struct BwdRows {
  int dst[CHUNK];
  int eid[CHUNK];
  int pos[CHUNK];
  C alpha[CHUNK * MAX_HEADS];
  C alpha_d[CHUNK * MAX_HEADS];
};

// warps a backward block: f64 rows take twice the bytes, and 4 warps keep
// them within the 48 KB of static shared memory
template <typename C>
constexpr int BWD_WARPS = sizeof(C) == 8 ? 4 : 8;

template <typename T, int LPE, int VPL>
__device__ __forceinline__ void bwd_item(
    const int4 it, const int lane, BwdRows<typename Payload<T>::C>& r,
    const T* __restrict__ x, const T* __restrict__ g,
    const typename Payload<T>::C* __restrict__ a_src,
    const typename Payload<T>::C* __restrict__ a_dst,
    const typename Payload<T>::C* __restrict__ lse,
    const typename Payload<T>::C* __restrict__ d,
    const int* __restrict__ t_dst, const int* __restrict__ t_eid, int H,
    int F, int Fp, typename Payload<T>::C slope,
    typename Payload<T>::C* __restrict__ dh,
    typename Payload<T>::C* __restrict__ da_src,
    typename Payload<T>::C* __restrict__ dz,
    typename Payload<T>::C* __restrict__ ws_acc,
    typename Payload<T>::C* __restrict__ ws_a) {
  using P = Payload<T>;
  using C = typename P::C;
  constexpr int VEC = P::VEC;
  constexpr int EPW = 32 / LPE;
  constexpr int U = IN_FLIGHT<VPL>;
  constexpr int HT = (MAX_HEADS + LPE - 1) / LPE;   // heads a lane closes
  const int j = it.x, beg = it.y, len = it.z - it.y, slot = it.w;

  // pass 1, lanes over the out-edges: alpha = exp(s - lse[dst]) and
  // alpha * D[dst], so the gather loop waits on no other global read
  C as[MAX_HEADS];
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h)
    as[h] = h < H ? a_src[static_cast<size_t>(j) * H + h] : C(0);
  for (int k = lane; k < len; k += 32) {
    const int i = t_dst[beg + k];
    r.dst[k] = i;
    r.eid[k] = t_eid[beg + k];
    int pos = 0;
#pragma unroll
    for (int h = 0; h < MAX_HEADS; ++h) {
      if (h < H) {
        const size_t ih = static_cast<size_t>(i) * H + h;
        const C z = as[h] + a_dst[ih];
        const C s = z >= C(0) ? z : slope * z;
        const C al = cexp(s - lse[ih]);
        r.alpha[k * H + h] = al;
        r.alpha_d[k * H + h] = al * d[ih];
        pos |= (z >= C(0)) << h;
      }
    }
    r.pos[k] = pos;
  }
  __syncwarp();

  const int nvec = H * Fp / VEC;
  const int group = lane / LPE, gl = lane % LPE;
  int hv[VPL];
  bool ok[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int q = v * LPE + gl;
    ok[v] = q < nvec;
    hv[v] = ok[v] ? q * VEC / Fp : 0;
  }
  // the source's own row, read once
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* gv = reinterpret_cast<const uint4*>(g);
  C xj[VPL][VEC], acc[VPL][VEC];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const uint4 b = ok[v] ? __ldg(xv + static_cast<size_t>(j) * nvec +
                                  v * LPE + gl)
                          : make_uint4(0u, 0u, 0u, 0u);
    P::unpack(b, xj[v]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[v][i] = 0;
  }
  C da[HT];
#pragma unroll
  for (int t = 0; t < HT; ++t) da[t] = 0;

  for (int k0 = 0; k0 < len; k0 += EPW * U) {
    uint4 buf[U][VPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * EPW + group;
      const bool in = k < len;
      const uint4* gr = gv + static_cast<size_t>(in ? r.dst[k] : 0) * nvec;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        buf[u][v] = (in && ok[v]) ? __ldg(gr + v * LPE + gl)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
    C part[U][MAX_HEADS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * EPW + group;
      const bool in = k < len;
#pragma unroll
      for (int h = 0; h < MAX_HEADS; ++h) part[u][h] = 0;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        C e[VEC];
        P::unpack(buf[u][v], e);
        const C al = in ? r.alpha[k * H + hv[v]] : C(0);
        C dot = 0;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          dot += xj[v][i] * e[i];
          acc[v][i] += al * e[i];
        }
#pragma unroll
        for (int h = 0; h < MAX_HEADS; ++h)
          if (h == hv[v]) part[u][h] += dot;
      }
    }
    // each head's dot product over the group's lanes
#pragma unroll
    for (int off = 1; off < LPE; off <<= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < MAX_HEADS; ++h)
          if (h < H) part[u][h] += __shfl_xor_sync(FULL, part[u][h], off);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u * EPW + group;
      if (k >= len) continue;
      const int pos = r.pos[k];
      const size_t e = static_cast<size_t>(r.eid[k]);
#pragma unroll
      for (int t = 0; t < HT; ++t) {
        const int h = gl + t * LPE;
        if (h < H) {
          C dal = part[u][0];
#pragma unroll
          for (int t2 = 1; t2 < MAX_HEADS; ++t2)
            if (t2 == h) dal = part[u][t2];
          const C ds = r.alpha[k * H + h] * dal - r.alpha_d[k * H + h];
          const C dzv = (pos >> h) & 1 ? ds : slope * ds;
          dz[e * H + h] = dzv;
          da[t] += dzv;
        }
      }
    }
  }
#pragma unroll
  for (int off = LPE; off < 32; off <<= 1) {
#pragma unroll
    for (int v = 0; v < VPL; ++v)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[v][i] += __shfl_xor_sync(FULL, acc[v][i], off);
#pragma unroll
    for (int t = 0; t < HT; ++t) da[t] += __shfl_xor_sync(FULL, da[t], off);
  }

  if (group != 0) return;
  if (slot < 0) {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (!ok[v]) continue;
      const int hh = hv[v], f0 = (v * LPE + gl) * VEC - hh * Fp;
      C* o = dh + (static_cast<size_t>(j) * H + hh) * F;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        if (f0 + i < F) o[f0 + i] = acc[v][i];
    }
#pragma unroll
    for (int t = 0; t < HT; ++t) {
      const int h = gl + t * LPE;
      if (h < H) da_src[static_cast<size_t>(j) * H + h] = da[t];
    }
  } else {
    C* wp = ws_acc + static_cast<size_t>(slot) * H * Fp;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (!ok[v]) continue;
      const int c0 = (v * LPE + gl) * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) wp[c0 + i] = acc[v][i];
    }
#pragma unroll
    for (int t = 0; t < HT; ++t) {
      const int h = gl + t * LPE;
      if (h < H) ws_a[static_cast<size_t>(slot) * H + h] = da[t];
    }
  }
}

// Persistent warps, as the forward's.
template <typename T, int LPE, int VPL>
__global__ void __launch_bounds__(THREADS)
    gat_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const typename Payload<T>::C* __restrict__ a_src,
                   const typename Payload<T>::C* __restrict__ a_dst,
                   const typename Payload<T>::C* __restrict__ lse,
                   const typename Payload<T>::C* __restrict__ d,
                   const int* __restrict__ t_dst,
                   const int* __restrict__ t_eid,
                   const int4* __restrict__ items, int n_items, int H, int F,
                   int Fp, typename Payload<T>::C slope,
                   typename Payload<T>::C* __restrict__ dh,
                   typename Payload<T>::C* __restrict__ da_src,
                   typename Payload<T>::C* __restrict__ dz,
                   typename Payload<T>::C* __restrict__ ws_acc,
                   typename Payload<T>::C* __restrict__ ws_a) {
  using C = typename Payload<T>::C;
  constexpr int W = BWD_WARPS<C>;
  __shared__ BwdRows<C> rows[W];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int item = blockIdx.x * W + warp; item < n_items;
       item += gridDim.x * W) {
    bwd_item<T, LPE, VPL>(items[item], lane, rows[warp], x, g, a_src, a_dst,
                          lse, d, t_dst, t_eid, H, F, Fp, slope, dh, da_src,
                          dz, ws_acc, ws_a);
    __syncwarp();       // every lane is done with the item's shared rows
  }
}

// The split sources {source, first slot, chunks}: their chunks' dh and
// da_src summed in chunk order. One warp a source and 32 of its columns,
// as the forward's merge.
template <typename C>
__global__ void __launch_bounds__(THREADS)
    gat_bwd_merge_kernel(const int4* __restrict__ merges, int n_merges,
                         int H, int F, int Fp,
                         const C* __restrict__ ws_acc,
                         const C* __restrict__ ws_a, C* __restrict__ dh,
                         C* __restrict__ da_src) {
  const int lane = threadIdx.x & 31;
  const int row_len = H * Fp;
  const int slices = (row_len + 31) / 32;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= n_merges * slices) return;
  const int4 it = merges[w / slices];
  const int slice = w % slices;
  const int j = it.x, n = it.z;
  const size_t first = static_cast<size_t>(it.y);
  const int c = slice * 32 + lane;
  const int hh = c / Fp, f = c - hh * Fp;
  if (c < row_len && f < F) {
    C a = 0;
#pragma unroll 8
    for (int s = 0; s < n; ++s) a += ws_acc[(first + s) * row_len + c];
    dh[(static_cast<size_t>(j) * H + hh) * F + f] = a;
  }
  if (slice == 0 && lane < H) {
    C a = 0;
    for (int s = 0; s < n; ++s) a += ws_a[(first + s) * H + lane];
    da_src[static_cast<size_t>(j) * H + lane] = a;
  }
}

// da_dst[i] = sum of dz over row i's dst-sorted edges. One warp a row.
template <typename C>
__global__ void __launch_bounds__(THREADS)
    gat_row_sum_kernel(const int* __restrict__ indptr, int n_nodes, int H,
                       const C* __restrict__ dz, C* __restrict__ da_dst) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= n_nodes) return;
  C s[MAX_HEADS];
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h) s[h] = 0;
  const int end = indptr[r + 1];
#pragma unroll 4
  for (int k = indptr[r] + lane; k < end; k += 32) {
#pragma unroll
    for (int h = 0; h < MAX_HEADS; ++h)
      if (h < H) s[h] += dz[static_cast<size_t>(k) * H + h];
  }
#pragma unroll
  for (int h = 0; h < MAX_HEADS; ++h)
    if (h < H) s[h] = warp_sum(s[h]);
  if (lane < H) da_dst[static_cast<size_t>(r) * H + lane] = pick(s, lane);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
inline unsigned blocks_for(long long warps, int per_block = WARPS) {
  return static_cast<unsigned>((warps + per_block - 1) / per_block);
}

// The blocks of a persistent launch: as many as fit on the card at once,
// or fewer where the items run out first.
template <typename K>
unsigned persistent_blocks(K kernel, int n_items, int per_block) {
  int dev = 0, sms = 0, per_sm = 0;
  const unsigned need = blocks_for(n_items, per_block);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, 32 * per_block, 0) != cudaSuccess ||
      sms * per_sm <= 0)
    return need;
  const unsigned full = static_cast<unsigned>(sms * per_sm);
  return need < full ? need : full;
}

template <int N>
using I = std::integral_constant<int, N>;

// Calls run(I<LPE>, I<VPL>) for a payload row of nvec 16-byte vectors:
// short rows give a group of LPE < 32 lanes an edge, longer ones the whole
// warp with VPL vectors a lane.
template <typename Run>
cudaError_t by_width(int nvec, Run&& run) {
  if (nvec <= 4) return run(I<4>{}, I<1>{});
  if (nvec <= 8) return run(I<8>{}, I<1>{});
  if (nvec <= 16) return run(I<16>{}, I<1>{});
  switch ((nvec + 31) / 32) {
    case 1: return run(I<32>{}, I<1>{});
    case 2: return run(I<32>{}, I<2>{});
    case 3: return run(I<32>{}, I<3>{});
    case 4: return run(I<32>{}, I<4>{});
    case 5:
    case 6: return run(I<32>{}, I<6>{});
    case 7:
    case 8: return run(I<32>{}, I<8>{});
    default: return cudaErrorInvalidValue;
  }
}

struct Shape {
  int n_nodes, H, F, Fp;
};

template <typename T>
bool valid(const Shape& s) {
  constexpr int VEC = Payload<T>::VEC;
  return s.n_nodes >= 0 && s.H >= 1 && s.H <= MAX_HEADS && s.F >= 1 &&
         s.Fp >= s.F && s.Fp % VEC == 0 &&
         s.H * s.Fp / VEC <= MAX_VECTORS;
}

template <typename T>
cudaError_t pack(const void* x, const void* y, const Shape& s, void* xp,
                 void* d, cudaStream_t st) {
  using C = typename Payload<T>::C;
  const int rows = s.n_nodes * s.H;
  if (rows == 0) return cudaSuccess;
  gat_pack_kernel<T><<<blocks_for(rows), THREADS, 0, st>>>(
      static_cast<const C*>(x), static_cast<const C*>(y), rows, s.F, s.Fp,
      static_cast<T*>(xp), static_cast<C*>(d));
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const void* h, void* xp, int do_pack, const void* a_src,
                    const void* a_dst, const void* src, const void* items,
                    int n_items, const void* merges, int n_merges,
                    const Shape& s, double slope, void* out, void* lse,
                    void* ws_acc, void* ws_ml, cudaStream_t st) {
  using C = typename Payload<T>::C;
  if (!valid<T>(s)) return cudaErrorInvalidValue;
  cudaError_t rc;
  if (do_pack && (rc = pack<T>(h, nullptr, s, xp, nullptr, st)) != cudaSuccess)
    return rc;
  const int nvec = s.H * s.Fp / Payload<T>::VEC;
  if (n_items > 0) {
    rc = by_width(nvec, [&](auto lpe, auto vpl) {
      auto kernel =
          gat_fwd_kernel<T, decltype(lpe)::value, decltype(vpl)::value>;
      kernel<<<persistent_blocks(kernel, n_items, WARPS), THREADS, 0, st>>>(
              static_cast<const T*>(xp), static_cast<const C*>(a_src),
              static_cast<const C*>(a_dst), static_cast<const int*>(src),
              static_cast<const int4*>(items), n_items, s.H, s.F, s.Fp,
              static_cast<C>(slope), static_cast<C*>(out),
              static_cast<C*>(lse), static_cast<C*>(ws_acc),
              static_cast<C*>(ws_ml));
      return cudaGetLastError();
    });
    if (rc != cudaSuccess) return rc;
  }
  if (n_merges > 0) {
    const long long slices = (s.H * s.Fp + 31) / 32;
    gat_fwd_merge_kernel<C>
        <<<blocks_for(n_merges * slices), THREADS, 0, st>>>(
        static_cast<const int4*>(merges), n_merges, s.H, s.F, s.Fp,
        static_cast<const C*>(ws_acc), static_cast<const C*>(ws_ml),
        static_cast<C*>(out), static_cast<C*>(lse));
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t backward(const void* xp, const void* g, const void* out,
                     void* gp, void* d, const void* a_src, const void* a_dst,
                     const void* lse, const void* indptr, const void* t_dst,
                     const void* t_eid, const void* items, int n_items,
                     const void* merges, int n_merges, const Shape& s,
                     double slope, void* dh, void* da_src, void* da_dst,
                     void* dz, void* ws_acc, void* ws_a, cudaStream_t st) {
  using C = typename Payload<T>::C;
  if (!valid<T>(s)) return cudaErrorInvalidValue;
  cudaError_t rc = pack<T>(g, out, s, gp, d, st);
  if (rc != cudaSuccess) return rc;
  const int nvec = s.H * s.Fp / Payload<T>::VEC;
  if (n_items > 0) {
    rc = by_width(nvec, [&](auto lpe, auto vpl) {
      constexpr int W = BWD_WARPS<C>;
      auto kernel =
          gat_bwd_kernel<T, decltype(lpe)::value, decltype(vpl)::value>;
      kernel<<<persistent_blocks(kernel, n_items, W), 32 * W, 0, st>>>(
              static_cast<const T*>(xp), static_cast<const T*>(gp),
              static_cast<const C*>(a_src), static_cast<const C*>(a_dst),
              static_cast<const C*>(lse), static_cast<const C*>(d),
              static_cast<const int*>(t_dst), static_cast<const int*>(t_eid),
              static_cast<const int4*>(items), n_items, s.H, s.F, s.Fp,
              static_cast<C>(slope), static_cast<C*>(dh),
              static_cast<C*>(da_src), static_cast<C*>(dz),
              static_cast<C*>(ws_acc), static_cast<C*>(ws_a));
      return cudaGetLastError();
    });
    if (rc != cudaSuccess) return rc;
  }
  if (n_merges > 0) {
    const long long slices = (s.H * s.Fp + 31) / 32;
    gat_bwd_merge_kernel<C>
        <<<blocks_for(n_merges * slices), THREADS, 0, st>>>(
        static_cast<const int4*>(merges), n_merges, s.H, s.F, s.Fp,
        static_cast<const C*>(ws_acc), static_cast<const C*>(ws_a),
        static_cast<C*>(dh), static_cast<C*>(da_src));
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  }
  if (s.n_nodes > 0) {
    gat_row_sum_kernel<C><<<blocks_for(s.n_nodes), THREADS, 0, st>>>(
        static_cast<const int*>(indptr), s.n_nodes, s.H,
        static_cast<const C*>(dz), static_cast<C*>(da_dst));
    if ((rc = cudaGetLastError()) != cudaSuccess) return rc;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// payload: 0 bf16 (sums and every (N, H) or (N, H, F) tensor in f32),
// 1 f32, 2 f64. h: (N, H, F) in the sums' type, packed into xp (N, H, Fp)
// in the payload type when pack != 0 (else xp already holds it); src: the
// dst-sorted sources (int32); items (n_items, 4) and merges (n_merges, 4)
// int32. Writes out (N, H, F) and lse (N, H); ws_acc (slots, H * Fp) and
// ws_ml (slots, 2 H) are the split rows' scratch.
int gat_fwd_launch(int payload, const void* h, void* xp, int pack,
                   const void* a_src, const void* a_dst, const void* src,
                   const void* items, int n_items, const void* merges,
                   int n_merges, int n_nodes, int H, int F, int Fp,
                   double slope, void* out, void* lse, void* ws_acc,
                   void* ws_ml, void* stream) {
  const Shape s{n_nodes, H, F, Fp};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (payload) {
    case 0:
      rc = forward<__nv_bfloat16>(h, xp, pack, a_src, a_dst, src, items,
                                  n_items, merges, n_merges, s, slope, out,
                                  lse, ws_acc, ws_ml, st);
      break;
    case 1:
      rc = forward<float>(h, xp, pack, a_src, a_dst, src, items, n_items,
                          merges, n_merges, s, slope, out, lse, ws_acc,
                          ws_ml, st);
      break;
    case 2:
      rc = forward<double>(h, xp, pack, a_src, a_dst, src, items, n_items,
                           merges, n_merges, s, slope, out, lse, ws_acc,
                           ws_ml, st);
      break;
    default:
      rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}

// xp: the forward's packed payload; g, out: (N, H, F) in the sums' type;
// gp (N, H, Fp) payload and d (N, H) are scratch; indptr (N + 1) the
// dst-sorted row offsets; t_dst, t_eid (E) the transposed CSR's
// destinations and edge ids; items / merges over the sources. Writes dh
// (N, H, F), da_src and da_dst (N, H); dz (E, H), ws_acc (slots, H * Fp)
// and ws_a (slots, H) are scratch.
int gat_bwd_launch(int payload, const void* xp, const void* g,
                   const void* out, void* gp, void* d, const void* a_src,
                   const void* a_dst, const void* lse, const void* indptr,
                   const void* t_dst, const void* t_eid, const void* items,
                   int n_items, const void* merges, int n_merges,
                   int n_nodes, int H, int F, int Fp, double slope, void* dh,
                   void* da_src, void* da_dst, void* dz, void* ws_acc,
                   void* ws_a, void* stream) {
  const Shape s{n_nodes, H, F, Fp};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (payload) {
    case 0:
      rc = backward<__nv_bfloat16>(xp, g, out, gp, d, a_src, a_dst, lse,
                                   indptr, t_dst, t_eid, items, n_items,
                                   merges, n_merges, s, slope, dh, da_src,
                                   da_dst, dz, ws_acc, ws_a, st);
      break;
    case 1:
      rc = backward<float>(xp, g, out, gp, d, a_src, a_dst, lse, indptr,
                           t_dst, t_eid, items, n_items, merges, n_merges, s,
                           slope, dh, da_src, da_dst, dz, ws_acc, ws_a, st);
      break;
    case 2:
      rc = backward<double>(xp, g, out, gp, d, a_src, a_dst, lse, indptr,
                            t_dst, t_eid, items, n_items, merges, n_merges,
                            s, slope, dh, da_src, da_dst, dz, ws_acc, ws_a,
                            st);
      break;
    default:
      rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}

}  // extern "C"
