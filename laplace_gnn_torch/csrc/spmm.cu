// The sparse graph's product over its dst-sorted CSR, for Hopper:
//
//     out[i] = sum_{e: dst_e = i} w_e x[src_e]
//
// for (N, d) x and per-edge weights w in the aggregation type (bf16, f32 or
// f64), sums in f32 (f64 for f64) written to (N, d) in the sums' type.
//
// Replaces no Pallas kernel: the JAX package's sparse aggregation
// (laplace_gnn_tpu/graph/container.py, SparseGraph.spmm) is plain XLA. It
// was added because the port's composed version of that function, the ELL
// tiers' embedding_bag, each overflow level's index_add copy and the
// remainder's segment sums (which read their lengths back on the host),
// took more than half of a full-batch SparseGCN epoch at ogbn-arxiv's
// shape at ~2% of its bound (PERF.md).
//
// What bounds it on an H100 (3.35 TB/s, 50 MB of L2): bytes, and the
// gathered ones above all. A d = 256 bf16 product gathers one 512-byte
// source row a stored edge (~2.36 M edges: ~1.2 GB) against ~0.2 GB of
// compulsory bytes (the rows of x once, each edge's index and weight, the
// output); the operations (2 E d) are ~0.01% of the card's rate. x itself
// (87 MB at d = 256 bf16) does not fit the L2, so a row is read again from
// device memory unless another edge read it a short while before.
//
// Design.
//  - Work items {row, begin, end, slot} over the dst-sorted edges, built
//    once with the graph (ops/spmm_kernel.py): each row an item of at most
//    CHUNK edges, a longer row (a hub: ~13k edges at ogbn-arxiv's shape)
//    split into chunks whose partial sums a second kernel adds in order.
//  - Persistent warps: the grid fills the card once and each warp walks
//    (slab, item) pairs a grid apart, slab-major, so a warp whose item is
//    long does not hold a block of finished neighbours.
//  - A slab is the LPE 16-byte vectors of the row that one group of LPE
//    lanes covers, one vector a lane; a warp holds 32 / LPE groups, each
//    on its own edge. The wrapper picks LPE from the width (the smallest
//    power of two that covers the row, at most 16), so narrow rows put
//    several edges on a warp, and rows wider than 16 vectors are walked
//    slab after slab, every item's first slab before any item's second,
//    so the slab of x in use is what the L2 holds (at d = 256 bf16: two
//    slabs 3.5% faster than one pass of 32 lanes, four 14% slower).
//  - Each batch of up to 32 edges: one coalesced load of their sources and
//    weights, a lane an edge, broadcast by shuffle; then each group keeps U
//    source rows in flight (U edges' loads issued before the first is
//    used), accumulating w_e x[src_e] in registers; four blocks an SM.
//    (Fetching the next item's descriptor and first batch behind the
//    current gathers measured no faster: -0.8% at d = 256, +3.6% at 40.)
//  - The edges' indices and weights and the output are streamed past the
//    L2 (evict-first loads and stores), so that they do not push x out.
//  - No atomics: a lane sums its edges in order, the groups meet in a fixed
//    xor butterfly, the chunks of a split row in chunk order; two calls
//    give the same bits.
//
// The wrapper (ops/spmm_kernel.py) checks devices, types and shapes, pads a
// row to whole 16-byte vectors where it must, and raises on what this
// kernel does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int WARPS = 8;                 // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct Operand;

template <>
struct Operand<__nv_bfloat16> {
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
  static __device__ __forceinline__ float widen(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 stream(
      const __nv_bfloat16* p) {
    const unsigned short b =
        __ldcs(reinterpret_cast<const unsigned short*>(p));
    return __ushort_as_bfloat16(b);
  }
};

template <>
struct Operand<float> {
  using C = float;
  static constexpr int VEC = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float widen(float x) { return x; }
  static __device__ __forceinline__ float stream(const float* p) {
    return __ldcs(p);
  }
};

template <>
struct Operand<double> {
  using C = double;
  static constexpr int VEC = 2;
  static __device__ __forceinline__ void unpack(const uint4& u, double* o) {
    o[0] = __hiloint2double(static_cast<int>(u.y), static_cast<int>(u.x));
    o[1] = __hiloint2double(static_cast<int>(u.w), static_cast<int>(u.z));
  }
  static __device__ __forceinline__ double widen(double x) { return x; }
  static __device__ __forceinline__ double stream(const double* p) {
    return __ldcs(p);
  }
};

// VEC sums to dst[0 .. valid), streamed; 16-byte stores where the whole
// vector lands on a 16-byte boundary
template <typename C, int VEC>
__device__ __forceinline__ void store(C* dst, const C (&acc)[VEC], int valid,
                                      bool aligned) {
  if (valid >= VEC && aligned) {
    if constexpr (std::is_same<C, float>::value) {
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        __stcs(reinterpret_cast<float4*>(dst + i),
               make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]));
    } else {
#pragma unroll
      for (int i = 0; i < VEC; i += 2)
        __stcs(reinterpret_cast<double2*>(dst + i),
               make_double2(acc[i], acc[i + 1]));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    if (i < valid) __stcs(dst + i, acc[i]);
}

// source rows in flight a group: 4, or as many as keep a warp's batch of
// 32 edges within one pass (8 and 16 measured slower at d = 256 and 40:
// fewer warps resident, and rows of ~14 edges fill few of the slots)
template <int LPE>
constexpr int IN_FLIGHT = (32 / LPE) * 4 <= 32 ? 4 : LPE;

// ---------------------------------------------------------------------------
// the product: one warp a (slab, item) pair, a group of LPE lanes an edge
// ---------------------------------------------------------------------------
// at most 64 registers a thread, so four blocks (32 warps) fit an SM: the
// loads in flight come from warps as much as from each warp's steps
template <typename T, int LPE>
__global__ void __launch_bounds__(THREADS, 4)
    spmm_kernel(const T* __restrict__ x, int nvec,
                const int* __restrict__ src, const T* __restrict__ w,
                const int4* __restrict__ items, int n_items, int n_slabs,
                int d, typename Operand<T>::C* __restrict__ out,
                typename Operand<T>::C* __restrict__ ws) {
  using P = Operand<T>;
  using C = typename P::C;
  constexpr int VEC = P::VEC;
  constexpr int EPW = 32 / LPE;          // edges a warp step
  constexpr int U = IN_FLIGHT<LPE>;      // steps in flight
  static_assert(EPW * U <= 32, "a pass stays within a batch of 32 edges");
  const int lane = threadIdx.x & 31;
  const int group = lane / LPE, gl = lane % LPE;
  const int dp = nvec * VEC;             // a row of x, padded
  const bool aligned = (static_cast<long long>(d) * sizeof(C)) % 16 == 0;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const long long n_work = static_cast<long long>(n_items) * n_slabs;
  for (long long wk = static_cast<long long>(blockIdx.x) * WARPS +
                      (threadIdx.x >> 5);
       wk < n_work; wk += static_cast<long long>(gridDim.x) * WARPS) {
    const int slab = static_cast<int>(wk / n_items);
    const int4 it = items[wk - static_cast<long long>(slab) * n_items];
    const int q = slab * LPE + gl;       // this lane's vector of the row
    const bool ok = q < nvec;
    C acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0;
    for (int b = it.y; b < it.z; b += 32) {
      const int n = min(32, it.z - b);
      int j = 0;
      C wl = 0;
      if (lane < n) {
        j = __ldcs(src + b + lane);
        wl = P::widen(P::stream(w + b + lane));
      }
      for (int k0 = 0; k0 < n; k0 += EPW * U) {
        uint4 buf[U];
        C we[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = k0 + u * EPW + group;
          const int jk = __shfl_sync(FULL, j, k);
          const C wk_ = __shfl_sync(FULL, wl, k);
          const bool in = k < n;
          we[u] = in ? wk_ : C(0);
          buf[u] = (in && ok)
                       ? __ldg(xv + static_cast<size_t>(jk) * nvec + q)
                       : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          C e[VEC];
          P::unpack(buf[u], e);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] += we[u] * e[i];
        }
      }
    }
#pragma unroll
    for (int off = LPE; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[i] += __shfl_xor_sync(FULL, acc[i], off);
    if (group != 0 || !ok) continue;
    const int c0 = q * VEC;
    if (it.w < 0)
      store<C, VEC>(out + static_cast<size_t>(it.x) * d + c0, acc, d - c0,
                    aligned);
    else
      store<C, VEC>(ws + static_cast<size_t>(it.w) * dp + c0, acc, VEC,
                    true);
  }
}

// The split rows {row, first slot, chunks}: their chunks' partial sums
// added in chunk order. One warp a row and 32 of its columns, a lane a
// column (a hub's ~200 chunks are read by as many warps as the row has
// 32-column slices).
template <typename C>
__global__ void __launch_bounds__(THREADS)
    spmm_merge_kernel(const int4* __restrict__ merges, int n_merges, int d,
                      int dp, const C* __restrict__ ws, C* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int slices = (d + 31) / 32;
  const long long wk = static_cast<long long>(blockIdx.x) * WARPS +
                       (threadIdx.x >> 5);
  if (wk >= static_cast<long long>(n_merges) * slices) return;
  const int4 it = merges[wk / slices];
  const int c = static_cast<int>(wk % slices) * 32 + lane;
  if (c >= d) return;
  const C* col = ws + static_cast<size_t>(it.y) * dp + c;
  C a = 0;
#pragma unroll 8
  for (int s = 0; s < it.z; ++s) a += col[static_cast<size_t>(s) * dp];
  __stcs(out + static_cast<size_t>(it.x) * d + c, a);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
inline unsigned blocks_for(long long warps) {
  return static_cast<unsigned>((warps + WARPS - 1) / WARPS);
}

// The blocks of the card's SMs can hold at once of this kernel, asked once
// a device.
template <typename T, int LPE>
long long resident_blocks() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, spmm_kernel<T, LPE>, THREADS, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <typename T, int LPE>
cudaError_t run(const void* x, int nvec, const void* src, const void* w,
                const void* items, int n_items, int d, void* out, void* ws,
                cudaStream_t st) {
  using C = typename Operand<T>::C;
  const int n_slabs = (nvec + LPE - 1) / LPE;
  const long long need = blocks_for(static_cast<long long>(n_items) * n_slabs);
  const long long full = resident_blocks<T, LPE>();
  const long long blocks = full > 0 && full < need ? full : need;
  spmm_kernel<T, LPE><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const T*>(x), nvec, static_cast<const int*>(src),
      static_cast<const T*>(w), static_cast<const int4*>(items), n_items,
      n_slabs, d, static_cast<C*>(out), static_cast<C*>(ws));
  return cudaGetLastError();
}

template <typename T>
cudaError_t product(const void* x, int nvec, int lanes, const void* src,
                    const void* w, const void* items, int n_items,
                    const void* merges, int n_merges, int d, void* out,
                    void* ws, cudaStream_t st) {
  using C = typename Operand<T>::C;
  constexpr int VEC = Operand<T>::VEC;
  if (nvec < 1 || d < 1 || d > nvec * VEC || d <= (nvec - 1) * VEC ||
      n_items < 0 || n_merges < 0)
    return cudaErrorInvalidValue;
  cudaError_t rc = cudaSuccess;
  if (n_items > 0) {
    switch (lanes) {
      case 1: rc = run<T, 1>(x, nvec, src, w, items, n_items, d, out, ws, st);
        break;
      case 2: rc = run<T, 2>(x, nvec, src, w, items, n_items, d, out, ws, st);
        break;
      case 4: rc = run<T, 4>(x, nvec, src, w, items, n_items, d, out, ws, st);
        break;
      case 8: rc = run<T, 8>(x, nvec, src, w, items, n_items, d, out, ws, st);
        break;
      case 16:
        rc = run<T, 16>(x, nvec, src, w, items, n_items, d, out, ws, st);
        break;
      case 32:
        rc = run<T, 32>(x, nvec, src, w, items, n_items, d, out, ws, st);
        break;
      default: return cudaErrorInvalidValue;
    }
    if (rc != cudaSuccess) return rc;
  }
  if (n_merges > 0) {
    const long long slices = (d + 31) / 32;
    spmm_merge_kernel<C><<<blocks_for(n_merges * slices), THREADS, 0, st>>>(
        static_cast<const int4*>(merges), n_merges, d, nvec * VEC,
        static_cast<const C*>(ws), static_cast<C*>(out));
    rc = cudaGetLastError();
  }
  return rc;
}

}  // namespace

extern "C" {

// dtype: 0 bf16 (sums and out in f32), 1 f32, 2 f64. x: (N, nvec * VEC)
// rows of whole 16-byte vectors, 16-byte aligned; lanes (1, 2, 4, ... 32):
// the lanes a slab of the row, one vector each; src (E) int32 and w (E) in
// x's type, the dst-sorted edges; items (n_items, 4) and merges
// (n_merges, 4) int32 (ops/spmm_kernel.py). Writes out (N, d) in the sums'
// type, d within the last vector of a row; ws (slots, nvec * VEC) is the
// split rows' scratch. Two kernels on the stream, the merge only where a
// row is split.
int spmm_launch(int dtype, const void* x, int nvec, int lanes,
                const void* src, const void* w, const void* items,
                int n_items, const void* merges, int n_merges, int d,
                void* out, void* ws, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (dtype) {
    case 0:
      rc = product<__nv_bfloat16>(x, nvec, lanes, src, w, items, n_items,
                                  merges, n_merges, d, out, ws, st);
      break;
    case 1:
      rc = product<float>(x, nvec, lanes, src, w, items, n_items, merges,
                          n_merges, d, out, ws, st);
      break;
    case 2:
      rc = product<double>(x, nvec, lanes, src, w, items, n_items, merges,
                           n_merges, d, out, ws, st);
      break;
    default:
      rc = cudaErrorInvalidValue;
  }
  return static_cast<int>(rc);
}

}  // extern "C"
