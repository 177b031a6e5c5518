// Batched eigensolvers for small symmetric matrices, n <= 128, one block
// (CTA) a matrix, every matrix of a launch the same size.
//
// Replaces no Pallas kernel: the JAX package leaves its eigensolves to XLA
// (laplace_gnn_tpu/ops/linalg.py, jnp.linalg.eigvalsh). It exists because
// torch's eigensolvers (cuSOLVER) check their status on the host: each call
// makes the host wait for the device, and a CUDA graph cannot capture one,
// so the whole run's Kron -log marglik evaluations and hypersteps (two
// solves each, of the KFAC factors: 64 x 64 twice and 7 x 7 at Cora's
// widths) could not replay from graphs. These kernels launch on the current
// stream, allocate nothing, never synchronise, and report a non-finite input
// or an unconverged solve by setting bits of a device flag (atomicOr) that
// the caller reads where it already reads the device.
//
// What bounds them on an H100: not bytes (2 n^2 elements in and out: 33 KB
// at n = 64 in f32, 10 ns at 3.35 TB/s) nor operations (~(4/3) n^3 for the
// reduction, 0.35 MFLOP at n = 64, 5 ns at 67 TFLOP/s f32), but latency: the
// reduction is n - 2 dependent steps of three block-wide barriers each
// (~1.7 us a step at n = 64, two thirds of the kernel), and each eigenvalue
// a chain of multisection rounds, each a length-n recurrence with a
// division. The design keeps the matrix in shared memory for the whole
// solve (no device-memory traffic between steps, rows padded to n + 1 so a
// column walk hits 32 banks), shares each row of the step's product among
// a few lanes, and gives each eigenvalue a few lanes of its own.
//
// small_eigvalsh_kernel: eigenvalues, ascending. Householder reduction to a
// tridiagonal T (A <- H A H with H = I - tau v v^T, the trailing block
// updated as A - v w^T - w v^T), then g lanes (g = 4 at n = 64) multisect
// the Gershgorin interval of T for the k-th eigenvalue on Sturm counts (the
// number of negative pivots of T - x I, each pivot kept at least pivmin in
// size), so the k-th value comes out k-th: no sort. A round shrinks the
// bracket (g + 1)-fold; it stops within 2 eps of its ends' size or eps
// ||T||, the accuracy that the reduction leaves.
//
// small_eigh_kernel: eigenvalues and eigenvectors (the backward's), by
// cyclic two-sided Jacobi in the round-robin parallel order: each round
// rotates n / 2 disjoint (p, q) pairs at once (rows, then columns, of A in
// shared memory; columns of V beside it, or in the output where shared
// memory is too small: f64 above n = 119), n - 1 rounds
// a sweep, sweeps until the off-diagonal norm is at most eps ||A||_F. Its
// vectors are orthonormal however the eigenvalues cluster. Values and
// vectors come out in the order of A's diagonal; the wrapper sorts them.
//
// Both read the lower triangle (torch's UPLO = "L") and mirror it. In f32
// and f64; the wrapper raises on anything else.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_N = 128;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BAD_INPUT = 1;       // a non-finite entry
constexpr int NOT_CONVERGED = 2;   // Jacobi's sweeps ran out

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ float eps() { return 1.1920929e-07f; }      // 2^-23
  static __device__ float safe_min() { return 1.17549435e-38f; }
  static __device__ float root(float x) { return sqrtf(x); }
  static __device__ float mag(float x) { return fabsf(x); }
  static __device__ float lower(float x, float y) { return fminf(x, y); }
  static __device__ float upper(float x, float y) { return fmaxf(x, y); }
  static __device__ float nan() { return __int_as_float(0x7fc00000); }
  static constexpr int max_sweeps = 20;
};

template <>
struct Num<double> {
  static __device__ double eps() { return 2.220446049250313e-16; }
  static __device__ double safe_min() { return 2.2250738585072014e-308; }
  static __device__ double root(double x) { return sqrt(x); }
  static __device__ double mag(double x) { return fabs(x); }
  static __device__ double lower(double x, double y) { return fmin(x, y); }
  static __device__ double upper(double x, double y) { return fmax(x, y); }
  static __device__ double nan() {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
  static constexpr int max_sweeps = 30;
};

// x - x is 0 for a finite x and NaN for an infinity or a NaN (IEEE; the
// build uses no fast-math flag)
template <typename T>
__device__ __forceinline__ bool finite(T x) {
  return x - x == T(0);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The sum of every thread's x, in a fixed order, returned to every thread.
// `red` holds WARPS values; the caller keeps a barrier between two uses of
// one `red`.
template <typename T>
__device__ T block_sum(T x, T* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  T s = T(0);
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

// Lower triangle of the batch's matrix into a (row stride ld), mirrored;
// true on every thread when an entry read is not finite.
template <typename T>
__device__ bool load_lower(const T* __restrict__ in, T* a, int n, int ld) {
  bool bad = false;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    if (j > i) continue;
    const T x = in[idx];
    bad |= !finite(x);
    a[i * ld + j] = x;
    a[j * ld + i] = x;
  }
  return __syncthreads_or(bad) != 0;
}

// Lanes of a warp that share one of `items` rows or eigenvalues: the
// largest power of two up to 32 with lanes * items <= THREADS.
__device__ __forceinline__ int lanes_per_item(int items) {
  int g = 32;
  while (g > 1 && g * items > THREADS) g >>= 1;
  return g;
}

// Number of eigenvalues of the tridiagonal (d, e2 = e^2) below x.
template <typename T>
__device__ __forceinline__ int sturm_count(const T* d, const T* e2, int n,
                                           T x, T pivmin) {
  int c = 0;
  T q = d[0] - x;
  if (Num<T>::mag(q) < pivmin) q = -pivmin;
  c += q < T(0);
  for (int i = 1; i < n; ++i) {
    q = d[i] - x - e2[i - 1] / q;
    if (Num<T>::mag(q) < pivmin) q = -pivmin;
    c += q < T(0);
  }
  return c;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
small_eigvalsh_kernel(const T* __restrict__ in, T* __restrict__ out, int n,
                      int* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ld = n + 1;
  T* a = smem;                 // n x ld
  T* v = a + n * ld;           // Householder vector
  T* w = v + n;                // p = tau A22 v
  T* d = w + n;                // T's diagonal
  T* e2 = d + n;               // T's squared off-diagonal
  T* red0 = e2 + n;            // WARPS
  T* red1 = red0 + WARPS;      // WARPS
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;

  if (load_lower(in + base * n, a, n, ld)) {
    if (tid == 0) atomicOr(status, BAD_INPUT);
    for (int k = tid; k < n; k += blockDim.x) out[base + k] = Num<T>::nan();
    return;
  }

  // Three barriers a step: the reduction for sigma (which also orders
  // the previous step's update before this step's reads), the one after
  // v, and the reduction for K (which also publishes p). Each step's
  // update sums the next step's sigma on the way.
  T part = T(0);
  for (int i = 2 + tid; i < n; i += blockDim.x) part += a[i * ld] * a[i * ld];
  for (int k = 0; k + 2 < n; ++k) {
    const int m = n - k - 1;                 // rows and columns k+1 .. n-1
    T* col = a + (k + 1) * ld + k;           // column k below the diagonal
    const T sigma = block_sum(part, red0);   // of col[1 ..]
    const T x0 = col[0];
    if (tid == 0) d[k] = a[k * ld + k];
    if (sigma == T(0)) {                     // already tridiagonal here
      if (tid == 0) e2[k] = x0 * x0;
      part = T(0);
      for (int i = k + 3 + tid; i < n; i += blockDim.x)
        part += a[i * ld + k + 1] * a[i * ld + k + 1];
      __syncthreads();                       // red0 read by all
      continue;
    }
    const T mu = Num<T>::root(x0 * x0 + sigma);
    const T v0 = x0 <= T(0) ? x0 - mu : -sigma / (x0 + mu);
    const T tau = T(2) * v0 * v0 / (sigma + v0 * v0);
    if (tid == 0) e2[k] = mu * mu;
    for (int i = tid; i < m; i += blockDim.x)
      v[i] = i == 0 ? T(1) : col[i * ld] / v0;
    __syncthreads();
    T* a22 = a + (k + 1) * ld + (k + 1);
    // p = tau A22 v into w: g lanes of a warp share a row (g the largest
    // power of two up to 32 with g m <= THREADS), joined by shuffles; the
    // passes are the same on every thread, so whole warps shuffle
    const int g = lanes_per_item(m);
    const int sub = tid & (g - 1);
    part = T(0);
    for (int i0 = 0; i0 < m; i0 += THREADS / g) {
      const int i = i0 + tid / g;
      T s = T(0);
      if (i < m) {
        const T* row = a22 + i * ld;
        for (int j = sub; j < m; j += g) s += row[j] * v[j];
      }
      for (int o = g / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (i < m && sub == 0) {
        w[i] = tau * s;
        part += v[i] * w[i];
      }
    }
    const T K = T(0.5) * tau * block_sum(part, red1);
    // A22 -= v w^T + w v^T with w = p - K v formed in place, a warp a row;
    // column 0 below its second row is the next step's sigma
    part = T(0);
    for (int i = tid >> 5; i < m; i += WARPS) {
      T* row = a22 + i * ld;
      const T vi = v[i], wi = w[i] - K * vi;
      for (int j = tid & 31; j < m; j += 32) {
        const T x = row[j] - (vi * (w[j] - K * v[j]) + wi * v[j]);
        row[j] = x;
        if (j == 0 && i >= 2) part += x * x;
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    if (n >= 2) {
      const T last = a[(n - 1) * ld + (n - 2)];
      d[n - 2] = a[(n - 2) * ld + (n - 2)];
      e2[n - 2] = last * last;
    }
    d[n - 1] = a[(n - 1) * ld + (n - 1)];
  }
  __syncthreads();

  // every thread: the Gershgorin interval of T and the pivot floor
  T lo = d[0], hi = d[0], e2max = T(0);
  bool bad = false;
  for (int i = 0; i < n; ++i) {
    const T left = i > 0 ? Num<T>::root(e2[i - 1]) : T(0);
    const T right = i + 1 < n ? Num<T>::root(e2[i]) : T(0);
    bad |= !finite(d[i] - left - right) || !finite(d[i] + left + right);
    lo = Num<T>::lower(lo, d[i] - left - right);
    hi = Num<T>::upper(hi, d[i] + left + right);
    if (i + 1 < n) e2max = Num<T>::upper(e2max, e2[i]);
  }
  const T eps = Num<T>::eps();
  const T tnorm = Num<T>::upper(Num<T>::mag(lo), Num<T>::mag(hi));
  const T pivmin = Num<T>::safe_min() * Num<T>::upper(T(1), e2max);
  if (__syncthreads_or(bad)) {
    if (tid == 0) atomicOr(status, BAD_INPUT);
    for (int k = tid; k < n; k += blockDim.x) out[base + k] = Num<T>::nan();
    return;
  }
  const T widen = T(2) * eps * tnorm * n + T(2) * pivmin;
  lo -= widen;
  hi += widen;
  const T floor_tol = eps * tnorm;
  // multisection: g lanes an eigenvalue (g as above, for n), each counting
  // at one of g points evenly inside the bracket; the first point with more
  // than k eigenvalues below it and the one before it bracket the next
  // round, a (g + 1)-fold shrink (about 11 rounds in f32 at g = 4)
  const int g = lanes_per_item(n);
  const int sub = tid & (g - 1);
  const int first_lane = (tid & 31) & ~(g - 1);
  const unsigned group = g == 32 ? 0xffffffffu : (1u << g) - 1u;
  for (int k0 = 0; k0 < n; k0 += THREADS / g) {
    const int k = k0 + tid / g;
    T l = lo, h = hi;
    bool done = k >= n;
    for (int it = 0; it < 200; ++it) {
      done = done || h - l <= Num<T>::upper(
          T(2) * eps * Num<T>::upper(Num<T>::mag(l), Num<T>::mag(h)),
          floor_tol);
      if (__all_sync(0xffffffffu, done)) break;
      const T x = l + (h - l) * T(sub + 1) / T(g + 1);
      const bool above = !done && sturm_count(d, e2, n, x, pivmin) > k;
      const unsigned bits =
          (__ballot_sync(0xffffffffu, above) >> first_lane) & group;
      if (!done) {
        const int first = bits ? __ffs(bits) - 1 : g;
        // the points as the lanes that counted them computed them
        const T nl = first == 0 ? l : l + (h - l) * T(first) / T(g + 1);
        const T nh = first == g ? h : l + (h - l) * T(first + 1) / T(g + 1);
        done = nl == l && nh == h;     // no representable point inside
        l = nl;
        h = nh;
      }
    }
    if (k < n && sub == 0) out[base + k] = T(0.5) * (l + h);
  }
}

// The round-robin tournament on np = n rounded up to even: round r pairs
// (np - 1, r) and ((r + t) % (np - 1), (r - t) mod (np - 1)) for t >= 1.
__device__ __forceinline__ void rr_pair(int np, int r, int t, int* p,
                                        int* q) {
  int x, y;
  if (t == 0) {
    x = np - 1;
    y = r;
  } else {
    x = (r + t) % (np - 1);
    y = (r - t + np - 1) % (np - 1);
  }
  *p = x < y ? x : y;
  *q = x < y ? y : x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
small_eigh_kernel(const T* __restrict__ in, T* __restrict__ vals,
                  T* __restrict__ vecs, int n, int v_shared,
                  int* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int ld = n + 1;
  const int np = n + (n & 1);
  const int half = np / 2;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  T* a = smem;                     // n x ld
  // V, row-major, column k = vector k: in shared memory (row stride n + 1)
  // where it fits beside A (f32 always, f64 up to n = 119), else in place
  // in the output
  T* out_v = vecs + base * n;
  T* V = v_shared ? a + n * ld : out_v;
  const int ldv = v_shared ? ld : n;
  T* cs = (v_shared ? V + n * ld : a + n * ld);   // c of each pair
  T* sn = cs + half;               // s of each pair
  T* red = sn + half;              // WARPS
  int* pp = reinterpret_cast<int*>(red + WARPS);
  int* qq = pp + half;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    V[i * ldv + j] = i == j ? T(1) : T(0);
  }
  if (load_lower(in + base * n, a, n, ld)) {
    if (tid == 0) atomicOr(status, BAD_INPUT);
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      out_v[idx] = Num<T>::nan();
      if (idx < n) vals[base + idx] = Num<T>::nan();
    }
    return;
  }
  T part = T(0);
  for (int idx = tid; idx < n * n; idx += blockDim.x) {
    const T x = a[(idx / n) * ld + idx % n];
    part += x * x;
  }
  const T total = block_sum(part, red);
  const T eps = Num<T>::eps();
  const T target = eps * eps * total;

  bool converged = false;
  for (int sweep = 0; sweep <= Num<T>::max_sweeps; ++sweep) {
    part = T(0);
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      const int i = idx / n, j = idx - i * n;
      if (i != j) part += a[i * ld + j] * a[i * ld + j];
    }
    __syncthreads();                   // red's previous readers are done
    const T off = block_sum(part, red);
    if (off <= target) {
      converged = true;
      break;
    }
    if (sweep == Num<T>::max_sweeps) break;
    for (int r = 0; r < np - 1; ++r) {
      for (int t = tid; t < half; t += blockDim.x) {
        int p, q;
        rr_pair(np, r, t, &p, &q);
        T c = T(1), s = T(0);
        if (q < n) {
          const T apq = a[p * ld + q];
          if (apq != T(0)) {
            const T theta = (a[q * ld + q] - a[p * ld + p]) / (T(2) * apq);
            const T tt = (theta >= T(0) ? T(1) : T(-1)) /
                         (Num<T>::mag(theta) +
                          Num<T>::root(theta * theta + T(1)));
            c = T(1) / Num<T>::root(tt * tt + T(1));
            s = tt * c;
          }
        }
        pp[t] = p;
        qq[t] = q < n ? q : p;         // a pair with the padding is idle
        cs[t] = c;
        sn[t] = s;
      }
      __syncthreads();
      // rows p and q: A <- J^T A
      for (int idx = tid; idx < half * n; idx += blockDim.x) {
        const int t = idx / n, j = idx - t * n;
        const int p = pp[t], q = qq[t];
        if (p == q) continue;
        const T c = cs[t], s = sn[t];
        const T ap = a[p * ld + j], aq = a[q * ld + j];
        a[p * ld + j] = c * ap - s * aq;
        a[q * ld + j] = s * ap + c * aq;
      }
      __syncthreads();
      // columns p and q: A <- A J, V <- V J
      for (int idx = tid; idx < half * n; idx += blockDim.x) {
        const int t = idx / n, i = idx - t * n;
        const int p = pp[t], q = qq[t];
        if (p == q) continue;
        const T c = cs[t], s = sn[t];
        const T ap = a[i * ld + p], aq = a[i * ld + q];
        // the rotation zeroes a[p][q] and a[q][p]: set them exactly, so
        // rounding leaves no off-diagonal mass of the order of ||A||
        a[i * ld + p] = i == q ? T(0) : c * ap - s * aq;
        a[i * ld + q] = i == p ? T(0) : s * ap + c * aq;
        const T vp = V[i * ldv + p], vq = V[i * ldv + q];
        V[i * ldv + p] = c * vp - s * vq;
        V[i * ldv + q] = s * vp + c * vq;
      }
      __syncthreads();
    }
  }
  if (!converged && tid == 0) atomicOr(status, NOT_CONVERGED);
  for (int k = tid; k < n; k += blockDim.x) vals[base + k] = a[k * ld + k];
  if (v_shared)
    for (int idx = tid; idx < n * n; idx += blockDim.x) {
      const int i = idx / n;
      out_v[idx] = V[i * ldv + idx - i * n];
    }
}

template <typename T>
size_t values_smem(int n) {
  return (static_cast<size_t>(n) * (n + 1) + 4 * n + 2 * WARPS) * sizeof(T);
}

constexpr size_t SMEM_LIMIT = 232448;   // a block's shared memory (H100)

template <typename T>
size_t vectors_smem(int n, bool v_shared) {
  const int half = (n + 1) / 2;
  const size_t square = static_cast<size_t>(n) * (n + 1);
  return ((v_shared ? 2 : 1) * square + 2 * half + WARPS) * sizeof(T) +
         2 * half * sizeof(int);
}

template <typename T>
cudaError_t launch_values(const void* in, void* out, int batch, int n,
                          int* status, cudaStream_t stream) {
  const size_t smem = values_smem<T>(n);
  auto kernel = small_eigvalsh_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<batch, THREADS, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), n, status);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vectors(const void* in, void* vals, void* vecs, int batch,
                           int n, int* status, cudaStream_t stream) {
  const bool v_shared = vectors_smem<T>(n, true) <= SMEM_LIMIT;
  const size_t smem = vectors_smem<T>(n, v_shared);
  auto kernel = small_eigh_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<batch, THREADS, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(vals), static_cast<T*>(vecs),
      n, static_cast<int>(v_shared), status);
  return cudaGetLastError();
}

bool valid(int batch, int n, int f64) {
  return batch >= 1 && batch <= 65535 && n >= 1 && n <= MAX_N &&
         (f64 == 0 || f64 == 1);
}

}  // namespace

extern "C" {

// in: (batch, n, n) contiguous, f32 (f64 = 0) or f64 (f64 = 1); out:
// (batch, n) eigenvalues, ascending; status: one int on the device, whose
// bits the kernel sets (1: a non-finite input, whose values come out NaN).
int small_eigvalsh_launch(const void* in, void* out, int batch, int n,
                          int f64, void* status, void* stream) {
  if (!valid(batch, n, f64)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<int*>(status);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f64 ? launch_values<double>(in, out, batch, n, st, s)
          : launch_values<float>(in, out, batch, n, st, s));
}

// As above, with vals (batch, n) in the order of the converged diagonal and
// vecs (batch, n, n) whose column k is the eigenvector of vals[k]; status
// bit 2: Jacobi did not converge.
int small_eigh_launch(const void* in, void* vals, void* vecs, int batch,
                      int n, int f64, void* status, void* stream) {
  if (!valid(batch, n, f64)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<int*>(status);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f64 ? launch_vectors<double>(in, vals, vecs, batch, n, st, s)
          : launch_vectors<float>(in, vals, vecs, batch, n, st, s));
}

}  // extern "C"
