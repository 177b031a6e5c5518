// graph_prep: native host-side graph preprocessing engine.
//
// The TPU compute path (SpMM/KFAC/marglik) is JAX/XLA/Pallas; this library
// is the runtime *around* it: the O(E) host-side transforms that stand
// between an on-disk edge list and a device-ready SparseGraph. The
// reference framework has no native runtime (SURVEY.md: zero C++/CUDA
// files; everything host-side is Python loops / numpy argsorts, e.g. the
// per-node ELL packing loop). At ogbn-arxiv scale and above these
// transforms dominate ingestion wall-clock, so they are implemented here
// as linear-time counting passes instead of O(E log E) comparison sorts:
//
//   - lg_sort_by_dst:    stable counting sort of a COO edge list by dst,
//                        emitting CSR-style offsets in the same pass.
//   - lg_lexsort2:       stable two-pass counting lexsort (major, minor) —
//                        used by the symmetry check.
//   - lg_check_symmetric: sorted-(dst,src,w) == sorted-(src,dst,w) triples.
//   - lg_choose_k:       hybrid-ELL width selection from the degree
//                        histogram in O(N + max_deg) (the numpy version is
//                        O(N * max_deg)).
//   - lg_ell_pack:       padded neighbor-list packing + overflow COO
//                        remainder, OpenMP-parallel over nodes.
//   - lg_degree:         weighted in-degree accumulation.
//
// Exact-parity contract: every function reproduces the numpy reference
// implementation in graph/container.py bit-for-bit (stable orders, same
// accumulation order), tested in tests/test_native.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Weighted in-degree: deg[dst[e]] += w[e]. Sequential in edge order
// (bit-identical to np.add.at's accumulation order).
void lg_degree(const int32_t* dst, const double* w, int64_t E, int32_t N,
               double* deg) {
    std::memset(deg, 0, sizeof(double) * (size_t)N);
    for (int64_t e = 0; e < E; ++e) deg[dst[e]] += w[e];
}

// Stable counting sort by dst. Emits sorted (src, dst, w) and CSR offsets
// (size N+1) so downstream passes get per-node segments for free.
void lg_sort_by_dst(const int32_t* src, const int32_t* dst, const double* w,
                    int64_t E, int32_t N,
                    int32_t* src_o, int32_t* dst_o, double* w_o,
                    int64_t* offsets) {
    std::vector<int64_t> count((size_t)N + 1, 0);
    for (int64_t e = 0; e < E; ++e) count[(size_t)dst[e] + 1]++;
    for (int32_t i = 0; i < N; ++i) count[(size_t)i + 1] += count[(size_t)i];
    std::memcpy(offsets, count.data(), sizeof(int64_t) * ((size_t)N + 1));
    std::vector<int64_t> cursor(count.begin(), count.end() - 1);
    for (int64_t e = 0; e < E; ++e) {
        int64_t pos = cursor[(size_t)dst[e]]++;
        src_o[pos] = src[e];
        dst_o[pos] = dst[e];
        w_o[pos] = w[e];
    }
}

// Stable lexsort permutation: sort indices by (major, minor) — minor pass
// first, then major, both stable counting sorts. Matches
// np.lexsort((minor, major)).
void lg_lexsort2(const int32_t* minor, const int32_t* major, int64_t E,
                 int32_t N, int64_t* perm) {
    std::vector<int64_t> tmp((size_t)E);
    std::vector<int64_t> count((size_t)N + 1, 0);
    // pass 1: by minor
    for (int64_t e = 0; e < E; ++e) count[(size_t)minor[e] + 1]++;
    for (int32_t i = 0; i < N; ++i) count[(size_t)i + 1] += count[(size_t)i];
    {
        std::vector<int64_t> cur(count.begin(), count.end() - 1);
        for (int64_t e = 0; e < E; ++e) tmp[(size_t)cur[(size_t)minor[e]]++] = e;
    }
    // pass 2: by major (stable over pass-1 order)
    std::fill(count.begin(), count.end(), 0);
    for (int64_t e = 0; e < E; ++e) count[(size_t)major[e] + 1]++;
    for (int32_t i = 0; i < N; ++i) count[(size_t)i + 1] += count[(size_t)i];
    {
        std::vector<int64_t> cur(count.begin(), count.end() - 1);
        for (int64_t t = 0; t < E; ++t) {
            int64_t e = tmp[(size_t)t];
            perm[(size_t)cur[(size_t)major[e]]++] = e;
        }
    }
}

// Symmetry detection: the multiset of (dst, src, w) triples equals the
// multiset of (src, dst, w) triples, with np.allclose tolerances on w.
// Mirrors graph/container.py's double-lexsort check.
int lg_check_symmetric(const int32_t* src, const int32_t* dst,
                       const double* w, int64_t E, int32_t N,
                       double rtol, double atol) {
    std::vector<int64_t> p1((size_t)E), p2((size_t)E);
    lg_lexsort2(src, dst, E, N, p1.data());   // sort by (dst, src)
    lg_lexsort2(dst, src, E, N, p2.data());   // sort by (src, dst)
    for (int64_t i = 0; i < E; ++i) {
        int64_t a = p1[(size_t)i], b = p2[(size_t)i];
        if (src[a] != dst[b] || dst[a] != src[b]) return 0;
        double diff = std::fabs(w[a] - w[b]);
        if (diff > atol + rtol * std::fabs(w[b])) return 0;
    }
    return 1;
}

// Hybrid-ELL width selection (mirrors add_ell_format's auto-K loop):
// smallest K whose padding overhead N*K stays within pad_budget of the
// edges it covers, preferring >=90% coverage. O(N + max_deg) via the
// degree histogram: in_ell(k) = sum_{d<=k} d*hist[d] + k * |{d > k}|.
int32_t lg_choose_k(const int64_t* offsets, int32_t N, double pad_budget) {
    int64_t max_deg = 0, total = 0;
    std::vector<int64_t> deg((size_t)N);
    for (int32_t i = 0; i < N; ++i) {
        deg[(size_t)i] = offsets[(size_t)i + 1] - offsets[(size_t)i];
        if (deg[(size_t)i] > max_deg) max_deg = deg[(size_t)i];
        total += deg[(size_t)i];
    }
    if (total < 1) total = 1;
    std::vector<int64_t> hist((size_t)max_deg + 1, 0);
    for (int32_t i = 0; i < N; ++i) hist[(size_t)deg[(size_t)i]]++;
    int64_t max_k = max_deg;
    int64_t covered = 0;        // sum_{d<=k} d*hist[d]
    int64_t nodes_le = hist.empty() ? 0 : hist[0];  // |{d <= k}| at k=0
    for (int64_t k = 1; k <= max_deg; ++k) {
        covered += k * hist[(size_t)k];
        nodes_le += hist[(size_t)k];
        int64_t in_ell = covered + k * ((int64_t)N - nodes_le);
        if ((double)N * (double)k <= pad_budget * (double)in_ell
            || (double)in_ell >= 0.98 * (double)total) {
            max_k = k;
            if ((double)in_ell >= 0.9 * (double)total) break;
        }
    }
    return (int32_t)max_k;
}

// Remainder edge count for a given K: sum max(0, deg - K).
int64_t lg_rem_count(const int64_t* offsets, int32_t N, int32_t K) {
    int64_t rem = 0;
    for (int32_t i = 0; i < N; ++i) {
        int64_t d = offsets[(size_t)i + 1] - offsets[(size_t)i];
        if (d > K) rem += d - K;
    }
    return rem;
}

// Pack dst-sorted edges into (N, K) padded neighbor lists; edges beyond K
// per node spill to a dst-sorted COO remainder. cols/vals must be
// zero-initialized by the caller (padding slots stay 0). Parallel over
// nodes — every node writes disjoint rows, remainder slots come from a
// serial prefix pass.
void lg_ell_pack(const int32_t* src_sorted, const double* w_sorted,
                 const int64_t* offsets, int32_t N, int32_t K,
                 int32_t* cols, double* vals,
                 int32_t* rem_src, int32_t* rem_dst, double* rem_w) {
    std::vector<int64_t> rem_off((size_t)N + 1, 0);
    for (int32_t i = 0; i < N; ++i) {
        int64_t d = offsets[(size_t)i + 1] - offsets[(size_t)i];
        rem_off[(size_t)i + 1] = rem_off[(size_t)i] + (d > K ? d - K : 0);
    }
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int32_t i = 0; i < N; ++i) {
        int64_t lo = offsets[(size_t)i];
        int64_t d = offsets[(size_t)i + 1] - lo;
        int64_t kk = d < K ? d : K;
        for (int64_t j = 0; j < kk; ++j) {
            cols[(size_t)i * K + (size_t)j] = src_sorted[(size_t)(lo + j)];
            vals[(size_t)i * K + (size_t)j] = w_sorted[(size_t)(lo + j)];
        }
        int64_t r = rem_off[(size_t)i];
        for (int64_t j = K; j < d; ++j, ++r) {
            rem_src[(size_t)r] = src_sorted[(size_t)(lo + j)];
            rem_dst[(size_t)r] = i;
            rem_w[(size_t)r] = w_sorted[(size_t)(lo + j)];
        }
    }
}

}  // extern "C"
