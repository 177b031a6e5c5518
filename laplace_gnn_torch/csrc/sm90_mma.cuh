// PTX wrappers shared by the port's kernels (matmul.cu, core_spmm.cu,
// flash_attention.cu): cp.async copies into shared memory (and fill16, 16
// bytes of a row at any copy width), ldmatrix fragment loads and the
// mma.sync products they feed. Header-only; every function is
// inline. The build hashes this file with each source that includes it
// (ops/cuda_build.py::library_path), so an edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES (16: .cg, bypassing L1; 8 or 4: .ca), of which the
// first src_bytes are read and the rest zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES),
                    "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 16 bytes of shared memory from `src`, of which the first `avail` bytes
// lie inside the matrix and the rest read 0, in copies of VEC bytes:
// cp.async for 16, 8 or 4 (src-size zero-fills), guarded register loads
// for 2 or 1.
template <int VEC>
__device__ __forceinline__ void fill16(unsigned char* dst,
                                       const unsigned char* src, int avail,
                                       const void* base) {
  avail = avail < 0 ? 0 : (avail > 16 ? 16 : avail);
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int q = 0; q < 16 / VEC; ++q) {
      const int a = min(max(avail - VEC * q, 0), VEC);
      cp_async<VEC>(dst + VEC * q, a > 0 ? src + VEC * q : base, a);
    }
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16 / VEC; ++e) {
      if (VEC * e >= avail) break;
      const uint32_t v = VEC == 2
          ? __ldg(reinterpret_cast<const unsigned short*>(src) + e)
          : __ldg(src + e);
      w[e * VEC / 4] |= v << (8 * ((e * VEC) % 4));
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)) : "memory");
}

// c += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: m16n8k8, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace sm90
