// Helpers shared by the attention kernels: the bf16 tensor-core product,
// fragment packing, and the tile copy from global to shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aaclip {

// d += a . b on the tensor cores: A 16x16 row-major, B 16x8 col-major, bf16
// in, fp32 accumulation. Fragment layouts (g = lane / 4, t = lane % 4):
//   A: a0 (row g, cols 2t..2t+1), a1 (row g+8, same), a2/a3 the same at
//      cols +8;  B: b0 (k rows 2t..2t+1, col g), b1 (k rows +8);
//   C/D: c0,c1 (row g, cols 2t..2t+1), c2,c3 (row g+8, same).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of a [16 x 16*KS] row-major tile in shared memory (row
// stride SLD) whose first row is r0.
template <int KS, int SLD>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[KS][4],
                                             const __nv_bfloat16* s, int r0,
                                             int t) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    f[ks][0] = ld32(s + r0 * SLD + ks * 16 + t * 2);
    f[ks][1] = ld32(s + (r0 + 8) * SLD + ks * 16 + t * 2);
    f[ks][2] = ld32(s + r0 * SLD + ks * 16 + 8 + t * 2);
    f[ks][3] = ld32(s + (r0 + 8) * SLD + ks * 16 + 8 + t * 2);
  }
}

// Copy a [kRows, HD] tile starting at row `row0` from global memory (row
// stride `ld` elements) into shared memory (row stride SLD), 16 bytes per
// thread and step; rows >= S are zero-filled.
template <typename T, int HD, int SLD, int kRows>
__device__ __forceinline__ void load_tile(T* smem, const T* src, int64_t ld,
                                          int row0, int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      v = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(smem + r * SLD + c) = v;
  }
}

}  // namespace aaclip
