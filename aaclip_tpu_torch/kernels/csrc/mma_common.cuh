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

// ---------------------------------------------- the 3-pass ("high") mode
// The JAX package's _kdot under precision "high" (XLA's F32_AS_3BF16): an
// fp32 operand x is split into bf16 halves hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact in fp32), and a product is hi.hi + hi.lo + lo.hi of the
// halves, each on the bf16 tensor cores with fp32 accumulation; the
// dropped lo.lo term and lo's own rounding leave about 2^-16 relative.

// Two fp32 values as the packed bf16 pairs of their hi and lo halves.
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_f32(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// d += a . b in three passes: a's and b's hi and lo fragments (layouts as
// mma_bf16_16816), hi.hi, then hi.lo, then lo.hi into one fp32
// accumulator.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_bf16_16816(d, ah, bh0, bh1);
  mma_bf16_16816(d, ah, bl0, bl1);
  mma_bf16_16816(d, al, bh0, bh1);
}

// C-layout fp32 values [16 x 8*NT] as the hi and lo A fragments of a
// product over them: two adjacent n-tiles form one 16-wide k-step.
template <int NT>
__device__ __forceinline__ void split_a_frags(uint32_t (&hi)[NT / 2][4],
                                              uint32_t (&lo)[NT / 2][4],
                                              const float (&v)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int j = (nt & 1) * 2;
    split_pack(v[nt][0], v[nt][1], hi[nt >> 1][j], lo[nt >> 1][j]);
    split_pack(v[nt][2], v[nt][3], hi[nt >> 1][j + 1], lo[nt >> 1][j + 1]);
  }
}

// ---------------------------------------------- the 6-pass ("highest") mode
// The JAX package's _kdot under precision "highest" on a TPU (the native
// 6-pass form): an fp32 x is held as three bf16 values hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid); each difference is exact
// in fp32, and hi + mid + lo = x whenever hi does not overflow and the
// residuals' bits lie above bf16's smallest subnormal step (2^-133):
// |x| in [2^-110, 0x1.fep127). A product is the six bf16 products
// hi.hi + hi.mid + mid.hi + hi.lo + lo.hi + mid.mid summed in fp32, the
// small ones first (hopper_common.cuh, mma6_ss / mma6_rs); the dropped
// terms are about 2^-24 relative.

__device__ __forceinline__ void split3(float x, __nv_bfloat16& hi,
                                       __nv_bfloat16& mid,
                                       __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// Two fp32 values as the packed bf16 pairs of their three planes.
__device__ __forceinline__ void split3_pack(float x0, float x1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  __nv_bfloat16 h0, m0, l0, h1, m1, l1;
  split3(x0, h0, m0, l0);
  split3(x1, h1, m1, l1);
  hi = pack_bf16(h0, h1);
  mid = pack_bf16(m0, m1);
  lo = pack_bf16(l0, l1);
}

// Two fp32 values as the packed bf16 pairs of their kP planes, p[plane]:
// split3_pack's hi, mid, lo (kP 3) or split_pack's hi, lo (kP 2).
template <int kP>
__device__ __forceinline__ void split_planes(float x0, float x1,
                                             uint32_t (&p)[kP]) {
  static_assert(kP == 2 || kP == 3, "two or three bf16 planes");
  if constexpr (kP == 3)
    split3_pack(x0, x1, p[0], p[1], p[2]);
  else
    split_pack(x0, x1, p[0], p[1]);
}

// Two fp32 values as the packed bf16 pairs of their kP planes, into
// f[plane][k][r]: split3's hi, mid, lo (kP 3) or split_pack's hi, lo
// (kP 2, whose lo is split3's mid bit for bit).
template <int kP, int KK>
__device__ __forceinline__ void split_frag(uint32_t (&f)[kP][KK][4], int k,
                                           int r, float x0, float x1) {
  static_assert(kP == 2 || kP == 3, "two or three bf16 planes");
  if constexpr (kP == 3)
    split3_pack(x0, x1, f[0][k][r], f[1][k][r], f[2][k][r]);
  else
    split_pack(x0, x1, f[0][k][r], f[1][k][r]);
}

// The A fragments of the kP planes (f[plane][k-step]) of a [64 x 2N] fp32
// wgmma accumulator (N registers a thread: 32 for 64 columns, 16 for 32):
// two adjacent 8-column groups form one 16-deep k-step, as in the bf16
// kernels' pack_frags.
template <int kP, int N>
__device__ __forceinline__ void split_frags(uint32_t (&f)[kP][N / 8][4],
                                            const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int k = j >> 1, r = (j & 1) * 2;
    split_frag<kP>(f, k, r, v[4 * j + 0], v[4 * j + 1]);
    split_frag<kP>(f, k, r + 1, v[4 * j + 2], v[4 * j + 3]);
  }
}

// Copy a [kRows, HD] fp32 tile starting at row `row0` (row stride `ld`
// elements) into shared memory as its bf16 hi and lo halves (row stride
// SLD), 16 bytes read per thread and step; rows >= S are zeros.
template <int HD, int SLD, int kRows>
__device__ __forceinline__ void load_split_tile(__nv_bfloat16* hi,
                                                __nv_bfloat16* lo,
                                                const float* src, int64_t ld,
                                                int row0, int S) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S)
      v = *reinterpret_cast<const float4*>(src + (int64_t)(row0 + r) * ld +
                                           c);
    uint2 h, l;
    split_pack(v.x, v.y, h.x, l.x);
    split_pack(v.z, v.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + r * SLD + c) = h;
    *reinterpret_cast<uint2*>(lo + r * SLD + c) = l;
  }
}

// The B fragments (hi and lo) at k-step ks of n-tile nt of B = T^T for a
// row-major [n rows x k] tile T (row stride SLD): a product A . T^T.
template <int SLD>
__device__ __forceinline__ void mma3_bt(float (&d)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const __nv_bfloat16* th,
                                        const __nv_bfloat16* tl, int nt,
                                        int ks, int g, int t) {
  const int off = (nt * 8 + g) * SLD + ks * 16 + t * 2;
  mma3(d, ah, al, ld32(th + off), ld32(th + off + 8), ld32(tl + off),
       ld32(tl + off + 8));
}

// The same for B = T, a row-major [k rows x n] tile: a product A . T at
// k-step kk of n-tile nd.
template <int SLD>
__device__ __forceinline__ void mma3_b(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4],
                                       const __nv_bfloat16* th,
                                       const __nv_bfloat16* tl, int kk,
                                       int nd, int g, int t) {
  const int off = (kk * 16 + t * 2) * SLD + nd * 8 + g;
  const __nv_bfloat16* h = th + off;
  const __nv_bfloat16* l = tl + off;
  mma3(d, ah, al, pack_bf16(h[0], h[SLD]), pack_bf16(h[8 * SLD], h[9 * SLD]),
       pack_bf16(l[0], l[SLD]), pack_bf16(l[8 * SLD], l[9 * SLD]));
}

}  // namespace aaclip
