// Backward of the packed-QKV attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces aaclip_tpu/ops/flash_attention.py::_attention_packed_bwd_impl
// (_packed_bwd_kernel), the backward of attention_packed_diff. Given the
// packed projection qkv [B, S, 3*D], the output cotangent dO [B, S, D] and
// the forward's logsumexp lse [B, H, S] (attention_packed.cu), it writes
// d(qkv) [B, S, 3*D] in qkv's dtype:
//   P = exp(s - lse), s = scale * Q.K^T with keys >= valid_len masked,
//   dV = bf16(P)^T dO,  dP = dO V^T,  dsum = rowsum(dP * P),
//   dS = round(P * (dP - dsum) * scale),  dQ = dS K,  dK = dS^T Q,
// with the TPU kernel's roundings: dO in the input dtype; P and dsum in
// fp32; P rounded to the input dtype for dV; dS rounded to the input dtype
// before both of its products; every product accumulated in fp32 and cast
// to the input dtype at the end. dsum is the TPU kernel's own
// rowsum(dP * P), not FlashAttention-2's rowsum(dO * O) shortcut, so the
// arithmetic is the reference's.
//
// What bounds it on an H100: the TPU kernel's five S^2*hd products are
// 10*B*H*S^2*hd FLOP, 153.8 GFLOP at B 8, H 16, S 1370, hd 64 (0.156 ms at
// 989 TFLOP/s), against ~158 MB moved (qkv and d(qkv) 67.3 MB each, dO
// 22.4 MB, lse 0.7 MB: 0.047 ms at 3.35 TB/s). Operations bound it.
//
// Design. On the TPU the q grid axis runs in order and dK/dV accumulate in
// VMEM across q blocks. Blocks on Hopper run in no order, so the work is
// split into two kernels, without atomics and deterministic:
//  (1) attn_bwd_dq_*: one block per (query tile, head, image). A first
//      walk over the K/V tiles recomputes P from lse and sums
//      dsum = rowsum(dP * P) (stored to `dsum` [B, H, S] for kernel 2); a
//      second walk forms dS and accumulates dQ = dS K in fp32 registers.
//  (2) attn_bwd_dkdv_*: one block per (key tile, head, image) walks the
//      query tiles, recomputes P^T = exp(K Q^T * scale - lse) and
//      dP^T = V dO^T, and keeps dK and dV of its rows in fp32 registers.
// This recomputes Q.K^T three times and dO.V^T twice, 11 S^2*hd products
// where the TPU kernel does 5; making it fast is later work.
//
// bf16: every product on the tensor cores through mma.sync m16n8k16 with
// fp32 accumulation, 4 warps of 16 rows, tiles of 64 rows. fp32 (the parity
// policy): fp32 FMA, no TF32; 32 rows per block and two threads per row,
// each owning half its columns; the block's own rows and the walked tile in
// shared memory, the fp32 accumulator half-rows in registers. Both are
// templated on the head dim.
// Ragged tail as in the forward: rows >= S are zero-filled and never stored
// (a padded query row's lse is +inf, so its P is 0), keys >= valid_len get
// P = 0 and key tiles wholly past valid_len store zero gradients.

#include <math.h>

#include "mma_common.cuh"

namespace {

using namespace aaclip;

constexpr int kTile = 64;   // rows per block and per walked tile (bf16)
constexpr int kRowsF = 32;  // rows per block and per walked tile (fp32)

// ---------------------------------------------------------------- bf16

// P (masked, from lse) and dP for one warp's 16 rows against a 64-row
// tile: a = the block's A fragments (Q or K rows), da = dO or V rows; the
// tile's B operand rows are sB (K or Q) and sdB (V or dO). `keep(i, col)`
// masks accumulator element i of tile column col, `lse_of(i, col)` gives
// its logsumexp.
template <int HD, typename Mask, typename Lse>
__device__ __forceinline__ void probs_and_dp(
    float (&p)[kTile / 8][4], float (&dp)[kTile / 8][4],
    const uint32_t (&a)[HD / 16][4], const uint32_t (&da)[HD / 16][4],
    const __nv_bfloat16* sB, const __nv_bfloat16* sdB, int g, int t,
    float scale, Mask keep, Lse lse_of) {
  constexpr int SLD = HD + 8;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
    dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const __nv_bfloat16* bp = sB + (nt * 8 + g) * SLD + ks * 16 + t * 2;
      mma_bf16_16816(p[nt], a[ks], ld32(bp), ld32(bp + 8));
      const __nv_bfloat16* dbp = sdB + (nt * 8 + g) * SLD + ks * 16 + t * 2;
      mma_bf16_16816(dp[nt], da[ks], ld32(dbp), ld32(dbp + 8));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = nt * 8 + t * 2 + (i & 1);
      p[nt][i] = keep(i, col)
                     ? __expf(__fmul_rn(p[nt][i], scale) - lse_of(i, col))
                     : 0.f;
    }
  }
}

// acc[nd] += A . B where A's 16 x 64 fragments are `af` (from C-layout
// values, two n-tiles per k-step) and B[k][n] = sB[k row][n col] of a
// [64 x HD] row-major tile.
template <int HD>
__device__ __forceinline__ void mma_tile_rows(
    float (&acc)[HD / 8][4], const uint32_t (&af)[kTile / 16][4],
    const __nv_bfloat16* sB, int g, int t) {
  constexpr int SLD = HD + 8;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      const __nv_bfloat16* bp = sB + (kk * 16 + t * 2) * SLD + nd * 8 + g;
      mma_bf16_16816(acc[nd], af[kk], pack_bf16(bp[0], bp[SLD]),
                     pack_bf16(bp[8 * SLD], bp[9 * SLD]));
    }
  }
}

// Pack C-layout fp32 values into bf16 A fragments: two adjacent n-tiles
// form one k-step.
__device__ __forceinline__ void pack_a(uint32_t (&af)[kTile / 16][4],
                                       const float (&v)[kTile / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    af[nt >> 1][(nt & 1) * 2 + 0] = pack_f32(v[nt][0], v[nt][1]);
    af[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(v[nt][2], v[nt][3]);
  }
}

template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, int64_t ld,
                                           const float (&acc)[HD / 8][4],
                                           int row_a, int S, int t) {
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(dst + (int64_t)row_a * ld + nd * 8 +
                                   t * 2) = pack_f32(acc[nd][0], acc[nd][1]);
    if (row_a + 8 < S)
      *reinterpret_cast<uint32_t*>(dst + (int64_t)(row_a + 8) * ld + nd * 8 +
                                   t * 2) = pack_f32(acc[nd][2], acc[nd][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(128)
attn_bwd_dq_bf16(const __nv_bfloat16* __restrict__ qkv,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ dsum,
                 __nv_bfloat16* __restrict__ dqkv, int S, int valid_len,
                 int64_t ld, int q_off, int k_off, int v_off, int64_t do_ld,
                 float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int SLD = HD + 8;
  constexpr int KS = HD / 16;
  constexpr int NT = kTile / 8;
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile * SLD];
  __shared__ __align__(16) __nv_bfloat16 sdO[kTile * SLD];
  __shared__ __align__(16) __nv_bfloat16 sK[kTile * SLD];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile * SLD];

  const int q0 = blockIdx.x * kTile;
  const int hoff = blockIdx.y * HD;
  const int64_t img = blockIdx.z;
  const __nv_bfloat16* base = qkv + img * S * ld;
  const int64_t lrow = (img * gridDim.y + blockIdx.y) * S;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int r0 = warp * 16 + g;
  const int row_a = q0 + r0;

  load_tile<__nv_bfloat16, HD, SLD, kTile>(sQ, base + q_off + hoff, ld, q0,
                                           S);
  load_tile<__nv_bfloat16, HD, SLD, kTile>(sdO, dout + img * S * do_ld + hoff,
                                           do_ld, q0, S);
  __syncthreads();
  uint32_t qf[KS][4], df[KS][4];
  load_a_frags<KS, SLD>(qf, sQ, r0, t);
  load_a_frags<KS, SLD>(df, sdO, r0, t);
  const float lse_r[2] = {row_a < S ? lse[lrow + row_a] : INFINITY,
                          row_a + 8 < S ? lse[lrow + row_a + 8] : INFINITY};
  auto lse_of = [&](int i, int) { return lse_r[i >> 1]; };

  const int n_tiles = (valid_len + kTile - 1) / kTile;
  float p[NT][4], dp[NT][4];
  // walk 1: dsum = rowsum(dP * P)
  float ds_row[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<__nv_bfloat16, HD, SLD, kTile>(sK, base + k_off + hoff, ld, k0,
                                             S);
    load_tile<__nv_bfloat16, HD, SLD, kTile>(sV, base + v_off + hoff, ld, k0,
                                             S);
    __syncthreads();
    probs_and_dp<HD>(p, dp, qf, df, sK, sV, g, t, scale,
                     [&](int, int col) { return k0 + col < valid_len; },
                     lse_of);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) ds_row[i >> 1] += dp[nt][i] * p[nt][i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ds_row[r] += __shfl_xor_sync(0xffffffffu, ds_row[r], 1);
    ds_row[r] += __shfl_xor_sync(0xffffffffu, ds_row[r], 2);
  }
  if (t == 0) {
    if (row_a < S) dsum[lrow + row_a] = ds_row[0];
    if (row_a + 8 < S) dsum[lrow + row_a + 8] = ds_row[1];
  }

  // walk 2: dQ = dS K
  float dq[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
    dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<__nv_bfloat16, HD, SLD, kTile>(sK, base + k_off + hoff, ld, k0,
                                             S);
    load_tile<__nv_bfloat16, HD, SLD, kTile>(sV, base + v_off + hoff, ld, k0,
                                             S);
    __syncthreads();
    probs_and_dp<HD>(p, dp, qf, df, sK, sV, g, t, scale,
                     [&](int, int col) { return k0 + col < valid_len; },
                     lse_of);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[nt][i] = p[nt][i] * (dp[nt][i] - ds_row[i >> 1]) * scale;
    uint32_t dsf[kTile / 16][4];
    pack_a(dsf, p);
    mma_tile_rows<HD>(dq, dsf, sK, g, t);
  }
  store_rows<HD>(dqkv + img * S * ld + q_off + hoff, ld, dq, row_a, S, t);
}

template <int HD>
__global__ void __launch_bounds__(128)
attn_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ qkv,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum,
                   __nv_bfloat16* __restrict__ dqkv, int S, int valid_len,
                   int64_t ld, int q_off, int k_off, int v_off, int64_t do_ld,
                   float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int SLD = HD + 8;
  constexpr int KS = HD / 16;
  constexpr int NT = kTile / 8;
  __shared__ __align__(16) __nv_bfloat16 sK[kTile * SLD];
  __shared__ __align__(16) __nv_bfloat16 sV[kTile * SLD];
  __shared__ __align__(16) __nv_bfloat16 sQ[kTile * SLD];
  __shared__ __align__(16) __nv_bfloat16 sdO[kTile * SLD];
  __shared__ float sLse[kTile];
  __shared__ float sDsum[kTile];

  const int kv0 = blockIdx.x * kTile;
  const int hoff = blockIdx.y * HD;
  const int64_t img = blockIdx.z;
  const __nv_bfloat16* base = qkv + img * S * ld;
  const __nv_bfloat16* dob = dout + img * S * do_ld + hoff;
  const int64_t lrow = (img * gridDim.y + blockIdx.y) * S;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int r0 = warp * 16 + g;
  const int row_a = kv0 + r0;

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nd][i] = dv[nd][i] = 0.f;

  if (kv0 < valid_len) {  // a tile wholly past valid_len has zero grads
    load_tile<__nv_bfloat16, HD, SLD, kTile>(sK, base + k_off + hoff, ld, kv0,
                                             S);
    load_tile<__nv_bfloat16, HD, SLD, kTile>(sV, base + v_off + hoff, ld, kv0,
                                             S);
    __syncthreads();
    uint32_t kf[KS][4], vf[KS][4];
    load_a_frags<KS, SLD>(kf, sK, r0, t);
    load_a_frags<KS, SLD>(vf, sV, r0, t);
    const bool keep_r[2] = {row_a < valid_len, row_a + 8 < valid_len};
    float p[NT][4], dp[NT][4];
    for (int q0 = 0; q0 < S; q0 += kTile) {
      __syncthreads();
      load_tile<__nv_bfloat16, HD, SLD, kTile>(sQ, base + q_off + hoff, ld,
                                               q0, S);
      load_tile<__nv_bfloat16, HD, SLD, kTile>(sdO, dob, do_ld, q0, S);
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        sLse[i] = q0 + i < S ? lse[lrow + q0 + i] : INFINITY;
        sDsum[i] = q0 + i < S ? dsum[lrow + q0 + i] : 0.f;
      }
      __syncthreads();
      // P^T and dP^T: rows are this block's keys, columns the tile's
      // queries
      probs_and_dp<HD>(p, dp, kf, vf, sQ, sdO, g, t, scale,
                       [&](int i, int) { return keep_r[i >> 1]; },
                       [&](int, int col) { return sLse[col]; });
      uint32_t af[kTile / 16][4];
      pack_a(af, p);  // bf16(P)^T
      mma_tile_rows<HD>(dv, af, sdO, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = nt * 8 + t * 2 + (i & 1);
          p[nt][i] = p[nt][i] * (dp[nt][i] - sDsum[col]) * scale;
        }
      pack_a(af, p);  // round(dS)^T
      mma_tile_rows<HD>(dk, af, sQ, g, t);
    }
  }
  __nv_bfloat16* out = dqkv + img * S * ld;
  store_rows<HD>(out + k_off + hoff, ld, dk, row_a, S, t);
  store_rows<HD>(out + v_off + hoff, ld, dv, row_a, S, t);
}

// ---------------------------------------------------------------- fp32

// Two threads (neighbouring lanes) share a row, each owning HD / 2 of its
// columns: one thread holding a whole fp32 accumulator row at hd 64 ran
// out of registers (255, with spills).
constexpr int kSplitF = 2;

// The full row dot product of two HD-vectors, of which this thread holds
// the half starting at a and b; both threads of the pair get the sum.
template <int HD>
__device__ __forceinline__ float pair_dot(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < HD / kSplitF; ++d) acc = fmaf(a[d], b[d], acc);
  return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

// This thread's half of a row (zeros past S) into shared memory.
template <int HD>
__device__ __forceinline__ void load_half_row(float* dst, const float* src,
                                              int64_t ld, int row, int S) {
#pragma unroll
  for (int d = 0; d < HD / kSplitF; ++d)
    dst[d] = row < S ? src[(int64_t)row * ld + d] : 0.f;
}

template <int HD>
__global__ void __launch_bounds__(kRowsF * kSplitF)
attn_bwd_dq_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ dsum,
                float* __restrict__ dqkv, int S, int valid_len, int64_t ld,
                int q_off, int k_off, int v_off, int64_t do_ld, float scale) {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
  constexpr int HH = HD / kSplitF;
  constexpr int PLD = HD + 1;  // padded rows
  __shared__ float sdO[kRowsF * PLD];
  __shared__ __align__(16) float sK[kRowsF * HD];
  __shared__ __align__(16) float sV[kRowsF * HD];

  const int row = blockIdx.x * kRowsF + (threadIdx.x >> 1);
  const int c0 = (threadIdx.x & 1) * HH;  // this thread's columns
  const int hoff = blockIdx.y * HD;
  const int64_t img = blockIdx.z;
  const float* base = qkv + img * S * ld;
  const int64_t lrow = (img * gridDim.y + blockIdx.y) * S;
  float* my_do = sdO + (threadIdx.x >> 1) * PLD + c0;

  float q[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d)
    q[d] = row < S ? base[(int64_t)row * ld + q_off + hoff + c0 + d] : 0.f;
  load_half_row<HD>(my_do, dout + img * S * do_ld + hoff + c0, do_ld, row,
                    S);
  const float lse_r = row < S ? lse[lrow + row] : INFINITY;

  float ds_row = 0.f;  // walk 1: dsum = rowsum(dP * P)
  for (int k0 = 0; k0 < valid_len; k0 += kRowsF) {
    __syncthreads();
    load_tile<float, HD, HD, kRowsF>(sK, base + k_off + hoff, ld, k0, S);
    load_tile<float, HD, HD, kRowsF>(sV, base + v_off + hoff, ld, k0, S);
    __syncthreads();
    for (int j = 0; j < kRowsF && k0 + j < valid_len; ++j) {
      const float p = expf(
          __fmul_rn(pair_dot<HD>(q, sK + j * HD + c0), scale) - lse_r);
      ds_row += pair_dot<HD>(my_do, sV + j * HD + c0) * p;
    }
  }
  float dq[HH];  // walk 2: dQ = dS K
#pragma unroll
  for (int d = 0; d < HH; ++d) dq[d] = 0.f;
  for (int k0 = 0; k0 < valid_len; k0 += kRowsF) {
    __syncthreads();
    load_tile<float, HD, HD, kRowsF>(sK, base + k_off + hoff, ld, k0, S);
    load_tile<float, HD, HD, kRowsF>(sV, base + v_off + hoff, ld, k0, S);
    __syncthreads();
    for (int j = 0; j < kRowsF && k0 + j < valid_len; ++j) {
      const float p = expf(
          __fmul_rn(pair_dot<HD>(q, sK + j * HD + c0), scale) - lse_r);
      const float dp = pair_dot<HD>(my_do, sV + j * HD + c0);
      const float ds = p * (dp - ds_row) * scale;
#pragma unroll
      for (int d = 0; d < HH; ++d)
        dq[d] = fmaf(ds, sK[j * HD + c0 + d], dq[d]);
    }
  }
  if (row < S) {
    if (c0 == 0) dsum[lrow + row] = ds_row;
    float* dst = dqkv + img * S * ld + (int64_t)row * ld + q_off + hoff + c0;
#pragma unroll
    for (int d = 0; d < HH; ++d) dst[d] = dq[d];
  }
}

template <int HD>
__global__ void __launch_bounds__(kRowsF * kSplitF)
attn_bwd_dkdv_f32(const float* __restrict__ qkv,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum, float* __restrict__ dqkv,
                  int S, int valid_len, int64_t ld, int q_off, int k_off,
                  int v_off, int64_t do_ld, float scale) {
  static_assert(HD % 8 == 0, "head dim must be a multiple of 8");
  constexpr int HH = HD / kSplitF;
  constexpr int PLD = HD + 1;
  __shared__ float sKo[kRowsF * PLD];
  __shared__ float sVo[kRowsF * PLD];
  __shared__ __align__(16) float sQ[kRowsF * HD];
  __shared__ __align__(16) float sdO[kRowsF * HD];
  __shared__ float sLse[kRowsF];
  __shared__ float sDsum[kRowsF];

  const int kv0 = blockIdx.x * kRowsF;
  const int row = kv0 + (threadIdx.x >> 1);
  const int c0 = (threadIdx.x & 1) * HH;
  const int hoff = blockIdx.y * HD;
  const int64_t img = blockIdx.z;
  const float* base = qkv + img * S * ld;
  const float* dob = dout + img * S * do_ld + hoff;
  const int64_t lrow = (img * gridDim.y + blockIdx.y) * S;

  float dk[HH], dv[HH];
#pragma unroll
  for (int d = 0; d < HH; ++d) dk[d] = dv[d] = 0.f;
  if (kv0 < valid_len) {  // a tile wholly past valid_len has zero grads
    float* my_k = sKo + (threadIdx.x >> 1) * PLD + c0;
    float* my_v = sVo + (threadIdx.x >> 1) * PLD + c0;
    load_half_row<HD>(my_k, base + k_off + hoff + c0, ld, row, S);
    load_half_row<HD>(my_v, base + v_off + hoff + c0, ld, row, S);
    const bool keep = row < valid_len;
    for (int q0 = 0; q0 < S; q0 += kRowsF) {
      __syncthreads();
      load_tile<float, HD, HD, kRowsF>(sQ, base + q_off + hoff, ld, q0, S);
      load_tile<float, HD, HD, kRowsF>(sdO, dob, do_ld, q0, S);
      for (int i = threadIdx.x; i < kRowsF; i += blockDim.x) {
        sLse[i] = q0 + i < S ? lse[lrow + q0 + i] : INFINITY;
        sDsum[i] = q0 + i < S ? dsum[lrow + q0 + i] : 0.f;
      }
      __syncthreads();
      // every lane runs the loop (the pair sums shuffle); a row past
      // valid_len gets P = 0
      for (int j = 0; j < kRowsF && q0 + j < S; ++j) {
        const float s = pair_dot<HD>(my_k, sQ + j * HD + c0);
        const float p = keep ? expf(__fmul_rn(s, scale) - sLse[j]) : 0.f;
        const float dp = pair_dot<HD>(my_v, sdO + j * HD + c0);
        const float ds = p * (dp - sDsum[j]) * scale;
#pragma unroll
        for (int d = 0; d < HH; ++d) {
          dv[d] = fmaf(p, sdO[j * HD + c0 + d], dv[d]);
          dk[d] = fmaf(ds, sQ[j * HD + c0 + d], dk[d]);
        }
      }
    }
  }
  if (row < S) {
    float* out = dqkv + img * S * ld + (int64_t)row * ld + hoff + c0;
#pragma unroll
    for (int d = 0; d < HH; ++d) {
      out[k_off + d] = dk[d];
      out[v_off + d] = dv[d];
    }
  }
}

template <int HD>
int launch(bool bf16, int batch, int seq, int heads, cudaStream_t st,
           const void* qkv, const void* dout, const float* lse, float* dsum,
           void* dqkv, int valid_len, int64_t ld, int q_off, int k_off,
           int v_off, int64_t do_ld, float scale) {
  if (bf16) {
    const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
    using T = __nv_bfloat16;
    attn_bwd_dq_bf16<HD><<<grid, 128, 0, st>>>(
        static_cast<const T*>(qkv), static_cast<const T*>(dout), lse, dsum,
        static_cast<T*>(dqkv), seq, valid_len, ld, q_off, k_off, v_off, do_ld,
        scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkdv_bf16<HD><<<grid, 128, 0, st>>>(
        static_cast<const T*>(qkv), static_cast<const T*>(dout), lse, dsum,
        static_cast<T*>(dqkv), seq, valid_len, ld, q_off, k_off, v_off, do_ld,
        scale);
  } else {
    const dim3 grid((seq + kRowsF - 1) / kRowsF, heads, batch);
    attn_bwd_dq_f32<HD><<<grid, kRowsF * kSplitF, 0, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout), lse,
        dsum, static_cast<float*>(dqkv), seq, valid_len, ld, q_off, k_off,
        v_off, do_ld, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkdv_f32<HD><<<grid, kRowsF * kSplitF, 0, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout), lse,
        dsum, static_cast<float*>(dqkv), seq, valid_len, ld, q_off, k_off,
        v_off, do_ld, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv and d_qkv: [batch, seq, ld] elements, the q/k/v sections of head h at
// column {q,k,v}_off + h * head_dim; d_out: [batch, seq, do_ld]; lse and
// the scratch dsum: [batch, heads, seq] fp32. Returns the CUDA error of the
// launches (0 on success); cudaErrorInvalidValue for a head dim with no
// instantiation.
extern "C" int aaclip_attention_packed_bwd(
    const void* qkv, const void* d_out, const float* lse, float* dsum,
    void* d_qkv, int bf16, int head_dim, int batch, int seq, int valid_len,
    int heads, long long ld, int q_off, int k_off, int v_off, long long do_ld,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(bf16 != 0, batch, seq, heads, st, qkv, d_out, lse,
                        dsum, d_qkv, valid_len, ld, q_off, k_off, v_off, do_ld,
                        scale);
    case 64:
      return launch<64>(bf16 != 0, batch, seq, heads, st, qkv, d_out, lse,
                        dsum, d_qkv, valid_len, ld, q_off, k_off, v_off, do_ld,
                        scale);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
