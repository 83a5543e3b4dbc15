// Fused residual-block kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the three Pallas kernels of aaclip_tpu/ops/fused_block.py, which
// its make_block_fn chains around the packed attention as the whole-block
// inference override (block_fn):
//  - ln_linear (_ln_linear_kernel): LayerNorm of x with fp32 statistics
//    (eps 1e-5, biased variance), rounded to the compute dtype, @ W with
//    fp32 accumulation, + b in fp32, rounded to x's dtype (the QKV
//    projection, or its value third in the V-V block);
//  - linear_residual (_linear_residual_kernel): res + (y @ W + b), all in
//    fp32 and rounded once (the attention out-projection and residual add);
//  - mlp_fused (_mlp_kernel): x + proj(act(fc(LN(x)))): the LayerNorm
//    rounded to the compute dtype, fc + b_fc and the activation in fp32, the
//    hidden rounded to the compute dtype, proj accumulated in fp32 over the
//    hidden tiles, then x + acc + b_proj in fp32, rounded once. The [rows,
//    hidden] activation never reaches device memory.
// Weights are read in nn.Linear's [out, in] layout as they lie: a row of W
// is a column of the product's B operand, which is the column-major operand
// mma.sync takes, so no transposed copy exists.
//
// What bounds them on an H100: at the predict's batch 32 (43,840 rows of
// 1024) ln_linear to 3072 columns is 275.8 GFLOP against 365.5 MB moved,
// linear_residual 91.9 GFLOP against 271.5 MB, mlp_fused (hidden 4096)
// 735.5 GFLOP against 196.4 MB: all far above the card's ~295 bf16 FLOP per
// byte of HBM, so bound by the tensor cores.
//
// Design. bf16 runs on mma.sync m16n8k16 with fp32 accumulation, fp32 on
// FMA with no TF32, as the attention kernels do.
//  - ln_linear / linear_residual share one GEMM: a block owns 128 rows x
//    128 output columns, 8 warps of 64 x 32, and walks K in tiles of 32
//    staged in shared memory, double-buffered through registers. The LN
//    prologue first takes each of its rows' mean and variance (one warp per
//    row, the row held in registers), then normalises and rounds the A tile
//    as it is staged, where the TPU kernel casts. The epilogue adds the bias
//    (and the residual) in fp32. Ragged row tails are masked by bounds: the
//    TPU kernel's row padding is not needed.
//  - mlp_fused: the TPU kernel keeps a [512, 1024] fp32 accumulator and the
//    normalised rows in VMEM while it sweeps the hidden in tiles; an SM has
//    64 K registers and 227 KB of shared memory. Here a block owns 32 rows
//    and all D output columns: 16 warps, each holding a [32, D/16] fp32
//    accumulator in registers (64 a thread at D 1024), the 32 normalised
//    rows (bf16) stay in shared memory, and the hidden is swept in tiles of
//    64: the fc tile of W_fc is staged, each warp computes one 16 x 8 piece
//    of the [32, 64] hidden tile, adds b_fc, activates, rounds it into
//    shared memory; then the proj tile of W_proj is staged in the same
//    buffer and every warp multiplies the hidden tile into its accumulator.
//    Each block reads both weight matrices once from L2 (16 MB at D 1024):
//    32 rows are the most whose accumulator fits a block.
//  - The activations use the precise erff / tanhf / expf: the hidden is
//    rounded to bf16 right after, and an approximate function would flip
//    those roundings against the plain version.
// Instantiated widths: any K and N that are multiples of the tiles (K a
// multiple of 32, at most 1024, N of 128; fp32 16 and 64) for the GEMM, D
// 128 and 1024 (hidden a multiple of 64) for the MLP; anything else returns
// cudaErrorInvalidValue.

#include <math.h>

#include "mma_common.cuh"

namespace {

using namespace aaclip;
using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-5f;
constexpr int kMaxK = 1024;  // the LayerNorm holds a row in registers

// activation codes, as ops/fused_block.py passes them
constexpr int kGeluErf = 0, kGeluTanh = 1, kQuickGelu = 2;

// The activation in fp32, in the order torch's elementwise kernels
// evaluate it (the plain version's F.gelu and x * sigmoid(1.702 x)).
__device__ __forceinline__ float activate(int act, float x) {
  if (act == kGeluErf) return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
  if (act == kGeluTanh) {
    const float inner = 0.79788456080286536f * (x + 0.044715f * (x * x * x));
    return 0.5f * x * (1.f + tanhf(inner));
  }
  return x * (1.f / (1.f + expf(-1.702f * x)));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 f32_to_bf16x8(const float (&v)[8]) {
  return make_uint4(pack_f32(v[0], v[1]), pack_f32(v[2], v[3]),
                    pack_f32(v[4], v[5]), pack_f32(v[6], v[7]));
}

// 16 bytes of a row as fp32: 8 bf16 or 4 fp32 values
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int n = 8;
  __device__ static void load(const bf16* p, float (&v)[8]) {
    bf16x8_to_f32(*reinterpret_cast<const uint4*>(p), v);
  }
};

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
};

// One warp: the mean and 1/sqrt(var + eps) of a row of K <= kMaxK values,
// in fp32: the mean first, then the mean of squared deviations (biased
// variance), as the TPU kernel's _ln_rows takes them. The row is read once
// and held in registers.
template <typename T>
__device__ __forceinline__ void row_stats(const T* __restrict__ row, int K,
                                          float& mean, float& rstd) {
  constexpr int n = Vec<T>::n;
  constexpr int kV = kMaxK / (32 * n);
  const int lane = threadIdx.x & 31;
  float v[kV][n];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int c = (i * 32 + lane) * n;
    if (c < K) {
      Vec<T>::load(row + c, v[i]);
    } else {
#pragma unroll
      for (int j = 0; j < n; ++j) v[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < n; ++j) s += v[i][j];
  }
  mean = warp_sum(s) / K;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    if ((i * 32 + lane) * n < K) {
#pragma unroll
      for (int j = 0; j < n; ++j) {
        const float d = v[i][j] - mean;
        q += d * d;
      }
    }
  }
  rstd = 1.f / sqrtf(warp_sum(q) / K + kLnEps);
}

// ---------------------------------------------------------------------------
// ln_linear and linear_residual, bf16: out [R, N] = epilogue(A [R, K] .
// W [N, K]^T). LN: A is x, normalised with gamma/beta and rounded to bf16 as
// it is staged, and the epilogue adds the bias (ln_linear). Otherwise A is y
// and the epilogue computes res + (acc + bias) (linear_residual).

constexpr int kBM = 128, kBN = 128, kBK = 32, kSK = kBK + 8;
constexpr int kGemmThreads = 256;

template <bool LN>
__global__ void __launch_bounds__(kGemmThreads)
gemm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const bf16* __restrict__ res, bf16* __restrict__ out, int R,
                 int N, int K) {
  // padded rows of 40 (80 bytes): the fragment loads are conflict-free
  __shared__ __align__(16) bf16 sA[2][kBM * kSK];
  __shared__ __align__(16) bf16 sB[2][kBN * kSK];
  __shared__ float sMean[kBM], sRstd[kBM];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int wm = warp >> 2;  // 2 x 4 warps, each 64 rows x 32 columns
  const int wn = warp & 3;

  if (LN) {
    for (int r = warp; r < kBM; r += kGemmThreads / 32) {
      float mean = 0.f, rstd = 0.f;
      if (m0 + r < R) row_stats(a + (int64_t)(m0 + r) * K, K, mean, rstd);
      if (lane == 0) {
        sMean[r] = mean;
        sRstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  // each thread stages two 16-byte vectors of the A tile and two of W's
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * kGemmThreads;
      const int r = idx >> 2, c = (idx & 3) * 8;
      ra[i] = m0 + r < R ? *reinterpret_cast<const uint4*>(
                               a + (int64_t)(m0 + r) * K + k0 + c)
                         : make_uint4(0u, 0u, 0u, 0u);
      rb[i] = *reinterpret_cast<const uint4*>(w + (int64_t)(n0 + r) * K +
                                              k0 + c);
    }
  };
  auto stage = [&](int buf, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * kGemmThreads;
      const int r = idx >> 2, c = (idx & 3) * 8;
      uint4 v = ra[i];
      if (LN && m0 + r < R) {
        float f[8];
        bf16x8_to_f32(v, f);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = (f[j] - sMean[r]) * sRstd[r] * gamma[k0 + c + j] +
                 beta[k0 + c + j];
        v = f32_to_bf16x8(f);
      }
      *reinterpret_cast<uint4*>(&sA[buf][r * kSK + c]) = v;
      *reinterpret_cast<uint4*>(&sB[buf][r * kSK + c]) = rb[i];
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int n_k = K / kBK;
  fetch(0);
  stage(0, 0);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) fetch((kt + 1) * kBK);
    const bf16* A = sA[buf];
    const bf16* B = sB[buf];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* p = A + (wm * 64 + mt * 16 + g) * kSK + ks * 16 + t * 2;
        af[mt][0] = ld32(p);
        af[mt][1] = ld32(p + 8 * kSK);
        af[mt][2] = ld32(p + 8);
        af[mt][3] = ld32(p + 8 * kSK + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* p = B + (wn * 32 + nt * 8 + g) * kSK + ks * 16 + t * 2;
        const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          mma_bf16_16816(acc[mt][nt], af[mt], b0, b1);
      }
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < n_k) stage(buf ^ 1, (kt + 1) * kBK);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + t * 2;
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mt * 16 + g + h * 8;
        if (row >= R) continue;
        const int64_t o = (int64_t)row * N + col;
        float v0 = acc[mt][nt][2 * h] + b0;
        float v1 = acc[mt][nt][2 * h + 1] + b1;
        if (!LN) {
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + o));
          v0 = r.x + v0;
          v1 = r.y + v1;
        }
        *reinterpret_cast<uint32_t*>(out + o) = pack_f32(v0, v1);
      }
    }
  }
}

// The same two functions in fp32 on FMA: a block owns 64 x 64 outputs, each
// thread a 4 x 4 block of them; K walks in tiles of 16 staged transposed in
// shared memory.
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

template <bool LN>
__global__ void __launch_bounds__(kGemmThreads)
gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                const float* __restrict__ bias,
                const float* __restrict__ gamma,
                const float* __restrict__ beta,
                const float* __restrict__ res, float* __restrict__ out, int R,
                int N, int K) {
  __shared__ __align__(16) float sA[kFBK][kFBM + 4];
  __shared__ __align__(16) float sB[kFBK][kFBN + 4];
  __shared__ float sMean[kFBM], sRstd[kFBM];

  const int n0 = blockIdx.x * kFBN;
  const int m0 = blockIdx.y * kFBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (LN) {
    for (int r = warp; r < kFBM; r += kGemmThreads / 32) {
      float mean = 0.f, rstd = 0.f;
      if (m0 + r < R) row_stats(a + (int64_t)(m0 + r) * K, K, mean, rstd);
      if (lane == 0) {
        sMean[r] = mean;
        sRstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  const int lr = threadIdx.x >> 2, lc = (threadIdx.x & 3) * 4;  // loads
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;       // outputs
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFBK) {
    float va[4] = {0.f, 0.f, 0.f, 0.f};
    if (m0 + lr < R) {
      Vec<float>::load(a + (int64_t)(m0 + lr) * K + k0 + lc, va);
      if (LN) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          va[j] = (va[j] - sMean[lr]) * sRstd[lr] * gamma[k0 + lc + j] +
                  beta[k0 + lc + j];
      }
    }
    float vb[4];
    Vec<float>::load(w + (int64_t)(n0 + lr) * K + k0 + lc, vb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sA[lc + j][lr] = va[j];
      sB[lc + j][lr] = vb[j];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      float xa[4], yb[4];
      Vec<float>::load(&sA[k][ty * 4], xa);
      Vec<float>::load(&sB[k][tx * 4], yb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], yb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      const int64_t o = (int64_t)row * N + col;
      float v = acc[i][j] + bias[col];
      if (!LN) v = res[o] + v;
      out[o] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// mlp_fused, bf16: a block owns kMlpRows rows and all D output columns.

constexpr int kMlpRows = 32, kMlpHid = 64, kMlpThreads = 512;

template <int D>
struct MlpSmem {
  static constexpr int kLd = D + 8;         // normalised rows, W_fc tile
  static constexpr int kLdH = kMlpHid + 8;  // hidden tile, W_proj tile
  static constexpr int kLn = kMlpRows * kLd;
  static constexpr int kWfc = kMlpHid * kLd;
  static constexpr int kWpj = D * kLdH;
  static constexpr int kW = kWfc > kWpj ? kWfc : kWpj;  // one buffer, both
  static constexpr int kH = kMlpRows * kLdH;
  static constexpr int bytes = (kLn + kW + kH) * 2;
};

template <int D>
__global__ void __launch_bounds__(kMlpThreads, 1)
mlp_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, const bf16* __restrict__ wfc,
                const float* __restrict__ bfc, const bf16* __restrict__ wpj,
                const float* __restrict__ bpj, bf16* __restrict__ out, int R,
                int F, int act) {
  using S = MlpSmem<D>;
  constexpr int WN = D / 16;  // output columns of each of the 16 warps
  constexpr int NT = WN / 8;  // their n8 tiles
  static_assert(D % 128 == 0 && D <= kMaxK, "width");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sLN = reinterpret_cast<bf16*>(smem_raw);
  bf16* sW = sLN + S::kLn;
  bf16* sH = sW + S::kW;

  const int m0 = blockIdx.x * kMlpRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // the block's rows, normalised and rounded to bf16; rows past R are 0
  for (int rr = warp; rr < kMlpRows; rr += kMlpThreads / 32) {
    const int row = m0 + rr;
    bf16* dst = sLN + rr * S::kLd;
    if (row < R) {
      const bf16* src = x + (int64_t)row * D;
      float mean, rstd;
      row_stats(src, D, mean, rstd);
      for (int c = lane * 8; c < D; c += 256) {
        float f[8];
        Vec<bf16>::load(src + c, f);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = (f[j] - mean) * rstd * gamma[c + j] + beta[c + j];
        *reinterpret_cast<uint4*>(dst + c) = f32_to_bf16x8(f);
      }
    } else {
      for (int c = lane * 8; c < D; c += 256)
        *reinterpret_cast<uint4*>(dst + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  const int fr = (warp >> 3) * 16 + g;  // this warp's 16 x 8 piece of the
  const int fc = (warp & 7) * 8;        // [32, 64] hidden tile
  for (int f0 = 0; f0 < F; f0 += kMlpHid) {
    // W_fc rows f0 .. f0 + 63, all D columns
    for (int i = threadIdx.x; i < kMlpHid * (D / 8); i += kMlpThreads) {
      const int n = i / (D / 8), c = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(sW + n * S::kLd + c) =
          *reinterpret_cast<const uint4*>(wfc + (int64_t)(f0 + n) * D + c);
    }
    __syncthreads();
    // two accumulators over alternate k-steps keep two products in flight
    float h0[4] = {0.f, 0.f, 0.f, 0.f}, h1[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* pa = sLN + fr * S::kLd + t * 2;
    const bf16* pb = sW + (fc + g) * S::kLd + t * 2;
#pragma unroll 4
    for (int ks = 0; ks < D / 16; ks += 2) {
      uint32_t af[4];
      const int k = ks * 16;
      af[0] = ld32(pa + k);
      af[1] = ld32(pa + 8 * S::kLd + k);
      af[2] = ld32(pa + k + 8);
      af[3] = ld32(pa + 8 * S::kLd + k + 8);
      mma_bf16_16816(h0, af, ld32(pb + k), ld32(pb + k + 8));
      af[0] = ld32(pa + k + 16);
      af[1] = ld32(pa + 8 * S::kLd + k + 16);
      af[2] = ld32(pa + k + 24);
      af[3] = ld32(pa + 8 * S::kLd + k + 24);
      mma_bf16_16816(h1, af, ld32(pb + k + 16), ld32(pb + k + 24));
    }
    {
      const int col = fc + t * 2;
      const float b0 = bfc[f0 + col], b1 = bfc[f0 + col + 1];
      *reinterpret_cast<uint32_t*>(sH + fr * S::kLdH + col) =
          pack_f32(activate(act, (h0[0] + h1[0]) + b0),
                   activate(act, (h0[1] + h1[1]) + b1));
      *reinterpret_cast<uint32_t*>(sH + (fr + 8) * S::kLdH + col) =
          pack_f32(activate(act, (h0[2] + h1[2]) + b0),
                   activate(act, (h0[3] + h1[3]) + b1));
    }
    __syncthreads();  // W_fc consumed, the hidden tile complete
    // W_proj[:, f0 .. f0 + 63] into the same buffer
    for (int i = threadIdx.x; i < D * (kMlpHid / 8); i += kMlpThreads) {
      const int n = i / (kMlpHid / 8), c = (i % (kMlpHid / 8)) * 8;
      *reinterpret_cast<uint4*>(sW + n * S::kLdH + c) =
          *reinterpret_cast<const uint4*>(wpj + (int64_t)n * F + f0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMlpHid / 16; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* p = sH + (mt * 16 + g) * S::kLdH + ks * 16 + t * 2;
        af[mt][0] = ld32(p);
        af[mt][1] = ld32(p + 8 * S::kLdH);
        af[mt][2] = ld32(p + 8);
        af[mt][3] = ld32(p + 8 * S::kLdH + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* p =
            sW + (warp * WN + nt * 8 + g) * S::kLdH + ks * 16 + t * 2;
        const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
        mma_bf16_16816(acc[0][nt], af[0], b0, b1);
        mma_bf16_16816(acc[1][nt], af[1], b0, b1);
      }
    }
    __syncthreads();  // W_proj and the hidden tile consumed
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = warp * WN + nt * 8 + t * 2;
      const float b0 = bpj[col], b1 = bpj[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mt * 16 + g + h * 8;
        if (row >= R) continue;
        const int64_t o = (int64_t)row * D + col;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + o));
        *reinterpret_cast<uint32_t*>(out + o) =
            pack_f32((xv.x + acc[mt][nt][2 * h]) + b0,
                     (xv.y + acc[mt][nt][2 * h + 1]) + b1);
      }
    }
  }
}

// mlp_fused, fp32 on FMA: a block owns kFRows rows and all D columns; each
// thread accumulates an RPT x 4 block of the output. The hidden tile [16,
// 64] is computed from W_fc staged in k-chunks of 64, activated into shared
// memory, then multiplied with W_proj staged in k-chunks of 16.
constexpr int kFRows = 16, kFHid = 64, kFKc = 64, kFPc = 16;

template <int D>
struct MlpF32Smem {
  static constexpr int kLdWf = kFHid + 4, kLdWp = D + 4;
  static constexpr int kLn = kFRows * D;
  static constexpr int kWf = kFKc * kLdWf;
  static constexpr int kH = kFRows * kFHid;
  static constexpr int kWp = kFPc * kLdWp;
  static constexpr int bytes = (kLn + kWf + kH + kWp) * 4;
};

template <int D>
__global__ void __launch_bounds__(kGemmThreads)
mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const float* __restrict__ wfc,
               const float* __restrict__ bfc, const float* __restrict__ wpj,
               const float* __restrict__ bpj, float* __restrict__ out, int R,
               int F, int act) {
  using S = MlpF32Smem<D>;
  constexpr int CB = D / 4;              // 4-column blocks of the output
  constexpr int RG = kGemmThreads / CB;  // row groups
  constexpr int RPT = kFRows / RG;       // rows of each thread
  static_assert(kGemmThreads % CB == 0 && kFRows % RG == 0, "width");
  extern __shared__ __align__(16) float fsmem[];
  float* sLN = fsmem;
  float* sWf = sLN + S::kLn;
  float* sH = sWf + S::kWf;
  float* sWp = sH + S::kH;

  const int m0 = blockIdx.x * kFRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int rr = warp; rr < kFRows; rr += kGemmThreads / 32) {
    const int row = m0 + rr;
    float* dst = sLN + rr * D;
    if (row < R) {
      const float* src = x + (int64_t)row * D;
      float mean, rstd;
      row_stats(src, D, mean, rstd);
      for (int c = lane; c < D; c += 32)
        dst[c] = (src[c] - mean) * rstd * gamma[c] + beta[c];
    } else {
      for (int c = lane; c < D; c += 32) dst[c] = 0.f;
    }
  }

  const int hr = threadIdx.x >> 4, hc = (threadIdx.x & 15) * 4;  // hidden
  const int cb = threadIdx.x % CB, rg = threadIdx.x / CB;         // output
  float acc[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kFHid) {
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < D; k0 += kFKc) {
      __syncthreads();  // the rows are written, the previous chunk consumed
      for (int i = threadIdx.x; i < kFHid * kFKc / 4; i += kGemmThreads) {
        const int n = i / (kFKc / 4), k = (i % (kFKc / 4)) * 4;
        float v[4];
        Vec<float>::load(wfc + (int64_t)(f0 + n) * D + k0 + k, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) sWf[(k + j) * S::kLdWf + n] = v[j];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kFKc; ++k) {
        const float av = sLN[hr * D + k0 + k];
        float b[4];
        Vec<float>::load(sWf + k * S::kLdWf + hc, b);
#pragma unroll
        for (int j = 0; j < 4; ++j) h[j] = fmaf(av, b[j], h[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sH[hr * kFHid + hc + j] = activate(act, h[j] + bfc[f0 + hc + j]);
    for (int p0 = 0; p0 < kFHid; p0 += kFPc) {
      __syncthreads();  // the hidden tile is written, the chunk consumed
      for (int i = threadIdx.x; i < D * kFPc / 4; i += kGemmThreads) {
        const int n = i / (kFPc / 4), k = (i % (kFPc / 4)) * 4;
        float v[4];
        Vec<float>::load(wpj + (int64_t)n * F + f0 + p0 + k, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) sWp[(k + j) * S::kLdWp + n] = v[j];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFPc; ++k) {
        float b[4];
        Vec<float>::load(sWp + k * S::kLdWp + cb * 4, b);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float hv = sH[(rg * RPT + r) * kFHid + p0 + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(hv, b[j], acc[r][j]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = m0 + rg * RPT + r;
    if (row >= R) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = cb * 4 + j;
      const int64_t o = (int64_t)row * D + col;
      out[o] = (x[o] + acc[r][j]) + bpj[col];
    }
  }
}

int gemm_shape_ok(bool use_bf16, int rows, int n, int k) {
  const int bm = use_bf16 ? kBM : kFBM, bn = use_bf16 ? kBN : kFBN;
  const int bk = use_bf16 ? kBK : kFBK;
  return rows >= 1 && n >= bn && n % bn == 0 && k >= bk && k % bk == 0 &&
         k <= kMaxK && (rows + bm - 1) / bm <= 65535;
}

template <bool LN>
int launch_gemm(bool use_bf16, const void* a, const void* w,
                const float* bias, const float* gamma, const float* beta,
                const void* res, void* out, int rows, int n, int k,
                cudaStream_t st) {
  if (!gemm_shape_ok(use_bf16, rows, n, k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (use_bf16) {
    const dim3 grid(n / kBN, (rows + kBM - 1) / kBM);
    gemm_bf16_kernel<LN><<<grid, kGemmThreads, 0, st>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(w), bias, gamma,
        beta, static_cast<const bf16*>(res), static_cast<bf16*>(out), rows, n,
        k);
  } else {
    const dim3 grid(n / kFBN, (rows + kFBM - 1) / kFBM);
    gemm_f32_kernel<LN><<<grid, kGemmThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(w), bias,
        gamma, beta, static_cast<const float*>(res), static_cast<float*>(out),
        rows, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mlp(bool use_bf16, const void* x, const float* gamma,
               const float* beta, const void* wfc, const float* bfc,
               const void* wpj, const float* bpj, void* out, int rows, int f,
               int act, cudaStream_t st) {
  cudaError_t e;
  if (use_bf16) {
    constexpr int bytes = MlpSmem<D>::bytes;
    e = cudaFuncSetAttribute(mlp_bf16_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    mlp_bf16_kernel<D><<<(rows + kMlpRows - 1) / kMlpRows, kMlpThreads,
                         bytes, st>>>(
        static_cast<const bf16*>(x), gamma, beta,
        static_cast<const bf16*>(wfc), bfc, static_cast<const bf16*>(wpj),
        bpj, static_cast<bf16*>(out), rows, f, act);
  } else {
    constexpr int bytes = MlpF32Smem<D>::bytes;
    e = cudaFuncSetAttribute(mlp_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    mlp_f32_kernel<D><<<(rows + kFRows - 1) / kFRows, kGemmThreads, bytes,
                        st>>>(
        static_cast<const float*>(x), gamma, beta,
        static_cast<const float*>(wfc), bfc, static_cast<const float*>(wpj),
        bpj, static_cast<float*>(out), rows, f, act);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Row-major operands of `rows` rows; x and out [rows, k] / [rows, n], w
// [n, k] (nn.Linear's layout); bias [n], gamma and beta [k] in fp32.
// `use_bf16` selects the bf16 kernel (every tensor operand bf16) or the
// fp32 one.
// Each returns the CUDA error of the launch (0 on success), or
// cudaErrorInvalidValue for a shape with no instantiation.
extern "C" int aaclip_ln_linear(const void* x, const void* w,
                                const float* bias, const float* gamma,
                                const float* beta, void* out, int use_bf16,
                                int rows, int n, int k, void* stream) {
  return launch_gemm<true>(use_bf16 != 0, x, w, bias, gamma, beta, nullptr,
                           out, rows, n, k,
                           static_cast<cudaStream_t>(stream));
}

// out = res + (y @ w^T + bias); y [rows, k], res and out [rows, n].
extern "C" int aaclip_linear_residual(const void* res, const void* y,
                                      const void* w, const float* bias,
                                      void* out, int use_bf16, int rows, int n,
                                      int k, void* stream) {
  return launch_gemm<false>(use_bf16 != 0, y, w, bias, nullptr, nullptr, res,
                            out, rows, n, k,
                            static_cast<cudaStream_t>(stream));
}

// out = x + proj(act(fc(LN(x)))); x and out [rows, d], w_fc [f, d], w_proj
// [d, f]; gamma, beta, b_proj [d] and b_fc [f] in fp32; act 0 erf GELU, 1
// tanh GELU, 2 QuickGELU.
extern "C" int aaclip_mlp_fused(const void* x, const float* gamma,
                                const float* beta, const void* w_fc,
                                const float* b_fc, const void* w_proj,
                                const float* b_proj, void* out, int use_bf16,
                                int rows, int d, int f, int act,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || f < kMlpHid || f % kMlpHid || act < kGeluErf ||
      act > kQuickGelu)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 128:
      return launch_mlp<128>(use_bf16 != 0, x, gamma, beta, w_fc, b_fc,
                             w_proj, b_proj, out, rows, f, act, st);
    case 1024:
      return launch_mlp<1024>(use_bf16 != 0, x, gamma, beta, w_fc, b_fc,
                              w_proj, b_proj, out, rows, f, act, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
