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
//    hidden rounded to the compute dtype, proj accumulated in fp32, then
//    x + acc + b_proj in fp32, rounded once.
// Weights are read in nn.Linear's [out, in] layout as they lie: a row of W
// is a column of the product's B operand, which is the K-major B operand
// of wgmma (and the column-major one of mma.sync), so no transposed copy
// exists.
//
// What bounds them on an H100: at the predict's batch 32 (43,840 rows of
// 1024) ln_linear to 3072 columns is 275.8 GFLOP against 365.5 MB moved,
// linear_residual 91.9 GFLOP against 271.5 MB, mlp_fused (hidden 4096)
// 735.5 GFLOP against 196.4 MB: all far above the card's ~295 bf16 FLOP per
// byte of HBM, so bound by the tensor cores.
//
// Routes, by the entry points' `mode`. bf16 (kModeBf16), the fast policy,
// runs the TMA + wgmma engine below; fp32 runs the same engine's
// split-plane modes on bf16 planes of its fp32 operands
// (gemm_planes_wgmma, further down): under precision "high" (kMode3Pass,
// fp32_high) the 3-pass mode on two planes, under "highest" (kModeF32),
// the parity policy, the 6-pass mode on three.
//
// The bf16 engine is one GEMM, out[R, N] = epilogue(prologue(A)[R, K] .
// W[N, K]^T), and a row-statistics kernel:
//  - row_stats_kernel writes each row's mean and 1/sqrt(var + eps) (fp32,
//    [R], one warp per row, the mean first and then the mean of squared
//    deviations) once, where a GEMM prologue would redo them in each of
//    the N / BN column blocks of a row.
//  - gemm_wgmma: persistent blocks of 384 threads walk 128 x BN output
//    tiles (BN 256 where N allows it, else 128), tile t at rows
//    128 * (t / (N / BN)), so the blocks in flight share their A rows and
//    W stays in L2. One thread of the producer warpgroup streams the A and
//    W tiles of 64 reduction columns by TMA (128-byte swizzle; rows past R
//    arrive as zeros) into a ring of kGemmStages stages with full and empty
//    mbarriers, and runs on into the block's next tile while the consumers
//    store the current one; it gives its registers up (setmaxnreg) to the
//    two consumer warpgroups, each of which holds a [64, BN] fp32
//    accumulator. Plain prologue (linear_residual, proj): wgmma with A and
//    W from shared memory. LN prologue (ln_linear, fc): each consumer reads
//    its A fragments of the raw x tile by ldmatrix, normalises them in fp32
//    with its rows' statistics and gamma / beta (staged once per block in
//    shared memory), rounds them to bf16 where the TPU kernel casts, and
//    issues wgmma with A from registers and W K-major; the next k-tile's
//    fragments are built while this one's products run.
//    Epilogues, in fp32 in the plain versions' order: acc + b (ln_linear);
//    act(acc + b), rounded to bf16 (fc; the precise erff / tanhf / expf:
//    the hidden is rounded right after, and an approximate function would
//    flip those roundings against the plain version); res + (acc + b)
//    (linear_residual); (x + acc) + b (proj). Rows past R are never
//    stored. No split-K and no atomics: two runs are bit-equal.
//  - mlp_fused is three launches: the statistics; fc (LN prologue,
//    activation epilogue) into a bf16 hidden [R, F] in device memory; proj
//    (plain prologue, K = F, the (x + acc) + b epilogue). The hidden goes
//    through device memory as bf16. The TPU kernel keeps it in VMEM, which
//    holds megabytes; on this card the register file decides: a wgmma tile
//    has 64 rows per warpgroup and a [64, 1024] fp32 accumulator is the
//    SM's whole 256 KB of registers, so a block holding the full-width
//    output holds at most ~40 rows and reads both weight matrices (16.8 MB
//    at D 1024) for them, and splitting D
//    across blocks recomputes fc D / 256 times. Each half alone is bound
//    by the tensor cores: at the predict's batch 32 fc is 367.8 GFLOP
//    against 90 MB of x, 8.4 MB of W_fc and 359 MB of bf16 hidden, and
//    proj the same; writing and reading the hidden adds 718 MB, ~0.21 ms at
//    3.35 TB/s, under ~0.74 ms of tensor-core time. The TPU kernel and the
//    plain version round the hidden to bf16 at exactly that point, so the
//    numerics stay the same.
// Widths, every route: K a multiple of 64 (at most kMaxK under the LN
// prologue, whose statistics hold a row in registers), N a multiple of
// 128. Anything else returns cudaErrorInvalidValue.

#include <math.h>

#include <atomic>

#include "hopper_common.cuh"
#include "launch_count.cuh"
#include "mma_common.cuh"

namespace {

using namespace aaclip;
using bf16 = __nv_bfloat16;

constexpr float kLnEps = 1e-5f;
constexpr int kMaxK = 1024;  // the LayerNorm statistics hold a row in registers

// activation codes, as ops/fused_block.py passes them
constexpr int kGeluErf = 0, kGeluTanh = 1, kQuickGelu = 2;

// the entry points' routes, as ops/fused_block.py passes them (_MODES)
constexpr int kModeF32 = 0, kModeBf16 = 1, kMode3Pass = 2;

// The activation in fp32, in the order torch's elementwise kernels
// evaluate it (the plain version's F.gelu and x * sigmoid(1.702 x)).
template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == kGeluErf) {
    return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
  } else if constexpr (ACT == kGeluTanh) {
    const float inner = 0.79788456080286536f * (x + 0.044715f * (x * x * x));
    return 0.5f * x * (1.f + tanhf(inner));
  } else {
    return x * (1.f / (1.f + expf(-1.702f * x)));
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// two bf16 (the lower address first) as fp32, exactly
__device__ __forceinline__ float2 bf16x2_to_f32(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// 16 bytes of a row as fp32: 8 bf16 or 4 fp32 values
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int n = 8;
  __device__ static void load(const bf16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = bf16x2_to_f32(w[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
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
// bf16: the row statistics of the LN prologue, one warp per row.

constexpr int kStatsRows = 8;  // rows (warps) per block

__global__ void __launch_bounds__(kStatsRows * 32)
row_stats_kernel(const bf16* __restrict__ x, float* __restrict__ mean,
                 float* __restrict__ rstd, int R, int K) {
  const int row = blockIdx.x * kStatsRows + threadIdx.x / 32;
  if (row >= R) return;  // the whole warp
  float m, r;
  row_stats(x + (int64_t)row * K, K, m, r);
  if ((threadIdx.x & 31) == 0) {
    mean[row] = m;
    rstd[row] = r;
  }
}

// ---------------------------------------------------------------------------
// bf16: the TMA + wgmma GEMM, out [R, N] = epilogue(prologue(A) . W^T).

constexpr int kBM = 128;  // output rows per tile: two warpgroups of 64
constexpr int kBK = 64;   // reduction columns per TMA tile (one 128 B row)
constexpr int kBN = 128, kBNWide = 256;  // output columns per tile
constexpr int kGemmStages = 4;   // A / W tile pairs in flight
constexpr int kTmaThreads = 384;  // two consumer warpgroups + the producer
static_assert(kBK == kTileCols, "a tile row is one 128-byte swizzle row");

enum Epilogue { kEpiBias, kEpiAct, kEpiResidual, kEpiProj };

struct GemmArgs {
  const bf16* bias;   // [N]
  const bf16* gamma;  // [K], LN prologue
  const bf16* beta;
  const float* mean;   // [R], LN prologue
  const float* rstd;
  const bf16* res;     // [R, N]: the residual, or proj's x
  bf16* out;           // [R, N]
  int R, N, K, act;
};

// Shared memory of a block: the ring (stage s: the A tile, then the W
// tile, both 1024-byte aligned), the mbarriers, and gamma and beta under
// the LN prologue.
template <int BN>
struct GemmSmem {
  static constexpr int kA = kBM * kRowBytes;
  static constexpr int kStage = kA + BN * kRowBytes;
  static constexpr int kBars = kGemmStages * kStage;
  static constexpr int kVecs = kBars + 2 * 8 * kGemmStages;
  static constexpr int bytes(bool ln) {
    return kSwizzleAtom + kVecs + (ln ? 2 * kMaxK * 4 : 0);
  }
};

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (BN == kBNWide)
    wgmma_ss_n256(d, da, db, scale_d);
  else
    wgmma_ss_n128(d, da, db, scale_d);
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (BN == kBNWide)
    wgmma_rs_n256(d, a, db, scale_d);
  else
    wgmma_rs_n128(d, a, db, scale_d);
}

// The LN prologue of one k-tile for one consumer thread: its warp's A
// fragments of the raw x tile `a` (rows wrow .. wrow + 15 of the tile) by
// ldmatrix, normalised in fp32 with the statistics of rows g and g + 8
// (index 0 and 1) and gamma / beta of columns k0 .., rounded to bf16.
// Fragment register r holds row g + 8 * (r % 2), columns 2t, 2t + 1 of the
// k-step's first (r < 2) or second eight.
__device__ __forceinline__ void ln_frags(uint32_t (&f)[kBK / 16][4],
                                         const uint8_t* a, int wrow, int k0,
                                         const float* sg, const float* sb,
                                         const float (&mean)[2],
                                         const float (&rstd)[2]) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const uint8_t* rp = a + (wrow + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              kRowBytes;
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    const int chunk = ks * 2 + (lane >> 4);
    ldmatrix_x4(f[ks], rp + ((chunk ^ (lane & 7)) << 4));  // the swizzle
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = k0 + ks * 16 + (r >> 1) * 8 + 2 * t;
      const float2 gm = *reinterpret_cast<const float2*>(sg + c);
      const float2 bt = *reinterpret_cast<const float2*>(sb + c);
      const float2 v = bf16x2_to_f32(f[ks][r]);
      const int i = r & 1;
      f[ks][r] = pack_f32((v.x - mean[i]) * rstd[i] * gm.x + bt.x,
                          (v.y - mean[i]) * rstd[i] * gm.y + bt.y);
    }
  }
}

// The epilogue of one consumer thread: rows r0 and r0 + 8, columns
// n0 + 8j + 2t, 2t + 1 of its accumulator (hopper_common.cuh's layout),
// with the activation ACT (kEpiAct) fixed at compile time. The bias and
// residual operands of kEpiCols column groups are loaded together, through
// the read-only path, before any of their stores, and rows past R are
// computed and only their stores skipped: one load and one store at a
// time, or a branch around each element, would wait out a memory or
// arithmetic latency for every pair of columns.
constexpr int kEpiCols = 8;

template <int BN, int EPI, int ACT>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           const GemmArgs& p, int r0, int n0,
                                           int t) {
  constexpr bool kRes = EPI == kEpiResidual || EPI == kEpiProj;
  const bool in[2] = {r0 < p.R, r0 + 8 < p.R};
  const int64_t o0 = (int64_t)r0 * p.N + n0 + 2 * t;
  const int64_t o[2] = {o0, o0 + 8 * (int64_t)p.N};
  const unsigned int* res = reinterpret_cast<const unsigned int*>(p.res);
  const unsigned int* bias = reinterpret_cast<const unsigned int*>(p.bias);
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += kEpiCols) {
    float2 b[kEpiCols];
    uint32_t r[kEpiCols][2];
#pragma unroll
    for (int j = 0; j < kEpiCols; ++j) {
      const int c = 8 * (j0 + j);
      b[j] = bf16x2_to_f32(__ldg(bias + (n0 + 2 * t + c) / 2));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        r[j][h] = kRes && in[h] ? __ldg(res + (o[h] + c) / 2) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kEpiCols; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a0 = acc[4 * (j0 + j) + 2 * h];
        const float a1 = acc[4 * (j0 + j) + 2 * h + 1];
        float v0, v1;
        if (EPI == kEpiProj) {
          const float2 x = bf16x2_to_f32(r[j][h]);
          v0 = (x.x + a0) + b[j].x;
          v1 = (x.y + a1) + b[j].y;
        } else {
          v0 = a0 + b[j].x;
          v1 = a1 + b[j].y;
          if (EPI == kEpiAct) {
            v0 = activate<ACT>(v0);
            v1 = activate<ACT>(v1);
          } else if (EPI == kEpiResidual) {
            const float2 x = bf16x2_to_f32(r[j][h]);
            v0 = x.x + v0;
            v1 = x.y + v1;
          }
        }
        if (in[h])
          *reinterpret_cast<uint32_t*>(p.out + o[h] + 8 * (j0 + j)) =
              pack_f32(v0, v1);
      }
    }
  }
}

template <int BN, bool LN, int EPI>
__global__ void __launch_bounds__(kTmaThreads, 1)
gemm_wgmma(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tw, const GemmArgs p) {
  using S = GemmSmem<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kGemmStages;
  float* sg = reinterpret_cast<float*>(smem + S::kVecs);  // gamma [K]
  float* sb = sg + kMaxK;                                 // beta [K]

  const int tiles_n = p.N / BN;
  const int n_tiles = (p.R + kBM - 1) / kBM * tiles_n;
  const int n_k = p.K / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    mbar_fence_init();
  }
  if (LN) {
    for (int i = threadIdx.x; i < p.K; i += kTmaThreads) {
      sg[i] = __bfloat162float(p.gamma[i]);
      sb[i] = __bfloat162float(p.beta[i]);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      int it = 0;  // k-tiles of all this block's tiles so far
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % kGemmStages;
          if (it >= kGemmStages)
            mbar_wait(&empty[st], (it / kGemmStages - 1) & 1);
          uint8_t* s = smem + st * S::kStage;
          mbar_arrive_expect_tx(&full[st], S::kStage);
          tma_load_3d(s, &ta, &full[st], kt * kBK, m0, 0);
          tma_load_3d(s + S::kA, &tw, &full[st], kt * kBK, n0, 0);
        }
      }
    }
  } else {  // consumers: 64 rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const int wrow = wg * 64 + warp * 16;  // the warp's first row of a tile
    float acc[BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * BN;
      const int r0 = m0 + wrow + g;  // this thread's rows r0 and r0 + 8
      if constexpr (LN) {
        float mean[2], rstd[2];  // rows past R: 0, so they read as beta
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool in = r0 + 8 * i < p.R;
          mean[i] = in ? p.mean[r0 + 8 * i] : 0.f;
          rstd[i] = in ? p.rstd[r0 + 8 * i] : 0.f;
        }
        uint32_t cur[kBK / 16][4], nxt[kBK / 16][4];
        mbar_wait(&full[it % kGemmStages], (it / kGemmStages) & 1);
        ln_frags(nxt, smem + it % kGemmStages * S::kStage, wrow, 0, sg, sb,
                 mean, rstd);
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % kGemmStages;
#pragma unroll
          for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
            for (int r = 0; r < 4; ++r) cur[ks][r] = nxt[ks][r];
          const uint64_t db = sw128_desc(smem + st * S::kStage + S::kA);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kBK / 16; ++ks)
            wgmma_rs<BN>(acc, cur[ks], desc_plus(db, 32 * ks), kt | ks);
          wgmma_commit();
          if (kt + 1 < n_k) {  // the next k-tile's fragments, under these
            const int sn = (it + 1) % kGemmStages;
            mbar_wait(&full[sn], ((it + 1) / kGemmStages) & 1);
            ln_frags(nxt, smem + sn * S::kStage, wrow, (kt + 1) * kBK, sg, sb,
                     mean, rstd);
          }
          wgmma_wait<0>();
          fence_frags(cur);  // the products read cur until here
          mbar_arrive(&empty[st]);
        }
      } else {
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % kGemmStages;
          mbar_wait(&full[st], (it / kGemmStages) & 1);
          const uint8_t* s = smem + st * S::kStage;
          const uint64_t da = sw128_desc(s + wg * 64 * kRowBytes);
          const uint64_t db = sw128_desc(s + S::kA);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kBK / 16; ++ks)
            wgmma_ss<BN>(acc, desc_plus(da, 32 * ks), desc_plus(db, 32 * ks),
                         kt | ks);
          wgmma_commit();
          wgmma_wait<1>();  // the previous k-tile's products are done
          if (kt > 0) mbar_arrive(&empty[(it + kGemmStages - 1) % kGemmStages]);
        }
        wgmma_wait<0>();
        mbar_arrive(&empty[(it + kGemmStages - 1) % kGemmStages]);
      }
      fence_operand(acc);
      if constexpr (EPI == kEpiAct) {
        if (p.act == kGeluErf)
          store_tile<BN, EPI, kGeluErf>(acc, p, r0, n0, t);
        else if (p.act == kGeluTanh)
          store_tile<BN, EPI, kGeluTanh>(acc, p, r0, n0, t);
        else
          store_tile<BN, EPI, kQuickGelu>(acc, p, r0, n0, t);
      } else {
        store_tile<BN, EPI, 0>(acc, p, r0, n0, t);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: the split-plane modes, what the TPU kernels' _kdot computes on fp32
// operands (flash_attention.py:49-71). Each fp32 operand v is held as kP
// bf16 planes (plane p of an [rows, cols] operand at p * rows * cols), and
// each product is a sum of bf16 products of planes in hopper_common.cuh's
// pass table (pass_a / pass_b), smallest first:
//  - precision "high" (kMode3Pass, fp32_high), kP 2: hi = bf16(v), lo =
//    bf16(v - hi) (mma_common.cuh's split_pack); hi.lo + lo.hi + hi.hi,
//    passes 3-5 (_kdot's 3-pass form);
//  - precision "highest" (kModeF32, the parity policy), kP 3: hi, mid, lo
//    with hi + mid + lo = v (split3_pack); all six passes, mid.mid, hi.lo,
//    lo.hi, hi.mid, mid.hi, hi.hi (the TPU's native 6-pass form; the
//    dropped terms are about 2^-24 relative).
// fp32 epilogues and fp32 outputs. Bound by the tensor cores three or six
// times over: at the predict's batch 8 (10,960 rows) ln_linear to 3072
// columns is 206.9 GFLOP in three passes (~0.209 ms at 989 TFLOP/s) and
// 413.7 in six (~0.418 ms), against ~192 MB of fp32 moved (~0.057 ms at
// 3.35 TB/s), and mlp_fused (hidden 4096) 1103.4 GFLOP in six (~1.116 ms).
//  - split_kernel<kP> writes the planes of W (every call: 12.6 MB of
//    3-pass planes at the QKV shape) and of the plain prologue's A
//    (linear_residual's y).
//  - ln_split_kernel<kP> is the LN prologue: one warp per row, the fp32
//    statistics (row_stats), y = (x - mean) * rstd * gamma + beta in fp32
//    rounded step by step as the plain version's tensor ops round it, and
//    y's planes written out; the GEMM then reads A as planes like any
//    other operand.
//  - gemm_planes_wgmma<kP, EPI> is gemm_wgmma's persistent blocks,
//    producer and ring, with 2 kP tiles a stage (A's planes, then W's) in
//    kPlaneRing bytes of stages, each tile kBK (64) deep with the 128-byte
//    swizzle: 3-pass three 64 KB stages, 6-pass two 96 KB stages (four
//    48 KB stages of 32-deep k-tiles read 4-7% slower on the card).
//    Each consumer runs a k-tile's passes into a fresh fp32 accumulator
//    and adds that to the tile's running sum with round-to-nearest: the
//    tensor cores truncate a chain's sum at each step, a one-sided error
//    that would grow with K (4096 in proj) in one long chain, where a
//    k-tile's chain truncates at its own, far smaller, size. The fresh
//    accumulator and the running sum are 128 registers of a consumer.
//  - The epilogues run in fp32 in the plain versions' order: acc + b
//    (ln_linear), res + (acc + b) (linear_residual), (x + acc) + b (proj),
//    and fc's act(acc + b) written straight out as the hidden's kP planes,
//    the exact split of the fp32 hidden the plain version hands proj, so
//    proj needs no split of its own.
// mlp_fused is four launches (the weights' split, the LN prologue, fc,
// proj), ln_linear three, linear_residual two (one split of W and y), in
// either mode. Two runs are bit-equal (no atomics, no split-K).

// Bytes of the split-plane GEMM's ring of stages.
constexpr int kPlaneRing = 192 * 1024;

template <int kP>
struct PlaneSmem {
  static constexpr int kRow = kBK * 2;   // bytes of a tile row
  static constexpr int kA = kBM * kRow;  // one plane's A tile
  static constexpr int kW = kBN * kRow;  // one plane's W tile
  static constexpr int kStage = kP * (kA + kW);
  static constexpr int kStages = kPlaneRing / kStage;
  static constexpr int kBars = kStages * kStage;
  static constexpr int bytes = kSwizzleAtom + kBars + 2 * 8 * kStages;
};

struct PlaneArgs {
  const float* bias;  // [N]
  const float* res;   // [R, N]: the residual, or proj's x
  void* out;          // [R, N] fp32, or fc's hidden planes [kP, R, N] bf16
  int R, N, K, act;
};

// Up to two fp32 arrays of n values (n a multiple of 4) as their kP planes
// at dst, dst + n, ...: one job per blockIdx.y.
struct SplitJob {
  const float* src;
  bf16* dst;
  int64_t n;
};

constexpr int kSplitThreads = 256;

template <int kP>
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const SplitJob a, const SplitJob b) {
  const SplitJob j = blockIdx.y ? b : a;
  const int64_t n4 = j.n / 4;
  const float4* src = reinterpret_cast<const float4*>(j.src);
  for (int64_t i = (int64_t)blockIdx.x * kSplitThreads + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * kSplitThreads) {
    const float4 v = src[i];
    uint32_t p01[kP], p23[kP];  // values 0-1 and 2-3 of each plane
    split_planes<kP>(v.x, v.y, p01);
    split_planes<kP>(v.z, v.w, p23);
#pragma unroll
    for (int pl = 0; pl < kP; ++pl)
      reinterpret_cast<uint2*>(j.dst + pl * j.n)[i] =
          make_uint2(p01[pl], p23[pl]);
  }
}

// The LN prologue of the split-plane modes: row `row` of x [R, K]
// normalised and written as its planes [kP, R, K].
template <int kP>
__global__ void __launch_bounds__(kStatsRows * 32)
ln_split_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, bf16* __restrict__ planes,
                int R, int K) {
  const int row = blockIdx.x * kStatsRows + threadIdx.x / 32;
  if (row >= R) return;  // the whole warp
  const float* xr = x + (int64_t)row * K;
  float mean, rstd;
  row_stats(xr, K, mean, rstd);
  bf16* dst = planes + (int64_t)row * K;
  for (int c = (threadIdx.x & 31) * 4; c < K; c += 32 * 4) {
    float v[4], g[4], b[4], y[4];
    Vec<float>::load(xr + c, v);
    Vec<float>::load(gamma + c, g);
    Vec<float>::load(beta + c, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)  // ((x - mean) * rstd) * gamma + beta
      y[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[i], mean), rstd),
                                 g[i]),
                       b[i]);
    uint32_t p01[kP], p23[kP];
    split_planes<kP>(y[0], y[1], p01);
    split_planes<kP>(y[2], y[3], p23);
#pragma unroll
    for (int pl = 0; pl < kP; ++pl)
      *reinterpret_cast<uint2*>(dst + pl * (int64_t)R * K + c) =
          make_uint2(p01[pl], p23[pl]);
  }
}

// The split-plane epilogue of one consumer thread, laid out as
// store_tile's.
template <int kP, int EPI, int ACT>
__device__ __forceinline__ void store_tile_planes(
    const float (&acc)[kBN / 2], const PlaneArgs& p, int r0, int n0, int t) {
  constexpr bool kRes = EPI == kEpiResidual || EPI == kEpiProj;
  const bool in[2] = {r0 < p.R, r0 + 8 < p.R};
  const int64_t o0 = (int64_t)r0 * p.N + n0 + 2 * t;
  const int64_t o[2] = {o0, o0 + 8 * (int64_t)p.N};
  const int64_t plane = (int64_t)p.R * p.N;
#pragma unroll
  for (int j0 = 0; j0 < kBN / 8; j0 += kEpiCols) {
    float2 b[kEpiCols], r[kEpiCols][2];
#pragma unroll
    for (int j = 0; j < kEpiCols; ++j) {
      const int c = 8 * (j0 + j);
      b[j] = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + 2 * t + c));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        r[j][h] = kRes && in[h]
                      ? __ldg(reinterpret_cast<const float2*>(p.res + o[h] +
                                                              c))
                      : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kEpiCols; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a0 = acc[4 * (j0 + j) + 2 * h];
        const float a1 = acc[4 * (j0 + j) + 2 * h + 1];
        float v0, v1;
        if (EPI == kEpiProj) {
          v0 = (r[j][h].x + a0) + b[j].x;
          v1 = (r[j][h].y + a1) + b[j].y;
        } else {
          v0 = a0 + b[j].x;
          v1 = a1 + b[j].y;
          if (EPI == kEpiAct) {
            v0 = activate<ACT>(v0);
            v1 = activate<ACT>(v1);
          } else if (EPI == kEpiResidual) {
            v0 = r[j][h].x + v0;
            v1 = r[j][h].y + v1;
          }
        }
        if (!in[h]) continue;
        const int64_t at = o[h] + 8 * (j0 + j);
        if (EPI == kEpiAct) {
          uint32_t pk[kP];
          split_planes<kP>(v0, v1, pk);
          bf16* planes = static_cast<bf16*>(p.out);
#pragma unroll
          for (int pl = 0; pl < kP; ++pl)
            *reinterpret_cast<uint32_t*>(planes + pl * plane + at) = pk[pl];
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + at) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

// out [R, N] = epilogue(A . W^T) in the passes of kP planes, A and W as
// their planes [kP, R, K] and [kP, N, K] (tensor maps of depth kP), tiles
// of 128 x kBN.
template <int kP, int EPI>
__global__ void __launch_bounds__(kTmaThreads, 1)
gemm_planes_wgmma(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tw, const PlaneArgs p) {
  using S = PlaneSmem<kP>;
  constexpr int kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + kStages;

  const int tiles_n = p.N / kBN;
  const int n_tiles = (p.R + kBM - 1) / kBM * tiles_n;
  const int n_k = p.K / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int st = it % kStages;
          if (it >= kStages) mbar_wait(&empty[st], (it / kStages - 1) & 1);
          uint8_t* s = smem + st * S::kStage;
          mbar_arrive_expect_tx(&full[st], S::kStage);
#pragma unroll
          for (int pl = 0; pl < kP; ++pl) {
            tma_load_3d(s + pl * S::kA, &ta, &full[st], kt * kBK, m0, pl);
            tma_load_3d(s + kP * S::kA + pl * S::kW, &tw, &full[st],
                        kt * kBK, n0, pl);
          }
        }
      }
    }
  } else {  // consumers: 64 rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const int wrow = wg * 64 + warp * 16;
    constexpr int first = first_pass<kP>();
    float acc[kBN / 2], part[kBN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * kBM, n0 = tile % tiles_n * kBN;
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int st = it % kStages;
        mbar_wait(&full[st], (it / kStages) & 1);
        const uint8_t* s = smem + st * S::kStage;
        const uint64_t a = sw128_desc(s + wg * 64 * S::kRow);
        const uint64_t w = sw128_desc(s + kP * S::kA);
        wgmma_fence();
#pragma unroll
        for (int i = first; i < 6; ++i)  // the smallest pass starts the chain
#pragma unroll
          for (int ks = 0; ks < kBK / 16; ++ks)
            wgmma_ss_n128(part, desc_plus(a, pass_a(i) * S::kA + 32 * ks),
                          desc_plus(w, pass_b(i) * S::kW + 32 * ks),
                          (i - first) | ks);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(part);
        mbar_arrive(&empty[st]);
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
      }
      const int r0 = m0 + wrow + g;  // this thread's rows r0 and r0 + 8
      if constexpr (EPI == kEpiAct) {
        if (p.act == kGeluErf)
          store_tile_planes<kP, EPI, kGeluErf>(acc, p, r0, n0, t);
        else if (p.act == kGeluTanh)
          store_tile_planes<kP, EPI, kGeluTanh>(acc, p, r0, n0, t);
        else
          store_tile_planes<kP, EPI, kQuickGelu>(acc, p, r0, n0, t);
      } else {
        store_tile_planes<kP, EPI, 0>(acc, p, r0, n0, t);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.

// Whether N output columns take the 256-wide tile: wherever 256 divides
// N. At the predict's rows it is the faster width for each of its GEMMs
// (ln_linear's, linear_residual's, fc and proj), which chip_smoke.py's
// phase 8e times at both widths.
bool wide_tiles(int n) { return n % kBNWide == 0; }

// The output tile width of every bf16 GEMM launch: 0 for wide_tiles' rule,
// or kBN / kBNWide as aaclip_gemm_tile_width forces it.
std::atomic<int> g_tile_width{0};

bool tma_shape_ok(bool ln, int rows, int n, int k) {
  return rows >= 1 && n >= kBN && n % kBN == 0 && k >= kBK && k % kBK == 0 &&
         (!ln || k <= kMaxK);
}

int launch_stats(const void* x, float* mean, float* rstd, int rows, int k,
                 cudaStream_t st) {
  row_stats_kernel<<<(rows + kStatsRows - 1) / kStatsRows, kStatsRows * 32,
                     0, st>>>(static_cast<const bf16*>(x), mean, rstd, rows,
                              k);
  note_launch();
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool LN, int EPI>
int run_gemm(const CUtensorMap& ta, const void* w, const GemmArgs& p,
             cudaStream_t st) {
  CUtensorMap tw;
  cudaError_t err = make_tile_map(&tw, w, p.K, p.N, 1, (uint64_t)p.K * 2,
                                  (uint64_t)p.N * p.K * 2, BN);
  constexpr int smem = GemmSmem<BN>::bytes(LN);
  if (err == cudaSuccess)
    err = smem_attribute_once(
        reinterpret_cast<const void*>(gemm_wgmma<BN, LN, EPI>), smem);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.R + kBM - 1) / kBM * (p.N / BN);
  gemm_wgmma<BN, LN, EPI><<<tiles < sms ? tiles : sms, kTmaThreads, smem,
                            st>>>(ta, tw, p);
  note_launch();
  return static_cast<int>(cudaGetLastError());
}

// The GEMM on A [p.R, p.K] and W [p.N, p.K], both bf16 and row-major.
template <bool LN, int EPI>
int launch_tma_gemm(const void* a, const void* w, const GemmArgs& p,
                    cudaStream_t st) {
  if (!tma_shape_ok(LN, p.R, p.N, p.K))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta;
  const cudaError_t err = make_tile_map(&ta, a, p.K, p.R, 1,
                                        (uint64_t)p.K * 2,
                                        (uint64_t)p.R * p.K * 2, kBM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bn = g_tile_width.load(std::memory_order_relaxed);
  if (bn == kBNWide && p.N % kBNWide)
    return static_cast<int>(cudaErrorInvalidValue);
  return (bn ? bn == kBNWide : wide_tiles(p.N))
             ? run_gemm<kBNWide, LN, EPI>(ta, w, p, st)
             : run_gemm<kBN, LN, EPI>(ta, w, p, st);
}

// The kP planes of one or two fp32 arrays (src1 null for one), each of n
// values, a multiple of 4.
template <int kP>
int launch_split(const void* src0, void* dst0, int64_t n0, const void* src1,
                 void* dst1, int64_t n1, cudaStream_t st) {
  const SplitJob a{static_cast<const float*>(src0), static_cast<bf16*>(dst0),
                   n0};
  const SplitJob b = src1 ? SplitJob{static_cast<const float*>(src1),
                                     static_cast<bf16*>(dst1), n1}
                          : a;
  const int64_t most = (src1 && n1 > n0 ? n1 : n0) / 4;
  const int64_t blocks = (most + kSplitThreads - 1) / kSplitThreads;
  const dim3 grid(static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                  src1 ? 2 : 1);
  split_kernel<kP><<<grid, kSplitThreads, 0, st>>>(a, b);
  note_launch();
  return static_cast<int>(cudaGetLastError());
}

template <int kP>
int launch_ln_split(const void* x, const void* gamma, const void* beta,
                    void* planes, int rows, int k, cudaStream_t st) {
  ln_split_kernel<kP><<<(rows + kStatsRows - 1) / kStatsRows,
                        kStatsRows * 32, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(planes), rows, k);
  note_launch();
  return static_cast<int>(cudaGetLastError());
}

// The split-plane GEMM on A's planes [kP, p.R, p.K] and W's [kP, p.N,
// p.K].
template <int kP, int EPI>
int launch_planes_gemm(const void* a_planes, const void* w_planes,
                       const PlaneArgs& p, cudaStream_t st) {
  using S = PlaneSmem<kP>;
  if (!tma_shape_ok(false, p.R, p.N, p.K))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ta, tw;
  cudaError_t err = make_tile_map(&ta, a_planes, p.K, p.R, kP,
                                  (uint64_t)p.K * 2,
                                  (uint64_t)p.R * p.K * 2, kBM);
  if (err == cudaSuccess)
    err = make_tile_map(&tw, w_planes, p.K, p.N, kP, (uint64_t)p.K * 2,
                        (uint64_t)p.N * p.K * 2, kBN);
  if (err == cudaSuccess)
    err = smem_attribute_once(
        reinterpret_cast<const void*>(gemm_planes_wgmma<kP, EPI>), S::bytes);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (p.R + kBM - 1) / kBM * (p.N / kBN);
  gemm_planes_wgmma<kP, EPI><<<tiles < sms ? tiles : sms, kTmaThreads,
                               S::bytes, st>>>(ta, tw, p);
  note_launch();
  return static_cast<int>(cudaGetLastError());
}

// The split-plane routes of the entry points below, kP planes (2:
// kMode3Pass, 3: kModeF32), each after the entry's width check.
template <int kP>
int ln_linear_planes(const void* x, const void* w, const void* bias,
                     const void* gamma, const void* beta, void* a_planes,
                     void* w_planes, void* out, int rows, int n, int k,
                     cudaStream_t st) {
  int err = launch_split<kP>(w, w_planes, (int64_t)n * k, nullptr, nullptr,
                             0, st);
  if (err == 0)
    err = launch_ln_split<kP>(x, gamma, beta, a_planes, rows, k, st);
  if (err != 0) return err;
  const PlaneArgs p{static_cast<const float*>(bias), nullptr, out, rows, n,
                    k, 0};
  return launch_planes_gemm<kP, kEpiBias>(a_planes, w_planes, p, st);
}

template <int kP>
int linear_residual_planes(const void* res, const void* y, const void* w,
                           const void* bias, void* a_planes, void* w_planes,
                           void* out, int rows, int n, int k,
                           cudaStream_t st) {
  const int err = launch_split<kP>(w, w_planes, (int64_t)n * k, y, a_planes,
                                   (int64_t)rows * k, st);
  if (err != 0) return err;
  const PlaneArgs p{static_cast<const float*>(bias),
                    static_cast<const float*>(res), out, rows, n, k, 0};
  return launch_planes_gemm<kP, kEpiResidual>(a_planes, w_planes, p, st);
}

template <int kP>
int mlp_planes(const void* x, const void* gamma, const void* beta,
               const void* w_fc, const void* b_fc, const void* w_proj,
               const void* b_proj, void* hidden, void* a_planes,
               void* w_planes, void* out, int rows, int d, int f, int act,
               cudaStream_t st) {
  bf16* wp_fc = static_cast<bf16*>(w_planes);
  bf16* wp_proj = wp_fc + kP * (int64_t)f * d;
  int err = launch_split<kP>(w_fc, wp_fc, (int64_t)f * d, w_proj, wp_proj,
                             (int64_t)d * f, st);
  if (err == 0)
    err = launch_ln_split<kP>(x, gamma, beta, a_planes, rows, d, st);
  if (err != 0) return err;
  const PlaneArgs fc{static_cast<const float*>(b_fc), nullptr, hidden, rows,
                     f, d, act};
  err = launch_planes_gemm<kP, kEpiAct>(a_planes, wp_fc, fc, st);
  if (err != 0) return err;
  const PlaneArgs proj{static_cast<const float*>(b_proj),
                       static_cast<const float*>(x), out, rows, d, f, 0};
  return launch_planes_gemm<kP, kEpiProj>(hidden, wp_proj, proj, st);
}

}  // namespace

// Row-major operands of `rows` rows; x and out [rows, k] / [rows, n], w
// [n, k] (nn.Linear's layout); bias [n], gamma and beta [k]. `mode`
// selects the route: kModeBf16 (every operand, the vectors too, bf16, as
// the predictor casts a block's leaves) on the TMA + wgmma engine, whose
// tensor maps need every bf16 operand's base 16-byte aligned (the wrappers
// refuse anything else); kMode3Pass and kModeF32 (every operand fp32) on
// the same engine's 3-pass and 6-pass modes. Scratch from the caller, each
// unused (and may be null) on the other routes: mean and rstd fp32 [rows]
// for the bf16 route's statistics; a_planes bf16 [kP, rows, k] and
// w_planes bf16 [kP, n, k] for the kP planes of the normalised x and of w
// (kP 2 on kMode3Pass, 3 on kModeF32).
// Each returns the CUDA error of its launches (0 on success), or
// cudaErrorInvalidValue for a shape or mode the routes do not take.
extern "C" int aaclip_ln_linear(const void* x, const void* w,
                                const void* bias, const void* gamma,
                                const void* beta, float* mean, float* rstd,
                                void* a_planes, void* w_planes, void* out,
                                int mode, int rows, int n, int k,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tma_shape_ok(true, rows, n, k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kModeF32)
    return ln_linear_planes<3>(x, w, bias, gamma, beta, a_planes, w_planes,
                               out, rows, n, k, st);
  if (mode == kMode3Pass)
    return ln_linear_planes<2>(x, w, bias, gamma, beta, a_planes, w_planes,
                               out, rows, n, k, st);
  if (mode != kModeBf16) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_stats(x, mean, rstd, rows, k, st);
  if (err != 0) return err;
  const GemmArgs p{static_cast<const bf16*>(bias),
                   static_cast<const bf16*>(gamma),
                   static_cast<const bf16*>(beta), mean, rstd, nullptr,
                   static_cast<bf16*>(out), rows, n, k, 0};
  return launch_tma_gemm<true, kEpiBias>(x, w, p, st);
}

// out = res + (y @ w^T + bias); y [rows, k], res and out [rows, n];
// a_planes [kP, rows, k] and w_planes [kP, n, k] the split routes'
// scratch.
extern "C" int aaclip_linear_residual(const void* res, const void* y,
                                      const void* w, const void* bias,
                                      void* a_planes, void* w_planes,
                                      void* out, int mode, int rows, int n,
                                      int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tma_shape_ok(false, rows, n, k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kModeF32)
    return linear_residual_planes<3>(res, y, w, bias, a_planes, w_planes,
                                     out, rows, n, k, st);
  if (mode == kMode3Pass)
    return linear_residual_planes<2>(res, y, w, bias, a_planes, w_planes,
                                     out, rows, n, k, st);
  if (mode != kModeBf16) return static_cast<int>(cudaErrorInvalidValue);
  const GemmArgs p{static_cast<const bf16*>(bias), nullptr, nullptr, nullptr,
                   nullptr, static_cast<const bf16*>(res),
                   static_cast<bf16*>(out), rows, n, k, 0};
  return launch_tma_gemm<false, kEpiResidual>(y, w, p, st);
}

// out = x + proj(act(fc(LN(x)))); x and out [rows, d], w_fc [f, d], w_proj
// [d, f]; gamma, beta, b_proj [d] and b_fc [f]; act 0 erf GELU, 1 tanh
// GELU, 2 QuickGELU. Scratch from the caller: on the bf16 route mean and
// rstd fp32 [rows] and hidden bf16 [rows, f]; on the split routes hidden
// the hidden's planes bf16 [kP, rows, f], a_planes the normalised x's
// [kP, rows, d] and w_planes w_fc's [kP, f, d] then w_proj's [kP, d, f].
extern "C" int aaclip_mlp_fused(const void* x, const void* gamma,
                                const void* beta, const void* w_fc,
                                const void* b_fc, const void* w_proj,
                                const void* b_proj, float* mean, float* rstd,
                                void* hidden, void* a_planes, void* w_planes,
                                void* out, int mode, int rows, int d, int f,
                                int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // fc (K = d under the LN prologue, N = f), then proj (K = f, N = d)
  if (act < kGeluErf || act > kQuickGelu || !tma_shape_ok(true, rows, f, d) ||
      !tma_shape_ok(false, rows, d, f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == kModeF32)
    return mlp_planes<3>(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, hidden,
                         a_planes, w_planes, out, rows, d, f, act, st);
  if (mode == kMode3Pass)
    return mlp_planes<2>(x, gamma, beta, w_fc, b_fc, w_proj, b_proj, hidden,
                         a_planes, w_planes, out, rows, d, f, act, st);
  if (mode != kModeBf16) return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_stats(x, mean, rstd, rows, d, st);
  if (err != 0) return err;
  const GemmArgs fc{static_cast<const bf16*>(b_fc),
                    static_cast<const bf16*>(gamma),
                    static_cast<const bf16*>(beta), mean, rstd, nullptr,
                    static_cast<bf16*>(hidden), rows, f, d, act};
  err = launch_tma_gemm<true, kEpiAct>(x, w_fc, fc, st);
  if (err != 0) return err;
  const GemmArgs proj{static_cast<const bf16*>(b_proj), nullptr, nullptr,
                      nullptr, nullptr, static_cast<const bf16*>(x),
                      static_cast<bf16*>(out), rows, d, f, 0};
  return launch_tma_gemm<false, kEpiProj>(hidden, w_proj, proj, st);
}

// Every later bf16 GEMM launch of this library takes output tiles of `bn`
// columns (128 or 256; a launch whose N 256 does not divide then fails
// with cudaErrorInvalidValue), or wide_tiles' rule again with 0. For
// holding the two widths against each other on the card; returns
// cudaErrorInvalidValue for any other width.
extern "C" int aaclip_gemm_tile_width(int bn) {
  if (bn != 0 && bn != kBN && bn != kBNWide)
    return static_cast<int>(cudaErrorInvalidValue);
  g_tile_width.store(bn, std::memory_order_relaxed);
  return 0;
}
