// Packed-QKV softmax attention for Hopper (sm_90a), plain C interface.
//
// Replaces aaclip_tpu/ops/flash_attention.py::attention_packed
// (_packed_kernel) in both of its modes: non-causal attention read straight
// out of the packed projection qkv [B, S, sections*D] (bias already added),
// keys at or past `valid_len` masked, softmax division deferred to the
// output, written token-major to out [B, S, D].
//  - standard mode: qkv [B, S, 3*D], ld = 3*D, offsets 0, D, 2*D;
//  - V-V mode (vv=True, packed_sections=1, the CLIP-Surgery tail of the
//    stage-1 features): a value-only v [B, S, D], ld = D, all three
//    offsets 0, so it computes softmax(V V^T * hd^-1/2) V per head.
//    Nothing below assumes ld == 3*D: rows are addressed through `ld`
//    and each section through its offset, and 16-byte row alignment holds
//    for any D that is a multiple of 8 (bf16) or 4 (fp32).
//
// What bounds it on an H100: per image and launch at ViT-L/518 (S 1370,
// 16 heads x 64) the work is 4*16*1370^2*64 = 7.69 GFLOP against 11.2 MB
// moved (3072*1370*2 B read, 1024*1370*2 B written), about 690 FLOP per
// byte, far above the card's ~295 bf16 FLOP per byte of HBM: it is bound
// by the tensor cores (989 TFLOP/s), not by memory; 245.9 GFLOP at the
// predict's batch 32 is 0.249 ms (at ViT-H-14's 16 heads of 80, 307.5
// GFLOP, 0.311 ms; ViT-g-14's 16 of 88, 338.3 GFLOP, 0.342 ms;
// ViT-bigG-14's 16 of 104, 399.8 GFLOP, 0.404 ms; in 8 heads of 128,
// ViT-L's 0.249). At head dim 64 the
// softmax's exponentials are a second bound of the same size: one per
// score at 16 per SM and clock takes as long as the score's 4*64 product
// FLOP at the tensor cores' ~4096 per SM and clock, so the design overlaps
// the two.
//
// Routes. bf16 at a TMA head dim (tma_head_dim: 64, ViT-L and ViT-B; 80,
// open_clip's ViT-H-14; 88, its ViT-g-14; 104, its ViT-bigG-14; 128) runs
// attn_fwd_wgmma<HD>, the design below.
// fp32 there, the CLIs' default precision ("highest"), runs
// attn_fwd_6pass<HD> on the same TMA + wgmma machinery (below); fp32 under
// precision "high" (the 3-pass mode) runs attn_fwd_3pass_wgmma<HD>, the
// same kernel on two planes. Head dim 16 (tiny-test) keeps the first
// port's kernels: bf16 on mma.sync
// (attn_bf16_kernel: one block per 64 query rows, K/V tiles of 64 copied
// through registers), fp32 on FMA with one thread per query row and no
// TF32 (attn_f32_kernel), and the 3-pass mode on mma.sync from hi/lo tiles
// (attn_fwd_3pass).
//
// The fp32 route at head dim 64 (attn_fwd_6pass) replaces the same TPU
// kernel at precision "highest", where _kdot (flash_attention.py:49-71)
// lowers every product to the MXU's native 6-pass form: six bf16
// products of the operands' bf16 hi/mid/lo planes. What bounds it: those
// six passes, 6 x 4*B*H*S^2*hd = 369.0 GFLOP at the fp32 predict's batch
// 8, 0.373 ms at 989 TFLOP/s, while on fp32 FMA at 67 TFLOP/s the one
// true-fp32 pass alone takes at least 0.92 ms. The design: a split
// kernel (split3_kernel) writes each fp32 operand's three bf16 planes to
// scratch, so every tile arrives by TMA as in the bf16 route; each product
// is six wgmma chains into one fp32 accumulator; P stays fp32 and is split
// in registers. TF32's wgmma would do three passes at the same cost, but it
// reads only K-major operands, and P V needs V MN-major.
//
// The 3-pass route at head dim 64 (attn_fwd_3pass_wgmma) replaces the same
// TPU kernel at precision "high", where _kdot splits each fp32 operand
// into bf16 hi and lo = bf16(x - hi) and sums hi.hi + hi.lo + lo.hi in
// fp32. What bounds it: three bf16 passes, 3 x 4*B*H*S^2*hd = 184.5 GFLOP
// at the fp32_high predict's batch 8, 0.187 ms at 989 TFLOP/s. The design
// is the 6-pass route's on two planes (split2_kernel writes hi and lo, the
// products are passes 3-5 of the 6-pass table).
//
// Head dims 80, 88, 104 and 128. One tile row of the TMA + wgmma kernels
// is 64 bf16 columns, one 128-byte swizzle row (hopper_common.cuh), so a
// head is loaded as 64-column chunks (Head<HD>), each a TMA box of its own
// at column 64 c of the head and a tile of the same layout: one chunk at
// 64, two at 80, 88, 104 and 128 (16, 24 or 40 of the second box's
// columns used at 80, 88, 104). Q K^T runs ceil(HD / 16) k-steps, k-step
// ks 32 * (ks % 4) bytes into chunk ks / 4 (five at 80, six at 88, seven
// at 104: four from the first chunk, the rest from the second). At 88 and
// 104 the head dim is no whole number of k-steps, and the last one reads 8
// pad columns (88-95, 104-111) of both Q and K, which must add exact
// zeros to every score. The pad must be zeros in both operands: zeros in
// one alone would not do, as 0 * NaN is NaN, so a non-finite value in the
// next head would reach this head's scores. So at 88 and 104 every
// operand comes through a per-head tensor map
// (hopper_common.cuh::make_head_map) whose innermost extent is one head:
// a box's columns past the head dim arrive as zeros, never as the next
// head's, for nothing; zeroing the pad in shared memory instead would
// cost the consumers a pass over every K tile and a barrier before its
// product. At 64, 80 and 128 the k-steps end at the head, and the
// section-wide maps of the first kernels serve (at 80 the second box's
// columns 80-127 are the next head's and never enter a product), so those
// instantiations compile to the same code as before.
// P V runs one product per chunk, m64n64 on a full chunk and m64nN on the
// first N = HD - 64 columns of the second (16, 24, 40 at 80, 88, 104; the
// MN-major descriptor reading N / 8 of each swizzled row's eight 16-byte
// chunks), so V's pad never enters a product, and O's stores are as
// compile-time per chunk as its products (a runtime bound on a chunk's
// columns pushed O into local memory). So every route spends hd's own
// products at 80 and 128, and at 88 and 104 one padded k-step of Q K^T
// more (6 / 5.5 and 7 / 6.5 of Q K^T's work, which the bound does not
// count). The tile plans (rows x keys per tile x stages; shared memory;
// registers a consumer thread holds for O, S, P):
//   bf16      hd 64:     128 x 128 x 3, 113 KB; O 32, S 64, P 32 + 32
//             hd 80-128: 128 x 64 x 5, 193 KB; O 40/44/52/64, S 32,
//                        P 16 + 16
//   6-pass    hd 64:     128 x 64 x 3, 193 KB; O 32 + 32, S 32, P 3 x 16
//             hd 80-128: 128 x 32 x 2, 193 KB; O 40/44/52/64 + 32, S 16,
//                        P 3 x 8
//   3-pass    hd 64:     128 x 64 x 4, 161 KB; O 32 + 32, S 32, P 2 x 16
//             hd 80-128: 128 x 32 x 4, 193 KB; O 40/44/52/64 + 32, S 16,
//                        P 2 x 8
// (fp32's O + 32: the running O and one chunk's P V accumulator, the
// chunks' P V run one after the other; at 88 and 104 the last chunk's
// product has an accumulator of its own, 12 or 20 registers.) Above 64
// the bf16 keys drop to 64 a tile because O grows to 40-64 registers and
// ptxas plans the 384-thread consumers at 168 (64 keys also halve S and
// P); the fp32 keys drop to 32 because Q's planes alone take kP x 32 KB
// (96 KB on the 6-pass route) and a 64-key stage 2 x kP x 16 KB. ptxas
// (CUDA 12.8, sm_90a) at 64, 80 and 128: every instantiation 168
// registers, no stack and no spill; C7519 (warpgroup.arrive injected) in
// attn_fwd_wgmma at 64, 80 and 128, and C7511 (wgmma serialized for want
// of registers) in attn_fwd_3pass_wgmma<80>; 88 and 104 as chip_smoke.py's
// phase 2 prints them (PERF.md). The logsumexp keeps its meaning at every
// head dim: m + log(l) per row of [B, H, S].
//
// Design of attn_fwd_wgmma. The TPU kernel holds a head's whole K and V
// in VMEM (~360 KB at S 1408), more than a block's 227 KB of shared
// memory, so here one block owns (128 query rows, one head, one image) and
// walks the keys in tiles of 128 with an online softmax (running max and
// sum in fp32) and one division at the end. Its 384 threads are three
// warpgroups: two consumers of 64 query rows each and a producer. One
// producer thread keeps the block's Q tile and a ring of kFwdStages K/V
// tile pairs in flight by TMA, each stage tracked by a full and an empty
// mbarrier, so the next tiles arrive while the current one's products run
// (the first port copied each tile through registers between two
// __syncthreads, with no copy in flight). Each consumer computes
// S = Q K^T on wgmma from shared memory (m64n128k16, both operands K-major,
// 128-byte swizzle as TMA writes it; hopper_common.cuh), rounds P to bf16
// in registers, where the accumulator layout of S is already the
// A-fragment layout of the next product, and accumulates O += P V on wgmma
// with A from registers and V read MN-major (m64n64k16). Tile k's S is
// issued together with tile k-1's P V, so the softmax of tile k runs on
// the CUDA cores while that product is on the tensor cores; P V of tile
// k-1 reads its fragments from registers the softmax of tile k does not
// write. Scores stay raw and one FFMA takes them to the exp2 domain
// (exp(s*scale - m*scale) = 2^(s*c - m*c), c = scale * log2 e), and only
// the tile holding valid_len is masked. The producer gives its registers
// up (setmaxnreg) to the consumers. Q, K and V come through three 3-D
// tensor maps (columns x rows x depth): the packed launches map each
// section as (D columns, S rows, B images) with strides ld and S*ld, the
// section offset in the base address, so rows past S in a tail tile read
// as zeros from this image and never from the next; the [B, H, S, hd]
// launch maps (hd, S, B*H). At 88 and 104 the maps are 4-D, one head a
// map row: (hd, H heads, S, B) with strides hd, ld, S*ld packed, (hd, 1,
// S, B*H) on [B, H, S, hd]. The ragged tail is masked as before: keys >=
// valid_len get -inf, key tiles wholly past valid_len are not loaded, rows
// >= S are never stored. P is rounded to bf16 against the running max
// before P.V and the row sum is taken over the fp32 P, as the TPU kernel
// does.
//
// B4 (flash_attention.py::attention_kernel, _attn_kernel) is the same
// function on separate q, k, v in the [B, H, S, hd] layout: every route
// addresses its operands through (batch, head, row) strides (`Layout`) or
// through tensor maps, so aaclip_attention_bhsd launches the same kernels
// with its own base pointers and the strides of that layout (H*S*hd,
// S*hd, hd). Rows from valid_len up to S are real queries there and are
// computed; only keys are masked. The same kernel and tiles on the same
// values give the same bits in both layouts, and the V-V launch gives the
// bits of the standard launch on [v, v, v].
//
// Training (attention_packed_bwd.cu) needs each row's logsumexp: with a
// non-null `lse` [B, H, S] fp32 every route also writes m + log(l), the
// final running max plus the log of the row sum (both in the scaled-score
// domain). The inference path passes null and stores nothing more.

#include <math.h>

#include <type_traits>

#include "hopper_common.cuh"
#include "launch_count.cuh"
#include "mma_common.cuh"

namespace {

using namespace aaclip;

constexpr int kBlockM = 64;  // query rows per block
constexpr int kBlockN = 64;  // keys per shared-memory tile (bf16)
constexpr int kBlockNF = 32; // keys per shared-memory tile (fp32)

// Element strides of an operand: (image, head, row) -> b*batch + h*head +
// row*row from its base pointer.
struct Layout {
  int64_t batch, head, row;
};

template <int HD>
__global__ void __launch_bounds__(128)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int S, int valid_len, Layout in, Layout ol, float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int SLD = HD + 8;       // padded row: conflict-free fragments
  constexpr int KS = HD / 16;       // k-steps of Q.K^T over the head dim
  constexpr int ND = HD / 8;        // n-tiles of P.V over the head dim
  constexpr int NT = kBlockN / 8;   // n-tiles of Q.K^T over the keys
  constexpr int KK = kBlockN / 16;  // k-steps of P.V over the keys
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockM * SLD];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockN * SLD];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockN * SLD];

  const int q0 = blockIdx.x * kBlockM;
  const int64_t in_off = blockIdx.z * in.batch + blockIdx.y * in.head;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  load_tile<__nv_bfloat16, HD, SLD, kBlockM>(sQ, q + in_off, in.row, q0, S);
  __syncthreads();
  uint32_t qf[KS][4];
  const int r0 = warp * 16 + g;
  load_a_frags<KS, SLD>(qf, sQ, r0, t);

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the sums

  const int n_tiles = (valid_len + kBlockN - 1) / kBlockN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();  // the previous tile is fully consumed
    load_tile<__nv_bfloat16, HD, SLD, kBlockN>(sK, k + in_off, in.row, k0,
                                               S);
    load_tile<__nv_bfloat16, HD, SLD, kBlockN>(sV, v + in_off, in.row, k0,
                                               S);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* kp = sK + (nt * 8 + g) * SLD + ks * 16 + t * 2;
        mma_bf16_16816(s[nt], qf[ks], ld32(kp), ld32(kp + 8));
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + t * 2 + (i & 1);
        const float sv = col < valid_len ? s[nt][i] * scale : -INFINITY;
        s[nt][i] = sv;
        mx[i >> 1] = fmaxf(mx[i >> 1], sv);
      }
    }
    float mref[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mref[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = __expf(m[r] - mref[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }

    uint32_t pf[KK][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = __expf(s[nt][0] - mref[0]);
      const float p1 = __expf(s[nt][1] - mref[0]);
      const float p2 = __expf(s[nt][2] - mref[1]);
      const float p3 = __expf(s[nt][3] - mref[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      // two adjacent score n-tiles form one A fragment of P.V
      pf[nt >> 1][(nt & 1) * 2 + 0] = pack_f32(p0, p1);
      pf[nt >> 1][(nt & 1) * 2 + 1] = pack_f32(p2, p3);
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const __nv_bfloat16* vp = sV + (kk * 16 + t * 2) * SLD + nd * 8 + g;
        const uint32_t b0 = pack_bf16(vp[0], vp[SLD]);
        const uint32_t b1 = pack_bf16(vp[8 * SLD], vp[9 * SLD]);
        mma_bf16_16816(o[nd], pf[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row_a = q0 + r0;
  const int row_b = row_a + 8;
  __nv_bfloat16* ob =
      out + blockIdx.z * ol.batch + blockIdx.y * ol.head + t * 2;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(ob + row_a * ol.row + nd * 8) =
          pack_f32(o[nd][0] / l[0], o[nd][1] / l[0]);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(ob + row_b * ol.row + nd * 8) =
          pack_f32(o[nd][2] / l[1], o[nd][3] / l[1]);
  }
  if (lse != nullptr && t == 0) {
    float* lrow = lse + ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * S;
    if (row_a < S) lrow[row_a] = m[0] + logf(l[0]);
    if (row_b < S) lrow[row_b] = m[1] + logf(l[1]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kBlockM)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, int S, int valid_len, Layout in,
                Layout ol, float scale) {
  static_assert(HD % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float sK[kBlockNF * HD];
  __shared__ __align__(16) float sV[kBlockNF * HD];

  const int row = blockIdx.x * kBlockM + threadIdx.x;
  const int64_t in_off = blockIdx.z * in.batch + blockIdx.y * in.head;

  float qr[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d)
    qr[d] = row < S ? q[in_off + row * in.row + d] : 0.f;
  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < valid_len; k0 += kBlockNF) {
    __syncthreads();
    load_tile<float, HD, HD, kBlockNF>(sK, k + in_off, in.row, k0, S);
    load_tile<float, HD, HD, kBlockNF>(sV, v + in_off, in.row, k0, S);
    __syncthreads();
    float s[kBlockNF];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBlockNF; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc = fmaf(qr[d], sK[j * HD + d], acc);
      s[j] = k0 + j < valid_len ? acc * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float mref = mx == -INFINITY ? 0.f : mx;
    const float alpha = expf(m - mref);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockNF; ++j) {
      const float p = expf(s[j] - mref);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] = fmaf(p, sV[j * HD + d], o[d]);
    }
  }
  if (row < S) {
    float* orow = out + blockIdx.z * ol.batch + blockIdx.y * ol.head +
                  row * ol.row;
#pragma unroll
    for (int d = 0; d < HD; ++d) orow[d] = o[d] / l;
    if (lse != nullptr)
      lse[((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * S + row] =
          m + logf(l);
  }
}


// ------------------------------------- TMA + wgmma: hd 64, 80, 88, 104, 128

constexpr int kWgRows = 64;      // query rows per consumer warpgroup
constexpr int kFwdRows = 2 * kWgRows;  // query rows per block
constexpr int kFwdThreads = 384;  // two consumer warpgroups + the producer

// The head dims of the TMA + wgmma kernels (every route: bf16, 6-pass,
// 3-pass); the retained kernels take head dim 16.
constexpr bool tma_head_dim(int hd) {
  return hd == 64 || hd == 80 || hd == 88 || hd == 104 || hd == 128;
}

// Tensor-map coordinates of head h of image b: h * hcol, the head's
// column in a section-wide map (hd packed, 0 on [B, H, S, hd]) or its
// coordinate in a per-head map (1 packed, 0 on [B, H, S, hd], whose map
// has one head a row); depth b * bz + h * hz ((1, 0) packed, (H, 1) on
// [B, H, S, hd]); the 6-pass route's bf16 plane p lies pz further in
// depth (0 on the bf16 route, which has one plane).
struct MapCoords {
  int hcol, bz, hz, pz;
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T over a head of HD columns into kN key columns (the first
// k-step overwrites S): Q's and K's chunks `q_chunk` and `k_chunk` bytes
// apart.
template <int HD, int kN>
__device__ __forceinline__ void qk_head(float (&s)[kN / 2], uint64_t dq,
                                        int q_chunk, uint64_t dk,
                                        int k_chunk) {
#pragma unroll
  for (int ks = 0; ks < Head<HD>::kKSteps; ++ks)
    wgmma_ss<kN>(s, desc_plus(dq, (ks / 4) * q_chunk + 32 * (ks % 4)),
                 desc_plus(dk, (ks / 4) * k_chunk + 32 * (ks % 4)), ks);
}

// O += P V on one chunk of kN columns (o: its accumulators), kKK k-steps
// of 16 keys.
template <int kN, int kKK>
__device__ __forceinline__ void pv_chunk(float* o,
                                         const uint32_t (&pf)[kKK][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kKK; ++kk)
    wgmma_rs_mn<kN>(o, pf[kk], desc_plus(dv, 16 * kRowBytes * kk));
}

// O += P V over a head of HD columns (V's chunks `v_chunk` bytes apart;
// the last chunk's product on its HD - 64 columns alone below 128).
template <int HD, int kKK>
__device__ __forceinline__ void pv_head(float (&o)[HD / 2],
                                        const uint32_t (&pf)[kKK][4],
                                        uint64_t dv, int v_chunk) {
  pv_chunk<kTileCols, kKK>(o, pf, dv);
  if constexpr (Head<HD>::kChunks == 2)
    pv_chunk<Head<HD>::cols(1), kKK>(o + 32, pf, desc_plus(dv, v_chunk));
}

// O's rows g and g + 8 rescaled by alpha (the accumulator layout of
// hopper_common.cuh: pairs alternate between the two rows).
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int nd = 0; nd < N / 4; ++nd) {
    o[4 * nd + 0] *= alpha[0];
    o[4 * nd + 1] *= alpha[0];
    o[4 * nd + 2] *= alpha[1];
    o[4 * nd + 3] *= alpha[1];
  }
}

// Rows a and a + 8 of kN output columns from column c0 (o: their
// accumulators), divided by the row sums l and stored at `ob` (rows `ld`
// elements apart) as bf16 pairs or fp32 pairs; rows >= S are not stored.
__device__ __forceinline__ void put_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32(x, y);
}

__device__ __forceinline__ void put_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

template <int kN, typename TO>
__device__ __forceinline__ void store_rows(TO* ob, const float* o, int c0,
                                           int row_a, int S, int64_t ld,
                                           const float (&l)[2]) {
#pragma unroll
  for (int nd = 0; nd < kN / 8; ++nd) {
    if (row_a < S)
      put_pair(ob + row_a * ld + c0 + nd * 8, o[4 * nd + 0] / l[0],
               o[4 * nd + 1] / l[0]);
    if (row_a + 8 < S)
      put_pair(ob + (row_a + 8) * ld + c0 + nd * 8, o[4 * nd + 2] / l[1],
               o[4 * nd + 3] / l[1]);
  }
}

// O of a head of HD columns: store_rows on each chunk.
template <int HD, typename TO>
__device__ __forceinline__ void store_head(TO* ob, const float (&o)[HD / 2],
                                           int row_a, int S, int64_t ld,
                                           const float (&l)[2]) {
  store_rows<kTileCols>(ob, o, 0, row_a, S, ld, l);
  if constexpr (Head<HD>::kChunks == 2)
    store_rows<Head<HD>::cols(1)>(ob, o + 32, kTileCols, row_a, S, ld, l);
}

// One tile of the online softmax for rows g and g + 8 of a warp on kKeys
// keys: raw scores s (keys at or past valid_len read as -inf when kMask)
// update the running raw max m and the row sums l (scaled by alpha, which
// the caller applies to O), and become bf16(P) as the A fragments pf of
// P V. P is rounded against the running max, the sum taken over the fp32
// P. The scores are only read: writing a wgmma's accumulator registers
// while products are in flight makes the compiler serialize them.
template <bool kMask, int kKeys>
__device__ __forceinline__ void softmax_tile(const float (&s)[kKeys / 2],
                                             float (&m)[2], float (&l)[2],
                                             uint32_t (&pf)[kKeys / 16][4],
                                             float (&alpha)[2], int k0,
                                             int valid_len, float c, int t) {
  auto score = [&](int j, int i) {
    return kMask && k0 + j * 8 + t * 2 + (i & 1) >= valid_len
               ? -INFINITY
               : s[4 * j + i];
  };
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], score(j, i));
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mc[r] = (mx[r] == -INFINITY ? 0.f : mx[r]) * c;
    alpha[r] = ex2(fmaf(m[r], c, -mc[r]));
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    const float p0 = ex2(fmaf(score(j, 0), c, -mc[0]));
    const float p1 = ex2(fmaf(score(j, 1), c, -mc[0]));
    const float p2 = ex2(fmaf(score(j, 2), c, -mc[1]));
    const float p3 = ex2(fmaf(score(j, 3), c, -mc[1]));
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    // two adjacent 8-key column groups form one 16-key k-step
    pf[j >> 1][(j & 1) * 2 + 0] = pack_f32(p0, p1);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_f32(p2, p3);
  }
}

// The bf16 kernel's tile plan at head dim HD: Q's 128 rows as its chunks,
// a ring of kStages K/V tile pairs of kKeys keys (every chunk of each).
// Head dim 64: 128 keys, 3 stages (S is 64 registers a thread, P's two
// fragment sets 32 each, O 32: ptxas's 168 with no spill). 80 to 128:
// O grows to 40-64 registers, so the keys drop to 64 per tile (S 32,
// P 16 + 16) and the ring to 5 stages of two chunks (Q 32 KB + 5 x 32 KB).
template <int HD>
struct FwdTiles {
  static constexpr int kKeys = HD == 64 ? 128 : 64;  // keys per TMA tile
  static constexpr int kStages = HD == 64 ? 3 : 5;   // K/V pairs in flight
  static constexpr int kQChunk = kFwdRows * kRowBytes;  // 16 KB
  static constexpr int kTile = kKeys * kRowBytes;  // a chunk of K or of V
  static constexpr int kStageBytes = 2 * Head<HD>::kChunks * kTile;
  static constexpr int kSmem = kSwizzleAtom +  // slack to align the tiles
                               Head<HD>::kChunks * kQChunk +
                               kStages * kStageBytes + 8 * (1 + 2 * kStages);
};

template <int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
               int S, int valid_len, MapCoords mc, Layout ol, float scale) {
  using H = Head<HD>;
  using T = FwdTiles<HD>;
  constexpr int kKeys = T::kKeys, kC = H::kChunks;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_atom(smem_raw);
  uint8_t* sQ = smem;  // [chunk][128 rows][64], rows 64w.. for warpgroup w
  uint8_t* sK = sQ + kC * T::kQChunk;  // [stage][chunk][keys][64]
  uint8_t* sV = sK + T::kStages * kC * T::kTile;  // [stage][chunk][keys][64]
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sV + T::kStages * kC * T::kTile);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + T::kStages;

  const int q0 = blockIdx.x * kFwdRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = h * mc.hcol, depth = b * mc.bz + h * mc.hz;
  const int n_tiles = (valid_len + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
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
      mbar_arrive_expect_tx(q_full, kC * T::kQChunk);
      for (int c = 0; c < kC; ++c)
        for (int r = 0; r < kFwdRows; r += kKeys)
          tma_chunk<HD>(sQ + c * T::kQChunk + r * kRowBytes, &tq, q_full,
                        col, c, q0 + r, depth);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % T::kStages;
        if (kt >= T::kStages)
          mbar_wait(&empty[st], (kt / T::kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[st], T::kStageBytes);
        for (int c = 0; c < kC; ++c) {
          tma_chunk<HD>(sK + (st * kC + c) * T::kTile, &tk, &full[st], col,
                        c, kt * kKeys, depth);
          tma_chunk<HD>(sV + (st * kC + c) * T::kTile, &tv, &full[st], col,
                        c, kt * kKeys, depth);
        }
      }
    }
  } else {  // consumers: 64 query rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    const int g = (threadIdx.x & 31) >> 2;
    const int t = threadIdx.x & 3;
    const uint64_t dq = sw128_desc(sQ + wg * kWgRows * kRowBytes);

    // scores are kept raw (unscaled); c takes them to the exp2 domain, so
    // each probability is one FFMA and one ex2: exp(s*scale - m*scale)
    const float c = scale * kLog2e;
    float o[H::kRegs];
#pragma unroll
    for (int i = 0; i < H::kRegs; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running raw max of rows g, g+8
    float l[2] = {0.f, 0.f};              // this thread's share of the sums
    float s[kKeys / 2];              // S = Q K^T: [64 rows x kKeys keys]
    uint32_t pf[kKeys / 16][4];      // bf16(P) of the previous tile
    uint32_t pn[kKeys / 16][4];      // bf16(P) of the current tile
    float alpha[2];
    const int n_full = valid_len / kKeys;  // tiles with no masked key
    mbar_wait(q_full, 0);

    // Tile kt's S = Q K^T is issued together with the previous tile's
    // O += P V; the softmax of tile kt runs on the CUDA cores while that
    // P V product is still on the tensor cores.
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % T::kStages;
      const int prev = (kt + T::kStages - 1) % T::kStages;
      mbar_wait(&full[st], (kt / T::kStages) & 1);
      const uint64_t dk = sw128_desc(sK + st * kC * T::kTile);
      wgmma_fence();
      qk_head<HD, kKeys>(s, dq, T::kQChunk, dk, T::kTile);
      wgmma_commit();
      if (kt > 0) {
        pv_head<HD, kKeys / 16>(o, pf,
                                sw128_desc(sV + prev * kC * T::kTile),
                                T::kTile);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_operand(s);
      if (kt < n_full)
        softmax_tile<false, kKeys>(s, m, l, pn, alpha, 0, valid_len, c, t);
      else
        softmax_tile<true, kKeys>(s, m, l, pn, alpha, kt * kKeys,
                                  valid_len, c, t);
      wgmma_wait<0>();
      fence_operand(o);
      fence_frags(pf);  // the P V product read pf until here
      if (kt > 0) mbar_arrive(&empty[prev]);
      rescale(o, alpha);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) pf[kk][r] = pn[kk][r];
    }
    {  // the last tile's P V
      const int st = (n_tiles - 1) % T::kStages;
      wgmma_fence();
      pv_head<HD, kKeys / 16>(o, pf, sw128_desc(sV + st * kC * T::kTile),
                              T::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(o);
      fence_frags(pf);
      mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row_a = q0 + wg * kWgRows + warp * 16 + g;
    const int row_b = row_a + 8;
    store_head<HD>(out + b * ol.batch + h * ol.head + t * 2, o, row_a, S,
                   ol.row, l);
    if (lse != nullptr && t == 0) {
      float* lrow = lse + ((int64_t)b * gridDim.y + h) * S;
      if (row_a < S) lrow[row_a] = m[0] * scale + logf(l[0]);
      if (row_b < S) lrow[row_b] = m[1] * scale + logf(l[1]);
    }
  }
}

// A bf16 operand of the TMA + wgmma kernels: its base, the head dim, the
// heads a row holds, the rows per depth step, the depth, and the head, row
// and depth strides in elements (make_head_map).
struct MapOperand {
  const void* base;
  int64_t hd, heads, rows, depth, head, row, step;
};

// fn(std::integral_constant<int, hd>) for a TMA head dim hd;
// cudaErrorInvalidValue for another.
template <typename F>
int by_head_dim(int hd, F&& fn) {
  switch (hd) {
    case 64: return fn(std::integral_constant<int, 64>{});
    case 80: return fn(std::integral_constant<int, 80>{});
    case 88: return fn(std::integral_constant<int, 88>{});
    case 104: return fn(std::integral_constant<int, 104>{});
    case 128: return fn(std::integral_constant<int, 128>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor maps of q, k and v at head dim HD: per-head maps in boxes of
// kTileCols x 1 x box_rows x 1 (Head<HD>::kHeadMap), else section-wide
// ones (all `heads` heads of a row) in boxes of kTileCols x box_rows x 1.
template <int HD>
int make_maps(CUtensorMap (&maps)[3], const MapOperand (&qkv)[3],
              uint32_t box_rows) {
  for (int i = 0; i < 3; ++i) {
    const MapOperand& a = qkv[i];
    const cudaError_t err =
        Head<HD>::kHeadMap
            ? make_head_map(&maps[i], a.base, a.hd, a.heads, a.rows,
                            a.depth, a.head * 2, a.row * 2, a.step * 2,
                            box_rows)
            : make_tile_map(&maps[i], a.base, a.heads * a.hd, a.rows,
                            a.depth, a.row * 2, a.step * 2, box_rows);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int HD>
int launch_wgmma(const MapOperand (&qkv)[3], MapCoords mc, int batch,
                 int seq, int valid_len, int heads, void* out, float* lse,
                 Layout ol, float scale, cudaStream_t st) {
  using T = FwdTiles<HD>;
  CUtensorMap maps[3];
  if (const int err = make_maps<HD>(maps, qkv, T::kKeys)) return err;
  const cudaError_t err = smem_attribute_once(
      reinterpret_cast<const void*>(attn_fwd_wgmma<HD>), T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + kFwdRows - 1) / kFwdRows, heads, batch);
  attn_fwd_wgmma<HD><<<grid, kFwdThreads, T::kSmem, st>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), lse, seq,
      valid_len, mc, ol, scale);
  note_launch();
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ fp32: 6-pass, 3-pass

// The tile plan of the plane kernels over kP bf16 planes at head dim HD:
// keys per TMA tile (the box's rows, which Q's 128 rows are loaded in
// too), K/V tile pairs in flight, one chunk of one plane of a K or V
// tile, one plane of Q, one stage's K and V planes, the dynamic shared
// memory. Head dim 64: 64 keys, 3 stages of three planes and 4 of two.
// 80 to 128 hold two chunks a plane, so Q alone takes kP x 32 KB (96 KB
// on the 6-pass route) and a 64-key stage 2 x kP x 16 KB: the keys drop
// to 32 a tile, 2 stages of three planes (96 + 2 x 48 KB) and 4 of two
// (64 + 4 x 32 KB). 32 keys also keep the registers in ptxas's 168: O
// (40 or 64), one chunk's P V accumulator (32), S (16), P's planes (8 a
// plane).
template <int kP, int HD>
struct PlaneTiles {
  static constexpr int kKeys = HD == 64 ? kWgRows : 32;
  static constexpr int kStages =
      HD == 64 ? (kP == kPlanes ? 3 : 4) : (kP == kPlanes ? 2 : 4);
  static constexpr int kBox = kKeys * kRowBytes;
  static constexpr int kQChunk = kFwdRows * kRowBytes;  // 16 KB
  static constexpr int kQPlane = Head<HD>::kChunks * kQChunk;
  static constexpr int kKVPlane = Head<HD>::kChunks * kBox;
  static constexpr int kStageBytes = 2 * kP * kKVPlane;
  static constexpr int kSmem = kSwizzleAtom + kP * kQPlane +
                               kStages * kStageBytes + 8 * (1 + 2 * kStages);
};

// The split kernels, the fp32 routes' operand staging: fp32 x[n] becomes
// its kP bf16 planes at planes, planes + stride (and planes + 2 * stride):
// split3's hi, mid, lo for the 6-pass route (split3_kernel), split_pack's
// hi, lo for the 3-pass route (split2_kernel; its lo is split3's mid bit
// for bit, and models/layers.py::_split_bf16's lo), four values per thread
// and step (x 16-byte aligned, stride a multiple of 4), the n % 4 tail one
// by one. What bounds them: bytes, 4 read and 2 * kP written per value
// (the step's qkv [8, 1370, 3072]: 0.10 ms for split3, 0.080 ms for
// split2 at 3.35 TB/s).
template <int kP>
__device__ __forceinline__ void split_planes(const float* __restrict__ x,
                                             __nv_bfloat16* __restrict__ planes,
                                             int64_t n, int64_t stride) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < n / 4; i += step) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    uint2 w[kP];
    if constexpr (kP == kPlanes) {
      split3_pack(v.x, v.y, w[0].x, w[1].x, w[2].x);
      split3_pack(v.z, v.w, w[0].y, w[1].y, w[2].y);
    } else {
      split_pack(v.x, v.y, w[0].x, w[1].x);
      split_pack(v.z, v.w, w[0].y, w[1].y);
    }
#pragma unroll
    for (int p = 0; p < kP; ++p)
      reinterpret_cast<uint2*>(planes + p * stride)[i] = w[p];
  }
  for (int64_t i = n / 4 * 4 + first; i < n; i += step) {
    __nv_bfloat16 hi, mid, lo;
    split3(x[i], hi, mid, lo);
    planes[i] = hi;
    planes[stride + i] = mid;
    if constexpr (kP == kPlanes) planes[2 * stride + i] = lo;
  }
}

__global__ void __launch_bounds__(256)
split3_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ planes,
              int64_t n, int64_t stride) {
  split_planes<3>(x, planes, n, stride);
}

__global__ void __launch_bounds__(256)
split2_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ planes,
              int64_t n, int64_t stride) {
  split_planes<2>(x, planes, n, stride);
}

// One tile of the plane kernels' online softmax for rows g and g + 8 of a
// warp, on kKeys keys: the raw scores s (keys at or past valid_len read as
// -inf when kMask) scaled as the FMA and mma.sync 3-pass kernels and the
// TPU kernel scale them (one rounded product), the running max m and the
// row sums l in that domain (alpha, which the caller applies to O,
// rescales l here), and P = expf(score - max) with the precise expf, kept
// in fp32 and split into the A fragments of its kP planes (pf[plane]
// [k-step]) for O += P V. (The bf16 route's exp2 of one FFMA is faster and
// rounds otherwise; at fp32 the routes follow the reference's arithmetic.)
template <bool kMask, int kP, int kKeys>
__device__ __forceinline__ void softmax_tile_planes(
    const float (&s)[kKeys / 2], float (&m)[2], float (&l)[2],
    uint32_t (&pf)[kP][kKeys / 16][4], float (&alpha)[2], int k0,
    int valid_len, float scale, int t) {
  auto score = [&](int j, int i) {
    return kMask && k0 + j * 8 + t * 2 + (i & 1) >= valid_len
               ? -INFINITY
               : __fmul_rn(s[4 * j + i], scale);
  };
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], score(j, i));
  float mref[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mref[r] = mx[r] == -INFINITY ? 0.f : mx[r];
    alpha[r] = expf(m[r] - mref[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    const int k = j >> 1, r = (j & 1) * 2;
    const float p0 = expf(score(j, 0) - mref[0]);
    const float p1 = expf(score(j, 1) - mref[0]);
    const float p2 = expf(score(j, 2) - mref[1]);
    const float p3 = expf(score(j, 3) - mref[1]);
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    split_frag<kP>(pf, k, r, p0, p1);
    split_frag<kP>(pf, k, r + 1, p2, p3);
  }
}

// O = O * alpha + the tile's P V, on kN columns.
template <int kN, int M>
__device__ __forceinline__ void fold(float* o, const float (&ot)[M],
                                     const float (&alpha)[2]) {
#pragma unroll
  for (int nd = 0; nd < kN / 8; ++nd) {
    o[4 * nd + 0] = fmaf(o[4 * nd + 0], alpha[0], ot[4 * nd + 0]);
    o[4 * nd + 1] = fmaf(o[4 * nd + 1], alpha[0], ot[4 * nd + 1]);
    o[4 * nd + 2] = fmaf(o[4 * nd + 2], alpha[1], ot[4 * nd + 2]);
    o[4 * nd + 3] = fmaf(o[4 * nd + 3], alpha[1], ot[4 * nd + 3]);
  }
}

// The plane kernels' product of a tile's P with the last chunk of V (kN1
// columns, planes `b_plane` bytes apart) into `acc`, added into O's last
// chunk (o + 32); then the stage's slot is released.
template <int kP, int kN1, int M, int KK>
__device__ __forceinline__ void tail_chunk(float* o, float (&acc)[M],
                                           uint32_t (&pf)[kP][KK][4],
                                           uint64_t dv, int b_plane,
                                           const float (&alpha)[2],
                                           uint64_t* empty) {
  wgmma_fence();
  mma_planes_rs<kP, kN1>(acc, pf, dv, b_plane);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(acc);
  fence_planes<kP>(pf);
  mbar_arrive(empty);
  fold<kN1>(o + 32, acc, alpha);
}

// The plane kernels: fp32 on the bf16 planes a split kernel wrote,
// attn_fwd_6pass (kP 3, precision "highest" or None) and
// attn_fwd_3pass_wgmma (kP 2, precision "high": _kdot's hi.hi + hi.lo +
// lo.hi); the tensor maps span every plane in depth (plane p of head h,
// image b at depth b * bz + h * hz + p * pz). The layout of attn_fwd_wgmma
// (a producer warpgroup, two consumers of 64 query rows, 128-byte-swizzled
// TMA tiles in a ring, a head as its 64-column chunks) with kP planes of
// every tile and the tile plan of PlaneTiles. S = Q K^T is mma_planes_ss
// (one chain per pass, smallest first); P stays fp32 and is split in
// registers into the A fragments of its planes for O += P V
// (mma_planes_rs, the V planes read MN-major), a chunk at a time. Each
// chunk's P V goes into its own accumulator, which is added to the fp32
// running O in registers (O = O * alpha + tile): the tensor cores' chains
// stay short, and the sum over tiles is rounded as fp32 adds round. At head dim 64, keys stay in tiles
// of 64 with two planes too: a 128-key tile holds 64 scores and 64
// fragment registers of P at once, which with O and its per-tile
// accumulator leaves nothing of ptxas's 168-register plan (the 384-thread
// consumers are planned as if setmaxnreg gave nothing). Each consumer
// waits for its own products (the other consumer's run meanwhile): issuing
// tile kt + 1's S before tile kt's softmax, into a second score set, made
// ptxas inject a wait (C7517) in the 6-pass kernel and gained no time that
// two runs could tell apart. One row sum over the fp32 P, one division at
// the end, and m + log(l) into `lse` when it is non-null.
template <int kP, int HD>
__device__ __forceinline__ void fwd_planes(const CUtensorMap& tq,
                                           const CUtensorMap& tk,
                                           const CUtensorMap& tv,
                                           float* __restrict__ out,
                                           float* __restrict__ lse, int S,
                                           int valid_len, MapCoords mc,
                                           Layout ol, float scale) {
  using H = Head<HD>;
  using T = PlaneTiles<kP, HD>;
  constexpr int kKeys = T::kKeys, kC = H::kChunks, kKK = kKeys / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_atom(smem_raw);  // [plane][chunk][128 rows][64]
  uint8_t* sKV = sQ + kP * T::kQPlane;
  // stage st: K plane p, chunk c at sKV + st * T::kStageBytes + p *
  // T::kKVPlane + c * T::kBox, the V planes kP * T::kKVPlane further
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sKV + T::kStages * T::kStageBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + T::kStages;

  const int q0 = blockIdx.x * kFwdRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = h * mc.hcol, depth = b * mc.bz + h * mc.hz;
  const int n_tiles = (valid_len + kKeys - 1) / kKeys;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
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
      mbar_arrive_expect_tx(q_full, kP * T::kQPlane);
      for (int p = 0; p < kP; ++p)
        for (int c = 0; c < kC; ++c)
          for (int r = 0; r < kFwdRows; r += kKeys)
            tma_chunk<HD>(sQ + p * T::kQPlane + c * T::kQChunk +
                              r * kRowBytes,
                          &tq, q_full, col, c, q0 + r, depth + p * mc.pz);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % T::kStages;
        if (kt >= T::kStages)
          mbar_wait(&empty[st], (kt / T::kStages - 1) & 1);
        uint8_t* dst = sKV + st * T::kStageBytes;
        mbar_arrive_expect_tx(&full[st], T::kStageBytes);
        for (int p = 0; p < kP; ++p)
          for (int c = 0; c < kC; ++c) {
            tma_chunk<HD>(dst + p * T::kKVPlane + c * T::kBox, &tk,
                          &full[st], col, c, kt * kKeys, depth + p * mc.pz);
            tma_chunk<HD>(dst + (kP + p) * T::kKVPlane + c * T::kBox, &tv,
                          &full[st], col, c, kt * kKeys, depth + p * mc.pz);
          }
      }
    }
  } else {  // consumers: 64 query rows each
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x % 128) / 32;
    const int g = (threadIdx.x & 31) >> 2;
    const int t = threadIdx.x & 3;
    const uint64_t dq = sw128_desc(sQ + wg * kWgRows * kRowBytes);
    float o[H::kRegs], ot[32];  // running O; a chunk's P V of the tile
#pragma unroll
    for (int i = 0; i < H::kRegs; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
    float l[2] = {0.f, 0.f};              // this thread's share of the sums
    uint32_t pf[kP][kKK][4];              // P's planes as A fragments
    const int n_full = valid_len / kKeys;  // tiles with no masked key
    mbar_wait(q_full, 0);

    float s[kKeys / 2];
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int st = kt % T::kStages;
      uint8_t* stage = sKV + st * T::kStageBytes;
      mbar_wait(&full[st], (kt / T::kStages) & 1);
      wgmma_fence();
      mma_planes_ss<kP, H::kKSteps, kKeys>(s, dq, T::kQPlane,
                                           sw128_desc(stage), T::kKVPlane,
                                           T::kQChunk, T::kBox);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(s);
      float alpha[2];
      if (kt < n_full)
        softmax_tile_planes<false, kP, kKeys>(s, m, l, pf, alpha, 0,
                                              valid_len, scale, t);
      else
        softmax_tile_planes<true, kP, kKeys>(s, m, l, pf, alpha,
                                             kt * kKeys, valid_len, scale,
                                             t);
      const uint64_t dv = sw128_desc(stage + kP * T::kKVPlane);
      wgmma_fence();
      mma_planes_rs<kP>(ot, pf, dv, T::kKVPlane);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(ot);
      if constexpr (kC == 1) {
        fence_planes<kP>(pf);
        mbar_arrive(&empty[st]);
      }
      fold<kTileCols>(o, ot, alpha);
      if constexpr (kC == 2) {  // the second chunk
        constexpr int kN1 = H::cols(1);
        // at 88 and 104 into an accumulator of its own: into ot, the
        // 6-pass kernel at 104 ran 1.30x and the 3-pass one at 88 1.26x
        // slower (a first build of them had ptxas serialize the 6-pass
        // kernels' wgmma, C7511)
        if constexpr (H::kHeadMap) {
          float ot1[kN1 / 2];
          tail_chunk<kP, kN1>(o, ot1, pf, desc_plus(dv, T::kBox),
                              T::kKVPlane, alpha, &empty[st]);
        } else {  // into the same ot
          tail_chunk<kP, kN1>(o, ot, pf, desc_plus(dv, T::kBox),
                              T::kKVPlane, alpha, &empty[st]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row_a = q0 + wg * kWgRows + warp * 16 + g;
    const int row_b = row_a + 8;
    store_head<HD>(out + b * ol.batch + h * ol.head + t * 2, o, row_a, S,
                   ol.row, l);
    if (lse != nullptr && t == 0) {
      float* lrow = lse + ((int64_t)b * gridDim.y + h) * S;
      if (row_a < S) lrow[row_a] = m[0] + logf(l[0]);
      if (row_b < S) lrow[row_b] = m[1] + logf(l[1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
attn_fwd_6pass(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               float* __restrict__ out, float* __restrict__ lse, int S,
               int valid_len, MapCoords mc, Layout ol, float scale) {
  fwd_planes<3, HD>(tq, tk, tv, out, lse, S, valid_len, mc, ol, scale);
}

template <int HD>
__global__ void __launch_bounds__(kFwdThreads, 1)
attn_fwd_3pass_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     float* __restrict__ out, float* __restrict__ lse, int S,
                     int valid_len, MapCoords mc, Layout ol, float scale) {
  fwd_planes<2, HD>(tq, tk, tv, out, lse, S, valid_len, mc, ol, scale);
}

// A plane kernel on three operands of kP bf16 planes each
// (MapOperand.depth counts every plane, mc.pz the depth of one).
template <int kP, int HD>
int launch_planes(const MapOperand (&qkv)[3], MapCoords mc, int batch,
                  int seq, int valid_len, int heads, float* out, float* lse,
                  Layout ol, float scale, cudaStream_t st) {
  using T = PlaneTiles<kP, HD>;
  CUtensorMap maps[3];
  if (const int err = make_maps<HD>(maps, qkv, T::kKeys)) return err;
  constexpr int smem = T::kSmem;
  const dim3 grid((seq + kFwdRows - 1) / kFwdRows, heads, batch);
  if constexpr (kP == kPlanes) {
    const cudaError_t err = smem_attribute_once(
        reinterpret_cast<const void*>(attn_fwd_6pass<HD>), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_fwd_6pass<HD><<<grid, kFwdThreads, smem, st>>>(
        maps[0], maps[1], maps[2], out, lse, seq, valid_len, mc, ol, scale);
    note_launch();
  } else {
    const cudaError_t err = smem_attribute_once(
        reinterpret_cast<const void*>(attn_fwd_3pass_wgmma<HD>), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_fwd_3pass_wgmma<HD><<<grid, kFwdThreads, smem, st>>>(
        maps[0], maps[1], maps[2], out, lse, seq, valid_len, mc, ol, scale);
    note_launch();
  }
  return static_cast<int>(cudaGetLastError());
}

// The packed launch of a plane kernel: `planes` holds the kP bf16 planes
// of the fp32 qkv [batch, seq, ld], one after the other (plane stride
// batch * seq * ld).
template <int kP>
int launch_planes_packed(const void* planes, float* out, float* lse,
                         int head_dim, int batch, int seq, int valid_len,
                         int heads, long long ld, int q_off, int k_off,
                         int v_off, long long out_ld, float scale,
                         void* stream) {
  const char* base = static_cast<const char*>(planes);
  const int64_t depth = (int64_t)kP * batch;
  const int64_t step = (int64_t)seq * ld;
  const MapOperand ops[3] = {{base + 2 * (int64_t)q_off, head_dim, heads,
                              seq, depth, head_dim, ld, step},
                             {base + 2 * (int64_t)k_off, head_dim, heads,
                              seq, depth, head_dim, ld, step},
                             {base + 2 * (int64_t)v_off, head_dim, heads,
                              seq, depth, head_dim, ld, step}};
  const Layout ol{(int64_t)seq * out_ld, head_dim, out_ld};
  return by_head_dim(head_dim, [&](auto hd) {
    constexpr int HD = decltype(hd)::value;
    return launch_planes<kP, HD>(
        ops, MapCoords{head_col<HD>(), 1, 0, batch}, batch, seq, valid_len,
        heads, out, lse, ol, scale, static_cast<cudaStream_t>(stream));
  });
}

// The [batch, heads, seq, head_dim] launch: q, k and v each the kP bf16
// planes of an fp32 operand (plane stride batch * heads * seq * head_dim).
template <int kP>
int launch_planes_bhsd(const void* q, const void* k, const void* v,
                       float* out, int head_dim, int batch, int seq,
                       int valid_len, int heads, float scale, void* stream) {
  const int64_t hs = (int64_t)seq * head_dim;
  const int64_t depth = (int64_t)kP * batch * heads;
  const MapOperand ops[3] = {
      {q, head_dim, 1, seq, depth, head_dim, head_dim, hs},
      {k, head_dim, 1, seq, depth, head_dim, head_dim, hs},
      {v, head_dim, 1, seq, depth, head_dim, head_dim, hs}};
  const Layout l{heads * hs, hs, head_dim};
  return by_head_dim(head_dim, [&](auto hd) {
    return launch_planes<kP, decltype(hd)::value>(
        ops, MapCoords{0, heads, 1, batch * heads}, batch, seq, valid_len,
        heads, out, nullptr, l, scale, static_cast<cudaStream_t>(stream));
  });
}

// A split kernel's launch; cudaErrorInvalidValue for an alignment it
// cannot take.
template <int kP>
int launch_split(const float* x, void* planes, long long n, long long stride,
                 void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(planes) % 16 || stride % 4 || stride < n ||
      n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (n / 4 + 255) / 256;
  const dim3 grid(static_cast<unsigned>(want < 1      ? 1
                                        : want > 4096 ? 4096
                                                      : want));
  auto* dst = static_cast<__nv_bfloat16*>(planes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kP == kPlanes) {
    split3_kernel<<<grid, 256, 0, st>>>(x, dst, n, stride);
    note_launch();
  } else {
    split2_kernel<<<grid, 256, 0, st>>>(x, dst, n, stride);
    note_launch();
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ the retained routes

// bf16 and fp32 at head dim 16; cudaErrorInvalidValue for a pair with no
// kernel.
int launch_retained(bool bf16, int head_dim, int batch, int seq,
                    int valid_len, int heads, const void* q, const void* k,
                    const void* v, void* out, float* lse, Layout in,
                    Layout ol, float scale, cudaStream_t st) {
  const dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  using T = __nv_bfloat16;
  if (bf16 && head_dim == 16) {
    attn_bf16_kernel<16><<<grid, 128, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse, seq, valid_len,
        in, ol, scale);
    note_launch();
  } else if (!bf16 && head_dim == 16) {
    attn_f32_kernel<16><<<grid, kBlockM, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, seq,
        valid_len, in, ol, scale);
    note_launch();
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ fp32, 3-pass ("high")

// attn_fwd_3pass: the forward under the JAX package's precision "high"
// (_kdot's F32_AS_3BF16 branch) on fp32 inputs at head dim 16 (tiny-test;
// head dim 64 runs attn_fwd_3pass_wgmma above). Blocks of 64 query rows
// (4 warps of 16) walk key tiles of 64 as attn_bf16_kernel does, but each
// fp32 tile is split into its bf16 hi and lo halves as it is staged into
// shared memory (load_split_tile), and every product is three mma.sync
// bf16 products into one fp32 accumulator: S = Q K^T as Qhi.Khi + Qhi.Klo
// + Qlo.Khi, then O += P V the same way from P's halves, where P =
// exp(s - m) is kept in fp32 (split, never rounded) with precise expf, the
// row sum taken over the fp32 P, and one division at the end; the
// logsumexp is m + log(l) as in the other routes.
template <int HD>
__global__ void __launch_bounds__(128)
attn_fwd_3pass(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, int S, int valid_len, Layout in,
               Layout ol, float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert(kBlockM == kBlockN, "Q and K/V tiles share one size");
  constexpr int SLD = HD + 8;       // padded row: conflict-free fragments
  constexpr int KS = HD / 16;       // k-steps of Q.K^T over the head dim
  constexpr int ND = HD / 8;        // n-tiles of P.V over the head dim
  constexpr int NT = kBlockN / 8;   // n-tiles of Q.K^T over the keys
  constexpr int KK = kBlockN / 16;  // k-steps of P.V over the keys
  constexpr int kTileElems = kBlockN * SLD;
  extern __shared__ __align__(16) uint8_t smem3_raw[];
  __nv_bfloat16* sQh = reinterpret_cast<__nv_bfloat16*>(smem3_raw);
  __nv_bfloat16* sQl = sQh + kTileElems;
  __nv_bfloat16* sKh = sQl + kTileElems;
  __nv_bfloat16* sKl = sKh + kTileElems;
  __nv_bfloat16* sVh = sKl + kTileElems;
  __nv_bfloat16* sVl = sVh + kTileElems;

  const int q0 = blockIdx.x * kBlockM;
  const int64_t in_off = blockIdx.z * in.batch + blockIdx.y * in.head;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;

  load_split_tile<HD, SLD, kBlockM>(sQh, sQl, q + in_off, in.row, q0, S);
  __syncthreads();
  uint32_t qh[KS][4], ql[KS][4];
  const int r0 = warp * 16 + g;
  load_a_frags<KS, SLD>(qh, sQh, r0, t);
  load_a_frags<KS, SLD>(ql, sQl, r0, t);

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};              // this thread's share of the sums

  const int n_tiles = (valid_len + kBlockN - 1) / kBlockN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBlockN;
    __syncthreads();  // the previous tile is fully consumed
    load_split_tile<HD, SLD, kBlockN>(sKh, sKl, k + in_off, in.row, k0, S);
    load_split_tile<HD, SLD, kBlockN>(sVh, sVl, v + in_off, in.row, k0, S);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma3_bt<SLD>(s[nt], qh[ks], ql[ks], sKh, sKl, nt, ks, g, t);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + nt * 8 + t * 2 + (i & 1);
        const float sv = col < valid_len ? s[nt][i] * scale : -INFINITY;
        s[nt][i] = sv;
        mx[i >> 1] = fmaxf(mx[i >> 1], sv);
      }
    }
    float mref[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mref[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = expf(m[r] - mref[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = expf(s[nt][i] - mref[i >> 1]);  // P, fp32
        l[i >> 1] += s[nt][i];
      }
    }
    uint32_t ph[KK][4], pl[KK][4];
    split_a_frags<NT>(ph, pl, s);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        mma3_b<SLD>(o[nd], ph[kk], pl[kk], sVh, sVl, kk, nd, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row_a = q0 + r0;
  const int row_b = row_a + 8;
  float* ob = out + blockIdx.z * ol.batch + blockIdx.y * ol.head + t * 2;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    if (row_a < S)
      *reinterpret_cast<float2*>(ob + row_a * ol.row + nd * 8) =
          make_float2(o[nd][0] / l[0], o[nd][1] / l[0]);
    if (row_b < S)
      *reinterpret_cast<float2*>(ob + row_b * ol.row + nd * 8) =
          make_float2(o[nd][2] / l[1], o[nd][3] / l[1]);
  }
  if (lse != nullptr && t == 0) {
    float* lrow = lse + ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * S;
    if (row_a < S) lrow[row_a] = m[0] + logf(l[0]);
    if (row_b < S) lrow[row_b] = m[1] + logf(l[1]);
  }
}

// attn_fwd_3pass at head dim 16; cudaErrorInvalidValue for another.
int launch_3pass(int head_dim, int batch, int seq, int valid_len, int heads,
                 const float* q, const float* k, const float* v, float* out,
                 float* lse, Layout in, Layout ol, float scale,
                 cudaStream_t st) {
  if (head_dim != 16) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = 6 * kBlockN * (16 + 8) * 2;  // Q, K, V hi and lo
  const dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  attn_fwd_3pass<16><<<grid, 128, smem, st>>>(q, k, v, out, lse, seq,
                                              valid_len, in, ol, scale);
  note_launch();
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: [batch, seq, ld] elements, out: [batch, seq, out_ld]; the q/k/v
// sections of head h start at column {q,k,v}_off + h * head_dim. lse:
// [batch, heads, seq] fp32, or null to skip it. bf16 at a TMA head dim
// (tma_head_dim: 64, 80, 88, 104, 128) takes attn_fwd_wgmma, whose tensor
// maps need qkv, each section's start, head_dim * 2 and ld * 2 bytes to be
// multiples of kTmaAlign; fp32 there has its own entries
// (aaclip_attention_packed_6pass and _3pass_wgmma). Returns the CUDA error
// of the launch (0 on success); cudaErrorInvalidValue for a pair with no
// kernel here or an operand TMA cannot take.
extern "C" int aaclip_attention_packed(const void* qkv, void* out,
                                       float* lse, int bf16,
                                       int head_dim, int batch, int seq,
                                       int valid_len, int heads,
                                       long long ld, int q_off, int k_off,
                                       int v_off, long long out_ld,
                                       float scale, void* stream) {
  const size_t esize = bf16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  const Layout ol{(int64_t)seq * out_ld, head_dim, out_ld};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && tma_head_dim(head_dim)) {
    const int64_t step = (int64_t)seq * ld;
    const MapOperand ops[3] = {
        {base + q_off * esize, head_dim, heads, seq, batch, head_dim, ld,
         step},
        {base + k_off * esize, head_dim, heads, seq, batch, head_dim, ld,
         step},
        {base + v_off * esize, head_dim, heads, seq, batch, head_dim, ld,
         step}};
    return by_head_dim(head_dim, [&](auto hd) {
      constexpr int HD = decltype(hd)::value;
      return launch_wgmma<HD>(ops, MapCoords{head_col<HD>(), 1, 0, 0}, batch,
                              seq, valid_len, heads, out, lse, ol, scale,
                              st);
    });
  }
  const Layout in{(int64_t)seq * ld, head_dim, ld};
  return launch_retained(bf16 != 0, head_dim, batch, seq, valid_len, heads,
                         base + q_off * esize, base + k_off * esize,
                         base + v_off * esize, out, lse, in, ol, scale, st);
}

// q, k, v, out: contiguous [batch, heads, seq, head_dim] (flash_attention.py
// attention_kernel's layout); keys at or past valid_len masked, every row
// computed. The same routes and returns as aaclip_attention_packed.
extern "C" int aaclip_attention_bhsd(const void* q, const void* k,
                                     const void* v, void* out, int bf16,
                                     int head_dim, int batch, int seq,
                                     int valid_len, int heads, float scale,
                                     void* stream) {
  const int64_t hs = (int64_t)seq * head_dim;
  const Layout l{heads * hs, hs, head_dim};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && tma_head_dim(head_dim)) {
    const int64_t depth = (int64_t)batch * heads;
    const MapOperand ops[3] = {
        {q, head_dim, 1, seq, depth, head_dim, head_dim, hs},
        {k, head_dim, 1, seq, depth, head_dim, head_dim, hs},
        {v, head_dim, 1, seq, depth, head_dim, head_dim, hs}};
    return by_head_dim(head_dim, [&](auto hd) {
      return launch_wgmma<decltype(hd)::value>(
          ops, MapCoords{0, heads, 1, 0}, batch, seq, valid_len, heads, out,
          nullptr, l, scale, st);
    });
  }
  return launch_retained(bf16 != 0, head_dim, batch, seq, valid_len, heads, q,
                         k, v, out, nullptr, l, l, scale, st);
}

// The 3-pass mode (fp32 under precision "high") of aaclip_attention_packed
// at head dim 16: the same operands in fp32, attn_fwd_3pass;
// cudaErrorInvalidValue for another head dim (64 to 128 have their
// own entry, aaclip_attention_packed_3pass_wgmma).
extern "C" int aaclip_attention_packed_3pass(
    const float* qkv, float* out, float* lse, int head_dim, int batch,
    int seq, int valid_len, int heads, long long ld, int q_off, int k_off,
    int v_off, long long out_ld, float scale, void* stream) {
  const Layout in{(int64_t)seq * ld, head_dim, ld};
  const Layout ol{(int64_t)seq * out_ld, head_dim, out_ld};
  return launch_3pass(head_dim, batch, seq, valid_len, heads, qkv + q_off,
                      qkv + k_off, qkv + v_off, out, lse, in, ol, scale,
                      static_cast<cudaStream_t>(stream));
}

// The 3-pass mode of aaclip_attention_bhsd on fp32 [batch, heads, seq,
// head_dim] operands at head dim 16.
extern "C" int aaclip_attention_bhsd_3pass(const float* q, const float* k,
                                           const float* v, float* out,
                                           int head_dim, int batch, int seq,
                                           int valid_len, int heads,
                                           float scale, void* stream) {
  const int64_t hs = (int64_t)seq * head_dim;
  const Layout l{heads * hs, hs, head_dim};
  return launch_3pass(head_dim, batch, seq, valid_len, heads, q, k, v, out,
                      nullptr, l, l, scale,
                      static_cast<cudaStream_t>(stream));
}

// The 6-pass route (fp32 at a TMA head dim under precision "highest"
// or None) of aaclip_attention_packed: `planes` holds the bf16 planes hi,
// mid and lo of the fp32 qkv [batch, seq, ld], one after the other
// (aaclip_split3 with stride batch * seq * ld), and attn_fwd_6pass reads
// them through tensor maps, which need each section's start, head_dim *
// 2 and ld * 2 bytes to be multiples of kTmaAlign. out [batch, seq,
// out_ld] and lse as aaclip_attention_packed's, in fp32.
// cudaErrorInvalidValue for another head dim.
extern "C" int aaclip_attention_packed_6pass(
    const void* planes, float* out, float* lse, int head_dim, int batch,
    int seq, int valid_len, int heads, long long ld, int q_off, int k_off,
    int v_off, long long out_ld, float scale, void* stream) {
  return launch_planes_packed<kPlanes>(planes, out, lse, head_dim, batch,
                                       seq, valid_len, heads, ld, q_off,
                                       k_off, v_off, out_ld, scale, stream);
}

// The 6-pass route of aaclip_attention_bhsd: q, k and v each the three
// bf16 planes of an fp32 [batch, heads, seq, head_dim] operand
// (aaclip_split3 with stride batch * heads * seq * head_dim).
extern "C" int aaclip_attention_bhsd_6pass(const void* q, const void* k,
                                           const void* v, float* out,
                                           int head_dim, int batch, int seq,
                                           int valid_len, int heads,
                                           float scale, void* stream) {
  return launch_planes_bhsd<kPlanes>(q, k, v, out, head_dim, batch, seq,
                                     valid_len, heads, scale, stream);
}

// The 3-pass route (fp32 at a TMA head dim under precision "high")
// of aaclip_attention_packed: `planes` holds the bf16 planes hi and lo of
// the fp32 qkv (aaclip_split2 with stride batch * seq * ld), read by
// attn_fwd_3pass_wgmma as the 6-pass entry's planes are read.
// cudaErrorInvalidValue for another head dim.
extern "C" int aaclip_attention_packed_3pass_wgmma(
    const void* planes, float* out, float* lse, int head_dim, int batch,
    int seq, int valid_len, int heads, long long ld, int q_off, int k_off,
    int v_off, long long out_ld, float scale, void* stream) {
  return launch_planes_packed<2>(planes, out, lse, head_dim, batch, seq,
                                 valid_len, heads, ld, q_off, k_off, v_off,
                                 out_ld, scale, stream);
}

// The 3-pass route of aaclip_attention_bhsd: q, k and v each the two bf16
// planes of an fp32 [batch, heads, seq, head_dim] operand (aaclip_split2
// with stride batch * heads * seq * head_dim).
extern "C" int aaclip_attention_bhsd_3pass_wgmma(
    const void* q, const void* k, const void* v, float* out, int head_dim,
    int batch, int seq, int valid_len, int heads, float scale,
    void* stream) {
  return launch_planes_bhsd<2>(q, k, v, out, head_dim, batch, seq, valid_len,
                               heads, scale, stream);
}

// fp32 x[n] (16-byte aligned) into its bf16 planes hi, mid, lo at planes,
// planes + stride and planes + 2 * stride (stride a multiple of 4,
// planes 16-byte aligned): split3_kernel. cudaErrorInvalidValue for an
// alignment it cannot take.
extern "C" int aaclip_split3(const float* x, void* planes, long long n,
                             long long stride, void* stream) {
  return launch_split<kPlanes>(x, planes, n, stride, stream);
}

// The same into the two planes hi and lo = bf16(x - hi) at planes and
// planes + stride: split2_kernel.
extern "C" int aaclip_split2(const float* x, void* planes, long long n,
                             long long stride, void* stream) {
  return launch_split<2>(x, planes, n, stride, stream);
}
