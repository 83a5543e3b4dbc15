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
// Seven products at hd 88 and 104 in bf16, nine elsewhere, not five. On
// the TPU the q grid axis runs in order and dK/dV accumulate in VMEM
// across q blocks, so one walk does S, dP, dV, dQ and dK. Blocks on Hopper
// run in no order, and dQ sums over keys while dK and dV sum over queries.
// dsum must be complete before any dS, so it costs a walk of its own (S
// and dP: 2 products): FlashAttention-2's dsum = rowsum(dO * O) would need
// the forward's output and departs from the TPU kernel's arithmetic. Every
// route below is deterministic (two calls give the same bits), with no
// atomic whose order depends on which block finishes first.
//  - bf16 at hd 88 and 104 (key_outer_head_dim): attn_bwd_dsum_wgmma, the
//    dsum pre-pass (kernel A's walk 1: 2 products), then
//    attn_bwd_kv_wgmma, key-outer: S^T, dP^T, dV, dK and each streamed
//    query tile's dQ partial dS K over the block's keys (5 products), the
//    partials summed over the key blocks in a fixed order (below). That is
//    7 S^2*hd products, 14*B*H*S^2*hd FLOP (0.354 ms at 989 TFLOP/s at B 8,
//    H 16, S 1370, hd 104; 0.299 at 88).
//  - every other head dim and route: two kernels, each output element
//    written once. (A) attn_bwd_dq_*, query-outer: one block per (query
//    tile, head, image). Walk 1 over the K/V tiles recomputes S = Q K^T
//    and dP = dO V^T (2 products) and sums dsum = rowsum(dP * P), stored
//    to `dsum` [B, H, S] for kernel B; walk 2 recomputes S and dP and
//    accumulates dQ += dS K (3 products). (B) attn_bwd_dkdv_*, key-outer:
//    one block per (key tile, head, image) walks the query tiles,
//    recomputes S^T = K Q^T and dP^T = V dO^T and accumulates dV +=
//    bf16(P)^T dO and dK += dS^T Q (4 products). That is 9 S^2*hd
//    products (18*B*H*S^2*hd FLOP, 276.8 GFLOP at hd 64, 0.280 ms at
//    peak). The first port did the same 9 on mma.sync (its header said
//    11; it was 9).
//
// The key-outer kernel's order (hd 88 and 104, bf16). dQ's partials meet
// in the wrapper's fp32 workspace dq_acc [B, H, nq * 64, HD] (nq = ceil(S
// / 64) query tiles); counters[(b * H + h) * nq + m], zeroed by the
// dsum pre-pass on every call, names the key block whose turn it is to add to
// query tile m. Key block n of (b, h), its partial of tile m in shared
// memory, waits until the counter reads n (ld.acquire.gpu), adds the
// partial with one bulk reduce (cp.reduce.async.bulk .add.f32; block 0
// writes it with a bulk copy instead, so dq_acc needs no memset), frees
// the shared buffer once the copy has read it (wait_group.read), waits
// until the writes are done (cp.async.bulk.wait_group 0, not .read),
// fences the async proxy and counts the counter on to n + 1
// (red.release.gpu). The last key block below valid_len reads the sum
// instead, adds its own partial in fp32 (the addition the bulk reduce
// would make) and stores dQ in bf16. So dQ = ((p_0 + p_1) + p_2) + ... in
// key-block order whatever order blocks run in; key blocks wholly past
// valid_len are not in the chain. The kernel takes its work (image,
// head, key block) from an atomic ticket (the counter after the chains')
// on a persistent grid of one block per SM, in groups of 16 (image, head)
// pairs, key block major within a group (KvTiles::kHeadGroup): key block
// n of a head takes its ticket 16 tickets after block n - 1, which is
// then a few tiles ahead, so its turns have mostly come (with one head's
// key blocks on consecutive tickets each waited on the one before, and
// the call ran slower on an H100; so did groups of 32 or more). A block
// waits only on a key block of its own head with a smaller ticket, which
// a running block has already taken, so no block waits on one that has
// not started, on any grid; a group's accumulators (16 x 1370 x 104 x 4
// B = 9.1 MB) stay in L2.
//
// Routes. bf16 at a TMA head dim (tma_head_dim: 64, ViT-L and ViT-B; 80,
// open_clip's ViT-H-14; 88, its ViT-g-14; 104, its ViT-bigG-14; 128) runs
// on TMA + wgmma: at 64, 80 and 128 the pair attn_bwd_dq_wgmma<HD> /
// attn_bwd_dkdv_wgmma<HD>, at 88 and 104 attn_bwd_dsum_wgmma<HD> /
// attn_bwd_kv_wgmma<HD> (above, and below the pair). fp32 there, the
// CLIs' default precision ("highest"), runs attn_bwd_dq_6pass<HD> /
// attn_bwd_dkdv_6pass<HD>, the same pair with every product in the TPU's
// native 6-pass form (below); fp32 under precision "high" (the 3-pass
// mode) runs attn_bwd_dq_3pass_wgmma<HD> / attn_bwd_dkdv_3pass_wgmma<HD>,
// the same pair on two planes. Head dim 16 (tiny-test) keeps the first
// port's kernels: bf16 on the mma.sync pair (4 warps of 16 rows, tiles of
// 64 copied through registers), fp32 on FMA (32 rows per block, two
// threads per row, each owning half its columns; no TF32), and the 3-pass
// mode on the mma.sync pair attn_bwd_*_3pass from hi/lo tiles.
//
// The fp32 route at head dim 64. Under "highest" the TPU kernel's
// _kdot (flash_attention.py:49-71) computes each product as six bf16
// products of the operands' hi/mid/lo planes, and that is the work here:
// the pair's nine products x 6 = 1660.6 GFLOP at [8, 1370, 3072], 1.679
// ms at 989 TFLOP/s (the TPU kernel's five products: 0.933 ms). On fp32
// FMA at 67 TFLOP/s the nine true-fp32 products alone take at least 4.13
// ms, about what a library's fp32 backward takes on tensor cores. So
// the fp32 pair runs the wgmma pair's design on bf16 planes: the wrapper
// splits qkv and dO into hi/mid/lo planes (attention_packed.cu,
// split3_kernel), the planes arrive by TMA, each product is six wgmma
// chains into one fp32 accumulator, and P and dS stay fp32, split in
// registers. (TF32's wgmma would take three passes at the same rate, but
// only K-major operands; dV = P^T dO, dQ = dS K and dK = dS^T Q need the
// MN-major B operand that only bf16 and fp16 wgmma take.)
//
// Design of the wgmma pair. Each block has three warpgroups: two
// consumers of 64 rows each (128 rows per block) and a producer whose
// registers go to the consumers (setmaxnreg 40 / 232). All tiles arrive
// by TMA (3-D tensor maps of the packed sections and of dO, columns x rows
// x images, so a tail tile reads zeros past S and never the next image),
// 128-byte swizzled, into a ring of stages tracked by full and empty
// mbarriers, so the next tiles are in flight while the current products
// run; every product is a wgmma of a 64-row warpgroup tile
// (hopper_common.cuh).
//  (A) The block's Q and dO rows stay in shared memory; K/V tiles of 64
//      keys stream through the ring twice, once per walk. S and dP are
//      m64n64k16 from shared memory (both K-major); walk 2 rounds dS to
//      bf16 in registers, where S's accumulator layout is the A-fragment
//      layout, and accumulates dQ += dS K with A from registers and the K
//      tile read MN-major. Each walk keeps the tensor cores busy during
//      its elementwise work: walk 1 issues tile k+1's S and dP (into a
//      second register set) before tile k's rowsum, walk 2 issues tile k's
//      S and dP together with tile k-1's dQ product (whose dS fragments
//      are a second register set). The elementwise work only reads the
//      score registers: writing a wgmma's accumulator registers while
//      products are in flight makes the compiler serialize them (ptxas
//      notes C7515 / C7517, and a markedly slower kernel on an H100).
//  (B) The block's K and V rows stay in shared memory; Q/dO tiles of 64
//      queries stream through the ring with their lse and dsum slices
//      (the producer warp copies those into the stage beside the TMA
//      tiles: a row of lse is S * 4 bytes, not a multiple of 16 at
//      S 1370, so TMA cannot map it). S^T and dP^T are m64n64k16 from
//      shared memory; bf16(P^T) and bf16(dS^T) are the register A
//      operands of dV += P^T dO and dK += dS^T Q with dO and Q read
//      MN-major; dK and dV stay in fp32 registers.
// The key-outer kernel at 88 and 104 is kernel B's plan with a dQ
// warpgroup beside its two consumers: each consumer also writes its
// bf16(dS^T) rows into a 128-byte-swizzled shared buffer (put_ds, the
// layout TMA writes), while its dV and dK products run; the dQ warpgroup
// takes each tile's partial dQ[64 queries x HD] = dS K over the block's
// 128 keys from that buffer (A, MN-major) and the own K rows (B,
// MN-major), a chunk at a time (m64n64, then m64n24 / m64n40: 32
// accumulator registers), and hands it to the producer's writer warps
// through two fp32 buffers; the writer keeps the order above. So the
// consumers' loop is kernel B's plus one shared store, and dQ's
// accumulator never sits beside dK, dV, S^T and dP^T. (Split between the
// two consumers by columns, dQ made each consumer wait on the other's
// dS^T and on the writer every tile, and ran slower than the pair at 88
// and 104 on an H100.) The two consumers take turns issuing a tile's S^T
// and dP^T (turn_wait / turn_pass, named barriers 2 and 3): started
// together from the same stage, both waited on their products at once and
// then left the tensor cores to the dQ warpgroup during their elementwise
// work; in turns, one's exponentials run beside the other's products
// (1.05x faster at 88 on an H100, the same bits).
// Ragged tail as in the forward: rows >= S read as zeros and are never
// stored (a padded query row's lse is +inf, so its P is 0), keys >=
// valid_len get P = 0, and key tiles wholly past valid_len store zero
// gradients without loading anything.
//
// Head dims 80, 88, 104 and 128. One tile row of the TMA + wgmma kernels
// is 64 bf16 columns, one 128-byte swizzle row (hopper_common.cuh), so a
// head is read as 64-column chunks (Head<HD>), each a TMA box of its own
// and a tile of the same layout, as the forward reads it: one chunk at 64,
// two at 80, 88, 104 and 128. At 80 the second box covers columns 64-127
// of the head, of which the products read 16 (the rest is the next head's,
// or zeros past the map's edge, and never enters a product). S and dP (S^T
// and dP^T in kernel B) run ceil(HD / 16) k-steps (five at 80, six at 88,
// seven at 104: four from the first chunk, the rest from the second); dQ,
// dK and dV one product per chunk, m64n64 on a full chunk and m64nN on the
// first N = HD - 64 columns of the second chunk below 128 (16, 24, 40),
// whose MN-major descriptor reads N / 8 of each swizzled row's eight
// 16-byte chunks. At 88 and 104 the head dim is no whole number of k-steps:
// the last k-step of S, dP, S^T and dP^T reads 8 pad columns (88-95,
// 104-111) of both its operands (Q, K, dO, V), which must add exact zeros,
// and zeros in one operand alone would not do, as 0 * NaN is NaN. So at 88
// and 104 every operand comes through a per-head tensor map
// (hopper_common.cuh::make_head_map, one head a map row) whose columns past
// the head arrive as zeros, never as the next head's, as the forward reads
// them; at 64, 80 and 128 the section-wide maps serve (per-head maps at
// 80 serialized the forward's 6-pass wgmma, C7511). Each gradient's
// stores are as compile-time per chunk as its products and write exactly
// the head's HD columns (a write of a pad column would land in the next
// head's gradient). So every route spends exactly hd's own products into the
// head, and at 88 and 104 one padded k-step more in each product over it
// (6 / 5.5 and 7 / 6.5 of S's and dP's work, which the bound does not
// count). The tile plans (BwdTiles, KvTiles; own rows per block x rows
// per streamed tile x stages, threads, shared memory of kernels A / B):
//   bf16      hd 64, 80, 128: 128 x 64 x 3, 384 threads, 81 / 83 KB at 64,
//                        161 / 163 KB at 80 and 128
//             hd 88, 104: the dsum pre-pass 128 x 64 x 3, 384 threads,
//                        161 KB; the key-outer kernel 128 x 64 x 2, 512
//                        threads, 206 / 214 KB (two dS^T and two fp32 dQ
//                        buffers besides)
//   6-pass    hd 64:     128 x 64 x 2, 384 threads, 193 / 194 KB
//             hd 80-128:  64 x 32 x 2, 160 threads, 193 / 194 KB
//   3-pass    hd 64:     128 x 64 x 3, 384 threads, 161 / 163 KB
//             hd 80-128:  64 x 32 x 2, 160 threads, 129 / 130 KB
// The 384 threads are two consumer warpgroups and a producer warpgroup
// that hands its registers over (setmaxnreg 40 / 232). The bf16 pair keeps
// that plan above 64, dQ, dK and dV at 40, 44, 52 or 64 registers each, and
// kernel A's overlapped walks (a 288-thread plan without the hand-off, two
// consumers and one producer warp, spilled in kernel B: registers go per
// SM quarter, and 9 warps put 3 in one, as 12 do). The key-outer kernel's
// 512 threads hand registers over as 200 (consumers) / 72 (dQ) / 40
// (producer). The plane pairs hold kP
// planes of two chunks of the own rows: 128 rows of Q and dO would take
// 2 x kP x 32 KB (192 KB on the 6-pass route) before any streamed tile,
// so their blocks own 64 rows, one consumer warpgroup and one producer
// warp (160 threads, which ptxas plans at up to 255 registers a thread:
// kernel B's dK and dV alone are 128 at 128, 104 at 104), and stream
// 32-row tiles (m64n32 scores) in 2 stages; at 88 and 104 the second
// chunk's product of a tile goes into an accumulator of its own (12 or 20
// registers), as in the forward. ptxas (CUDA 12.8, sm_90a), registers a
// thread, as chip_smoke.py's phase 2 prints them: bf16 168 in every
// instantiation; 6-pass dq / dkdv 144 / 216 at 80 and 190 / 244 at 128,
// 3-pass 128 / 195 and 156 / 234; hd 64 168 each; no spill and no stack
// frame anywhere. C75xx notes: C7519 (warpgroup.arrive injected) in
// attn_bwd_dq_wgmma at 64, 80 and 128, and C7512 (wgmma serialized for
// want of registers) at 128. At 88 / 104: the pre-pass 168 registers, no
// spill, C7517 (warpgroup.wait injected); the key-outer kernel 128 at
// launch (200 / 72 / 40 after the hand-off), 28 / 36 bytes spilled;
// 6-pass dq / dkdv 152 / 228 and 170 / 246, 3-pass 132 / 207 and 150 /
// 232.

#include <math.h>

#include <type_traits>

#include "hopper_common.cuh"
#include "launch_count.cuh"
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

// ------------------------------ TMA + wgmma: hd 64, 80, 88, 104, 128

constexpr int kWgRows = 64;  // rows per consumer warpgroup

// The head dims of the TMA + wgmma pairs (every route: bf16, 6-pass,
// 3-pass); the retained kernels take head dim 16.
constexpr bool tma_head_dim(int hd) {
  return hd == 64 || hd == 80 || hd == 88 || hd == 104 || hd == 128;
}

// The tile plan of a pair on P bf16 planes (1: the bf16 route; 3: 6-pass;
// 2: 3-pass) at head dim HD: consumer warpgroups (each 64 of the block's
// own rows), rows per streamed tile (the TMA box's rows, in which the own
// rows are loaded too), stages in flight, threads (384 with the register
// hand-off for two consumers, else one consumer and one producer warp),
// and the bytes of one chunk of one plane of an own operand and of a
// streamed tile. The header's table gives the plan of each instantiation.
template <int P, int HD>
struct BwdTiles {
  static constexpr int kP = P;
  static constexpr int kHD = HD;
  static constexpr bool kWide = HD != 64;
  static constexpr int kC = Head<HD>::kChunks;
  static constexpr int kWgs = P == 1 || !kWide ? 2 : 1;
  static constexpr int kRows = kWgs * kWgRows;  // the block's own rows
  static constexpr int kWalk = P == 1 || !kWide ? 64 : 32;
  static constexpr int kStages = P == 1 ? 3 : P == kPlanes || kWide ? 2
                                                          : 3;
  static constexpr int kThreads = kWgs == 2 ? 384 : 160;
  static constexpr int kOwnChunk = kRows * kRowBytes;
  static constexpr int kOwnPlane = kC * kOwnChunk;
  static constexpr int kOwn = 2 * P * kOwnPlane;  // both own operands
  static constexpr int kBox = kWalk * kRowBytes;
  static constexpr int kWalkPlane = kC * kBox;
  static constexpr int kStageBytes = 2 * P * kWalkPlane;
  static constexpr int kDqSmem = kSwizzleAtom + kOwn + kStages * kStageBytes +
                                 8 * (1 + 2 * kStages);
  // kernel B also stages each streamed tile's lse and dsum
  static constexpr int kDkdvSmem = kDqSmem + kStages * 2 * kWalk * 4;
};

// The register hand-off of the 384-thread plans (hopper_common.cuh): the
// producer warpgroup drops to kProducerRegs, the consumers take what it
// frees. The 160-thread plans have one producer warp and no hand-off.
template <class T>
__device__ __forceinline__ void producer_regs() {
  if constexpr (T::kWgs == 2) setmaxnreg_dec<kProducerRegs>();
}

template <class T>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (T::kWgs == 2) setmaxnreg_inc<kConsumerRegs>();
}

// Every plane and chunk of the block's own T::kRows rows of one operand,
// in boxes of T::kWalk rows (plane p at depth `depth` + p * pz; `col` is
// h * head_col<HD>(), hopper_common.cuh).
template <class T>
__device__ __forceinline__ void load_own(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row0,
                                         int depth, int pz) {
  for (int p = 0; p < T::kP; ++p)
    for (int c = 0; c < T::kC; ++c)
      for (int r = 0; r < T::kRows; r += T::kWalk)
        tma_chunk<T::kHD>(
            dst + p * T::kOwnPlane + c * T::kOwnChunk + r * kRowBytes, map,
            bar, col, c, row0 + r, depth + p * pz);
}

// One stage: every plane and chunk of a streamed T::kWalk-row tile of two
// operands (K and V, or Q and dO), the second's planes after the first's.
template <class T>
__device__ __forceinline__ void load_walk(uint8_t* dst, const CUtensorMap* a,
                                          const CUtensorMap* b, uint64_t* bar,
                                          int col, int row0, int depth,
                                          int pz) {
  for (int p = 0; p < T::kP; ++p)
    for (int c = 0; c < T::kC; ++c) {
      tma_chunk<T::kHD>(dst + p * T::kWalkPlane + c * T::kBox, a, bar, col, c,
                        row0, depth + p * pz);
      tma_chunk<T::kHD>(dst + (T::kP + p) * T::kWalkPlane + c * T::kBox, b,
                        bar, col, c, row0, depth + p * pz);
    }
}

// Issue S and dP of one warpgroup's 64 rows against one streamed tile of
// kN rows as one wgmma group: s = A . B^T and dp = dA . dB^T over a head of
// HD columns, all four operands K-major in shared memory (A's chunks
// a_chunk bytes apart, B's b_chunk). The caller waits for the group.
template <int HD, int kN>
__device__ __forceinline__ void issue_scores_and_dp(
    float (&s)[kN / 2], float (&dp)[kN / 2], uint64_t a, uint64_t da,
    int a_chunk, uint64_t bt, uint64_t dbt, int b_chunk) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < Head<HD>::kKSteps; ++ks)
    wgmma_ss<kN>(s, desc_plus(a, (ks / 4) * a_chunk + 32 * (ks % 4)),
                 desc_plus(bt, (ks / 4) * b_chunk + 32 * (ks % 4)), ks);
#pragma unroll
  for (int ks = 0; ks < Head<HD>::kKSteps; ++ks)
    wgmma_ss<kN>(dp, desc_plus(da, (ks / 4) * a_chunk + 32 * (ks % 4)),
                 desc_plus(dbt, (ks / 4) * b_chunk + 32 * (ks % 4)), ks);
  wgmma_commit();
}

// Kernel A's P of score s[4j + i] of one tile (keys at or past valid_len,
// checked when kMask, get P = 0). The two users below read the scores and
// write other registers: a score register written while a wgmma is in
// flight would serialize the products.
template <bool kMask, int N>
__device__ __forceinline__ float prob_a(const float (&s)[N], int j, int i,
                                        int k0, int valid_len, float scale,
                                        const float (&lse_r)[2], int t) {
  const bool keep = !kMask || k0 + j * 8 + t * 2 + (i & 1) < valid_len;
  return keep ? __expf(__fmul_rn(s[4 * j + i], scale) - lse_r[i >> 1])
              : 0.f;
}

// Walk 1 of kernel A: ds_row += rowsum(dP * P) over one tile.
template <bool kMask, int N>
__device__ __forceinline__ void dsum_tile(const float (&s)[N],
                                          const float (&dp)[N],
                                          float (&ds_row)[2], int k0,
                                          int valid_len, float scale,
                                          const float (&lse_r)[2], int t) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ds_row[i >> 1] +=
          dp[4 * j + i] *
          prob_a<kMask>(s, j, i, k0, valid_len, scale, lse_r, t);
}

// Walk 2 of kernel A: bf16(dS) = round(P * (dP - dsum) * scale) of one
// tile as the A fragments f of dQ += dS K.
template <bool kMask, int N>
__device__ __forceinline__ void ds_tile(const float (&s)[N],
                                        const float (&dp)[N],
                                        uint32_t (&f)[N / 8][4],
                                        const float (&ds_row)[2], int k0,
                                        int valid_len, float scale,
                                        const float (&lse_r)[2], int t) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = prob_a<kMask>(s, j, i, k0, valid_len, scale, lse_r, t) *
             (dp[4 * j + i] - ds_row[i >> 1]) * scale;
    f[j >> 1][(j & 1) * 2 + 0] = pack_f32(v[0], v[1]);
    f[j >> 1][(j & 1) * 2 + 1] = pack_f32(v[2], v[3]);
  }
}

// bf16 A fragments of an accumulator of 2N columns: two adjacent 8-column
// groups form one 16-deep k-step.
template <int N>
__device__ __forceinline__ void pack_frags(uint32_t (&f)[N / 8][4],
                                           const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    f[j >> 1][(j & 1) * 2 + 0] = pack_f32(v[4 * j + 0], v[4 * j + 1]);
    f[j >> 1][(j & 1) * 2 + 1] = pack_f32(v[4 * j + 2], v[4 * j + 3]);
  }
}

// acc += A . B into a head of HD columns: A the fragments f (kKK k-steps of
// 16 rows of the streamed tile), B the tile read MN-major (its rows are the
// reduction), one product per chunk (chunks b_chunk bytes apart).
template <int HD, int kKK>
__device__ __forceinline__ void mma_rows(float (&acc)[HD / 2],
                                         const uint32_t (&f)[kKK][4],
                                         uint64_t b, int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < kKK; ++kk)
    wgmma_rs_mn<kTileCols>(acc, f[kk], desc_plus(b, 16 * kRowBytes * kk));
  if constexpr (Head<HD>::kChunks == 2) {
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk)
      wgmma_rs_mn<Head<HD>::cols(1)>(
          acc + 32, f[kk], desc_plus(b, b_chunk + 16 * kRowBytes * kk));
  }
}

__device__ __forceinline__ void put_pair(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = pack_f32(x, y);
}

__device__ __forceinline__ void put_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Rows row_a and row_a + 8 (when < S) of kN accumulator columns into dst
// (row stride ld), as bf16 or fp32 pairs.
template <int kN, typename TO>
__device__ __forceinline__ void store_cols(TO* dst, int64_t ld,
                                           const float* acc, int row_a, int S,
                                           int t) {
#pragma unroll
  for (int nd = 0; nd < kN / 8; ++nd) {
    if (row_a < S)
      put_pair(dst + (int64_t)row_a * ld + nd * 8 + t * 2, acc[4 * nd + 0],
               acc[4 * nd + 1]);
    if (row_a + 8 < S)
      put_pair(dst + (int64_t)(row_a + 8) * ld + nd * 8 + t * 2,
               acc[4 * nd + 2], acc[4 * nd + 3]);
  }
}

// A gradient of a head of HD columns: store_cols on each chunk.
template <int HD, typename TO>
__device__ __forceinline__ void store_head(TO* dst, int64_t ld,
                                           const float (&acc)[HD / 2],
                                           int row_a, int S, int t) {
  store_cols<kTileCols>(dst, ld, acc, row_a, S, t);
  if constexpr (Head<HD>::kChunks == 2)
    store_cols<Head<HD>::cols(1)>(dst + kTileCols, ld, acc + 32, row_a, S, t);
}

// Kernel A's body: walk 1 (dsum) and, with kDq, walk 2 (dQ into d(qkv)'s
// Q columns); without it, the key-outer plan's dsum pre-pass.
template <int HD, bool kDq>
__device__ __forceinline__ void query_outer(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ lse,
    float* __restrict__ dsum, __nv_bfloat16* __restrict__ dqkv, int S,
    int valid_len, int64_t ld, int q_off, float scale) {
  using T = BwdTiles<1, HD>;
  constexpr int kN = T::kWalk, kKK = kN / 16;
  constexpr int kWalks = kDq ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_atom(smem_raw);  // [chunk][own rows][64]
  uint8_t* sdO = sQ + T::kOwnPlane;    // [chunk][own rows][64]
  uint8_t* sKV = sdO + T::kOwnPlane;   // [stage]: K's chunks, then V's
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sKV + T::kStages * T::kStageBytes);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + T::kStages;

  const int q0 = blockIdx.x * T::kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  [[maybe_unused]] const int col = h * HD;  // walk 2's
  const int n = (valid_len + kN - 1) / kN;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::kWgs * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == T::kWgs) {  // producer: Q and dO once, then K/V tiles per walk
    producer_regs<T>();
    if (threadIdx.x == T::kWgs * 128) {
      mbar_arrive_expect_tx(own_full, T::kOwn);
      load_own<T>(sQ, &tq, own_full, h * head_col<HD>(), q0, b, 0);
      load_own<T>(sdO, &tdo, own_full, h * head_col<HD>(), q0, b, 0);
      for (int it = 0; it < kWalks * n; ++it) {
        const int st = it % T::kStages;
        if (it >= T::kStages)
          mbar_wait(&empty[st], (it / T::kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[st], T::kStageBytes);
        load_walk<T>(sKV + st * T::kStageBytes, &tk, &tv, &full[st],
                     h * head_col<HD>(), (it % n) * kN, b, 0);
      }
    }
  } else {
    consumer_regs<T>();
    const int warp = (threadIdx.x % 128) / 32;
    const int g = (threadIdx.x & 31) >> 2;
    const int t = threadIdx.x & 3;
    const int row_a = q0 + wg * kWgRows + warp * 16 + g;
    const int64_t lrow = ((int64_t)b * gridDim.y + h) * S;
    const float lse_r[2] = {row_a < S ? lse[lrow + row_a] : INFINITY,
                            row_a + 8 < S ? lse[lrow + row_a + 8] : INFINITY};
    const uint64_t dq_desc = sw128_desc(sQ + wg * kWgRows * kRowBytes);
    const uint64_t ddo_desc = sw128_desc(sdO + wg * kWgRows * kRowBytes);
    mbar_wait(own_full, 0);

    // walk 1: dsum = rowsum(dP * P). Tile it + 1's S and dP are issued
    // before tile it's elementwise work, into the other of two register
    // sets (sa/da, sb/db), so the tensor cores run them meanwhile.
    float ds_row[2] = {0.f, 0.f};
    auto issue = [&](float (&s)[kN / 2], float (&dp)[kN / 2], int it) {
      const int st = it % T::kStages;
      const uint8_t* stage = sKV + st * T::kStageBytes;
      mbar_wait(&full[st], (it / T::kStages) & 1);
      issue_scores_and_dp<HD, kN>(s, dp, dq_desc, ddo_desc, T::kOwnChunk,
                                  sw128_desc(stage),
                                  sw128_desc(stage + T::kWalkPlane), T::kBox);
    };
    auto walk1 = [&](float (&s)[kN / 2], float (&dp)[kN / 2],
                     float (&sn)[kN / 2], float (&dpn)[kN / 2], int it) {
      if (it + 1 < n) {
        issue(sn, dpn, it + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_operand(s);
      fence_operand(dp);
      mbar_arrive(&empty[it % T::kStages]);
      const int k0 = it * kN;
      if (k0 + kN <= valid_len)
        dsum_tile<false>(s, dp, ds_row, k0, valid_len, scale, lse_r, t);
      else
        dsum_tile<true>(s, dp, ds_row, k0, valid_len, scale, lse_r, t);
    };
    float s[kN / 2], dp[kN / 2], sb[kN / 2], db[kN / 2];
    issue(s, dp, 0);
    for (int it = 0; it < n; it += 2) {
      walk1(s, dp, sb, db, it);
      if (it + 1 < n) walk1(sb, db, s, dp, it + 1);
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
    if constexpr (!kDq) return;

    // walk 2: dQ = dS K. Tile it's S and dP are issued together with the
    // previous tile's dQ product, whose dS fragments (dsf) the elementwise
    // work of tile it does not touch: it writes the next ones (dsn).
    float dq[Head<HD>::kRegs];
#pragma unroll
    for (int i = 0; i < Head<HD>::kRegs; ++i) dq[i] = 0.f;
    uint32_t dsf[kKK][4], dsn[kKK][4];
    for (int it = n; it < 2 * n; ++it) {
      const int prev = (it - 1) % T::kStages;
      issue(s, dp, it);
      if (it > n) {
        mma_rows<HD>(dq, dsf, sw128_desc(sKV + prev * T::kStageBytes),
                     T::kBox);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_operand(s);
      fence_operand(dp);
      const int k0 = (it - n) * kN;
      if (k0 + kN <= valid_len)
        ds_tile<false>(s, dp, dsn, ds_row, k0, valid_len, scale, lse_r, t);
      else
        ds_tile<true>(s, dp, dsn, ds_row, k0, valid_len, scale, lse_r, t);
      wgmma_wait<0>();
      fence_operand(dq);
      fence_frags(dsf);
      if (it > n) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int k = 0; k < kKK; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) dsf[k][r] = dsn[k][r];
    }
    {  // the last tile's dQ product
      const int st = (2 * n - 1) % T::kStages;
      wgmma_fence();
      mma_rows<HD>(dq, dsf, sw128_desc(sKV + st * T::kStageBytes), T::kBox);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(dq);
      fence_frags(dsf);
      mbar_arrive(&empty[st]);
    }
    store_head<HD>(dqkv + (int64_t)b * S * ld + q_off + col, ld, dq, row_a,
                   S, t);
  }
}

template <int HD>
__global__ void __launch_bounds__(BwdTiles<1, HD>::kThreads, 1)
attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, float* __restrict__ dsum,
                  __nv_bfloat16* __restrict__ dqkv, int S, int valid_len,
                  int64_t ld, int q_off, float scale) {
  query_outer<HD, true>(tq, tk, tv, tdo, lse, dsum, dqkv, S, valid_len, ld,
                        q_off, scale);
}

// One streamed tile of kernel B's consumers (and the key-outer kernel's):
// from S^T and dP^T (s, dp: [64 keys x kWalk queries], fp32) and the
// tile's lse and dsum rows, bf16(P^T) into pf and round(dS^T) into dsf,
// then dV += P^T dO and dK += dS^T Q issued and committed; the caller
// waits. keep_r: whether each of the thread's two key rows is below
// valid_len.
template <class T>
__device__ __forceinline__ void dkdv_tile(
    float (&s)[T::kWalk / 2], float (&dp)[T::kWalk / 2],
    uint32_t (&pf)[T::kWalk / 16][4], uint32_t (&dsf)[T::kWalk / 16][4],
    float (&dk)[T::kHD / 2], float (&dv)[T::kHD / 2],
    const float* rows, const bool (&keep_r)[2], int t, float scale,
    uint64_t q_desc, uint64_t do_desc) {
  constexpr int kN = T::kWalk;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = j * 8 + t * 2 + (i & 1);
      s[4 * j + i] = keep_r[i >> 1]
                         ? __expf(__fmul_rn(s[4 * j + i], scale) - rows[c])
                         : 0.f;
    }
  pack_frags(pf, s);  // bf16(P)^T
#pragma unroll
  for (int j = 0; j < kN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = j * 8 + t * 2 + (i & 1);
      dp[4 * j + i] = s[4 * j + i] * (dp[4 * j + i] - rows[kN + c]) * scale;
    }
  pack_frags(dsf, dp);  // round(dS)^T
  wgmma_fence();
  mma_rows<T::kHD>(dv, pf, do_desc, T::kBox);
  mma_rows<T::kHD>(dk, dsf, q_desc, T::kBox);
  wgmma_commit();
}

template <int HD>
__global__ void __launch_bounds__(BwdTiles<1, HD>::kThreads, 1)
attn_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dqkv, int S, int valid_len,
                    int64_t ld, int k_off, int v_off, float scale) {
  using T = BwdTiles<1, HD>;
  constexpr int kN = T::kWalk, kKK = kN / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align_atom(smem_raw);  // [chunk][own keys][64]
  uint8_t* sV = sK + T::kOwnPlane;     // [chunk][own keys][64]
  uint8_t* sQdO = sV + T::kOwnPlane;   // [stage]: Q's chunks, then dO's
  float* sRow = reinterpret_cast<float*>(sQdO + T::kStages * T::kStageBytes);
  // sRow[stage][0][kN]: lse of the tile's queries; [stage][1][kN]: dsum
  uint64_t* bars = reinterpret_cast<uint64_t*>(sRow + T::kStages * 2 * kN);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + T::kStages;

  const int kv0 = blockIdx.x * T::kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = h * HD;
  const int nq = (S + kN - 1) / kN;
  const bool active = kv0 < valid_len;  // else zero gradients, no loads
  const int64_t lrow = ((int64_t)b * gridDim.y + h) * S;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp
      mbar_init(&empty[s], T::kWgs * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == T::kWgs) {  // producer warp: K and V once, then Q/dO tiles
    producer_regs<T>();
    const int lane = threadIdx.x - T::kWgs * 128;
    if (lane < 32 && active) {
      if (lane == 0) {
        mbar_arrive_expect_tx(own_full, T::kOwn);
        load_own<T>(sK, &tk, own_full, h * head_col<HD>(), kv0, b, 0);
        load_own<T>(sV, &tv, own_full, h * head_col<HD>(), kv0, b, 0);
      }
      for (int it = 0; it < nq; ++it) {
        const int st = it % T::kStages;
        if (it >= T::kStages)
          mbar_wait(&empty[st], (it / T::kStages - 1) & 1);
        float* rows = sRow + st * 2 * kN;
        for (int i = lane; i < kN; i += 32) {
          const int qr = it * kN + i;
          rows[i] = qr < S ? lse[lrow + qr] : INFINITY;
          rows[kN + i] = qr < S ? dsum[lrow + qr] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], T::kStageBytes);
          load_walk<T>(sQdO + st * T::kStageBytes, &tq, &tdo, &full[st],
                       h * head_col<HD>(), it * kN, b, 0);
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    consumer_regs<T>();
    const int warp = (threadIdx.x % 128) / 32;
    const int g = (threadIdx.x & 31) >> 2;
    const int t = threadIdx.x & 3;
    const int row_a = kv0 + wg * kWgRows + warp * 16 + g;
    float dk[Head<HD>::kRegs], dv[Head<HD>::kRegs];
#pragma unroll
    for (int i = 0; i < Head<HD>::kRegs; ++i) dk[i] = dv[i] = 0.f;
    if (active) {
      const bool keep_r[2] = {row_a < valid_len, row_a + 8 < valid_len};
      const uint64_t dk_desc = sw128_desc(sK + wg * kWgRows * kRowBytes);
      const uint64_t dv_desc = sw128_desc(sV + wg * kWgRows * kRowBytes);
      mbar_wait(own_full, 0);
      // (Issuing tile it's S^T and dP^T together with tile it-1's dV and
      // dK, as kernel A's walk 2 does, ran slower here on an H100: the two
      // extra fragment sets leave little of the register budget.)
      float s[kN / 2], dp[kN / 2];  // S^T and dP^T: [64 keys x kN queries]
      uint32_t pf[kKK][4], dsf[kKK][4];
      for (int it = 0; it < nq; ++it) {
        const int st = it % T::kStages;
        mbar_wait(&full[st], (it / T::kStages) & 1);
        const uint8_t* stage = sQdO + st * T::kStageBytes;
        const uint64_t q_desc = sw128_desc(stage);
        const uint64_t do_desc = sw128_desc(stage + T::kWalkPlane);
        issue_scores_and_dp<HD, kN>(s, dp, dk_desc, dv_desc, T::kOwnChunk,
                                    q_desc, do_desc, T::kBox);
        wgmma_wait<0>();
        fence_operand(s);
        fence_operand(dp);
        dkdv_tile<T>(s, dp, pf, dsf, dk, dv, sRow + st * 2 * kN, keep_r, t,
                     scale, q_desc, do_desc);
        wgmma_wait<0>();
        fence_operand(dv);
        fence_operand(dk);
        fence_frags(pf);
        fence_frags(dsf);
        mbar_arrive(&empty[st]);
      }
    }
    __nv_bfloat16* out = dqkv + (int64_t)b * S * ld + col;
    store_head<HD>(out + k_off, ld, dk, row_a, S, t);
    store_head<HD>(out + v_off, ld, dv, row_a, S, t);
  }
}

// The tensor maps of q, k, v and dO over T::kP planes (plane p of image b
// at depth b + p * batch; planes batch * seq * ld and batch * seq * do_ld
// elements apart), in boxes of T::kWalk rows: at 88 and 104
// (Head<HD>::kHeadMap) per-head maps, one head of HD columns a map row, so
// a chunk's columns past the head read as zeros; else every row of each
// covers the heads x HD columns of its section.
template <class T, int HD>
int bwd_maps(CUtensorMap (&maps)[4], const void* qkv, const void* dout,
             int batch, int seq, int heads, int64_t ld, int q_off, int k_off,
             int v_off, int64_t do_ld) {
  const char* base = static_cast<const char*>(qkv);
  const int64_t cols = (int64_t)heads * HD;
  const void* bases[4] = {base + 2 * (int64_t)q_off, base + 2 * (int64_t)k_off,
                          base + 2 * (int64_t)v_off, dout};
  for (int i = 0; i < 4; ++i) {
    const int64_t row = i < 3 ? ld : do_ld;
    const cudaError_t err =
        Head<HD>::kHeadMap
            ? make_head_map(&maps[i], bases[i], HD, heads, seq, T::kP * batch,
                            2 * HD, 2 * row, 2 * seq * row, T::kWalk)
            : make_tile_map(&maps[i], bases[i], cols, seq, T::kP * batch,
                            2 * row, 2 * seq * row, T::kWalk);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

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

template <int HD>
int launch_wgmma(int batch, int seq, int heads, cudaStream_t st,
                 const void* qkv, const void* dout, const float* lse,
                 float* dsum, void* dqkv, int valid_len, int64_t ld,
                 int q_off, int k_off, int v_off, int64_t do_ld,
                 float scale) {
  using T = BwdTiles<1, HD>;
  CUtensorMap maps[4];  // q, k, v, dO
  if (const int err = bwd_maps<T, HD>(maps, qkv, dout, batch, seq, heads, ld,
                                      q_off, k_off, v_off, do_ld))
    return err;
  cudaError_t err = smem_attribute_once(
      reinterpret_cast<const void*>(attn_bwd_dq_wgmma<HD>), T::kDqSmem);
  if (err == cudaSuccess)
    err = smem_attribute_once(
        reinterpret_cast<const void*>(attn_bwd_dkdv_wgmma<HD>), T::kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + T::kRows - 1) / T::kRows, heads, batch);
  using B = __nv_bfloat16;
  attn_bwd_dq_wgmma<HD><<<grid, T::kThreads, T::kDqSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dsum, static_cast<B*>(dqkv),
      seq, valid_len, ld, q_off, scale);
  note_launch();
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_wgmma<HD><<<grid, T::kThreads, T::kDkdvSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dsum, static_cast<B*>(dqkv),
      seq, valid_len, ld, k_off, v_off, scale);
  note_launch();
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------ bf16 at hd 88 and 104: seven products

// The head dims whose bf16 backward is the dsum pre-pass and the key-outer
// kernel below; every other head dim's bf16 backward is the pair above.
constexpr bool key_outer_head_dim(int hd) { return hd == 88 || hd == 104; }

// The dsum pre-pass: kernel A's walk 1 alone, on kernel A's plan (128 own
// query rows, 64-key tiles through the ring, the producer's register
// hand-off): dsum = rowsum(dP * P) of S = Q K^T and dP = dO V^T in fp32,
// into `dsum` [B, H, S]. Two S^2*hd products. It also zeroes the
// key-outer kernel's counters for this call, which runs after it on the
// stream: each block those of its own query tiles (its image and head's,
// nq = ceil(S / 64) of them), block (0, 0, 0) the ticket after them.
template <int HD>
__global__ void __launch_bounds__(BwdTiles<1, HD>::kThreads, 1)
attn_bwd_dsum_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, float* __restrict__ dsum,
                    int* __restrict__ counters, int S, int valid_len,
                    float scale) {
  using T = BwdTiles<1, HD>;
  constexpr int kTiles = T::kRows / T::kWalk;  // query tiles per block
  const int nq = (S + T::kWalk - 1) / T::kWalk;
  const int64_t bh = (int64_t)blockIdx.z * gridDim.y + blockIdx.y;
  if (threadIdx.x < kTiles && blockIdx.x * kTiles + threadIdx.x < nq)
    counters[bh * nq + blockIdx.x * kTiles + threadIdx.x] = 0;
  if (threadIdx.x == 0 && blockIdx.x == 0 && bh == 0)
    counters[(int64_t)gridDim.z * gridDim.y * nq] = 0;
  query_outer<HD, false>(tq, tk, tv, tdo, lse, dsum, nullptr, S, valid_len,
                         0, 0, scale);
}

// The products of dQ's partial, d[64 x N] (+)= A . B with A and B from
// shared memory, both MN-major (the operand's rows are the reduction):
// m64nNk16 on a head's chunks, 64 columns or the last chunk's 24 or 40.
__device__ __forceinline__ void wgmma_ss_n24_mn(float (&d)[12], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n40_mn(float (&d)[20], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19"
      "}, %20, %21, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B, both MN-major from shared memory, N columns; d points at
// N / 2 accumulators.
template <int N>
__device__ __forceinline__ void wgmma_ss_mn(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64_mn(*reinterpret_cast<float(*)[32]>(d), da, db, scale_d);
  } else if constexpr (N == 40) {
    wgmma_ss_n40_mn(*reinterpret_cast<float(*)[20]>(d), da, db, scale_d);
  } else {
    static_assert(N == 24, "MN-major products of 64, 40 or 24 columns");
    wgmma_ss_n24_mn(*reinterpret_cast<float(*)[12]>(d), da, db, scale_d);
  }
}

// The key-outer kernel's plan: BwdTiles<1, HD>'s own rows (128 keys, K and
// V) and streamed tiles (64 queries, Q and dO) in a ring of kStages, two
// buffers of a tile's dS^T (bf16, 128 keys x 64 queries, 128-byte
// swizzled) and kDqBufs of its dQ partial (fp32, 64 queries x HD, the
// workspace's layout), then the mbarriers, the stages' lse and dsum rows,
// the partials' headers (item, query tile) and two item slots. Four
// warpgroups: two consumers (64 keys each: S^T, dP^T, dV, dK), the dQ
// warpgroup and the producer (the loader warp and three writer warps),
// registers handed over as kRegs* give them (2 * 200 + 72 + 40 = 512 =
// 4 * 128, the launch's share).
template <int HD>
struct KvTiles {
  using T = BwdTiles<1, HD>;
  static constexpr int kThreads = 512;
  static constexpr int kRegsConsumer = 200, kRegsDq = 72, kRegsProducer = 40;
  static constexpr int kStages = 2, kDqBufs = 2;
  // tickets interleave this many (image, head) pairs, key block major
  // within a group: key block n of a head starts kHeadGroup tickets after
  // block n - 1, whose adds it waits for
  static constexpr int kHeadGroup = 16;
  static constexpr int kDs = T::kRows * kRowBytes;
  static constexpr int kDq = T::kWalk * HD * 4;
  // own full / empty; the ring's full / empty; item and dS full / empty,
  // two each; dQ full / empty
  static constexpr int kBars = 2 + 2 * kStages + 8 + 2 * kDqBufs;
  static constexpr int kSmem = kSwizzleAtom + T::kOwn +
                               kStages * T::kStageBytes + 2 * kDs +
                               kDqBufs * kDq + 8 * kBars +
                               kStages * 2 * T::kWalk * 4 +
                               (2 * kDqBufs + 2) * 4;
};

// Chunk C of a tile's dQ partial, dQ[64 queries x the chunk's columns] =
// dS . K over the block's 128 keys: A the tile's dS^T buffer `ds`, B chunk
// C of the own K rows `sk` ([chunk][128 keys][64]), both MN-major, eight
// k-steps of 16 keys (m64n64, or m64n24 / m64n40 on the last chunk). The
// caller commits and waits.
template <int HD, int C>
__device__ __forceinline__ void dq_partial(
    float (&dq)[Head<HD>::cols(C) / 2], const uint8_t* ds,
    const uint8_t* sk) {
  const uint64_t a = sw128_desc(ds),
                 b = sw128_desc(sk + C * BwdTiles<1, HD>::kOwnChunk);
#pragma unroll
  for (int kk = 0; kk < BwdTiles<1, HD>::kRows / 16; ++kk) {
    const int k = 16 * kRowBytes * kk;
    wgmma_ss_mn<Head<HD>::cols(C)>(dq, desc_plus(a, k), desc_plus(b, k), kk);
  }
}

// A consumer's bf16(dS^T) fragments (rows `row` and row + 8 of the block's
// 128 keys, the tile's 64 queries) into the 128-byte-swizzled buffer
// `buf`: element (r, c) at r * 128 + ((c / 8) ^ (r % 8)) * 16 + (c % 8) * 2,
// as TMA would have written it.
__device__ __forceinline__ void put_ds(uint8_t* buf, const uint32_t (&f)[4][4],
                                       int row, int t) {
  uint8_t* r0 = buf + row * kRowBytes;
  const int g = row & 7;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = ((j ^ g) << 4) + 4 * t;
    *reinterpret_cast<uint32_t*>(r0 + c) = f[j >> 1][(j & 1) * 2];
    *reinterpret_cast<uint32_t*>(r0 + 8 * kRowBytes + c) =
        f[j >> 1][(j & 1) * 2 + 1];
  }
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's shared-memory operands, the bulk copies), before the barrier
// that hands them over.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The workspace's global accesses ordered between the async proxy (the
// bulk copies) and the generic proxy (the counters' acquire and release,
// the last block's loads).
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Wait until the counter at p reads `want` (acquire, GPU scope); traps
// after kHangNs without it, as mbar_wait does.
__device__ __forceinline__ void wait_counter(const int* p, int want) {
  uint64_t t0 = 0;
  for (int i = 0;; ++i) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
    if (v == want) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (i == 0)
      t0 = now;
    else if (now - t0 > kHangNs)
      __trap();
  }
}

// The next key block's turn: the counter at p one more (release, GPU
// scope).
__device__ __forceinline__ void release_counter(int* p) {
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(p)
               : "memory");
}

// `bytes` of shared memory at src into global dst, written (kAdd false) or
// added as fp32 (kAdd true); `freed` hears once src is read, and the call
// returns once the writes are done.
template <bool kAdd>
__device__ __forceinline__ void bulk_to_global(float* dst, const float* src,
                                               int bytes, uint64_t* freed) {
  if constexpr (kAdd)
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
        "[%1], %2;\n" ::"l"(dst),
        "r"(smem_u32(src)), "r"(bytes)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst),
        "r"(smem_u32(src)), "r"(bytes)
        : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  mbar_arrive(freed);
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void writer_sync() {  // the three writer warps
  asm volatile("bar.sync 1, 96;\n" ::: "memory");
}

// The consumers' turns at the tensor cores: consumer wg issues a tile's
// S^T and dP^T after the other has issued its own (barrier 2 + wg, 128
// threads waiting and the other's 128 arriving), so one consumer's
// elementwise work runs beside the other's products.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - wg) : "memory");
}

// The shared memory and arguments the key-outer kernel's roles share.
struct KvShared {
  uint8_t *sK, *sV, *sQdO, *sDs;
  float *sDq, *sRow;
  uint64_t *own_full, *own_empty, *full, *empty, *item_full, *item_empty,
      *ds_full, *ds_empty, *dq_full, *dq_empty;
  int *hdr, *slot;
  int S, valid_len, heads, nk, nq;
};

// Consumer warpgroup wg (0 or 1) of the key-outer kernel: per item (image,
// head, key block of 128 keys) its 64 keys' dK and dV over every streamed
// query tile, as kernel B computes them, and each tile's bf16(dS^T) rows
// into the dS^T buffer the dQ warpgroup reads.
template <int HD>
__device__ __forceinline__ void kv_consumer(const KvShared& m, int wg,
                                            __nv_bfloat16* __restrict__ dqkv,
                                            int64_t ld, int k_off, int v_off,
                                            float scale) {
  using T = BwdTiles<1, HD>;
  using K = KvTiles<HD>;
  constexpr int kN = T::kWalk, kKK = kN / 16;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int own = wg * kWgRows + warp * 16 + g;  // row of the block's keys
  const uint64_t dk_desc = sw128_desc(m.sK + wg * kWgRows * kRowBytes);
  const uint64_t dv_desc = sw128_desc(m.sV + wg * kWgRows * kRowBytes);
  int active = 0, tile = 0;  // active items and tiles so far
  if (wg == 1) turn_pass(wg);  // consumer 0 goes first
  for (int k = 0;; ++k) {
    mbar_wait(&m.item_full[k % 2], (k / 2) & 1);
    const int item = m.slot[k % 2];
    mbar_arrive(&m.item_empty[k % 2]);
    if (item < 0) {
      if (wg == 0) turn_wait(wg);  // consumer 1's last pass
      break;
    }
    const int bh = item / m.nk, kv0 = (item % m.nk) * T::kRows;
    const int b = bh / m.heads, h = bh % m.heads;
    const int row_a = kv0 + own;
    float dk[Head<HD>::kRegs], dv[Head<HD>::kRegs];
#pragma unroll
    for (int i = 0; i < Head<HD>::kRegs; ++i) dk[i] = dv[i] = 0.f;
    if (kv0 < m.valid_len) {  // else zero gradients, nothing loaded
      const bool keep_r[2] = {row_a < m.valid_len, row_a + 8 < m.valid_len};
      mbar_wait(m.own_full, active & 1);
      ++active;
      float s[kN / 2], dp[kN / 2];  // S^T and dP^T: [64 keys x 64 queries]
      uint32_t pf[kKK][4], dsf[kKK][4];
      for (int it = 0; it < m.nq; ++it, ++tile) {
        const int st = tile % K::kStages;
        mbar_wait(&m.full[st], (tile / K::kStages) & 1);
        const uint8_t* stage = m.sQdO + st * T::kStageBytes;
        const uint64_t q_desc = sw128_desc(stage);
        const uint64_t do_desc = sw128_desc(stage + T::kWalkPlane);
        turn_wait(wg);
        issue_scores_and_dp<HD, kN>(s, dp, dk_desc, dv_desc, T::kOwnChunk,
                                    q_desc, do_desc, T::kBox);
        turn_pass(wg);
        wgmma_wait<0>();
        fence_operand(s);
        fence_operand(dp);
        dkdv_tile<T>(s, dp, pf, dsf, dk, dv, m.sRow + st * 2 * kN, keep_r, t,
                     scale, q_desc, do_desc);
        // while dV and dK run: this tile's dS^T for the dQ warpgroup
        const int db = tile % 2;
        if (tile >= 2) mbar_wait(&m.ds_empty[db], (tile / 2 - 1) & 1);
        put_ds(m.sDs + db * K::kDs, dsf, own, t);
        fence_async_smem();
        mbar_arrive(&m.ds_full[db]);
        wgmma_wait<0>();
        fence_operand(dv);
        fence_operand(dk);
        fence_frags(pf);
        fence_frags(dsf);
        mbar_arrive(&m.empty[st]);
      }
      mbar_arrive(m.own_empty);  // K and V are read for the last time
    }
    __nv_bfloat16* out = dqkv + (int64_t)b * m.S * ld + h * HD;
    store_head<HD>(out + k_off, ld, dk, row_a, m.S, t);
    store_head<HD>(out + v_off, ld, dv, row_a, m.S, t);
  }
}

// The dQ warpgroup of the key-outer kernel: per streamed tile of an active
// item, its dQ partial over the block's 128 keys (dq_partial, from the
// consumers' dS^T buffer and the own K rows) a chunk at a time, so its
// accumulator is 32 registers, into a dQ buffer the writer warps take
// with its header; after the last item, a header that ends the writer.
template <int HD>
__device__ __forceinline__ void kv_dq(const KvShared& m) {
  using T = BwdTiles<1, HD>;
  using K = KvTiles<HD>;
  constexpr int kB = K::kDqBufs;
  const int row = (threadIdx.x % 128) / 32 * 16 + ((threadIdx.x & 31) >> 2);
  const int t = threadIdx.x & 3;
  const bool lead = threadIdx.x % 128 == 0;
  int tile = 0;
  for (int k = 0;; ++k) {
    mbar_wait(&m.item_full[k % 2], (k / 2) & 1);
    const int item = m.slot[k % 2];
    mbar_arrive(&m.item_empty[k % 2]);
    if (item < 0) break;
    if ((item % m.nk) * T::kRows >= m.valid_len) continue;
    for (int it = 0; it < m.nq; ++it, ++tile) {
      const int db = tile % 2, qb = tile % kB;
      float* dst = m.sDq + qb * (K::kDq / 4);
      mbar_wait(&m.ds_full[db], (tile / 2) & 1);
      if (tile >= kB) mbar_wait(&m.dq_empty[qb], (tile / kB - 1) & 1);
      float d0[Head<HD>::cols(0) / 2], d1[Head<HD>::cols(1) / 2];
      wgmma_fence();
      dq_partial<HD, 0>(d0, m.sDs + db * K::kDs, m.sK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(d0);
      store_cols<kTileCols>(dst, HD, d0, row, T::kWalk, t);
      wgmma_fence();
      dq_partial<HD, 1>(d1, m.sDs + db * K::kDs, m.sK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(d1);
      mbar_arrive(&m.ds_empty[db]);
      if (it + 1 == m.nq) mbar_arrive(m.own_empty);
      store_cols<Head<HD>::cols(1)>(dst + kTileCols, HD, d1, row, T::kWalk,
                                    t);
      if (lead) {
        m.hdr[2 * qb] = item;
        m.hdr[2 * qb + 1] = it;
      }
      fence_async_smem();
      mbar_arrive(&m.dq_full[qb]);
    }
  }
  const int qb = tile % kB;
  if (tile >= kB) mbar_wait(&m.dq_empty[qb], (tile / kB - 1) & 1);
  if (lead) m.hdr[2 * qb] = -1;  // no more partials
  mbar_arrive(&m.dq_full[qb]);
}

// The key-outer kernel: dK, dV and dQ of every (image, head, key block of
// 128 keys), an item each, taken in order from the atomic ticket at
// counters[B * H * nq] by a persistent grid of one block per SM. Per item
// the block's K and V rows stay in shared memory and the 64-query Q/dO
// tiles stream through the ring with their lse and dsum slices, as in
// kernel B; each tile's S^T and dP^T give bf16(P^T) for dV += P^T dO and
// bf16(dS^T) for dK += dS^T Q and for the tile's dQ partial dS K over the
// block's 128 keys: five S^2*hd products in all. The warpgroups (KvTiles):
// two consumers (S^T, dP^T, dV, dK; dS^T into shared memory), the dQ
// warpgroup (the partials) and the producer: the loader (warp 0: the
// tickets, then each active item's K and V and its Q/dO tiles) and the
// writer (warps 1-3), which sums the partials over the key blocks in their
// order in the fp32 workspace dq_acc [B, H, nq * 64, HD]: key block n of a
// head adds its partial of query tile m once the counter of (image, head,
// m) reads n, then counts it on to n + 1. Block 0 writes in place of
// adding; the last block below valid_len reads the sum, adds its own, and
// stores bf16 dQ (the head's HD columns, rows below S). Blocks wholly past
// valid_len store zero dK and dV, load nothing and are not in the chain.
template <int HD>
__global__ void __launch_bounds__(KvTiles<HD>::kThreads, 1)
attn_bwd_kv_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum,
                  __nv_bfloat16* __restrict__ dqkv, float* __restrict__ dq_acc,
                  int* __restrict__ counters, int S, int valid_len,
                  int heads, int batch, int64_t ld, int q_off, int k_off,
                  int v_off, float scale) {
  using T = BwdTiles<1, HD>;
  using K = KvTiles<HD>;
  constexpr int kN = T::kWalk;
  constexpr int kConsumers = 2 * 128, kReaders = kConsumers + 128;
  extern __shared__ uint8_t smem_raw[];
  KvShared m;
  m.sK = align_atom(smem_raw);  // [chunk][own keys][64]
  m.sV = m.sK + T::kOwnPlane;
  m.sQdO = m.sV + T::kOwnPlane;  // [stage]: Q's chunks, then dO's
  m.sDs = m.sQdO + K::kStages * T::kStageBytes;
  m.sDq = reinterpret_cast<float*>(m.sDs + 2 * K::kDs);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(m.sDq + K::kDqBufs * (K::kDq / 4));
  m.own_full = bars;
  m.own_empty = bars + 1;
  m.full = bars + 2;
  m.empty = m.full + K::kStages;
  m.item_full = m.empty + K::kStages;
  m.item_empty = m.item_full + 2;
  m.ds_full = m.item_empty + 2;
  m.ds_empty = m.ds_full + 2;
  m.dq_full = m.ds_empty + 2;
  m.dq_empty = m.dq_full + K::kDqBufs;
  // sRow[stage][0][kN]: lse of the tile's queries; [stage][1][kN]: dsum
  m.sRow = reinterpret_cast<float*>(bars + K::kBars);
  m.hdr = reinterpret_cast<int*>(m.sRow + K::kStages * 2 * kN);
  m.slot = m.hdr + 2 * K::kDqBufs;
  m.S = S;
  m.valid_len = valid_len;
  m.heads = heads;
  m.nk = (S + T::kRows - 1) / T::kRows;
  m.nq = (S + kN - 1) / kN;
  const int n_items = batch * heads * m.nk;
  if (threadIdx.x == 0) {
    mbar_init(m.own_full, 1);
    mbar_init(m.own_empty, kReaders);  // the consumers and the dQ warpgroup
    for (int s = 0; s < K::kStages; ++s) {
      mbar_init(&m.full[s], 32);  // the loader warp
      mbar_init(&m.empty[s], kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&m.item_full[s], 1);
      mbar_init(&m.item_empty[s], kReaders);
      mbar_init(&m.ds_full[s], kConsumers);
      mbar_init(&m.ds_empty[s], 128);
    }
    for (int s = 0; s < K::kDqBufs; ++s) {
      mbar_init(&m.dq_full[s], 128);  // the dQ warpgroup
      mbar_init(&m.dq_empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 3) {
    setmaxnreg_dec<K::kRegsProducer>();
    const int pw = (threadIdx.x - 3 * 128) / 32;
    const int lane = threadIdx.x & 31;
    if (pw == 0) {  // the loader
      int* ticket = counters + (int64_t)batch * heads * m.nq;
      const int bhs = batch * heads;
      int active = 0, tile = 0;
      for (int k = 0;; ++k) {
        int item = 0;
        if (lane == 0) item = atomicAdd(ticket, 1);
        item = __shfl_sync(0xffffffffu, item, 0);
        const bool done = item >= n_items;
        if (!done) {  // ticket -> (image * heads + head) * nk + key block
          const int g = item / (K::kHeadGroup * m.nk);
          const int r = item - g * K::kHeadGroup * m.nk;
          const int ge = min(K::kHeadGroup, bhs - g * K::kHeadGroup);
          item = (g * K::kHeadGroup + r % ge) * m.nk + r / ge;
        }
        if (lane == 0) {
          if (k >= 2) mbar_wait(&m.item_empty[k % 2], (k / 2 - 1) & 1);
          m.slot[k % 2] = done ? -1 : item;
          mbar_arrive(&m.item_full[k % 2]);
        }
        if (done) break;
        const int bh = item / m.nk, kv0 = (item % m.nk) * T::kRows;
        const int b = bh / heads, h = bh % heads;
        if (kv0 >= valid_len) continue;
        const int64_t lrow = (int64_t)bh * S;
        auto load_tile = [&](int it) {
          const int st = tile % K::kStages;
          if (tile >= K::kStages)
            mbar_wait(&m.empty[st], (tile / K::kStages - 1) & 1);
          float* rows = m.sRow + st * 2 * kN;
          for (int i = lane; i < kN; i += 32) {
            const int qr = it * kN + i;
            rows[i] = qr < S ? lse[lrow + qr] : INFINITY;
            rows[kN + i] = qr < S ? dsum[lrow + qr] : 0.f;
          }
          if (lane == 0) {
            mbar_arrive_expect_tx(&m.full[st], T::kStageBytes);
            load_walk<T>(m.sQdO + st * T::kStageBytes, &tq, &tdo, &m.full[st],
                         h * head_col<HD>(), it * kN, b, 0);
          } else {
            mbar_arrive(&m.full[st]);
          }
          ++tile;
        };
        // the item's first tiles go out before its K and V, which wait
        // for the previous item's last products
        const int pre = m.nq < K::kStages ? m.nq : K::kStages;
        for (int it = 0; it < pre; ++it) load_tile(it);
        if (lane == 0) {
          if (active > 0) mbar_wait(m.own_empty, (active - 1) & 1);
          mbar_arrive_expect_tx(m.own_full, T::kOwn);
          load_own<T>(m.sK, &tk, m.own_full, h * head_col<HD>(), kv0, b, 0);
          load_own<T>(m.sV, &tv, m.own_full, h * head_col<HD>(), kv0, b, 0);
        }
        ++active;
        for (int it = pre; it < m.nq; ++it) load_tile(it);
      }
    } else {  // the writer: the dQ partials in their order
      const int wt = threadIdx.x - (3 * 128 + 32);  // 0 .. 95
      const int n_act = (valid_len + T::kRows - 1) / T::kRows;
      constexpr int kVec = kN * HD / 4;  // float4s of a partial
      for (int s = 0;; ++s) {
        const int qb = s % K::kDqBufs;
        mbar_wait(&m.dq_full[qb], (s / K::kDqBufs) & 1);
        const int item = m.hdr[2 * qb], mq = m.hdr[2 * qb + 1];
        if (item < 0) break;
        const int bh = item / m.nk, n = item % m.nk;
        const bool first = n == 0, last = n == n_act - 1;
        int* cnt = counters + (int64_t)bh * m.nq + mq;
        float* acc = dq_acc + ((int64_t)bh * m.nq + mq) * (kN * HD);
        const float* src = m.sDq + qb * (K::kDq / 4);
        if (!first && wt == 0) {
          wait_counter(cnt, n);
          fence_async_global();
        }
        writer_sync();
        if (last) {  // the sum in bf16 into d(qkv)'s Q columns
          const int b = bh / heads, h = bh % heads;
          __nv_bfloat16* dst =
              dqkv + ((int64_t)b * S + mq * kN) * ld + q_off + h * HD;
          for (int i = wt; i < kVec; i += 96) {
            const int r = 4 * i / HD, c = 4 * i % HD;
            if (mq * kN + r >= S) continue;
            float4 v = reinterpret_cast<const float4*>(src)[i];
            if (!first) {
              const float4 a =
                  __ldcg(reinterpret_cast<const float4*>(acc) + i);
              v = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
            }
            uint2 o;
            o.x = pack_f32(v.x, v.y);
            o.y = pack_f32(v.z, v.w);
            *reinterpret_cast<uint2*>(dst + (int64_t)r * ld + c) = o;
          }
          writer_sync();
          if (wt == 0) mbar_arrive(&m.dq_empty[qb]);
        } else if (wt == 0) {
          if (first)
            bulk_to_global<false>(acc, src, K::kDq, &m.dq_empty[qb]);
          else
            bulk_to_global<true>(acc, src, K::kDq, &m.dq_empty[qb]);
          fence_async_global();
          release_counter(cnt);
        }
      }
    }
  } else if (wg == 2) {
    setmaxnreg_dec<K::kRegsDq>();
    kv_dq<HD>(m);
  } else {
    setmaxnreg_inc<K::kRegsConsumer>();
    kv_consumer<HD>(m, wg, dqkv, ld, k_off, v_off, scale);
  }
}

// bf16 at head dim 88 or 104: the dsum pre-pass, then the key-outer kernel
// on a persistent grid; dq_acc and counters are the wrapper's workspace
// (aaclip_attention_packed_bwd_workspace), any contents: the pre-pass
// zeroes the counters (the chains', then the ticket).
template <int HD>
int launch_key_outer(int batch, int seq, int heads, cudaStream_t st,
                     const void* qkv, const void* dout, const float* lse,
                     float* dsum, void* dqkv, float* dq_acc, int* counters,
                     int valid_len, int64_t ld, int q_off, int k_off,
                     int v_off, int64_t do_ld, float scale) {
  using T = BwdTiles<1, HD>;
  using K = KvTiles<HD>;
  CUtensorMap maps[4];  // q, k, v, dO
  if (const int err = bwd_maps<T, HD>(maps, qkv, dout, batch, seq, heads, ld,
                                      q_off, k_off, v_off, do_ld))
    return err;
  if (dq_acc == nullptr || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = smem_attribute_once(
      reinterpret_cast<const void*>(attn_bwd_dsum_wgmma<HD>), T::kDqSmem);
  if (err == cudaSuccess)
    err = smem_attribute_once(
        reinterpret_cast<const void*>(attn_bwd_kv_wgmma<HD>), K::kSmem);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + T::kRows - 1) / T::kRows, heads, batch);
  attn_bwd_dsum_wgmma<HD><<<grid, T::kThreads, T::kDqSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dsum, counters, seq,
      valid_len, scale);
  note_launch();
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int items = batch * heads * ((seq + T::kRows - 1) / T::kRows);
  const int blocks = items < sms ? items : sms;  // persistent: one per SM
  attn_bwd_kv_wgmma<HD><<<blocks, K::kThreads, K::kSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse, dsum,
      static_cast<__nv_bfloat16*>(dqkv), dq_acc, counters, seq, valid_len,
      heads, batch, ld, q_off, k_off, v_off, scale);
  note_launch();
  return static_cast<int>(cudaGetLastError());
}

// ------------------------ fp32 at hd 64, 80, 88, 104, 128: 6-pass, 3-pass

// The plane pairs: fp32 on the bf16 planes of qkv and dO (attention_packed.
// cu's split kernels), attn_bwd_{dq,dkdv}_6pass<HD> (kP 3, precision
// "highest" or None) and attn_bwd_{dq,dkdv}_3pass_wgmma<HD> (kP 2,
// precision "high": _kdot's hi.hi + hi.lo + lo.hi on hi and lo = bf16(x -
// hi), passes 3-5 of the 6-pass table). The layout of the wgmma pair with
// kP planes of every tile (BwdTiles<kP, HD>). Every product is one wgmma
// chain per pass, smallest first (mma_planes_ss, mma_planes_rs;
// hopper_common.cuh); P = exp(s - lse) and dS = P * (dP - dsum) * scale
// stay fp32 and are split in registers into kP planes; dO is consumed in
// fp32 (the TPU kernel's do.astype(v.dtype)). A gradient sums its tiles in
// fp32 registers: each tile's product into a head chunk goes into its own
// accumulator first, so the tensor cores' chains stay one tile's k-steps
// per pass long. What bounds the 3-pass pair at head dim 64: the TPU
// kernel's five products in three bf16 passes, 461.5 GFLOP at [8, 1370,
// 3072] (0.466 ms at 989 TFLOP/s); the pair's nine, 830.3 (0.840 ms).

// fp32 P of score s[4j + i] from the logsumexp, as the FMA kernels take
// it (precise expf); keys at or past valid_len get 0 when kMask.
template <bool kMask, int N>
__device__ __forceinline__ float prob_f32(const float (&s)[N], int j, int i,
                                          int k0, int valid_len, float scale,
                                          const float (&lse_r)[2], int t) {
  const bool keep = !kMask || k0 + j * 8 + t * 2 + (i & 1) < valid_len;
  return keep ? expf(__fmul_rn(s[4 * j + i], scale) - lse_r[i >> 1]) : 0.f;
}

// Walk 1 of the plane kernel A: ds_row += rowsum(dP * P) over one tile.
template <bool kMask, int N>
__device__ __forceinline__ void dsum_tile_f32(const float (&s)[N],
                                              const float (&dp)[N],
                                              float (&ds_row)[2], int k0,
                                              int valid_len, float scale,
                                              const float (&lse_r)[2],
                                              int t) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ds_row[i >> 1] += dp[4 * j + i] * prob_f32<kMask>(s, j, i, k0,
                                                        valid_len, scale,
                                                        lse_r, t);
}

// Walk 2 of the plane kernel A: dS = P * (dP - dsum) * scale of one tile
// in fp32, written over the scores s (so dP's registers are free before
// the fragments are built), then as the A fragments of its kP planes.
template <bool kMask, int kP, int N>
__device__ __forceinline__ void ds_tile_planes(float (&s)[N],
                                               const float (&dp)[N],
                                               uint32_t (&f)[kP][N / 8][4],
                                               const float (&ds_row)[2],
                                               int k0, int valid_len,
                                               float scale,
                                               const float (&lse_r)[2],
                                               int t) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[4 * j + i] =
          prob_f32<kMask>(s, j, i, k0, valid_len, scale, lse_r, t) *
          (dp[4 * j + i] - ds_row[i >> 1]) * scale;
  split_frags<kP>(f, s);
}

// d[0 .. kN / 2) += v: one chunk's product of a tile into a gradient.
template <int kN>
__device__ __forceinline__ void add_acc(float* d, const float (&v)[32]) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) d[i] += v[i];
}

// acc_head += A . B into a head of HD columns on kP planes, a chunk at a
// time: each chunk's product of the tile into acc (mma_planes_rs, A the
// fragments f of its planes, B the tile's planes read MN-major, b_plane
// bytes apart, chunks b_chunk apart), waited for and added; the caller's
// `release` runs once the last chunk's product has read f and the tile.
template <int kP, int HD, int kKK, typename Release>
__device__ __forceinline__ void planes_into_head(
    float (&acc_head)[HD / 2], float (&acc)[32],
    uint32_t (&f)[kP][kKK][4], uint64_t b, int b_plane, int b_chunk,
    Release release) {
  wgmma_fence();
  mma_planes_rs<kP>(acc, f, b, b_plane);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(acc);
  if constexpr (Head<HD>::kChunks == 1) {
    fence_planes<kP>(f);
    release();
  }
  add_acc<kTileCols>(acc_head, acc);
  if constexpr (Head<HD>::kChunks == 2) {
    // a full second chunk reuses acc; the 16, 24 or 40 columns at head
    // dims 80, 88, 104 get an accumulator of their own: written into acc's
    // first registers, the 16 at 80 made ptxas serialize the 3-pass kernel
    // A's products (C7511), and in the forward a shared one ran the 6-pass
    // kernel 1.30x slower at 104
    constexpr int kN1 = Head<HD>::cols(1);
    if constexpr (kN1 == kTileCols) {
      wgmma_fence();
      mma_planes_rs<kP>(acc, f, desc_plus(b, b_chunk), b_plane);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
      fence_planes<kP>(f);
      release();
      add_acc<kN1>(acc_head + 32, acc);
    } else {
      float acc16[kN1 / 2];
      wgmma_fence();
      mma_planes_rs<kP, kN1>(acc16, f, desc_plus(b, b_chunk), b_plane);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc16);
      fence_planes<kP>(f);
      release();
#pragma unroll
      for (int i = 0; i < kN1 / 2; ++i) acc_head[32 + i] += acc16[i];
    }
  }
}

// Kernel A on kP planes: walk 1 sums dsum = rowsum(dP * P); walk 2
// recomputes S and dP and accumulates dQ += dS K. Each consumer waits for
// its own products, the other consumer's running meanwhile (at head dim
// 64; above 64 a block has one consumer): issuing tile it + 1's S and
// dP before tile it's rowsum, as the bf16 kernel does, needs a second set
// of accumulators, and ptxas then spilled and serialized the 6-pass
// kernel's wgmma at head dim 64 (C7512), which cost more time than the
// overlap saved.
template <int kP, int HD>
__device__ __forceinline__ void bwd_dq_planes(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ lse,
    float* __restrict__ dsum, float* __restrict__ dqkv, int S, int valid_len,
    int64_t ld, int q_off, int pz, float scale) {
  using T = BwdTiles<kP, HD>;
  using H = Head<HD>;
  constexpr int kN = T::kWalk, kKK = kN / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align_atom(smem_raw);  // [plane][chunk][own rows][64]
  uint8_t* sdO = sQ + kP * T::kOwnPlane;
  uint8_t* sKV = sdO + kP * T::kOwnPlane;
  // stage st: K plane p, chunk c at sKV + st * T::kStageBytes + p *
  // T::kWalkPlane + c * T::kBox, the V planes kP * T::kWalkPlane further
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sKV + T::kStages * T::kStageBytes);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + T::kStages;

  const int q0 = blockIdx.x * T::kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = h * HD;
  const int n = (valid_len + kN - 1) / kN;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::kWgs * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == T::kWgs) {  // producer: Q and dO once, then K/V tiles twice
    producer_regs<T>();
    if (threadIdx.x == T::kWgs * 128) {
      mbar_arrive_expect_tx(own_full, T::kOwn);
      load_own<T>(sQ, &tq, own_full, h * head_col<HD>(), q0, b, pz);
      load_own<T>(sdO, &tdo, own_full, h * head_col<HD>(), q0, b, pz);
      for (int it = 0; it < 2 * n; ++it) {
        const int st = it % T::kStages;
        if (it >= T::kStages)
          mbar_wait(&empty[st], (it / T::kStages - 1) & 1);
        mbar_arrive_expect_tx(&full[st], T::kStageBytes);
        load_walk<T>(sKV + st * T::kStageBytes, &tk, &tv, &full[st],
                     h * head_col<HD>(), (it % n) * kN, b, pz);
      }
    }
  } else {
    consumer_regs<T>();
    const int warp = (threadIdx.x % 128) / 32;
    const int g = (threadIdx.x & 31) >> 2;
    const int t = threadIdx.x & 3;
    const int row_a = q0 + wg * kWgRows + warp * 16 + g;
    const int64_t lrow = ((int64_t)b * gridDim.y + h) * S;
    const float lse_r[2] = {row_a < S ? lse[lrow + row_a] : INFINITY,
                            row_a + 8 < S ? lse[lrow + row_a + 8] : INFINITY};
    const uint64_t dq_desc = sw128_desc(sQ + wg * kWgRows * kRowBytes);
    const uint64_t ddo_desc = sw128_desc(sdO + wg * kWgRows * kRowBytes);
    mbar_wait(own_full, 0);

    // S = Q K^T and dP = dO V^T of tile it, as one wgmma group
    auto issue = [&](float (&s)[kN / 2], float (&dp)[kN / 2], int it) {
      const int st = it % T::kStages;
      mbar_wait(&full[st], (it / T::kStages) & 1);
      const uint8_t* tile = sKV + st * T::kStageBytes;
      wgmma_fence();
      mma_planes_ss<kP, H::kKSteps, kN>(s, dq_desc, T::kOwnPlane,
                                        sw128_desc(tile), T::kWalkPlane,
                                        T::kOwnChunk, T::kBox);
      mma_planes_ss<kP, H::kKSteps, kN>(
          dp, ddo_desc, T::kOwnPlane,
          sw128_desc(tile + kP * T::kWalkPlane), T::kWalkPlane, T::kOwnChunk,
          T::kBox);
      wgmma_commit();
    };

    // walk 1: dsum = rowsum(dP * P)
    float ds_row[2] = {0.f, 0.f};
    float s[kN / 2], dp[kN / 2];
    for (int it = 0; it < n; ++it) {
      issue(s, dp, it);
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);
      mbar_arrive(&empty[it % T::kStages]);
      const int k0 = it * kN;
      if (k0 + kN <= valid_len)
        dsum_tile_f32<false>(s, dp, ds_row, k0, valid_len, scale, lse_r, t);
      else
        dsum_tile_f32<true>(s, dp, ds_row, k0, valid_len, scale, lse_r, t);
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

    // walk 2: dQ = dS K, each tile's product of a chunk in qt, summed into
    // dq
    float dq[H::kRegs], qt[32];
#pragma unroll
    for (int i = 0; i < H::kRegs; ++i) dq[i] = 0.f;
    uint32_t dsf[kP][kKK][4];
    for (int it = n; it < 2 * n; ++it) {
      const int st = it % T::kStages;
      issue(s, dp, it);
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);
      const int k0 = (it - n) * kN;
      if (k0 + kN <= valid_len)
        ds_tile_planes<false, kP>(s, dp, dsf, ds_row, k0, valid_len, scale,
                                  lse_r, t);
      else
        ds_tile_planes<true, kP>(s, dp, dsf, ds_row, k0, valid_len, scale,
                                 lse_r, t);
      planes_into_head<kP, HD>(dq, qt, dsf,
                               sw128_desc(sKV + st * T::kStageBytes),
                               T::kWalkPlane, T::kBox,
                               [&] { mbar_arrive(&empty[st]); });
    }
    store_head<HD>(dqkv + (int64_t)b * S * ld + q_off + col, ld, dq, row_a,
                   S, t);
  }
}

// Kernel B on kP planes: the block's K and V rows against every Q/dO
// tile; P^T and dS^T split in registers for dV += P^T dO and dK += dS^T Q,
// each tile's product of a chunk in one accumulator, summed into dv and dk.
template <int kP, int HD>
__device__ __forceinline__ void bwd_dkdv_planes(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    const CUtensorMap& tdo, const float* __restrict__ lse,
    const float* __restrict__ dsum, float* __restrict__ dqkv, int S,
    int valid_len, int64_t ld, int k_off, int v_off, int pz, float scale) {
  using T = BwdTiles<kP, HD>;
  using H = Head<HD>;
  constexpr int kN = T::kWalk, kKK = kN / 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align_atom(smem_raw);  // [plane][chunk][own keys][64]
  uint8_t* sV = sK + kP * T::kOwnPlane;
  uint8_t* sQdO = sV + kP * T::kOwnPlane;
  // stage st: Q plane p, chunk c at sQdO + st * T::kStageBytes + p *
  // T::kWalkPlane + c * T::kBox, the dO planes kP * T::kWalkPlane further
  float* sRow = reinterpret_cast<float*>(sQdO + T::kStages * T::kStageBytes);
  // sRow[stage][0][kN]: lse of the tile's queries; [stage][1][kN]: dsum
  uint64_t* bars = reinterpret_cast<uint64_t*>(sRow + T::kStages * 2 * kN);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + T::kStages;

  const int kv0 = blockIdx.x * T::kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = h * HD;
  const int nq = (S + kN - 1) / kN;
  const bool active = kv0 < valid_len;  // else zero gradients, no loads
  const int64_t lrow = ((int64_t)b * gridDim.y + h) * S;
  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp
      mbar_init(&empty[s], T::kWgs * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == T::kWgs) {  // producer warp: K and V once, then Q/dO tiles
    producer_regs<T>();
    const int lane = threadIdx.x - T::kWgs * 128;
    if (lane < 32 && active) {
      if (lane == 0) {
        mbar_arrive_expect_tx(own_full, T::kOwn);
        load_own<T>(sK, &tk, own_full, h * head_col<HD>(), kv0, b, pz);
        load_own<T>(sV, &tv, own_full, h * head_col<HD>(), kv0, b, pz);
      }
      for (int it = 0; it < nq; ++it) {
        const int st = it % T::kStages;
        if (it >= T::kStages)
          mbar_wait(&empty[st], (it / T::kStages - 1) & 1);
        float* rows = sRow + st * 2 * kN;
        for (int i = lane; i < kN; i += 32) {
          const int qr = it * kN + i;
          rows[i] = qr < S ? lse[lrow + qr] : INFINITY;
          rows[kN + i] = qr < S ? dsum[lrow + qr] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[st], T::kStageBytes);
          load_walk<T>(sQdO + st * T::kStageBytes, &tq, &tdo, &full[st],
                       h * head_col<HD>(), it * kN, b, pz);
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    consumer_regs<T>();
    const int warp = (threadIdx.x % 128) / 32;
    const int g = (threadIdx.x & 31) >> 2;
    const int t = threadIdx.x & 3;
    const int row_a = kv0 + wg * kWgRows + warp * 16 + g;
    float dk[H::kRegs], dv[H::kRegs];
#pragma unroll
    for (int i = 0; i < H::kRegs; ++i) dk[i] = dv[i] = 0.f;
    if (active) {
      const bool keep_r[2] = {row_a < valid_len, row_a + 8 < valid_len};
      const uint64_t dk_desc = sw128_desc(sK + wg * kWgRows * kRowBytes);
      const uint64_t dv_desc = sw128_desc(sV + wg * kWgRows * kRowBytes);
      mbar_wait(own_full, 0);
      // S^T, dP^T: [64 keys x kN queries]; a chunk's product of the tile
      float s[kN / 2], dp[kN / 2], acc[32];
      uint32_t f[kP][kKK][4];  // P^T's planes, then dS^T's
      for (int it = 0; it < nq; ++it) {
        const int st = it % T::kStages;
        mbar_wait(&full[st], (it / T::kStages) & 1);
        const uint8_t* tile = sQdO + st * T::kStageBytes;
        const uint64_t q_desc = sw128_desc(tile);
        const uint64_t do_desc = sw128_desc(tile + kP * T::kWalkPlane);
        wgmma_fence();
        mma_planes_ss<kP, H::kKSteps, kN>(s, dk_desc, T::kOwnPlane, q_desc,
                                          T::kWalkPlane, T::kOwnChunk,
                                          T::kBox);
        mma_planes_ss<kP, H::kKSteps, kN>(dp, dv_desc, T::kOwnPlane, do_desc,
                                          T::kWalkPlane, T::kOwnChunk,
                                          T::kBox);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(s);
        fence_operand(dp);
        const float* rows = sRow + st * 2 * kN;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = j * 8 + t * 2 + (i & 1);
            const float p =
                keep_r[i >> 1]
                    ? expf(__fmul_rn(s[4 * j + i], scale) - rows[c])
                    : 0.f;
            s[4 * j + i] = p;
            dp[4 * j + i] = p * (dp[4 * j + i] - rows[kN + c]) * scale;
          }
        split_frags<kP>(f, s);  // P^T
        planes_into_head<kP, HD>(dv, acc, f, do_desc, T::kWalkPlane, T::kBox,
                                 [] {});
        split_frags<kP>(f, dp);  // dS^T
        planes_into_head<kP, HD>(dk, acc, f, q_desc, T::kWalkPlane, T::kBox,
                                 [&] { mbar_arrive(&empty[st]); });
      }
    }
    float* out = dqkv + (int64_t)b * S * ld + col;
    store_head<HD>(out + k_off, ld, dk, row_a, S, t);
    store_head<HD>(out + v_off, ld, dv, row_a, S, t);
  }
}

template <int HD>
__global__ void __launch_bounds__(BwdTiles<kPlanes, HD>::kThreads, 1)
attn_bwd_dq_6pass(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, float* __restrict__ dsum,
                  float* __restrict__ dqkv, int S, int valid_len, int64_t ld,
                  int q_off, int pz, float scale) {
  bwd_dq_planes<kPlanes, HD>(tq, tk, tv, tdo, lse, dsum, dqkv, S, valid_len,
                             ld, q_off, pz, scale);
}

template <int HD>
__global__ void __launch_bounds__(BwdTiles<kPlanes, HD>::kThreads, 1)
attn_bwd_dkdv_6pass(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    float* __restrict__ dqkv, int S, int valid_len,
                    int64_t ld, int k_off, int v_off, int pz, float scale) {
  bwd_dkdv_planes<kPlanes, HD>(tq, tk, tv, tdo, lse, dsum, dqkv, S,
                               valid_len, ld, k_off, v_off, pz, scale);
}

template <int HD>
__global__ void __launch_bounds__(BwdTiles<2, HD>::kThreads, 1)
attn_bwd_dq_3pass_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        float* __restrict__ dsum, float* __restrict__ dqkv,
                        int S, int valid_len, int64_t ld, int q_off, int pz,
                        float scale) {
  bwd_dq_planes<2, HD>(tq, tk, tv, tdo, lse, dsum, dqkv, S, valid_len, ld,
                       q_off, pz, scale);
}

template <int HD>
__global__ void __launch_bounds__(BwdTiles<2, HD>::kThreads, 1)
attn_bwd_dkdv_3pass_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          float* __restrict__ dqkv, int S, int valid_len,
                          int64_t ld, int k_off, int v_off, int pz,
                          float scale) {
  bwd_dkdv_planes<2, HD>(tq, tk, tv, tdo, lse, dsum, dqkv, S, valid_len, ld,
                         k_off, v_off, pz, scale);
}

// A plane pair at head dim HD on the kP bf16 planes of qkv and dO (plane
// strides batch * seq * ld and batch * seq * do_ld elements), into fp32
// dqkv.
template <int kP, int HD>
int launch_planes(int batch, int seq, int heads, cudaStream_t st,
                  const void* qkv, const void* dout, const float* lse,
                  float* dsum, float* dqkv, int valid_len, int64_t ld,
                  int q_off, int k_off, int v_off, int64_t do_ld,
                  float scale) {
  using T = BwdTiles<kP, HD>;
  CUtensorMap maps[4];  // q, k, v, dO over every plane
  if (const int err = bwd_maps<T, HD>(maps, qkv, dout, batch, seq, heads, ld,
                                      q_off, k_off, v_off, do_ld))
    return err;
  const void* dq_fn =
      kP == kPlanes ? reinterpret_cast<const void*>(attn_bwd_dq_6pass<HD>)
                    : reinterpret_cast<const void*>(
                          attn_bwd_dq_3pass_wgmma<HD>);
  const void* dkdv_fn =
      kP == kPlanes
          ? reinterpret_cast<const void*>(attn_bwd_dkdv_6pass<HD>)
          : reinterpret_cast<const void*>(attn_bwd_dkdv_3pass_wgmma<HD>);
  cudaError_t err = smem_attribute_once(dq_fn, T::kDqSmem);
  if (err == cudaSuccess) err = smem_attribute_once(dkdv_fn, T::kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + T::kRows - 1) / T::kRows, heads, batch);
  if constexpr (kP == kPlanes) {
    attn_bwd_dq_6pass<HD><<<grid, T::kThreads, T::kDqSmem, st>>>(
        maps[0], maps[1], maps[2], maps[3], lse, dsum, dqkv, seq, valid_len,
        ld, q_off, batch, scale);
    note_launch();
  } else {
    attn_bwd_dq_3pass_wgmma<HD><<<grid, T::kThreads, T::kDqSmem, st>>>(
        maps[0], maps[1], maps[2], maps[3], lse, dsum, dqkv, seq, valid_len,
        ld, q_off, batch, scale);
    note_launch();
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kP == kPlanes) {
    attn_bwd_dkdv_6pass<HD><<<grid, T::kThreads, T::kDkdvSmem, st>>>(
        maps[0], maps[1], maps[2], maps[3], lse, dsum, dqkv, seq, valid_len,
        ld, k_off, v_off, batch, scale);
    note_launch();
  } else {
    attn_bwd_dkdv_3pass_wgmma<HD><<<grid, T::kThreads, T::kDkdvSmem, st>>>(
        maps[0], maps[1], maps[2], maps[3], lse, dsum, dqkv, seq, valid_len,
        ld, k_off, v_off, batch, scale);
    note_launch();
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ the retained routes

// The mma.sync (BF16) or fp32 FMA pair at head dim HD.
template <int HD, bool BF16>
int launch_retained(int batch, int seq, int heads, cudaStream_t st,
                    const void* qkv, const void* dout, const float* lse,
                    float* dsum, void* dqkv, int valid_len, int64_t ld,
                    int q_off, int k_off, int v_off, int64_t do_ld,
                    float scale) {
  if constexpr (BF16) {
    const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
    using T = __nv_bfloat16;
    attn_bwd_dq_bf16<HD><<<grid, 128, 0, st>>>(
        static_cast<const T*>(qkv), static_cast<const T*>(dout), lse, dsum,
        static_cast<T*>(dqkv), seq, valid_len, ld, q_off, k_off, v_off, do_ld,
        scale);
    note_launch();
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkdv_bf16<HD><<<grid, 128, 0, st>>>(
        static_cast<const T*>(qkv), static_cast<const T*>(dout), lse, dsum,
        static_cast<T*>(dqkv), seq, valid_len, ld, q_off, k_off, v_off, do_ld,
        scale);
    note_launch();
  } else {
    const dim3 grid((seq + kRowsF - 1) / kRowsF, heads, batch);
    attn_bwd_dq_f32<HD><<<grid, kRowsF * kSplitF, 0, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout), lse,
        dsum, static_cast<float*>(dqkv), seq, valid_len, ld, q_off, k_off,
        v_off, do_ld, scale);
    note_launch();
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkdv_f32<HD><<<grid, kRowsF * kSplitF, 0, st>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout), lse,
        dsum, static_cast<float*>(dqkv), seq, valid_len, ld, q_off, k_off,
        v_off, do_ld, scale);
    note_launch();
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ fp32, 3-pass ("high")

// The backward under the JAX package's precision "high" on fp32 inputs at
// head dim 16 (tiny-test; head dim 64 runs the plane pair above), as
// _packed_bwd_kernel computes it there: dO is consumed in fp32
// (do.astype(v.dtype)), P = exp(s - lse) and dS = P * (dP - dsum) * scale
// stay fp32 (the casts to the input dtype are no-ops), and each of the
// products S = Q K^T, dP = dO V^T, dV = P^T dO, dQ = dS K and dK = dS^T Q
// is _kdot's three bf16 products hi.hi + hi.lo + lo.hi of the operands'
// halves (mma3, mma_common.cuh) into one fp32 accumulator. The same two
// deterministic kernels as the retained mma.sync pair (64-row blocks of 4
// warps, 64-row tiles, walks 1 and 2 for dsum and dQ, then dK/dV key-outer;
// no atomics, every output written once), with every fp32 tile split into
// its bf16 hi and lo halves as it is staged into shared memory; the A
// fragments of the block's own rows are read from shared memory per
// k-step, not held, to leave registers to the accumulators. Outputs fp32.

constexpr int k3Tiles = 8;  // hi and lo of four [64, HD] tiles

constexpr int bwd_3pass_smem(int hd) {
  return k3Tiles * kTile * (hd + 8) * 2;
}

// P (masked, from lse) and dP, fp32, for one warp's 16 rows (r0, r0 + 8)
// against a 64-row tile: the A operands are rows of (ah, al) and (dah,
// dal), the B operands rows of (bh, bl) and (dbh, dbl), all hi/lo tiles in
// shared memory; `keep(i, col)` masks accumulator element i of tile column
// col, `lse_of(i, col)` gives its logsumexp.
template <int HD, typename Mask, typename Lse>
__device__ __forceinline__ void probs_and_dp_3pass(
    float (&p)[kTile / 8][4], float (&dp)[kTile / 8][4],
    const __nv_bfloat16* ah, const __nv_bfloat16* al,
    const __nv_bfloat16* dah, const __nv_bfloat16* dal,
    const __nv_bfloat16* bh, const __nv_bfloat16* bl,
    const __nv_bfloat16* dbh, const __nv_bfloat16* dbl, int r0, int g,
    int t, float scale, Mask keep, Lse lse_of) {
  constexpr int SLD = HD + 8;
  constexpr int NT = kTile / 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[nt][i] = dp[nt][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t fh[1][4], fl[1][4], dfh[1][4], dfl[1][4];
    load_a_frags<1, SLD>(fh, ah + ks * 16, r0, t);
    load_a_frags<1, SLD>(fl, al + ks * 16, r0, t);
    load_a_frags<1, SLD>(dfh, dah + ks * 16, r0, t);
    load_a_frags<1, SLD>(dfl, dal + ks * 16, r0, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mma3_bt<SLD>(p[nt], fh[0], fl[0], bh, bl, nt, ks, g, t);
      mma3_bt<SLD>(dp[nt], dfh[0], dfl[0], dbh, dbl, nt, ks, g, t);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = nt * 8 + t * 2 + (i & 1);
      p[nt][i] = keep(i, col)
                     ? expf(__fmul_rn(p[nt][i], scale) - lse_of(i, col))
                     : 0.f;
    }
}

// acc[nd] += V . B for C-layout fp32 values V [16 x 64] (split into hi and
// lo A fragments here) and B the row-major [64 x HD] tile (bh, bl).
template <int HD>
__device__ __forceinline__ void mma3_tile_rows(float (&acc)[HD / 8][4],
                                               const float (&v)[kTile / 8][4],
                                               const __nv_bfloat16* bh,
                                               const __nv_bfloat16* bl,
                                               int g, int t) {
  uint32_t fh[kTile / 16][4], fl[kTile / 16][4];
  split_a_frags<kTile / 8>(fh, fl, v);
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      mma3_b<HD + 8>(acc[nd], fh[kk], fl[kk], bh, bl, kk, nd, g, t);
}

template <int HD>
__device__ __forceinline__ void store_rows_f32(float* dst, int64_t ld,
                                               const float (&acc)[HD / 8][4],
                                               int row_a, int S, int t) {
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd) {
    if (row_a < S)
      *reinterpret_cast<float2*>(dst + (int64_t)row_a * ld + nd * 8 + t * 2) =
          make_float2(acc[nd][0], acc[nd][1]);
    if (row_a + 8 < S)
      *reinterpret_cast<float2*>(dst + (int64_t)(row_a + 8) * ld + nd * 8 +
                                 t * 2) = make_float2(acc[nd][2], acc[nd][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(128)
attn_bwd_dq_3pass(const float* __restrict__ qkv,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ dsum,
                  float* __restrict__ dqkv, int S, int valid_len, int64_t ld,
                  int q_off, int k_off, int v_off, int64_t do_ld,
                  float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int SLD = HD + 8;
  constexpr int NT = kTile / 8;
  constexpr int T = kTile * SLD;
  extern __shared__ __align__(16) uint8_t smem3_raw[];
  __nv_bfloat16* sQh = reinterpret_cast<__nv_bfloat16*>(smem3_raw);
  __nv_bfloat16 *sQl = sQh + T, *sdOh = sQl + T, *sdOl = sdOh + T;
  __nv_bfloat16 *sKh = sdOl + T, *sKl = sKh + T, *sVh = sKl + T,
                *sVl = sVh + T;

  const int q0 = blockIdx.x * kTile;
  const int hoff = blockIdx.y * HD;
  const int64_t img = blockIdx.z;
  const float* base = qkv + img * S * ld;
  const int64_t lrow = (img * gridDim.y + blockIdx.y) * S;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int r0 = warp * 16 + g;
  const int row_a = q0 + r0;

  load_split_tile<HD, SLD, kTile>(sQh, sQl, base + q_off + hoff, ld, q0, S);
  load_split_tile<HD, SLD, kTile>(sdOh, sdOl, dout + img * S * do_ld + hoff,
                                  do_ld, q0, S);
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
    load_split_tile<HD, SLD, kTile>(sKh, sKl, base + k_off + hoff, ld, k0,
                                    S);
    load_split_tile<HD, SLD, kTile>(sVh, sVl, base + v_off + hoff, ld, k0,
                                    S);
    __syncthreads();
    probs_and_dp_3pass<HD>(p, dp, sQh, sQl, sdOh, sdOl, sKh, sKl, sVh, sVl,
                           r0, g, t, scale,
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
    load_split_tile<HD, SLD, kTile>(sKh, sKl, base + k_off + hoff, ld, k0,
                                    S);
    load_split_tile<HD, SLD, kTile>(sVh, sVl, base + v_off + hoff, ld, k0,
                                    S);
    __syncthreads();
    probs_and_dp_3pass<HD>(p, dp, sQh, sQl, sdOh, sdOl, sKh, sKl, sVh, sVl,
                           r0, g, t, scale,
                           [&](int, int col) { return k0 + col < valid_len; },
                           lse_of);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[nt][i] = p[nt][i] * (dp[nt][i] - ds_row[i >> 1]) * scale;
    mma3_tile_rows<HD>(dq, p, sKh, sKl, g, t);
  }
  store_rows_f32<HD>(dqkv + img * S * ld + q_off + hoff, ld, dq, row_a, S,
                     t);
}

template <int HD>
__global__ void __launch_bounds__(128)
attn_bwd_dkdv_3pass(const float* __restrict__ qkv,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    float* __restrict__ dqkv, int S, int valid_len,
                    int64_t ld, int q_off, int k_off, int v_off,
                    int64_t do_ld, float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int SLD = HD + 8;
  constexpr int NT = kTile / 8;
  constexpr int T = kTile * SLD;
  extern __shared__ __align__(16) uint8_t smem3_raw[];
  __nv_bfloat16* sKh = reinterpret_cast<__nv_bfloat16*>(smem3_raw);
  __nv_bfloat16 *sKl = sKh + T, *sVh = sKl + T, *sVl = sVh + T;
  __nv_bfloat16 *sQh = sVl + T, *sQl = sQh + T, *sdOh = sQl + T,
                *sdOl = sdOh + T;
  __shared__ float sLse[kTile];
  __shared__ float sDsum[kTile];

  const int kv0 = blockIdx.x * kTile;
  const int hoff = blockIdx.y * HD;
  const int64_t img = blockIdx.z;
  const float* base = qkv + img * S * ld;
  const float* dob = dout + img * S * do_ld + hoff;
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
    load_split_tile<HD, SLD, kTile>(sKh, sKl, base + k_off + hoff, ld, kv0,
                                    S);
    load_split_tile<HD, SLD, kTile>(sVh, sVl, base + v_off + hoff, ld, kv0,
                                    S);
    const bool keep_r[2] = {row_a < valid_len, row_a + 8 < valid_len};
    float p[NT][4], dp[NT][4];
    for (int q0 = 0; q0 < S; q0 += kTile) {
      __syncthreads();
      load_split_tile<HD, SLD, kTile>(sQh, sQl, base + q_off + hoff, ld, q0,
                                      S);
      load_split_tile<HD, SLD, kTile>(sdOh, sdOl, dob, do_ld, q0, S);
      for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
        sLse[i] = q0 + i < S ? lse[lrow + q0 + i] : INFINITY;
        sDsum[i] = q0 + i < S ? dsum[lrow + q0 + i] : 0.f;
      }
      __syncthreads();
      // P^T and dP^T: rows are this block's keys, columns the tile's
      // queries
      probs_and_dp_3pass<HD>(p, dp, sKh, sKl, sVh, sVl, sQh, sQl, sdOh,
                             sdOl, r0, g, t, scale,
                             [&](int i, int) { return keep_r[i >> 1]; },
                             [&](int, int col) { return sLse[col]; });
      mma3_tile_rows<HD>(dv, p, sdOh, sdOl, g, t);  // P^T dO
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = nt * 8 + t * 2 + (i & 1);
          p[nt][i] = p[nt][i] * (dp[nt][i] - sDsum[col]) * scale;
        }
      mma3_tile_rows<HD>(dk, p, sQh, sQl, g, t);  // dS^T Q
    }
  }
  float* out = dqkv + img * S * ld;
  store_rows_f32<HD>(out + k_off + hoff, ld, dk, row_a, S, t);
  store_rows_f32<HD>(out + v_off + hoff, ld, dv, row_a, S, t);
}

// The 3-pass pair at head dim 16.
int launch_3pass(int batch, int seq, int heads, cudaStream_t st,
                 const float* qkv, const float* dout, const float* lse,
                 float* dsum, float* dqkv, int valid_len, int64_t ld,
                 int q_off, int k_off, int v_off, int64_t do_ld,
                 float scale) {
  constexpr int smem = bwd_3pass_smem(16);
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  attn_bwd_dq_3pass<16><<<grid, 128, smem, st>>>(
      qkv, dout, lse, dsum, dqkv, seq, valid_len, ld, q_off, k_off, v_off,
      do_ld, scale);
  note_launch();
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_dkdv_3pass<16><<<grid, 128, smem, st>>>(
      qkv, dout, lse, dsum, dqkv, seq, valid_len, ld, q_off, k_off, v_off,
      do_ld, scale);
  note_launch();
  return static_cast<int>(cudaGetLastError());
}

// A plane pair's entry at the TMA head dims; cudaErrorInvalidValue for
// another head dim.
template <int kP>
int launch_planes_at(int head_dim, int batch, int seq, int heads,
                     void* stream, const void* qkv_planes,
                     const void* do_planes, const float* lse, float* dsum,
                     float* d_qkv, int valid_len, long long ld, int q_off,
                     int k_off, int v_off, long long do_ld, float scale) {
  return by_head_dim(head_dim, [&](auto hd) {
    return launch_planes<kP, decltype(hd)::value>(
        batch, seq, heads, static_cast<cudaStream_t>(stream), qkv_planes,
        do_planes, lse, dsum, d_qkv, valid_len, ld, q_off, k_off, v_off,
        do_ld, scale);
  });
}

}  // namespace

// qkv and d_qkv: [batch, seq, ld] elements, the q/k/v sections of head h at
// column {q,k,v}_off + h * head_dim; d_out: [batch, seq, do_ld]; lse and
// the scratch dsum: [batch, heads, seq] fp32. bf16 at a TMA head dim (64,
// 80, 128) takes the wgmma pair attn_bwd_{dq,dkdv}_wgmma<HD>, at 88 and 104
// attn_bwd_dsum_wgmma<HD> and attn_bwd_kv_wgmma<HD>, whose workspace
// aaclip_attention_packed_bwd_workspace sizes: dq_acc and counters, any
// contents (null elsewhere: no other kernel reads them). The tensor maps need qkv, each
// section's start, d_out, the row strides ld * 2 and do_ld * 2 bytes and
// (at 88 and 104) the head's head_dim * 2 bytes to be multiples of
// kTmaAlign; fp32 there has its own entries
// (aaclip_attention_packed_bwd_6pass, _3pass_wgmma). Returns the CUDA error
// of the launches (0 on success); cudaErrorInvalidValue for a pair with no
// kernel here, an operand TMA cannot take or a missing workspace.
extern "C" int aaclip_attention_packed_bwd(
    const void* qkv, const void* d_out, const float* lse, float* dsum,
    void* d_qkv, float* dq_acc, int* counters, int bf16, int head_dim,
    int batch, int seq, int valid_len, int heads, long long ld, int q_off,
    int k_off, int v_off, long long do_ld, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && tma_head_dim(head_dim))
    return by_head_dim(head_dim, [&](auto hd) {
      constexpr int HD = decltype(hd)::value;
      if constexpr (key_outer_head_dim(HD))
        return launch_key_outer<HD>(batch, seq, heads, st, qkv, d_out, lse,
                                    dsum, d_qkv, dq_acc, counters, valid_len,
                                    ld, q_off, k_off, v_off, do_ld, scale);
      else
        return launch_wgmma<HD>(batch, seq, heads, st, qkv, d_out, lse, dsum,
                                d_qkv, valid_len, ld, q_off, k_off, v_off,
                                do_ld, scale);
    });
  if (bf16 && head_dim == 16)
    return launch_retained<16, true>(batch, seq, heads, st, qkv, d_out, lse,
                                     dsum, d_qkv, valid_len, ld, q_off, k_off,
                                     v_off, do_ld, scale);
  if (!bf16 && head_dim == 16)
    return launch_retained<16, false>(batch, seq, heads, st, qkv, d_out, lse,
                                      dsum, d_qkv, valid_len, ld, q_off,
                                      k_off, v_off, do_ld, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The workspace aaclip_attention_packed_bwd takes for bf16 (bf16 != 0) or
// fp32 operands at head_dim and seq: where the call runs the dsum pre-pass
// and the key-outer kernel (bf16 at key_outer_head_dim), the number nq of
// 64-row query tiles, ceil(seq / 64), for dq_acc [batch, heads, nq * 64,
// head_dim] fp32 and counters [batch * heads * nq + 1] int32; 0 where the
// call's kernels read no workspace (pass null pointers). The launch and
// this answer take the plan from the same key_outer_head_dim.
extern "C" int aaclip_attention_packed_bwd_workspace(int bf16, int head_dim,
                                                     int seq) {
  if (!bf16 || !key_outer_head_dim(head_dim)) return 0;
  return by_head_dim(head_dim, [&](auto hd) {
    constexpr int kN = BwdTiles<1, decltype(hd)::value>::kWalk;
    return (seq + kN - 1) / kN;
  });
}

// The 3-pass mode (fp32 under precision "high") of
// aaclip_attention_packed_bwd at head dim 16: the same operands in fp32,
// the lse of the forward's 3-pass mode, the mma.sync 3-pass pair;
// cudaErrorInvalidValue for another head dim (the TMA head dims have their
// own entry, aaclip_attention_packed_bwd_3pass_wgmma).
extern "C" int aaclip_attention_packed_bwd_3pass(
    const float* qkv, const float* d_out, const float* lse, float* dsum,
    float* d_qkv, int head_dim, int batch, int seq, int valid_len, int heads,
    long long ld, int q_off, int k_off, int v_off, long long do_ld,
    float scale, void* stream) {
  if (head_dim != 16) return static_cast<int>(cudaErrorInvalidValue);
  return launch_3pass(batch, seq, heads, static_cast<cudaStream_t>(stream),
                      qkv, d_out, lse, dsum, d_qkv, valid_len, ld, q_off,
                      k_off, v_off, do_ld, scale);
}

// The 6-pass route (fp32 at a TMA head dim under precision "highest" or
// None) of aaclip_attention_packed_bwd: qkv_planes and do_planes hold the
// bf16 planes hi, mid and lo of the fp32 qkv [batch, seq, ld] and dO
// [batch, seq, do_ld], one after the other (attention_packed.cu's
// aaclip_split3); the tensor maps need each section's start and the row
// strides ld * 2 and do_ld * 2 bytes to be multiples of kTmaAlign. d_qkv,
// lse and dsum as aaclip_attention_packed_bwd's, d_qkv in fp32.
// cudaErrorInvalidValue for another head dim.
extern "C" int aaclip_attention_packed_bwd_6pass(
    const void* qkv_planes, const void* do_planes, const float* lse,
    float* dsum, float* d_qkv, int head_dim, int batch, int seq,
    int valid_len, int heads, long long ld, int q_off, int k_off, int v_off,
    long long do_ld, float scale, void* stream) {
  return launch_planes_at<kPlanes>(head_dim, batch, seq, heads, stream,
                                   qkv_planes, do_planes, lse, dsum, d_qkv,
                                   valid_len, ld, q_off, k_off, v_off, do_ld,
                                   scale);
}

// The 3-pass route (fp32 at a TMA head dim under precision "high") of
// aaclip_attention_packed_bwd: qkv_planes and do_planes hold the bf16
// planes hi and lo of qkv and dO (attention_packed.cu's aaclip_split2),
// with the lse of the forward's 3-pass route; otherwise as the 6-pass
// entry.
extern "C" int aaclip_attention_packed_bwd_3pass_wgmma(
    const void* qkv_planes, const void* do_planes, const float* lse,
    float* dsum, float* d_qkv, int head_dim, int batch, int seq,
    int valid_len, int heads, long long ld, int q_off, int k_off, int v_off,
    long long do_ld, float scale, void* stream) {
  return launch_planes_at<2>(head_dim, batch, seq, heads, stream, qkv_planes,
                             do_planes, lse, dsum, d_qkv, valid_len, ld,
                             q_off, k_off, v_off, do_ld, scale);
}
