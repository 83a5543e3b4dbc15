// Hopper building blocks shared by the TMA + wgmma kernels (the attention
// forward and backward, the fused-block GEMM): mbarriers (with a bounded
// wait that traps instead of hanging), TMA tile loads into 128-byte-
// swizzled shared memory, the matching wgmma shared-memory descriptor, the
// warpgroup products (and the fp32 kernels' 6-pass and 3-pass products
// over bf16 planes), A fragments by ldmatrix, each kernel's shared-memory
// attribute set once per device, register hand-off between warpgroups,
// and the host-side tensor maps of a bf16 [depth, rows, cols] array and of
// the attention forward's heads (one head per map row, a 4-D map).
//
// The swizzle pairing, in one place. A tile row is 64 bf16 = 128 bytes.
// TMA with CU_TENSOR_MAP_SWIZZLE_128B writes row r of a tile at byte
// r * 128 with its eight 16-byte chunks permuted by chunk ^ (r % 8), which
// is exactly the canonical 128-byte-swizzle layout wgmma reads through a
// descriptor with layout type 1, the stride between 8-row groups (SBO) of
// 1024 bytes, and a tile base aligned to 1024 bytes (base offset 0). The
// same descriptor serves
//  - a K-major operand (the tile's 64 columns are the reduction: a head
//    dim, or 64 columns of a GEMM's K): its k-th 16-column slice starts
//    32 * k bytes into the row (inside the swizzle atom; the hardware
//    applies the permutation to the full address). ldmatrix reads the
//    same tile by hand: element (r, c) lies at r * 128 +
//    (((c / 8) ^ (r % 8)) * 16) + (c % 8) * 2;
//  - an MN-major operand (the tile's rows are the reduction, its 64
//    columns the output): its k-th 16-row slice starts 2048 * k bytes in,
//    and the 64 columns are exactly one swizzle atom, so the leading byte
//    offset is never used.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>
#include <utility>

namespace aaclip {

constexpr int kTmaAlign = 16;     // bytes: TMA base address and strides
constexpr int kTileCols = 64;     // bf16 columns of every TMA tile (128 B)
constexpr int kRowBytes = kTileCols * 2;
constexpr int kSwizzleAtom = 8 * kRowBytes;  // 1024 B: 8 rows of 128 B
// A wait that sees no progress for this long traps: a wrong phase or byte
// count becomes a launch failure, not a hung process.
constexpr unsigned long long kHangNs = 2000000000ull;
// Registers per thread of the kernels with two consumer warpgroups and a
// producer warpgroup (384 threads, one block per SM): the launch bound
// gives each thread 168; the producer drops to kProducerRegs and the
// consumers take what it frees (128 * 40 + 256 * 232 = 384 * 168).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After the initialising thread's mbar_init calls, before __syncthreads.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// This thread's arrival, and `bytes` more to come from TMA copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity` (the
// n-th completion has parity n & 1); traps after kHangNs without it. The
// retry loop is inside the asm, so the compiler sees no divergent branch
// while wgmma products are in flight (which would serialize them).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done, late;\n"
      ".reg .u64 t0, t1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra.uni WAIT_DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "WAIT_RETRY:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra.uni WAIT_DONE;\n"
      "mov.u64 t1, %%globaltimer;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 late, t1, %2;\n"
      "@late trap;\n"
      "bra.uni WAIT_RETRY;\n"
      "WAIT_DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity), "l"(kHangNs)
      : "memory");
}

// ---------------------------------------------------------------- TMA

// One box of the 3-D tensor map at (col, row, depth) into shared memory;
// its bytes complete on `bar`. Rows past the map's extent arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row,
                                            int depth) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(depth)
      : "memory");
}

// One box of the 4-D tensor map at (col, head, row, depth): the attention
// forward's per-head maps (make_head_map), whose columns end at the head,
// so a box's columns past the head dim arrive as zeros, as rows past the
// map's extent do.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int head,
                                            int row, int depth) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(head), "r"(row), "r"(depth)
      : "memory");
}

// ---------------------------------------------------------------- heads

// The attention kernels' head of HD columns (attention_packed.cu and
// attention_packed_bwd.cu, every TMA + wgmma route) as 64-column chunks,
// each a TMA box of its own at column 64 c of the head and one
// 128-byte-swizzled tile: one chunk at 64, two at 80, 88, 104 (64 + 16,
// 24, 40 columns used) and 128. A product over the head (Q K^T; the
// backward's S, dP and their transposes) runs ceil(HD / 16) k-steps,
// k-step ks 32 * (ks % 4) bytes into chunk ks / 4; a product into the
// head (P V; dQ, dK, dV) runs one product per chunk, m64n64 on a full
// chunk and m64nN on the first N columns of the last chunk below 128.
// kHeadMap: at 88 and 104 the last k-step overruns the head by 8 columns
// in both operands, so every operand comes through a per-head map
// (make_head_map), whose columns end at the head and read as zeros past
// it; at 64, 80 and 128 the k-steps end at the head and the operands come
// through section-wide maps (make_tile_map), whose columns past the head
// in a last chunk are the next head's and never enter a product.
template <int HD>
struct Head {
  static_assert(HD == 64 || HD == 80 || HD == 88 || HD == 104 || HD == 128,
                "the TMA + wgmma kernels take head dims 64, 80, 88, 104 and "
                "128");
  static constexpr int kChunks = (HD + kTileCols - 1) / kTileCols;
  static constexpr int kKSteps = (HD + 15) / 16;  // of a product over it
  static constexpr int kRegs = HD / 2;  // a chunked accumulator's registers
  static constexpr bool kHeadMap = HD % 16 != 0;
  // the columns of chunk c: 64, or 16, 24, 40 for the last one at head
  // dims 80, 88, 104
  __host__ __device__ static constexpr int cols(int c) {
    return c + 1 < kChunks ? kTileCols : HD - kTileCols * c;
  }
};

// A head's column step in its operands' tensor maps: head h's first
// column in a section-wide map is h * HD, its coordinate in a per-head
// one h.
template <int HD>
__host__ __device__ constexpr int head_col() {
  return Head<HD>::kHeadMap ? 1 : HD;
}

// Chunk c of head dim HD's operand at row `row` and depth `depth` into
// dst, its bytes completing on `bar`; `col` is h * head_col<HD>() (or 0
// where the map holds one head a row at depth h).
template <int HD>
__device__ __forceinline__ void tma_chunk(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int col, int c,
                                          int row, int depth) {
  if constexpr (Head<HD>::kHeadMap)
    tma_load_4d(dst, map, bar, c * kTileCols, col, row, depth);
  else
    tma_load_3d(dst, map, bar, col + c * kTileCols, row, depth);
}

// ---------------------------------------------------------------- wgmma

// Descriptor of a 128-byte-swizzled tile at `tile` (1024-byte aligned, or
// a slice of one as the header describes): SBO 1024 B, layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(kSwizzleAtom >> 4) << 32) | (1ull << 62);
}

// A descriptor moved `bytes` further into its tile.
__device__ __forceinline__ uint64_t desc_plus(uint64_t desc, int bytes) {
  return desc + static_cast<uint64_t>(bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep reads of an accumulator after the wgmma_wait that completes it.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keep the register A fragments of an asynchronous wgmma alive and
// unchanged up to here, after the wgmma_wait that completes it (the
// compiler sees the registers read when the wgmma is issued).
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[k][r])::"memory");
}

// Register hand-off between the producer and the consumer warpgroups
// (all four warps of a warpgroup execute it together).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The products, m64nNk16 bf16 -> fp32. Accumulator layout (thread t of the
// warpgroup, warp w = t / 32, g = (t % 32) / 4, q = t % 4): d[4j + 0..1]
// at row 16w + g, columns 8j + 2q + 0..1; d[4j + 2..3] at row 16w + g + 8.
// scale_d = 0 overwrites d, anything else accumulates.

// d[64 x 64] (+)= A . B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] (+)= A . B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 32] (+)= A . B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 16] (+)= A . B, A from registers (the m16k16 fragments of
// mma.sync, per warp), B from shared memory MN-major (transposed): the
// first 16 columns of a 64-column tile (two of the eight 16-byte chunks of
// each swizzled row, as a K-major k-step reads two of them).
__device__ __forceinline__ void wgmma_rs_n16_mn(float (&d)[8],
                                                const uint32_t (&a)[4],
                                                uint64_t db,
                                                int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64 x 24] (+)= A . B, A from registers, B from shared memory MN-major:
// the first 24 columns of a 64-column tile (three of each swizzled row's
// eight 16-byte chunks), the last chunk of head dim 88.
__device__ __forceinline__ void wgmma_rs_n24_mn(float (&d)[12],
                                                const uint32_t (&a)[4],
                                                uint64_t db,
                                                int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64 x 40] (+)= A . B, A from registers, B from shared memory MN-major:
// the first 40 columns of a 64-column tile (five 16-byte chunks of each
// swizzled row), the last chunk of head dim 104.
__device__ __forceinline__ void wgmma_rs_n40_mn(float (&d)[20],
                                                const uint32_t (&a)[4],
                                                uint64_t db,
                                                int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64 x 64] (+)= A . B, A from registers (the m16k16 fragments of
// mma.sync, per warp), B from shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db,
                                                 int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64 x 256] (+)= A . B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] (+)= A . B, A from registers (the m16k16 fragments of
// mma.sync, per warp), B from shared memory K-major.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[64 x 256] (+)= A . B, A from registers (the m16k16 fragments of
// mma.sync, per warp), B from shared memory K-major.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A . B, A and B K-major from shared memory, B kN rows: m64nNk16
// at N = 128, 64 or 32.
template <int kN>
__device__ __forceinline__ void wgmma_ss(float (&d)[kN / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (kN == 128) {
    wgmma_ss_n128(d, da, db, scale_d);
  } else if constexpr (kN == 64) {
    wgmma_ss_n64(d, da, db, scale_d);
  } else {
    static_assert(kN == 32, "B tiles of 32, 64 or 128 rows");
    wgmma_ss_n32(d, da, db, scale_d);
  }
}

// d (+)= A . B, A register fragments, B MN-major from shared memory, kN
// output columns (64, or the first 16, 24 or 40 of a tile: the last chunk
// of head dims 80, 88 and 104); d points at kN / 2 accumulators.
template <int kN>
__device__ __forceinline__ void wgmma_rs_mn(float* d, const uint32_t (&a)[4],
                                            uint64_t db, int scale_d = 1) {
  if constexpr (kN == 64) {
    wgmma_rs_n64_mn(*reinterpret_cast<float(*)[32]>(d), a, db, scale_d);
  } else if constexpr (kN == 40) {
    wgmma_rs_n40_mn(*reinterpret_cast<float(*)[20]>(d), a, db, scale_d);
  } else if constexpr (kN == 24) {
    wgmma_rs_n24_mn(*reinterpret_cast<float(*)[12]>(d), a, db, scale_d);
  } else {
    static_assert(kN == 16, "MN-major products of 64, 40, 24 or 16 columns");
    wgmma_rs_n16_mn(*reinterpret_cast<float(*)[8]>(d), a, db, scale_d);
  }
}

// ---------------------------------------------------------------- split passes
// The fp32 attention kernels' products over bf16 planes (mma_common.cuh,
// split3 and split_pack). Precision "highest" (the TPU's native 6-pass
// form): each operand is three planes hi, mid, lo (plane 0, 1, 2), and
// pass i (0-5) multiplies A's plane pass_a(i) by B's plane pass_b(i), all
// into one fp32 accumulator whose first product overwrites it. The passes
// run smallest first, mid.mid, hi.lo, lo.hi, hi.mid, mid.hi, and hi.hi
// last: the tensor cores' fp32 accumulation truncates each product's sum
// to the accumulator's precision, so the small passes, added while the
// accumulator is still about 2^-8 of its final size, cost next to nothing,
// and only hi.hi's four k-steps truncate at full size (adding hi.hi first
// left the kernels further from fp64 than chip_smoke.py's bar allows).
// Precision "high" (_kdot's 3-pass form, XLA's F32_AS_3BF16): two planes
// hi and lo, where lo = bf16(x - hi) is exactly the 6-pass split's mid, so
// its products hi.lo, lo.hi and hi.hi are passes 3, 4 and 5 of the same
// table, in the same smallest-first order. kP is the number of planes.
constexpr int kPlanes = 3;  // the 6-pass route's planes

__host__ __device__ constexpr int pass_a(int i) {
  return i == 0 || i == 4 ? 1 : i == 2 ? 2 : 0;
}

__host__ __device__ constexpr int pass_b(int i) {
  return i == 0 || i == 3 ? 1 : i == 1 ? 2 : 0;
}

// The first pass over kP planes: 0 of six on three, 3 of three on two.
template <int kP>
__host__ __device__ constexpr int first_pass() {
  static_assert(kP == 2 || kP == 3, "two or three bf16 planes");
  return kP == 3 ? 0 : 3;
}

// d = A . B^T in the passes of kP planes, over kKSteps k-steps of 16
// columns: one 64-column (128-byte) tile row at the default 4, and beyond
// it the next chunk's rows, `a_chunk` and `b_chunk` bytes on, every fourth
// step (the forward's head dims 80, 88, 104 and 128). A and B both K-major
// from shared memory, A's planes `a_plane` bytes apart, B's `b_plane`; B
// has kN rows.
template <int kP, int kKSteps = kTileCols / 16, int kN = 64>
__device__ __forceinline__ void mma_planes_ss(float (&d)[kN / 2], uint64_t a,
                                              int a_plane, uint64_t b,
                                              int b_plane, int a_chunk = 0,
                                              int b_chunk = 0) {
  constexpr int first = first_pass<kP>();
#pragma unroll
  for (int i = first; i < 6; ++i)
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks)
      wgmma_ss<kN>(d,
                   desc_plus(a, pass_a(i) * a_plane + (ks / 4) * a_chunk +
                                    32 * (ks % 4)),
                   desc_plus(b, pass_b(i) * b_plane + (ks / 4) * b_chunk +
                                    32 * (ks % 4)),
                   i - first + ks);
}

// d = A . B in the passes of kP planes over kKK k-steps of 16 rows: A the
// register fragments f[plane][k-step] of its planes, B a tile read
// MN-major (its rows are the reduction) into kN output columns (64, or
// the first 16, 24 or 40), planes `b_plane` bytes apart; d points at kN / 2
// accumulators.
template <int kP, int kN = 64, int kKK>
__device__ __forceinline__ void mma_planes_rs(float* d,
                                              const uint32_t (&f)[kP][kKK][4],
                                              uint64_t b, int b_plane) {
  constexpr int first = first_pass<kP>();
#pragma unroll
  for (int i = first; i < 6; ++i)
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk)
      wgmma_rs_mn<kN>(d, f[pass_a(i)][kk],
                      desc_plus(b, pass_b(i) * b_plane +
                                       16 * kRowBytes * kk),
                      i - first + kk);
}

// Keep every plane's fragments alive up to here (fence_frags).
template <int kP, int KK>
__device__ __forceinline__ void fence_planes(uint32_t (&f)[kP][KK][4]) {
#pragma unroll
  for (int p = 0; p < kP; ++p) fence_frags(f[p]);
}

// The m16k16 A fragments of mma.sync (and of a register-A wgmma) for one
// warp, read from shared memory: lane l gives the address of row
// (l % 8) + 8 * ((l / 8) % 2), 16-byte column chunk l / 16, of the warp's
// 16-row slice (matrices: rows 0-7 / 8-15 x columns 0-7 / 8-15).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// Dynamic shared memory rounded up to the swizzle atom.
__device__ __forceinline__ uint8_t* align_atom(uint8_t* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return reinterpret_cast<uint8_t*>((a + kSwizzleAtom - 1) &
                                    ~static_cast<uintptr_t>(kSwizzleAtom - 1));
}

// ---------------------------------------------------------------- host

// cuTensorMapEncodeTiled is a driver-API call; it is taken through the
// runtime's driver entry point, so the libraries link nothing beyond
// cudart.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A kernel's dynamic shared-memory limit, raised to `bytes` once per
// device: the first launch on a device sets the attribute, later launches
// find it set and skip cudaFuncSetAttribute.
inline cudaError_t smem_attribute_once(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;  // (kernel, device)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, device})) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.insert({kernel, device});
  return err;
}

// The device's SM count, read once per device: the persistent kernels'
// grids are at most that many blocks.
inline cudaError_t sm_count(int* sms) {
  static std::mutex mu;
  static std::map<int, int> counts;  // device -> SMs
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = counts.find(device);
  if (it != counts.end()) {
    *sms = it->second;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) counts[device] = *sms;
  return err;
}

// Tensor map of a bf16 array of `depth` blocks of `rows` rows of `cols`
// elements (rows `row_bytes` apart, blocks `depth_bytes` apart) read in
// boxes of kTileCols x box_rows x 1 with the 128-byte swizzle; rows past
// `rows` read as zeros. cudaErrorInvalidValue for an address or stride TMA
// cannot take (the wrappers refuse those first).
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base,
                                 uint64_t cols, uint64_t rows, uint64_t depth,
                                 uint64_t row_bytes, uint64_t depth_bytes,
                                 uint32_t box_rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % kTmaAlign ||
      row_bytes % kTmaAlign || depth_bytes % kTmaAlign)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {cols, rows, depth};
  const cuuint64_t strides[2] = {row_bytes, depth_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kTileCols), box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The attention forward's per-head tensor map of a bf16 array: `depth`
// blocks of `rows` rows, each row holding `heads` heads of `hd` elements
// (heads `head_bytes` apart, rows `row_bytes`, blocks `depth_bytes`), read
// in boxes of kTileCols x 1 x box_rows x 1 with the 128-byte swizzle. The
// innermost extent is one head, so a box's columns past the head dim read
// as zeros and never as the next head's (a 64-column chunk of a head dim
// that is no multiple of 64), as rows past `rows` do. A [B, H, S, hd]
// operand is heads = 1, rows S, depth B * H. cudaErrorInvalidValue for an
// address or stride TMA cannot take (the wrappers refuse those first).
inline cudaError_t make_head_map(CUtensorMap* map, const void* base,
                                 uint64_t hd, uint64_t heads, uint64_t rows,
                                 uint64_t depth, uint64_t head_bytes,
                                 uint64_t row_bytes, uint64_t depth_bytes,
                                 uint32_t box_rows) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % kTmaAlign ||
      head_bytes % kTmaAlign || row_bytes % kTmaAlign ||
      depth_bytes % kTmaAlign)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {hd, heads, rows, depth};
  const cuuint64_t strides[3] = {head_bytes, row_bytes, depth_bytes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kTileCols), 1, box_rows,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace aaclip
