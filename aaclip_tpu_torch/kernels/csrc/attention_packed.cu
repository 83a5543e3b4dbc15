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
// by the tensor cores, not by memory.
//
// Design. The TPU kernel holds a head's whole K and V row in VMEM; at
// S 1408 in bf16 that is ~360 KB, more than a block's 227 KB of shared
// memory. Here one block owns (64 query rows, one head, one image) and
// walks the keys in tiles of 64 staged in shared memory, with an online
// softmax (running max and sum in fp32) and one division at the end. Q, K
// and V are read in place through the row stride and three section
// offsets, so the V-V mode (all three on the one section) needs no new
// kernel. The ragged tail is masked by bounds: rows >= S are zero-filled
// on load and never stored, keys >= valid_len get -inf, and key tiles
// wholly past valid_len are skipped.
//
// bf16: Q.K^T and P.V run on the tensor cores through mma.sync m16n8k16
// with fp32 accumulation; P is rounded to bf16 before P.V as the TPU
// kernel does, the row sum is taken over the fp32 P. Each of the 4 warps
// owns 16 query rows; scores, P and the output stay in registers.
// fp32 (the parity policy): fp32 FMA throughout, no TF32; one thread per
// query row.
// Both are templated on the head dim (64 for ViT-L/B, 16 for tiny-test).
//
// B4 (flash_attention.py::attention_kernel, _attn_kernel) is the same
// function on separate q, k, v in the [B, H, S, hd] layout: the kernels
// address every operand through batch, head and row strides (`Layout`), so
// aaclip_attention_bhsd launches them with its own base pointers and the
// strides of that layout (H*S*hd, S*hd, hd). Rows from valid_len up to S are
// real queries there and are computed; only keys are masked.
//
// Training (attention_packed_bwd.cu) needs each row's logsumexp: with a
// non-null `lse` [B, H, S] fp32 the kernel also writes m + log(l), the
// final running max plus the log of the row sum (both in the scaled-score
// domain). The inference path passes null and stores nothing more.

#include <math.h>

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

template <int HD>
void launch(bool bf16, dim3 grid, cudaStream_t stream, const void* q,
            const void* k, const void* v, void* out, float* lse, int S,
            int valid_len, Layout in, Layout ol, float scale) {
  if (bf16)
    attn_bf16_kernel<HD><<<grid, 128, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), lse, S, valid_len, in, ol, scale);
  else
    attn_f32_kernel<HD><<<grid, kBlockM, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, S,
        valid_len, in, ol, scale);
}

int launch_any(bool bf16, int head_dim, int batch, int seq, int valid_len,
               int heads, const void* q, const void* k, const void* v,
               void* out, float* lse, Layout in, Layout ol, float scale,
               void* stream) {
  const dim3 grid((seq + kBlockM - 1) / kBlockM, heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      launch<16>(bf16, grid, st, q, k, v, out, lse, seq, valid_len, in, ol,
                 scale);
      break;
    case 64:
      launch<64>(bf16, grid, st, q, k, v, out, lse, seq, valid_len, in, ol,
                 scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: [batch, seq, ld] elements, out: [batch, seq, out_ld]; the q/k/v
// sections of head h start at column {q,k,v}_off + h * head_dim. lse:
// [batch, heads, seq] fp32, or null to skip it. Returns
// the CUDA error of the launch (0 on success); cudaErrorInvalidValue for a
// head dim with no instantiation.
extern "C" int aaclip_attention_packed(const void* qkv, void* out,
                                       float* lse, int bf16,
                                       int head_dim, int batch, int seq,
                                       int valid_len, int heads,
                                       long long ld, int q_off, int k_off,
                                       int v_off, long long out_ld,
                                       float scale, void* stream) {
  const size_t esize = bf16 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  const Layout in{(int64_t)seq * ld, head_dim, ld};
  const Layout ol{(int64_t)seq * out_ld, head_dim, out_ld};
  return launch_any(bf16 != 0, head_dim, batch, seq, valid_len, heads,
                    base + q_off * esize, base + k_off * esize,
                    base + v_off * esize, out, lse, in, ol, scale, stream);
}

// q, k, v, out: contiguous [batch, heads, seq, head_dim] (flash_attention.py
// attention_kernel's layout); keys at or past valid_len masked, every row
// computed. Returns as aaclip_attention_packed.
extern "C" int aaclip_attention_bhsd(const void* q, const void* k,
                                     const void* v, void* out, int bf16,
                                     int head_dim, int batch, int seq,
                                     int valid_len, int heads, float scale,
                                     void* stream) {
  const int64_t hs = (int64_t)seq * head_dim;
  const Layout l{heads * hs, hs, head_dim};
  return launch_any(bf16 != 0, head_dim, batch, seq, valid_len, heads, q, k,
                    v, out, nullptr, l, l, scale, stream);
}
