// K2: self-attention forward with a key-padding bias, [B, N, H, D] layout;
// K7: the same without dropout or statistics, in either layout.
//
// Replaces the Pallas kernel transfusion_tpu/ops/attention.py:226
// (_fwd_kernel, launched by _flash_fwd at :372 for flash_attention_train).
// It computes
//   o = softmax(q k^T * scale + bias_key) v,   bias_key = 0 or -1e30,
// dividing by the row sum l after the P.V product, and writes the per-row
// f32 softmax statistics (m, l) to stats[B, H, N, 2] for the backward
// kernels (attention_bwd.cu). With dropout (training), each probability is
// kept by the hash of dropout.cuh and scaled by 1 / (1 - rate) before the
// P.V product, while l and the stored (m, l) stay those of the undropped
// probabilities, as in the TPU kernel (attention.py:238-250). Dropout is a
// compile-time variant, so the eval (rate 0) instantiation carries none of
// its code.
//
// Bound on the H100: operations. At the fusion stack's level 0 (B 8,
// N 3136, H 4, D 224) one call is 4 B H N^2 D = 0.28 TFLOP against 0.04 GB
// of q/k/v/o, about 7000 flops a byte, far above the card's ~295.
//
// Design (bf16, sm_90a; D = 224 only): both products are asynchronous
// warpgroup products (wgmma.mma_async, sm90.cuh) with f32 accumulators in
// registers, fed by TMA (helpers shared with K3/K4 in attention_sm90.cuh).
// One block of two consumer warpgroups per (b, h, 128 queries), one block
// an SM: each warpgroup owns 64 query rows and keeps their 64 x 224 output
// accumulator in registers (112 a thread). The Q tile loads once; K and V
// stream through a three-stage ring of 64-key stages (229,376 bytes of
// tiles with Q), each stage signalled by an mbarrier and refilled by the
// warpgroup that frees it last, with no producer warp (a third warpgroup
// would cap every thread at 168 registers; see attention_bwd.cu). Tiles
// come straight from the tensor through 4-D tensor maps, seven 32-column
// chunks with the 64-byte swizzle: no transpose, no padding copy. S = Q K^T
// reads both operands K-major from shared memory; O += P V takes P as the
// register A operand (the S accumulator's layout, rounded to bf16, never
// through shared memory) and reads V MN-major from the same stage. Per
// 64-key tile each warpgroup issues S of the next tile before P V of this
// one, so its online softmax (f32, exp2 on the special-function unit) runs
// while P V is on the tensor cores; the two warpgroups take turns to issue
// (ping-pong on named barriers), so one's softmax also runs under the
// other's products. The dropout hash is computed inside the softmax loop,
// where its integer work interleaves with the floating-point work. The
// output is rescaled only when a row maximum of the warp moved (alpha = 1
// is exact). Three stages keep the load of the tile after next in flight
// behind the two tiles in use. TMA returns rows past N as zeros; those
// keys get -inf and those queries are not stored. P is rounded to bf16 for
// the P V product as the TPU kernel rounds it to the input dtype; m and l
// stay f32.
//
// Design (f32, for tight checks): 32-query by 32-key tiles in shared memory
// with plain FMA, no tensor cores.
//
// K7 (tf_self_attention) replaces the Pallas kernel
// transfusion_tpu/ops/attention.py:29 (_attn_kernel, launched by
// flash_self_attention at :102 for [B, H, N, D] and flash_self_attention_blhd
// at :152 for [B, N, H, D]): the same function without dropout or
// statistics. It is a compile-time variant of K2 (kStats false) whose tensor
// maps are built from element strides of batch, position and head, so
// either layout loads without a transpose copy. The TPU kernel takes the
// exact row max over all keys before one exp; K2's online softmax rescales
// by exp(m_old - m_new) as the max grows, which is the same function. In
// bf16, q and k products are exact in f32 (8 x 8 significant bits) whether
// the operands are upcast first, as the TPU kernel does, or multiplied on
// the tensor cores, so only the order of the f32 sums differs; P is rounded
// to bf16 against the running instead of the final max, so outputs may land
// one bf16 ulp apart, and the card checks allow two ulps of max|plain| plus
// a mean bound, as for K2.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "dropout.cuh"
#include "warp_reduce.cuh"

namespace {

constexpr int kThreads = 128;  // f32 path
constexpr int kHeadDimCap = 256;
constexpr float kLog2e = 1.4426950408889634f;

// exp(a - b) that is 0 when a is -inf (a key past N or an empty running max).
__device__ __forceinline__ float exp_diff(float a, float b) {
  return a == -INFINITY ? 0.f : expf(a - b);
}

// ---------------------------------------------------------------- bf16 path
constexpr int kQRows = 2 * kRows;  // query rows of a block: one 64-row slab per consumer
constexpr int kStages = 3;         // K/V stages: two tiles in use, one loading
constexpr int kTurnBar = 1;        // named barriers 1 + c: warpgroup c may issue (the ring uses 5, 6)

// Q of the block's 128 queries, three stages of K and V (64 keys each), the
// barriers (Q, one a stage) and the release counts: 229,376 bytes of tiles
// + 44 + 1,024 for alignment.
struct FwdSmem {
  static constexpr uint32_t q = 0, k = tile_bytes(kQRows), v = k + kStages * tile_bytes(kRows);
  static constexpr uint32_t bars = v + kStages * tile_bytes(kRows), released = bars + (1 + kStages) * 8;
  static constexpr uint32_t bytes = released + kStages * 4 + 1024;
};
static_assert(FwdSmem::bytes <= 232448, "shared memory");

// One block per (128-query tile, h, b); consumer warpgroup c owns query rows
// [64 c, 64 c + 64) of the tile. out and the tensor maps follow the strides
// st; stats (kStats) is [B, H, N, 2]. Blocks run in the order of their
// index: every head's whole 128-query tiles first, then the heads' last,
// partial tiles, whose second warpgroup computes nothing when N ends in the
// first half, so the cheaper blocks fill the last wave (at level 0, 800
// blocks make 6.06 waves of 132).
template <bool kDropout, bool kStats>
__global__ void __launch_bounds__(kThreadsSm90, 1)
attn_fwd_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
              __nv_bfloat16* __restrict__ out, float* __restrict__ stats, int n, int nh, Strides st,
              float scale, Dropout drop) {
  using Ring3 = StageRing<kStages>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + FwdSmem::bars);
  uint64_t* qbar = bars;
  const int n_whole = n / kQRows, whole_blocks = n_whole * (int)(gridDim.x / ((n + kQRows - 1) / kQRows));
  int bh, qt;
  if ((int)blockIdx.x < whole_blocks) {
    bh = blockIdx.x / n_whole;
    qt = blockIdx.x - bh * n_whole;
  } else {
    bh = blockIdx.x - whole_blocks;
    qt = n_whole;
  }
  const int b = bh / nh, h = bh - b * nh;
  const int q0 = qt * kQRows;
  const int c = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0), tid = threadIdx.x & 127;
  const bool hf = heads_first(st);
  const Ring3 ring{bars + 1, reinterpret_cast<uint32_t*>(sm + FwdSmem::released), sm + FwdSmem::k,
                   sm + FwdSmem::v, &tm_k, &tm_v, h, b, (n + kRows - 1) / kRows, hf};
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      ring.released[s] = 0u;
    }
    fence_mbar_init();
    mbar_arrive_expect_tx(qbar, tile_bytes(kQRows));
    load_head_tile(sm + FwdSmem::q, &tm_q, qbar, kQRows, h, q0, b, hf);
    for (int t = 0; t < kStages && t < ring.n_tiles; ++t) ring.load(t);
  }
  __syncthreads();  // the barriers' initialisation, visible to all
  if (q0 + c * kRows >= n) {  // every row of this warpgroup lies past N: keep the ring going
    for (int t = 0; t < ring.n_tiles; ++t) {
      ring.wait(t);
      ring.release(t, c);
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int qa = q0 + c * kRows + warp * 16 + g, qb = qa + 8;  // this thread's two query rows
  const float* key_bias = bias + (size_t)b * n;
  uint32_t drop_a = 0, drop_b = 0;
  if constexpr (kDropout) {
    const uint32_t cell = (uint32_t)(b * nh + h);
    drop_a = dropout_row((uint32_t)qa, drop.seed, cell);
    drop_b = dropout_row((uint32_t)qb, drop.seed, cell);
  }

  float o[112];
#pragma unroll
  for (int i = 0; i < 112; ++i) o[i] = 0.f;
  fence_regs(o);
  float m_a = -INFINITY, m_b = -INFINITY;  // running maxima of rows qa and qb
  float l_a = 0.f, l_b = 0.f;              // this thread's share of their sums
  float sc[32];                            // S of the tile in flight
  uint32_t pa[4][4];                       // P of the tile whose P V is in flight
  const unsigned char* Qs = sm + FwdSmem::q;
  mbar_wait(qbar, 0);
  // Ping-pong, when both warpgroups compute: they issue their products in
  // turns, warpgroup 0 first; each waits for its turn and hands the turn
  // over once its products are issued.
  const bool both = q0 + kRows < n;
  if (both && c == 1) named_bar_arrive(kTurnBar, 256);

  // S = Q K^T for the slab's 64 queries x the 64 keys of tile t.
  auto issue_s = [&](int t) {
    const unsigned char* Ks = ring.a + Ring3::stage(t) * tile_bytes(kRows);
    ring.wait(t);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2 * kChunks; ++kk)
      wgmma_m64n64k16_ss(sc, kmajor_desc(Qs, kQRows, c, kk), kmajor_desc(Ks, kRows, 0, kk), kk > 0);
    wgmma_commit();
  };

  if (both) named_bar_sync(kTurnBar + c, 256);
  issue_s(0);
  if (both) named_bar_arrive(kTurnBar + 1 - c, 256);
  for (int t = 0; t < ring.n_tiles; ++t) {
    // In flight: S of tile t and, behind it, P V of tile t - 1. Meanwhile,
    // tile t's key biases (-inf past N).
    float kb[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * kRows + j * 8 + 2 * t4 + e;
        kb[2 * j + e] = key < n ? key_bias[key] : -INFINITY;
      }

    if (t > 0)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_regs(sc);
    // Online softmax into x (only wgmma writes an accumulator while a product
    // is in flight, or ptxas serialises the products): elements i & 3 < 2 lie
    // in row qa, the others in qb; a row's 64 keys are spread over the four
    // threads of a quad.
    float x[32];
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      x[i] = fmaf(sc[i], scale, kb[2 * (i >> 2) + (i & 1)]);
      if ((i & 3) >= 2)
        mx_b = fmaxf(mx_b, x[i]);
      else
        mx_a = fmaxf(mx_a, x[i]);
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
    }
    // Tile 0 holds key 0, so the maxima are finite from here on and only
    // keys past N (-inf) give exp2(-inf) = 0. x - m is exact where x = m,
    // also in a row whose keys are all padding (x = m = -1e30).
    const float alpha_a = fast_exp2((m_a - mx_a) * kLog2e), alpha_b = fast_exp2((m_b - mx_b) * kLog2e);
    m_a = mx_a;
    m_b = mx_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool row_b = (i & 3) >= 2;
      float p = fast_exp2((x[i] - (row_b ? mx_b : mx_a)) * kLog2e);
      if (row_b)
        ps_b += p;
      else
        ps_a += p;
      if constexpr (kDropout) {  // l keeps the undropped sum
        const uint32_t key = (uint32_t)(t * kRows + (i >> 2) * 8 + 2 * t4 + (i & 1));
        p = dropout_keep(row_b ? drop_b : drop_a, key, drop.thresh) ? p * drop.inv_keep : 0.f;
      }
      x[i] = p;
    }
    l_a = l_a * alpha_a + ps_a;
    l_b = l_b * alpha_b + ps_b;

    wgmma_wait<0>();  // P V of tile t - 1 is done: its stage and pa are free
    fence_regs(o);
    if (t > 0) ring.release(t - 1, c);
    if (__any_sync(0xffffffffu, alpha_a != 1.f || alpha_b != 1.f)) {  // a row maximum moved
#pragma unroll
      for (int j = 0; j < 28; ++j) {
        o[4 * j] *= alpha_a;
        o[4 * j + 1] *= alpha_a;
        o[4 * j + 2] *= alpha_b;
        o[4 * j + 3] *= alpha_b;
      }
    }
    fence_regs(o);  // the rescale stays ahead of the next products
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(pa[kk], x + 8 * kk);
    if (both) named_bar_sync(kTurnBar + c, 256);
    if (t + 1 < ring.n_tiles) issue_s(t + 1);

    // O[64 x 224] += P V for tile t.
    const unsigned char* Vs = ring.b + Ring3::stage(t) * tile_bytes(kRows);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n224k16_rs_mn(o, pa[kk], mnmajor_desc(Vs, kk), 1);
    wgmma_commit();
    // Warpgroup 1's last hand-over would have no taker.
    if (both && !(c == 1 && t + 1 == ring.n_tiles)) named_bar_arrive(kTurnBar + 1 - c, 256);
  }
  wgmma_wait<0>();
  fence_regs(o);

  // o = O / l in bf16; (m, l) to the f32 side output.
#pragma unroll
  for (int sh = 1; sh <= 2; sh <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, sh);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, sh);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
  __nv_bfloat16* oh = out + (size_t)b * st.b + (size_t)h * st.h;
#pragma unroll
  for (int j = 0; j < 28; ++j) {
    const int col = j * 8 + 2 * t4;
    if (qa < n)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)qa * st.n + col) =
          __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    if (qb < n)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)qb * st.n + col) =
          __floats2bfloat162_rn(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
  if (kStats && t4 == 0) {
    float* sr = stats + ((size_t)b * nh + h) * n * 2;
    if (qa < n) {
      sr[(size_t)qa * 2] = m_a;
      sr[(size_t)qa * 2 + 1] = l_a;
    }
    if (qb < n) {
      sr[(size_t)qb * 2] = m_b;
      sr[(size_t)qb * 2 + 1] = l_b;
    }
  }
}

template <bool kDropout, bool kStats>
cudaError_t launch_sm90(const void* q, const void* k, const void* v, const void* bias, void* out,
                        void* stats, int bsz, int n, int nh, Strides st, float scale, Dropout drop,
                        cudaStream_t s) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!head_map(&tm_q, q, bsz, n, nh, st, kQRows) || !head_map(&tm_k, k, bsz, n, nh, st, kRows) ||
      !head_map(&tm_v, v, bsz, n, nh, st, kRows))
    return cudaErrorInvalidValue;
  auto* kernel = attn_fwd_sm90<kDropout, kStats>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)FwdSmem::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(n + kQRows - 1) / kQRows * nh * bsz, kThreadsSm90, FwdSmem::bytes, s>>>(
      tm_q, tm_k, tm_v, (const float*)bias, (__nv_bfloat16*)out, (float*)stats, n, nh, st, scale,
      drop);
  return cudaSuccess;
}

// ----------------------------------------------------------------- f32 path
constexpr int kFQ = 32, kFK = 32;

template <bool kDropout, bool kStats>
__global__ void __launch_bounds__(kThreads)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ bias,
             float* __restrict__ out, float* __restrict__ stats,
             int n, int nh, int d, Strides st, float scale, uint32_t seed, uint32_t thresh,
             float inv_keep) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + 1;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kFQ * ld;
  float* Vs = Ks + kFK * ld;
  float* Os = Vs + kFK * ld;
  float* Ps = Os + kFQ * ld;           // [kFQ][kFK + 1]
  float* row_m = Ps + kFQ * (kFK + 1);
  float* row_l = row_m + kFQ;
  float* row_alpha = row_l + kFQ;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kFQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row_stride = st.n;
  const size_t head_off = (size_t)b * st.b + (size_t)h * st.h;

  for (int idx = threadIdx.x; idx < kFQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    Qs[r * ld + c] = (q0 + r < n) ? q[head_off + (size_t)(q0 + r) * row_stride + c] : 0.f;
    Os[r * ld + c] = 0.f;
  }
  if (threadIdx.x < kFQ) {
    row_m[threadIdx.x] = -INFINITY;
    row_l[threadIdx.x] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += kFK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kFK * d; idx += kThreads) {
      const int r = idx / d, c = idx - r * d;
      const bool in = k0 + r < n;
      Ks[r * ld + c] = in ? k[head_off + (size_t)(k0 + r) * row_stride + c] : 0.f;
      Vs[r * ld + c] = in ? v[head_off + (size_t)(k0 + r) * row_stride + c] : 0.f;
    }
    __syncthreads();
    // Scores: warp w handles rows w, w + 4, ...; lane = key.
    for (int r = warp; r < kFQ; r += kThreads / 32) {
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot = fmaf(Qs[r * ld + c], Ks[lane * ld + c], dot);
      const float s = (k0 + lane < n) ? dot * scale + bias[(size_t)b * n + k0 + lane] : -INFINITY;
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = exp_diff(s, m_new);
      const float psum = warp_sum(p);
      if constexpr (kDropout) {
        const uint32_t row = dropout_row((uint32_t)(q0 + r), seed, (uint32_t)(b * nh + h));
        Ps[r * (kFK + 1) + lane] = dropout_keep(row, (uint32_t)(k0 + lane), thresh) ? p * inv_keep : 0.f;
      } else {
        Ps[r * (kFK + 1) + lane] = p;
      }
      if (lane == 0) {
        const float alpha = exp_diff(m_old, m_new);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + psum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kFQ * d; idx += kThreads) {
      const int r = idx / d, c = idx - r * d;
      float acc = Os[r * ld + c] * row_alpha[r];
      for (int j = 0; j < kFK; ++j) acc = fmaf(Ps[r * (kFK + 1) + j], Vs[j * ld + c], acc);
      Os[r * ld + c] = acc;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kFQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    if (q0 + r < n) out[head_off + (size_t)(q0 + r) * row_stride + c] = Os[r * ld + c] / row_l[r];
  }
  if (kStats && threadIdx.x < kFQ && q0 + threadIdx.x < n) {
    float* sr = stats + (((size_t)b * nh + h) * n + q0 + threadIdx.x) * 2;
    sr[0] = row_m[threadIdx.x];
    sr[1] = row_l[threadIdx.x];
  }
}

size_t smem_f32(int d) {
  const int ld = d + 1;
  return sizeof(float) * ((size_t)(2 * kFQ + 2 * kFK) * ld + kFQ * (kFK + 1) + 3 * kFQ);
}

template <bool kDropout, bool kStats>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* bias, void* out,
                       void* stats, int bsz, int n, int nh, int d, Strides st, float scale,
                       uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t s) {
  const size_t smem = smem_f32(d);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_f32<kDropout, kStats>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kFQ - 1) / kFQ, nh, bsz);
  attn_fwd_f32<kDropout, kStats><<<grid, kThreads, smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias, (float*)out,
      (float*)stats, n, nh, d, st, scale, seed, thresh, inv_keep);
  return cudaSuccess;
}

}  // namespace

// seed, thresh and inv_keep are read only when dropout is non-zero: seed is
// the int32 seed reinterpreted as uint32, thresh = uint32(rate * 4294967295),
// inv_keep = 1 / (1 - rate).
extern "C" int tf_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                void* out, void* stats, int bsz, int n, int nh, int d,
                                float scale, int is_bf16, unsigned seed, unsigned thresh,
                                float inv_keep, int dropout, void* stream) {
  if (bsz <= 0 || n <= 0 || nh <= 0 || d <= 0 || d > kHeadDimCap) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Strides st{(long long)n * nh * d, (long long)nh * d, d};  // [B, N, H, D]
  cudaError_t err;
  if (is_bf16) {
    if (d != kD) return (int)cudaErrorInvalidValue;
    err = dropout ? launch_sm90<true, true>(q, k, v, bias, out, stats, bsz, n, nh, st, scale,
                                            Dropout{seed, thresh, inv_keep}, s)
                  : launch_sm90<false, true>(q, k, v, bias, out, stats, bsz, n, nh, st, scale,
                                             Dropout{0u, 0u, 1.f}, s);
  } else {
    err = dropout ? launch_f32<true, true>(q, k, v, bias, out, stats, bsz, n, nh, d, st, scale,
                                           seed, thresh, inv_keep, s)
                  : launch_f32<false, true>(q, k, v, bias, out, stats, bsz, n, nh, d, st, scale,
                                            0u, 0u, 1.f, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K7: exact self-attention without statistics or dropout, q/k/v/out addressed
// through the element strides (sb, sn, sh) of batch, position and head, so
// [B, H, N, D] and [B, N, H, D] both run without a transpose copy. Every row
// must start on a 16-byte boundary (bf16: D = 224 only, the batch stride the
// largest; f32: any D <= 256).
extern "C" int tf_self_attention(const void* q, const void* k, const void* v, const void* bias,
                                 void* out, int bsz, int n, int nh, int d, long long sb,
                                 long long sn, long long sh, float scale, int is_bf16,
                                 void* stream) {
  if (bsz <= 0 || n <= 0 || nh <= 0 || d <= 0 || d > kHeadDimCap) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Strides st{sb, sn, sh};
  cudaError_t err;
  if (is_bf16) {
    if (d != kD) return (int)cudaErrorInvalidValue;
    err = launch_sm90<false, false>(q, k, v, bias, out, nullptr, bsz, n, nh, st, scale,
                                    Dropout{0u, 0u, 1.f}, s);
  } else {
    err = launch_f32<false, false>(q, k, v, bias, out, nullptr, bsz, n, nh, d, st, scale, 0u, 0u,
                                   1.f, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
