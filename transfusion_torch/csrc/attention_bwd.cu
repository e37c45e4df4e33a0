// K3 and K4: the backward pass of K2 (attention.cu), [B, N, H, D] layout.
//
// K3 (tf_attention_bwd_dq) replaces the Pallas kernel
// transfusion_tpu/ops/attention.py:253 (_bwd_dq_kernel, launched by
// _flash_bwd at :432); K4 (tf_attention_bwd_dkv) replaces :297
// (_bwd_dkv_kernel, launched at :442). With the probabilities rebuilt from
// the forward's stored f32 statistics, P = exp(s - m) / l for
// s = q k^T * scale + bias_key, and D = rowsum(dO * O) in f32:
//   dP = dropout(dO v^T) (the forward's keep mask, scaled by 1 / (1 - rate)),
//   dS = P * (dP - D), from the f32 P, rounded to the input dtype before its
//   products,
//   dQ = dS k * scale,   dK = dS^T q * scale,   dV = dropout(P)^T dO,
// each accumulated in f32 and stored in the input dtype. The dropout mask is
// regenerated from the hash of dropout.cuh at global (query, key) indices,
// so it is the forward's bit for bit. Neither kernel uses atomics: two
// launches on the same inputs give the same bits.
//
// Bound on the H100: operations. At the fusion stack's level 0 (B 8,
// N 3136, H 4, D 224) K3 does 3 products of 2 B H N^2 D flops (0.42 TFLOP)
// and K4 4 (0.56 TFLOP) against 0.06 GB of q/k/v/dO/D.
//
// Design (bf16, sm_90a; D = 224 only): every product is an asynchronous
// warpgroup product (wgmma.mma_async, sm90.cuh) with f32 accumulators in
// registers; the tensor maps, operand descriptors and stage ring come from
// attention_sm90.cuh, shared with the forward. A block is two warpgroups
// that compute; the next tiles load by TMA into a two-stage ring in shared
// memory while they do: each stage is
// signalled by an mbarrier, and the second warpgroup to finish with a stage
// refills it with the tile after next, so one load is always in flight
// behind the tile being computed. There is no separate producer warp: a
// block of three warpgroups (or of two and one warp: registers are
// allocated four warps at a time) may hold 168 registers a thread, and ptxas
// then spilled the 112-register accumulators and serialised the products;
// handing the producer's registers over with setmaxnreg did not change its
// allocation. Two warpgroups may hold 255. Tiles come
// straight from [B, N, H, D] through 4-D tensor maps (row stride 1792 bytes,
// no transpose, no padding copy) as seven 32-column chunks with the 64-byte
// swizzle; bf16 wgmma reads a shared operand in either major order, so one
// copy of a K, V, Q or dO tile serves both the products that contract over d
// (K-major) and those that contract over its rows (MN-major). Probabilities
// and their gradients are converted to bf16 in registers and fed to the next
// product as its register A operand, never through shared memory.
//   K3: one block per (b, h, 128 queries); each consumer owns 64 query rows
//   and keeps their 64 x 224 dQ accumulator in registers while the block
//   streams 64-key stages of K and V: S = Q K^T and dP~ = dO V^T are issued as
//   two groups (the softmax starts while dP~ runs; the keep bits are hashed
//   while both run), then dQ += dS K. K3 computes D for its rows from dO and O
//   and writes it to a [B, H, N] f32 buffer for K4.
//   K4: one block per (b, h, 64 keys) streams 64-query stages of Q and dO.
//   Both 64 x 224 accumulators would need 224 registers a
//   thread, so they live in different warpgroups and S is computed once:
//   consumer V computes S^T = K Q^T, P^T and the keep bits, and accumulates
//   dV += dropout(P)^T dO; consumer K computes dP~^T = V dO^T and, with P^T
//   handed over in f32 through shared memory (the sign bit marks a dropped
//   entry) under named barriers, dS^T and dK += dS^T Q: 8 N^2 D flops, not the
//   10 of recomputing S in both halves. K4 reads D and never O. K4's V side
//   rebuilds P as exp(s - (m + log l)), one row value a query instead of
//   two, which keeps the dropout instantiation within 255 registers; P moves
//   by a few f32 ulps, far inside the bf16 rounding of dS and dV's P.
//   Each warpgroup issues the next tile's first product right behind this
//   tile's accumulation, so products stay queued while it runs its
//   elementwise work.
// Shared memory (232,448 bytes a block at most): K3 holds Q and dO of 128
// rows (114,688) and two stages of K and V (114,688) plus 544 of D rows,
// barriers and counts; K4 holds K and V (57,344), two stages of Q and dO
// (114,688), two 16,384-byte P^T buffers and 32 of barriers and counts. One
// block an SM. Key biases and the per-query (m, l, D) are read from global
// memory (L2) while each tile's first product runs.
//
// Design (f32, for tight checks): 32 x 32 tiles in shared memory with plain
// FMA, no tensor cores, any D <= 256; each kernel computes D itself.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_sm90.cuh"
#include "dropout.cuh"
#include "warp_reduce.cuh"

namespace {

constexpr int kHeadDimCap = 256;

// dot(a[0:n], b[0:n]) of two bf16 rows in f32; n is a multiple of 8 and both
// rows are 16-byte aligned.
__device__ __forceinline__ float dot_bf16_rows(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                               int n) {
  float acc = 0.f;
  for (int c = 0; c < n; c += 8) {
    const uint4 ua = *reinterpret_cast<const uint4*>(a + c);
    const uint4 ub = *reinterpret_cast<const uint4*>(b + c);
    const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&ua);
    const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&ub);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(ha[i]), fb = __bfloat1622float2(hb[i]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
  return acc;
}

// ---------------------------------------------------------------- bf16 path
constexpr int kDqRows = 2 * kRows;  // query rows of a K3 block: one 64-row slab per consumer

// K3 shared memory: Q and dO of the block's 128 queries, two stages of K and
// V (64 keys each), the D rows of each consumer, the barriers and release
// counts. 229,376 bytes of tiles + 568 + 1,024 for alignment.
struct DqSmem {
  static constexpr uint32_t q = 0, dout = tile_bytes(kDqRows), k = 2 * tile_bytes(kDqRows);
  static constexpr uint32_t v = k + 2 * tile_bytes(kRows), drow = v + 2 * tile_bytes(kRows);
  static constexpr uint32_t bars = drow + 2 * kRows * 4, released = bars + 3 * 8;
  static constexpr uint32_t bytes = released + 2 * 4 + 1024;
};
// K4: K and V of the block's 64 keys, two stages of Q and dO, the two f32
// P^T exchange buffers, the barriers and release counts.
struct DkvSmem {
  static constexpr uint32_t k = 0, v = tile_bytes(kRows), q = 2 * tile_bytes(kRows);
  static constexpr uint32_t dout = q + 2 * tile_bytes(kRows), xch = dout + 2 * tile_bytes(kRows);
  static constexpr uint32_t bars = xch + 2 * kRows * kRows * 4, released = bars + 3 * 8;
  static constexpr uint32_t bytes = released + 2 * 4 + 1024;
};
static_assert(DqSmem::bytes <= 232448 && DkvSmem::bytes <= 232448, "shared memory");

// K3: one block per (128-query tile, h, b); consumer warpgroup c owns query
// rows [64 c, 64 c + 64) of the tile.
template <bool kDropout>
__global__ void __launch_bounds__(kThreadsSm90, 1)
attn_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ bias, const float* __restrict__ stats,
                 float* __restrict__ dbuf, __nv_bfloat16* __restrict__ dq, int n, int nh,
                 float scale, Dropout drop) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  float* sdrow = reinterpret_cast<float*>(sm + DqSmem::drow);  // [2 consumers][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + DqSmem::bars);
  uint64_t* qbar = bars;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kDqRows;
  const int c = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0), tid = threadIdx.x & 127;
  const Ring ring{bars + 1, reinterpret_cast<uint32_t*>(sm + DqSmem::released), sm + DqSmem::k,
                  sm + DqSmem::v, &tm_k, &tm_v, h, b, (n + kRows - 1) / kRows};
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    mbar_init(&ring.full[0], 1);
    mbar_init(&ring.full[1], 1);
    ring.released[0] = ring.released[1] = 0u;
    fence_mbar_init();
    mbar_arrive_expect_tx(qbar, 2 * tile_bytes(kDqRows));
    load_head_tile(sm + DqSmem::q, &tm_q, qbar, kDqRows, h, q0, b);
    load_head_tile(sm + DqSmem::dout, &tm_do, qbar, kDqRows, h, q0, b);
    ring.load(0);
    if (ring.n_tiles > 1) ring.load(1);
  }

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const size_t row_stride = (size_t)nh * kD;
  const size_t head_off = (size_t)b * n * row_stride + (size_t)h * kD;
  const int slab0 = q0 + c * kRows;
  const int qa = slab0 + warp * 16 + g, qb = qa + 8;
  const float* st = stats + ((size_t)b * nh + h) * n * 2;
  const float* key_bias = bias + (size_t)b * n;

  // D = rowsum(dO * O) of the slab while the first tiles load: two threads a
  // row, 112 columns each, written once to dbuf for K4.
  {
    const int r = tid >> 1, half = tid & 1;
    float d = 0.f;
    if (slab0 + r < n) {
      const size_t off = head_off + (size_t)(slab0 + r) * row_stride + half * (kD / 2);
      d = dot_bf16_rows(dout + off, o + off, kD / 2);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      sdrow[c * kRows + r] = d;
      if (slab0 + r < n) dbuf[((size_t)b * nh + h) * n + slab0 + r] = d;
    }
  }
  __syncthreads();  // D rows, and the barriers' initialisation, visible to all
  const float d_a = sdrow[c * kRows + warp * 16 + g], d_b = sdrow[c * kRows + warp * 16 + g + 8];
  const float m_a = qa < n ? st[(size_t)qa * 2] : 0.f, m_b = qb < n ? st[(size_t)qb * 2] : 0.f;
  const float il_a = qa < n ? 1.f / st[(size_t)qa * 2 + 1] : 0.f;  // 0: P = 0 past N
  const float il_b = qb < n ? 1.f / st[(size_t)qb * 2 + 1] : 0.f;
  uint32_t drop_a = 0, drop_b = 0;
  if constexpr (kDropout) {
    const uint32_t cell = (uint32_t)(b * nh + h);
    drop_a = dropout_row((uint32_t)qa, drop.seed, cell);
    drop_b = dropout_row((uint32_t)qb, drop.seed, cell);
  }

  float acc[112];
#pragma unroll
  for (int i = 0; i < 112; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);
  const unsigned char* Qs = sm + DqSmem::q;
  const unsigned char* dOs = sm + DqSmem::dout;

  for (int t = 0; t < ring.n_tiles; ++t) {
    const unsigned char* Ks = ring.a + (t & 1) * tile_bytes(kRows);
    const unsigned char* Vs = ring.b + (t & 1) * tile_bytes(kRows);
    ring.wait(t);

    // S = Q K^T and dP~ = dO V^T for the slab's 64 queries x 64 keys, as two
    // groups so the softmax can start while dP~ is still in flight.
    float sc[32], dp[32];
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2 * kChunks; ++kk)
      wgmma_m64n64k16_ss(sc, kmajor_desc(Qs, kDqRows, c, kk), kmajor_desc(Ks, kRows, 0, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 2 * kChunks; ++kk)
      wgmma_m64n64k16_ss(dp, kmajor_desc(dOs, kDqRows, c, kk), kmajor_desc(Vs, kRows, 0, kk), kk > 0);
    wgmma_commit();

    // While the products run: this tile's key biases and keep bits.
    float kb[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = t * kRows + j * 8 + 2 * t4 + e;
        kb[2 * j + e] = key < n ? key_bias[key] : -INFINITY;
      }
    uint32_t keep = 0xffffffffu;
    if constexpr (kDropout) {
      keep = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t key = (uint32_t)(t * kRows + j * 8 + 2 * t4 + (e & 1));
          keep |= (uint32_t)dropout_keep(e >= 2 ? drop_b : drop_a, key, drop.thresh) << (4 * j + e);
        }
    }

    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // P, in place
      const float x = sc[i] * scale + kb[2 * (i >> 2) + (i & 1)];
      sc[i] = (i & 3) >= 2 ? fast_exp_diff(x, m_b) * il_b : fast_exp_diff(x, m_a) * il_a;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // dS = P * (dropout(dP~) - D), in place
      float x = dp[i];
      if constexpr (kDropout) x = (keep >> i) & 1u ? x * drop.inv_keep : 0.f;
      dp[i] = sc[i] * (x - ((i & 3) >= 2 ? d_b : d_a));
    }
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(a[kk], dp + 8 * kk);

    // dQ[64 x 224] += dS K.
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_m64n224k16_rs_mn(acc, a[kk], mnmajor_desc(Ks, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    ring.release(t, c);
  }

#pragma unroll
  for (int j = 0; j < 28; ++j) {
    const int col = j * 8 + 2 * t4;
    if (qa < n)
      *reinterpret_cast<__nv_bfloat162*>(dq + head_off + (size_t)qa * row_stride + col) =
          __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (qb < n)
      *reinterpret_cast<__nv_bfloat162*>(dq + head_off + (size_t)qb * row_stride + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

// K4: one block per (64-key tile, h, b). Consumer 0 ("V") owns S^T, P^T and
// dV; consumer 1 ("K") owns dP^T, dS^T and dK. P^T crosses in f32 through
// one of two shared buffers, its sign bit set where dropout drops it.
constexpr int kXchFull = 1, kXchEmpty = 3;  // named barriers 1-2 and 3-4

template <bool kDropout>
__global__ void __launch_bounds__(kThreadsSm90, 1)
attn_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ bias, const float* __restrict__ stats,
                  const float* __restrict__ dbuf, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int n, int nh, float scale, Dropout drop) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  float4* xch = reinterpret_cast<float4*>(sm + DkvSmem::xch);  // [2][8][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + DkvSmem::bars);
  uint64_t* kvbar = bars;
  const int h = blockIdx.y, b = blockIdx.z;
  const int key0 = blockIdx.x * kRows;
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x >> 7, 0), tid = threadIdx.x & 127;
  const size_t cell = (size_t)b * nh + h;
  const Ring ring{bars + 1, reinterpret_cast<uint32_t*>(sm + DkvSmem::released), sm + DkvSmem::q,
                  sm + DkvSmem::dout, &tm_q, &tm_do, h, b, (n + kRows - 1) / kRows};
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    mbar_init(&ring.full[0], 1);
    mbar_init(&ring.full[1], 1);
    ring.released[0] = ring.released[1] = 0u;
    fence_mbar_init();
    mbar_arrive_expect_tx(kvbar, 2 * tile_bytes(kRows));
    load_head_tile(sm + DkvSmem::k, &tm_k, kvbar, kRows, h, key0, b);
    load_head_tile(sm + DkvSmem::v, &tm_v, kvbar, kRows, h, key0, b);
    ring.load(0);
    if (ring.n_tiles > 1) ring.load(1);
  }
  __syncthreads();

  const bool v_side = wg == 0;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int ka = key0 + warp * 16 + g, kb = ka + 8;  // this thread's two keys (rows)
  const float bias_a = ka < n ? bias[(size_t)b * n + ka] : -INFINITY;
  const float bias_b = kb < n ? bias[(size_t)b * n + kb] : -INFINITY;
  const float2* st = reinterpret_cast<const float2*>(stats) + cell * n;  // (m, l) a query
  const float* drow = dbuf + cell * n;
  const unsigned char* Ks = sm + DkvSmem::k;
  const unsigned char* Vs = sm + DkvSmem::v;
  if (!v_side) {  // both exchange buffers start free
    named_bar_arrive(kXchEmpty, 256);
    named_bar_arrive(kXchEmpty + 1, 256);
  }

  float acc[112];
#pragma unroll
  for (int i = 0; i < 112; ++i) acc[i] = 0.f;
  mbar_wait(kvbar, 0);

  // V side: S^T = K Q^T; K side: dP~^T = V dO^T (64 keys x 64 queries of
  // tile t).
  float x[32];
  auto issue_first = [&](int t) {
    const int s = t & 1;
    ring.wait(t);
    fence_regs(x);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2 * kChunks; ++kk)
      wgmma_m64n64k16_ss(x, kmajor_desc(v_side ? Ks : Vs, kRows, 0, kk),
                         kmajor_desc((v_side ? ring.a : ring.b) + s * tile_bytes(kRows), kRows, 0, kk),
                         kk > 0);
    wgmma_commit();
  };

  // Software pipeline: tile t + 1's first product is issued right behind
  // tile t's accumulation, so each warpgroup keeps products queued.
  issue_first(0);
  uint32_t a[4][4];
  for (int t = 0; t < ring.n_tiles; ++t) {
    const int s = t & 1;
    const unsigned char* Qs = ring.a + s * tile_bytes(kRows);
    const unsigned char* dOs = ring.b + s * tile_bytes(kRows);
    float4* xb = xch + s * 8 * 128;

    // While the product runs: the queries' m + log l and the keep bits, or
    // their D.
    float qlse[16], qd[16];
    uint32_t keep = 0xffffffffu;
    if (v_side) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = t * kRows + j * 8 + 2 * t4 + e;
          const float2 ml = qi < n ? st[qi] : make_float2(INFINITY, 1.f);  // P = 0 past N
          qlse[2 * j + e] = ml.x + logf(ml.y);
        }
      if constexpr (kDropout) {
        keep = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t row = dropout_row((uint32_t)(t * kRows + j * 8 + 2 * t4 + e), drop.seed,
                                             (uint32_t)cell);
            keep |= (uint32_t)dropout_keep(row, (uint32_t)ka, drop.thresh) << (4 * j + e);
            keep |= (uint32_t)dropout_keep(row, (uint32_t)kb, drop.thresh) << (4 * j + e + 2);
          }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = t * kRows + j * 8 + 2 * t4 + e;
          qd[2 * j + e] = qi < n ? drow[qi] : 0.f;
        }
    }
    wgmma_wait<1>();  // tile t - 1's accumulation is done
    if (t > 0) ring.release(t - 1, wg);
    wgmma_wait<0>();
    fence_regs(x);

    if (v_side) {
#pragma unroll
      for (int i = 0; i < 32; ++i)  // P^T = exp(s - m) / l, f32
        x[i] = fast_exp_diff(x[i] * scale + ((i & 3) >= 2 ? bias_b : bias_a),
                             qlse[2 * (i >> 2) + (i & 1)]);
      named_bar_sync(kXchEmpty + s, 256);
#pragma unroll
      for (int k4 = 0; k4 < 8; ++k4) {
        float4 v4 = make_float4(x[4 * k4], x[4 * k4 + 1], x[4 * k4 + 2], x[4 * k4 + 3]);
        if constexpr (kDropout) {
          float* f = &v4.x;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!((keep >> (4 * k4 + e)) & 1u)) f[e] = -f[e];  // sign bit: dropped
        }
        xb[k4 * 128 + tid] = v4;
      }
      __threadfence_block();
      named_bar_arrive(kXchFull + s, 256);
      if constexpr (kDropout) {
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i] = (keep >> i) & 1u ? x[i] * drop.inv_keep : 0.f;
      }
    } else {
      named_bar_sync(kXchFull + s, 256);
      float p[32];
#pragma unroll
      for (int k4 = 0; k4 < 8; ++k4) {
        const float4 v4 = xb[k4 * 128 + tid];
        p[4 * k4] = v4.x;
        p[4 * k4 + 1] = v4.y;
        p[4 * k4 + 2] = v4.z;
        p[4 * k4 + 3] = v4.w;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // dS^T = P^T * (dropout(dP~^T) - D)
        float dpe = x[i];
        if constexpr (kDropout) dpe = signbit(p[i]) ? 0.f : dpe * drop.inv_keep;
        x[i] = fabsf(p[i]) * (dpe - qd[2 * (i >> 2) + (i & 1)]);
      }
      if (t + 2 < ring.n_tiles) named_bar_arrive(kXchEmpty + s, 256);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pack_a(a[kk], x + 8 * kk);

    // dV[64 x 224] += dropout(P)^T dO, or dK[64 x 224] += dS^T Q; the
    // registers of a stay untouched until it is done.
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n224k16_rs_mn(acc, a[kk], mnmajor_desc(v_side ? dOs : Qs, kk), 1);
    wgmma_commit();
    if (t + 1 < ring.n_tiles) issue_first(t + 1);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  __nv_bfloat16* dst = v_side ? dv : dk;
  const float sc = v_side ? 1.f : scale;
  const size_t row_stride = (size_t)nh * kD;
  const size_t head_off = (size_t)b * n * row_stride + (size_t)h * kD;
#pragma unroll
  for (int j = 0; j < 28; ++j) {
    const int col = j * 8 + 2 * t4;
    if (ka < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + head_off + (size_t)ka * row_stride + col) =
          __floats2bfloat162_rn(acc[4 * j] * sc, acc[4 * j + 1] * sc);
    if (kb < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + head_off + (size_t)kb * row_stride + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * sc, acc[4 * j + 3] * sc);
  }
}

struct HeadMaps {
  CUtensorMap q, k, v, dout;
};

bool make_maps(HeadMaps* m, const void* q, const void* k, const void* v, const void* dout,
               int bsz, int n, int nh, int q_rows, int kv_rows) {
  const Strides st = blhd_strides(n, nh);
  return head_map(&m->q, q, bsz, n, nh, st, q_rows) && head_map(&m->k, k, bsz, n, nh, st, kv_rows) &&
         head_map(&m->v, v, bsz, n, nh, st, kv_rows) && head_map(&m->dout, dout, bsz, n, nh, st, q_rows);
}

template <bool kDropout>
cudaError_t launch_dq_sm90(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* bias, const void* stats, void* dbuf,
                           void* dq, int bsz, int n, int nh, float scale, Dropout drop,
                           cudaStream_t s) {
  HeadMaps m;
  if (!make_maps(&m, q, k, v, dout, bsz, n, nh, kDqRows, kRows)) return cudaErrorInvalidValue;
  auto* kernel = attn_bwd_dq_sm90<kDropout>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)DqSmem::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + kDqRows - 1) / kDqRows, nh, bsz), kThreadsSm90, DqSmem::bytes, s>>>(
      m.q, m.k, m.v, m.dout, (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
      (const float*)bias, (const float*)stats, (float*)dbuf, (__nv_bfloat16*)dq, n, nh, scale, drop);
  return cudaSuccess;
}

template <bool kDropout>
cudaError_t launch_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                            const void* bias, const void* stats, const void* dbuf, void* dk,
                            void* dv, int bsz, int n, int nh, float scale, Dropout drop,
                            cudaStream_t s) {
  HeadMaps m;
  if (!make_maps(&m, q, k, v, dout, bsz, n, nh, kRows, kRows)) return cudaErrorInvalidValue;
  auto* kernel = attn_bwd_dkv_sm90<kDropout>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)DkvSmem::bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + kRows - 1) / kRows, nh, bsz), kThreadsSm90, DkvSmem::bytes, s>>>(
      m.q, m.k, m.v, m.dout, (const float*)bias, (const float*)stats, (const float*)dbuf,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, n, nh, scale, drop);
  return cudaSuccess;
}

// ----------------------------------------------------------------- f32 path
constexpr int kF = 32;  // rows of every f32 tile
constexpr int kThreadsF32 = 128;

// D of the 32 rows of a tile: warp w takes rows w, w + 4, ...; dO from shared
// memory (pitch ld), O from global memory.
__device__ __forceinline__ void row_dots_f32(float* dst, const float* dOs, int ld, const float* o,
                                             size_t head_off, size_t row_stride, int row0, int n,
                                             int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kF; r += kThreadsF32 / 32) {
    float acc = 0.f;
    if (row0 + r < n)
      for (int c = lane; c < d; c += 32)
        acc = fmaf(dOs[r * ld + c], o[head_off + (size_t)(row0 + r) * row_stride + c], acc);
    acc = warp_sum(acc);
    if (lane == 0) dst[r] = acc;
  }
}

// Rows [row0, row0 + 32) of one head into shared memory (pitch d + 1), zero
// past n.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, size_t row_stride,
                                              int row0, int n, int d) {
  const int ld = d + 1;
  for (int idx = threadIdx.x; idx < kF * d; idx += kThreadsF32) {
    const int r = idx / d, c = idx - r * d;
    dst[r * ld + c] = row0 + r < n ? src[(size_t)(row0 + r) * row_stride + c] : 0.f;
  }
}

size_t smem_dq_f32(int d) {
  return sizeof(float) * ((size_t)5 * kF * (d + 1) + kF * (kF + 1) + 3 * kF);
}
size_t smem_dkv_f32(int d) {
  return sizeof(float) * ((size_t)6 * kF * (d + 1) + 2 * kF * (kF + 1) + 3 * kF);
}

template <bool kDropout>
__global__ void __launch_bounds__(kThreadsF32)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ o,
                const float* __restrict__ dout, const float* __restrict__ bias,
                const float* __restrict__ stats, float* __restrict__ dq, int n, int nh, int d,
                float scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + 1;
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kF * ld;
  float* Ks = dOs + kF * ld;
  float* Vs = Ks + kF * ld;
  float* dQs = Vs + kF * ld;
  float* dS = dQs + kF * ld;  // [kF][kF + 1]
  float* rm = dS + kF * (kF + 1);
  float* rl = rm + kF;
  float* rd = rl + kF;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row_stride = (size_t)nh * d;
  const size_t head_off = (size_t)b * n * row_stride + (size_t)h * d;
  const float* st = stats + ((size_t)b * nh + h) * n * 2;
  const uint32_t cell = (uint32_t)(b * nh + h);

  load_rows_f32(Qs, q + head_off, row_stride, q0, n, d);
  load_rows_f32(dOs, dout + head_off, row_stride, q0, n, d);
  for (int idx = threadIdx.x; idx < kF * d; idx += kThreadsF32) {
    const int r = idx / d, c = idx - r * d;
    dQs[r * ld + c] = 0.f;
  }
  if (threadIdx.x < kF) {
    const int qi = q0 + threadIdx.x;
    rm[threadIdx.x] = qi < n ? st[(size_t)qi * 2] : 0.f;
    rl[threadIdx.x] = qi < n ? st[(size_t)qi * 2 + 1] : 1.f;
  }
  __syncthreads();
  row_dots_f32(rd, dOs, ld, o, head_off, row_stride, q0, n, d);

  for (int k0 = 0; k0 < n; k0 += kF) {
    __syncthreads();
    load_rows_f32(Ks, k + head_off, row_stride, k0, n, d);
    load_rows_f32(Vs, v + head_off, row_stride, k0, n, d);
    __syncthreads();
    // Warp w takes rows w, w + 4, ...; lane = key.
    for (int r = warp; r < kF; r += kThreadsF32 / 32) {
      const int key = k0 + lane;
      float sdot = 0.f, pdot = 0.f;
      for (int c = 0; c < d; ++c) {
        sdot = fmaf(Qs[r * ld + c], Ks[lane * ld + c], sdot);
        pdot = fmaf(dOs[r * ld + c], Vs[lane * ld + c], pdot);
      }
      float ds = 0.f;
      if (key < n) {
        const float p = expf(sdot * scale + bias[(size_t)b * n + key] - rm[r]) / rl[r];
        if constexpr (kDropout)
          pdot = dropout_keep(dropout_row((uint32_t)(q0 + r), drop.seed, cell), (uint32_t)key,
                              drop.thresh) ? pdot * drop.inv_keep : 0.f;
        ds = p * (pdot - rd[r]);
      }
      dS[r * (kF + 1) + lane] = ds;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kF * d; idx += kThreadsF32) {
      const int r = idx / d, c = idx - r * d;
      float acc = 0.f;
      for (int j = 0; j < kF; ++j) acc = fmaf(dS[r * (kF + 1) + j], Ks[j * ld + c], acc);
      dQs[r * ld + c] += acc * scale;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kF * d; idx += kThreadsF32) {
    const int r = idx / d, c = idx - r * d;
    if (q0 + r < n) dq[head_off + (size_t)(q0 + r) * row_stride + c] = dQs[r * ld + c];
  }
}

template <bool kDropout>
__global__ void __launch_bounds__(kThreadsF32)
attn_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout, const float* __restrict__ bias,
                 const float* __restrict__ stats, float* __restrict__ dk, float* __restrict__ dv,
                 int n, int nh, int d, float scale, Dropout drop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = d + 1;
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kF * ld;
  float* Qs = Vs + kF * ld;
  float* dOs = Qs + kF * ld;
  float* dKs = dOs + kF * ld;
  float* dVs = dKs + kF * ld;
  float* Pt = dVs + kF * ld;       // [kF keys][kF + 1]: dropout(P)^T
  float* dSt = Pt + kF * (kF + 1);  // [kF keys][kF + 1]: dS^T
  float* qm = dSt + kF * (kF + 1);
  float* ql = qm + kF;
  float* qd = ql + kF;

  const int h = blockIdx.y, b = blockIdx.z;
  const int key0 = blockIdx.x * kF;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row_stride = (size_t)nh * d;
  const size_t head_off = (size_t)b * n * row_stride + (size_t)h * d;
  const float* st = stats + ((size_t)b * nh + h) * n * 2;
  const uint32_t cell = (uint32_t)(b * nh + h);

  load_rows_f32(Ks, k + head_off, row_stride, key0, n, d);
  load_rows_f32(Vs, v + head_off, row_stride, key0, n, d);
  for (int idx = threadIdx.x; idx < kF * d; idx += kThreadsF32) {
    const int r = idx / d, c = idx - r * d;
    dKs[r * ld + c] = 0.f;
    dVs[r * ld + c] = 0.f;
  }
  for (int q0 = 0; q0 < n; q0 += kF) {
    __syncthreads();
    load_rows_f32(Qs, q + head_off, row_stride, q0, n, d);
    load_rows_f32(dOs, dout + head_off, row_stride, q0, n, d);
    if (threadIdx.x < kF) {
      const int qi = q0 + threadIdx.x;
      qm[threadIdx.x] = qi < n ? st[(size_t)qi * 2] : 0.f;
      ql[threadIdx.x] = qi < n ? st[(size_t)qi * 2 + 1] : 1.f;
    }
    __syncthreads();
    row_dots_f32(qd, dOs, ld, o, head_off, row_stride, q0, n, d);
    __syncthreads();
    // Warp w takes keys w, w + 4, ...; lane = query.
    for (int r = warp; r < kF; r += kThreadsF32 / 32) {
      const int key = key0 + r, qi = q0 + lane;
      float sdot = 0.f, pdot = 0.f;
      for (int c = 0; c < d; ++c) {
        sdot = fmaf(Ks[r * ld + c], Qs[lane * ld + c], sdot);
        pdot = fmaf(Vs[r * ld + c], dOs[lane * ld + c], pdot);
      }
      float pt = 0.f, ds = 0.f;
      if (key < n && qi < n) {
        const float p = expf(sdot * scale + bias[(size_t)b * n + key] - qm[lane]) / ql[lane];
        pt = p;
        if constexpr (kDropout) {
          const bool keep = dropout_keep(dropout_row((uint32_t)qi, drop.seed, cell),
                                         (uint32_t)key, drop.thresh);
          pt = keep ? p * drop.inv_keep : 0.f;
          pdot = keep ? pdot * drop.inv_keep : 0.f;
        }
        ds = p * (pdot - qd[lane]);
      }
      Pt[r * (kF + 1) + lane] = pt;
      dSt[r * (kF + 1) + lane] = ds;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kF * d; idx += kThreadsF32) {
      const int r = idx / d, c = idx - r * d;
      float av = 0.f, ak = 0.f;
      for (int j = 0; j < kF; ++j) {
        av = fmaf(Pt[r * (kF + 1) + j], dOs[j * ld + c], av);
        ak = fmaf(dSt[r * (kF + 1) + j], Qs[j * ld + c], ak);
      }
      dVs[r * ld + c] += av;
      dKs[r * ld + c] += ak * scale;
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kF * d; idx += kThreadsF32) {
    const int r = idx / d, c = idx - r * d;
    if (key0 + r < n) {
      dk[head_off + (size_t)(key0 + r) * row_stride + c] = dKs[r * ld + c];
      dv[head_off + (size_t)(key0 + r) * row_stride + c] = dVs[r * ld + c];
    }
  }
}

bool bad_shape(int bsz, int n, int nh, int d, int is_bf16) {
  if (bsz <= 0 || n <= 0 || nh <= 0 || d <= 0 || d > kHeadDimCap) return true;
  return is_bf16 && d != 224;  // BF16_HEAD_DIMS in ops/attention.py
}

}  // namespace

// Arguments as tf_attention_fwd's, plus o (the forward's output), dout, the
// [B, H, N] f32 row buffer d_rows and the gradient outputs; stats are the
// forward's [B, H, N, 2] (m, l). The bf16 path writes D = rowsum(dO * O) to
// d_rows for tf_attention_bwd_dkv, which reads it in place of O; the f32
// path computes D in each kernel and leaves d_rows alone.
extern "C" int tf_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* bias, const void* stats,
                                   void* d_rows, void* dq, int bsz, int n, int nh, int d,
                                   float scale, int is_bf16, unsigned seed, unsigned thresh,
                                   float inv_keep, int dropout, void* stream) {
  if (bad_shape(bsz, n, nh, d, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Dropout drop{seed, thresh, inv_keep};
  cudaError_t err;
  if (is_bf16) {
    err = dropout ? launch_dq_sm90<true>(q, k, v, o, dout, bias, stats, d_rows, dq, bsz, n, nh,
                                         scale, drop, s)
                  : launch_dq_sm90<false>(q, k, v, o, dout, bias, stats, d_rows, dq, bsz, n, nh,
                                          scale, drop, s);
  } else {
    const size_t smem = smem_dq_f32(d);
    auto* kernel = dropout ? attn_bwd_dq_f32<true> : attn_bwd_dq_f32<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      kernel<<<dim3((n + kF - 1) / kF, nh, bsz), kThreadsF32, smem, s>>>(
          (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dout,
          (const float*)bias, (const float*)stats, (float*)dq, n, nh, d, scale, drop);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch after tf_attention_bwd_dq on the same stream: the bf16 path reads
// the D rows it wrote (and not o).
extern "C" int tf_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* bias, const void* stats,
                                    const void* d_rows, void* dk, void* dv, int bsz, int n, int nh,
                                    int d, float scale, int is_bf16, unsigned seed,
                                    unsigned thresh, float inv_keep, int dropout, void* stream) {
  if (bad_shape(bsz, n, nh, d, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Dropout drop{seed, thresh, inv_keep};
  cudaError_t err;
  if (is_bf16) {
    err = dropout ? launch_dkv_sm90<true>(q, k, v, dout, bias, stats, d_rows, dk, dv, bsz, n, nh,
                                          scale, drop, s)
                  : launch_dkv_sm90<false>(q, k, v, dout, bias, stats, d_rows, dk, dv, bsz, n, nh,
                                           scale, drop, s);
  } else {
    const size_t smem = smem_dkv_f32(d);
    auto* kernel = dropout ? attn_bwd_dkv_f32<true> : attn_bwd_dkv_f32<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      kernel<<<dim3((n + kF - 1) / kF, nh, bsz), kThreadsF32, smem, s>>>(
          (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dout,
          (const float*)bias, (const float*)stats, (float*)dk, (float*)dv, n, nh, d, scale, drop);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
