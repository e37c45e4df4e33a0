// K3 and K4: the backward pass of K2 (attention.cu), [B, N, H, D] layout.
//
// K3 (tf_attention_bwd_dq) replaces the Pallas kernel
// transfusion_tpu/ops/attention.py:253 (_bwd_dq_kernel, launched by
// _flash_bwd at :432); K4 (tf_attention_bwd_dkv) replaces :297
// (_bwd_dkv_kernel, launched at :442). With the probabilities rebuilt from
// the forward's stored f32 statistics, P = exp(s - m) / l for
// s = q k^T * scale + bias_key, and D = rowsum(dO * O) in f32:
//   dP = dropout(dO v^T) (the forward's keep mask, scaled by 1 / (1 - rate)),
//   dS = P * (dP - D), rounded to the input dtype before its products,
//   dQ = dS k * scale,   dK = dS^T q * scale,   dV = dropout(P)^T dO,
// each accumulated in f32 and stored in the input dtype. The dropout mask is
// regenerated from the hash of dropout.cuh at global (query, key) indices,
// so it is the forward's bit for bit.
//
// Bound on the H100: operations. At the fusion stack's level 0 (B 8,
// N 3136, H 4, D 224) K3 does 3 products of 2 B H N^2 D flops (0.42 TFLOP)
// and K4 4 (0.56 TFLOP) against 0.06 GB of q/k/v/o/dO.
//
// Design (bf16): mma.sync m16n8k16 with ldmatrix operand loads and the
// register hand-over of mma_bf16.cuh, tiles of 64 rows read strided from
// [B, N, H, D] with cp.async (no transpose, no padding; D = 224 is 14 steps
// of 16). K3: one 8-warp block per (b, h, 128-query tile); each warp owns 16
// query rows and keeps their 16 x D dQ accumulator in registers while the
// block streams 64-key tiles of K and V. K4: one 8-warp block per (b, h,
// 64-key tile) streams 64-query tiles of Q and dO; warps 0-3 own dV and
// warps 4-7 own dK of 16 keys each, so each warp keeps one 16 x D
// accumulator in registers (both at once would not fit in 255 registers);
// both halves recompute S^T = K Q^T, which costs a fifth more products
// than the minimum. D is computed in the kernels from dO (in shared memory)
// and O (read from global memory), as the TPU kernels do. Tile loads are not
// yet overlapped with the products.
//
// Design (f32, for tight checks): 32 x 32 tiles in shared memory with plain
// FMA, no tensor cores, any D <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kHeadDimCap = 256;

struct Dropout {
  uint32_t seed, thresh;
  float inv_keep;
};

// dot(a[0:n], b[0:n]) of a bf16 row in shared memory and one in global
// memory, in f32; n is a multiple of 8 and both rows are 16-byte aligned.
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
constexpr int kTile = 64;        // rows of a streamed K/V (K3) or Q/dO (K4) tile
constexpr int kWarps = 8;
constexpr int kThreadsBf16 = kWarps * 32;
constexpr int kDqRows = kWarps * 16;  // query rows of a K3 block

template <int kD>
constexpr size_t smem_dq_bf16() {
  return sizeof(__nv_bfloat16) * (size_t)(2 * kDqRows + 2 * kTile) * (kD + 8);
}
template <int kD>
constexpr size_t smem_dkv_bf16() {
  return sizeof(__nv_bfloat16) * (size_t)(4 * kTile) * (kD + 8) + sizeof(float) * 3 * kTile;
}

template <int kD, bool kDropout>
__global__ void __launch_bounds__(kThreadsBf16, 1)
attn_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout, const float* __restrict__ bias,
                 const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq, int n, int nh,
                 float scale, Dropout drop) {
  constexpr int kNT = kD / 8;     // 8-wide column tiles of the dQ accumulator
  constexpr int kST = kTile / 8;  // 8-key column tiles of a score tile
  constexpr int ld = kD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dOs = Qs + kDqRows * ld;
  __nv_bfloat16* Ks = dOs + kDqRows * ld;
  __nv_bfloat16* Vs = Ks + kTile * ld;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kDqRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t row_stride = (size_t)nh * kD;
  const size_t head_off = (size_t)b * n * row_stride + (size_t)h * kD;
  const float* key_bias = bias + (size_t)b * n;
  const float* st = stats + ((size_t)b * nh + h) * n * 2;
  const int r0 = warp * 16;
  const int qa = q0 + r0 + g, qb = qa + 8;

  load_tile_async<kD, kThreadsBf16>(Qs, q + head_off, row_stride, q0, kDqRows, n);
  load_tile_async<kD, kThreadsBf16>(dOs, dout + head_off, row_stride, q0, kDqRows, n);
  load_tile_async<kD, kThreadsBf16>(Ks, k + head_off, row_stride, 0, kTile, n);
  load_tile_async<kD, kThreadsBf16>(Vs, v + head_off, row_stride, 0, kTile, n);
  cp_async_commit();

  // Row statistics of rows g and g + 8 (rows past N: P is never used).
  const float m_a = qa < n ? st[(size_t)qa * 2] : 0.f, l_a = qa < n ? st[(size_t)qa * 2 + 1] : 1.f;
  const float m_b = qb < n ? st[(size_t)qb * 2] : 0.f, l_b = qb < n ? st[(size_t)qb * 2 + 1] : 1.f;
  const float inv_la = 1.f / l_a, inv_lb = 1.f / l_b;
  uint32_t drop_a = 0, drop_b = 0;
  if constexpr (kDropout) {
    const uint32_t cell = (uint32_t)(b * nh + h);
    drop_a = dropout_row((uint32_t)qa, drop.seed, cell);
    drop_b = dropout_row((uint32_t)qb, drop.seed, cell);
  }

  cp_async_wait_all();
  __syncthreads();

  // D of rows g and g + 8: the quad's four lanes split the head dim.
  float d_a = 0.f, d_b = 0.f;
  {
    constexpr int part = kD / 4;  // 56 at D = 224: seven 16-byte vectors
    static_assert(part % 8 == 0, "head dim / 4 must be a multiple of 8");
    if (qa < n)
      d_a = dot_bf16_rows(dOs + (r0 + g) * ld + t * part,
                          o + head_off + (size_t)qa * row_stride + t * part, part);
    if (qb < n)
      d_b = dot_bf16_rows(dOs + (r0 + g + 8) * ld + t * part,
                          o + head_off + (size_t)qb * row_stride + t * part, part);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      d_a += __shfl_xor_sync(0xffffffffu, d_a, off);
      d_b += __shfl_xor_sync(0xffffffffu, d_b, off);
    }
  }

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kTile) {
    // S = Q K^T and dP~ = dO V^T for this warp's 16 rows x 64 keys.
    float s[kST][4], dp[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a<ld>(aq, Qs, r0, kk * 16);
      load_a<ld>(ado, dOs, r0, kk * 16);
#pragma unroll
      for (int j = 0; j < kST / 2; ++j) {
        uint32_t bk[4], bv[4];
        load_b_rows_n<ld>(bk, Ks, j * 16, kk * 16);
        load_b_rows_n<ld>(bv, Vs, j * 16, kk * 16);
        mma_bf16(s[2 * j], aq, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * j], ado, bv[0], bv[1]);
        mma_bf16(dp[2 * j + 1], ado, bv[2], bv[3]);
      }
    }
    // dS = P * (dropout(dP~) - D), packed as the A operand of dS K.
    uint32_t da[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) {
      const int key = k0 + j * 8 + 2 * t;
      const float bias0 = key < n ? key_bias[key] : -INFINITY;
      const float bias1 = key + 1 < n ? key_bias[key + 1] : -INFINITY;
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool row_b = e >= 2;
        const float sc = s[j][e] * scale + ((e & 1) ? bias1 : bias0);
        const float p = row_b ? fast_exp_diff(sc, m_b) * inv_lb : fast_exp_diff(sc, m_a) * inv_la;
        float dpe = dp[j][e];
        if constexpr (kDropout)
          dpe = dropout_keep(row_b ? drop_b : drop_a, (uint32_t)(key + (e & 1)), drop.thresh)
                    ? dpe * drop.inv_keep : 0.f;
        ds[e] = p * (dpe - (row_b ? d_b : d_a));
      }
      da[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      da[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ[16 x D] += dS K.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        uint32_t bk[4];
        load_b_rows_k<ld>(bk, Ks, kk * 16, j * 16);
        mma_bf16(acc[2 * j], da[kk], bk[0], bk[1]);
        mma_bf16(acc[2 * j + 1], da[kk], bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this K/V tile
    if (k0 + kTile < n) {
      load_tile_async<kD, kThreadsBf16>(Ks, k + head_off, row_stride, k0 + kTile, kTile, n);
      load_tile_async<kD, kThreadsBf16>(Vs, v + head_off, row_stride, k0 + kTile, kTile, n);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int c = j * 8 + 2 * t;
    if (qa < n)
      *reinterpret_cast<__nv_bfloat162*>(dq + head_off + (size_t)qa * row_stride + c) =
          __floats2bfloat162_rn(acc[j][0] * scale, acc[j][1] * scale);
    if (qb < n)
      *reinterpret_cast<__nv_bfloat162*>(dq + head_off + (size_t)qb * row_stride + c) =
          __floats2bfloat162_rn(acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int kD, bool kDropout>
__global__ void __launch_bounds__(kThreadsBf16, 1)
attn_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout, const float* __restrict__ bias,
                  const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int n, int nh, float scale, Dropout drop) {
  constexpr int kNT = kD / 8;
  constexpr int kST = kTile / 8;  // 8-query column tiles of a transposed score tile
  constexpr int ld = kD + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + kTile * ld;
  __nv_bfloat16* Qs = Vs + kTile * ld;
  __nv_bfloat16* dOs = Qs + kTile * ld;
  float* qm = reinterpret_cast<float*>(dOs + kTile * ld);
  float* qinv_l = qm + kTile;
  float* qd = qinv_l + kTile;

  const int h = blockIdx.y, b = blockIdx.z;
  const int key0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool dk_warp = warp >= 4;
  const int kr0 = (warp & 3) * 16;  // this warp's 16 keys within the tile
  const size_t row_stride = (size_t)nh * kD;
  const size_t head_off = (size_t)b * n * row_stride + (size_t)h * kD;
  const float* st = stats + ((size_t)b * nh + h) * n * 2;
  const int ka = key0 + kr0 + g, kb = ka + 8;  // rows g and g + 8 are keys
  const float bias_a = ka < n ? bias[(size_t)b * n + ka] : -INFINITY;
  const float bias_b = kb < n ? bias[(size_t)b * n + kb] : -INFINITY;
  const uint32_t cell = (uint32_t)(b * nh + h);

  load_tile_async<kD, kThreadsBf16>(Ks, k + head_off, row_stride, key0, kTile, n);
  load_tile_async<kD, kThreadsBf16>(Vs, v + head_off, row_stride, key0, kTile, n);
  cp_async_commit();

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kTile) {
    load_tile_async<kD, kThreadsBf16>(Qs, q + head_off, row_stride, q0, kTile, n);
    load_tile_async<kD, kThreadsBf16>(dOs, dout + head_off, row_stride, q0, kTile, n);
    cp_async_commit();
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      qm[threadIdx.x] = qi < n ? st[(size_t)qi * 2] : 0.f;
      qinv_l[threadIdx.x] = qi < n ? 1.f / st[(size_t)qi * 2 + 1] : 0.f;  // 0: P = 0 past N
    }
    cp_async_wait_all();
    __syncthreads();
    {  // D of the tile's 64 queries: four lanes a query split the head dim.
      constexpr int part = kD / 4;
      const int r = threadIdx.x >> 2, quarter = threadIdx.x & 3;
      float d = 0.f;
      if (q0 + r < n)
        d = dot_bf16_rows(dOs + r * ld + quarter * part,
                          o + head_off + (size_t)(q0 + r) * row_stride + quarter * part, part);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (quarter == 0) qd[r] = d;
    }
    __syncthreads();

    // S^T = K Q^T (16 keys x 64 queries); the dK warps also dP~^T = V dO^T.
    float s[kST][4], dp[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    if (dk_warp) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a<ld>(ak, Ks, kr0, kk * 16);
        load_a<ld>(av, Vs, kr0, kk * 16);
#pragma unroll
        for (int j = 0; j < kST / 2; ++j) {
          uint32_t bq[4], bd[4];
          load_b_rows_n<ld>(bq, Qs, j * 16, kk * 16);
          load_b_rows_n<ld>(bd, dOs, j * 16, kk * 16);
          mma_bf16(s[2 * j], ak, bq[0], bq[1]);
          mma_bf16(s[2 * j + 1], ak, bq[2], bq[3]);
          mma_bf16(dp[2 * j], av, bd[0], bd[1]);
          mma_bf16(dp[2 * j + 1], av, bd[2], bd[3]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        uint32_t ak[4];
        load_a<ld>(ak, Ks, kr0, kk * 16);
#pragma unroll
        for (int j = 0; j < kST / 2; ++j) {
          uint32_t bq[4];
          load_b_rows_n<ld>(bq, Qs, j * 16, kk * 16);
          mma_bf16(s[2 * j], ak, bq[0], bq[1]);
          mma_bf16(s[2 * j + 1], ak, bq[2], bq[3]);
        }
      }
    }

    // dV warps: dropout(P)^T; dK warps: dS^T = P^T * (dropout(dP~^T) - D).
    uint32_t pa[kTile / 16][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) {
      const int qc = j * 8 + 2 * t;  // tile-local query of element 0
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool row_b = e >= 2;
        const int ql = qc + (e & 1);
        const float sc = s[j][e] * scale + (row_b ? bias_b : bias_a);
        const float p = fast_exp_diff(sc, qm[ql]) * qinv_l[ql];
        bool keep = true;
        if constexpr (kDropout)
          keep = dropout_keep(dropout_row((uint32_t)(q0 + ql), drop.seed, cell),
                              (uint32_t)(row_b ? kb : ka), drop.thresh);
        if (dk_warp) {
          float dpe = dp[j][e];
          if constexpr (kDropout) dpe = keep ? dpe * drop.inv_keep : 0.f;
          x[e] = p * (dpe - qd[ql]);
        } else {
          x[e] = kDropout ? (keep ? p * drop.inv_keep : 0.f) : p;
        }
      }
      pa[j / 2][(j & 1) * 2] = pack_bf16(x[0], x[1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(x[2], x[3]);
    }
    // dV[16 x D] += dropout(P)^T dO, or dK[16 x D] += dS^T Q.
    const __nv_bfloat16* rhs = dk_warp ? Qs : dOs;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        uint32_t bb[4];
        load_b_rows_k<ld>(bb, rhs, kk * 16, j * 16);
        mma_bf16(acc[2 * j], pa[kk], bb[0], bb[1]);
        mma_bf16(acc[2 * j + 1], pa[kk], bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this Q/dO tile
  }

  __nv_bfloat16* dst = dk_warp ? dk : dv;
  const float sc = dk_warp ? scale : 1.f;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int c = j * 8 + 2 * t;
    if (ka < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + head_off + (size_t)ka * row_stride + c) =
          __floats2bfloat162_rn(acc[j][0] * sc, acc[j][1] * sc);
    if (kb < n)
      *reinterpret_cast<__nv_bfloat162*>(dst + head_off + (size_t)kb * row_stride + c) =
          __floats2bfloat162_rn(acc[j][2] * sc, acc[j][3] * sc);
  }
}

template <int kD, bool kDropout>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* bias, const void* stats, void* dq,
                           int bsz, int n, int nh, float scale, Dropout drop, cudaStream_t s) {
  constexpr size_t smem = smem_dq_bf16<kD>();
  auto* kernel = attn_bwd_dq_bf16<kD, kDropout>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kDqRows - 1) / kDqRows, nh, bsz);
  kernel<<<grid, kThreadsBf16, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)bias,
      (const float*)stats, (__nv_bfloat16*)dq, n, nh, scale, drop);
  return cudaSuccess;
}

template <int kD, bool kDropout>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* bias, const void* stats, void* dk,
                            void* dv, int bsz, int n, int nh, float scale, Dropout drop,
                            cudaStream_t s) {
  constexpr size_t smem = smem_dkv_bf16<kD>();
  auto* kernel = attn_bwd_dkv_bf16<kD, kDropout>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, nh, bsz);
  kernel<<<grid, kThreadsBf16, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)bias,
      (const float*)stats, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, n, nh, scale, drop);
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

// Arguments as tf_attention_fwd's, plus o (the forward's output), dout and
// the gradient outputs; stats are the forward's [B, H, N, 2] (m, l).
extern "C" int tf_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* bias, const void* stats,
                                   void* dq, int bsz, int n, int nh, int d, float scale,
                                   int is_bf16, unsigned seed, unsigned thresh, float inv_keep,
                                   int dropout, void* stream) {
  if (bad_shape(bsz, n, nh, d, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Dropout drop{seed, thresh, inv_keep};
  cudaError_t err;
  if (is_bf16) {
    err = dropout ? launch_dq_bf16<224, true>(q, k, v, o, dout, bias, stats, dq, bsz, n, nh, scale,
                                              drop, s)
                  : launch_dq_bf16<224, false>(q, k, v, o, dout, bias, stats, dq, bsz, n, nh,
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

extern "C" int tf_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* bias, const void* stats,
                                    void* dk, void* dv, int bsz, int n, int nh, int d, float scale,
                                    int is_bf16, unsigned seed, unsigned thresh, float inv_keep,
                                    int dropout, void* stream) {
  if (bad_shape(bsz, n, nh, d, is_bf16)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Dropout drop{seed, thresh, inv_keep};
  cudaError_t err;
  if (is_bf16) {
    err = dropout ? launch_dkv_bf16<224, true>(q, k, v, o, dout, bias, stats, dk, dv, bsz, n, nh,
                                               scale, drop, s)
                  : launch_dkv_bf16<224, false>(q, k, v, o, dout, bias, stats, dk, dv, bsz, n,
                                                nh, scale, drop, s);
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
