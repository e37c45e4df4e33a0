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
// Design (bf16): one 128-thread block (4 warps) per (b, h, 64-query tile),
// two blocks an SM. q/k/v are read strided straight from [B, N, H, D] with
// cp.async: no transpose and no padding copy (D = 224 is 14 tensor-core
// steps of 16). The block loops over 64-key tiles with an f32 online
// softmax, so K/V never need to be resident as a whole (the TPU kernel kept
// all of K/V in VMEM). Each warp owns 16 query rows end to end: Q K^T and
// P V run on the tensor cores as mma.sync m16n8k16 (bf16 in, f32
// accumulate) with operands fetched by ldmatrix, and the scores, the
// probabilities and the 16 x D output accumulator stay in registers (the
// score accumulator's layout is the next product's A operand, so P never
// touches shared memory). P is rounded to bf16 for the P V product as the
// TPU kernel rounds it to the input dtype; m and l stay f32. The next K
// tile loads while the softmax and P V run, the next V tile while Q K^T
// runs. Rows of shared memory are padded by 16 bytes so ldmatrix reads are
// free of bank conflicts.
//
// Design (f32, for tight checks): 32-query by 32-key tiles in shared memory
// with plain FMA, no tensor cores.
//
// K7 (tf_self_attention) replaces the Pallas kernel
// transfusion_tpu/ops/attention.py:29 (_attn_kernel, launched by
// flash_self_attention at :102 for [B, H, N, D] and flash_self_attention_blhd
// at :152 for [B, N, H, D]): the same function without dropout or
// statistics. It is a compile-time variant of K2 (kStats false) whose rows
// are addressed through element strides of batch, position and head, so
// either layout runs without a transpose copy. The TPU kernel takes the
// exact row max over all keys before one exp; K2's online softmax rescales
// by exp(m_old - m_new) as the max grows, which is the same function. In
// bf16, q and k products are exact in f32 (8 x 8 significant bits) whether
// the operands are upcast first, as the TPU kernel does, or multiplied on
// the tensor cores, so only the order of the f32 sums differs; P is rounded
// to bf16 against the running instead of the final max, so outputs may land
// one bf16 ulp apart, and the card checks allow two ulps of max|plain| plus
// a mean bound, as for K2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kHeadDimCap = 256;

// Element strides of batch, sequence position and head: (N H D, H D, D) for
// [B, N, H, D], (H N D, D, N D) for [B, H, N, D]. The head dim is contiguous.
struct Strides {
  long long b, n, h;
};

// exp(a - b) that is 0 when a is -inf (a key past N or an empty running max).
__device__ __forceinline__ float exp_diff(float a, float b) {
  return a == -INFINITY ? 0.f : expf(a - b);
}

// ---------------------------------------------------------------- bf16 path
constexpr int kBQ = 64, kBK = 64;

size_t smem_bf16(int d) { return sizeof(__nv_bfloat16) * (size_t)(kBQ + 2 * kBK) * (d + 8); }

// The head dim kD is a compile-time constant: every loop over it unrolls
// without guards, so the compiler can overlap one step's ldmatrix with the
// previous step's mma.
template <int kD, bool kDropout, bool kStats>
__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
              __nv_bfloat16* __restrict__ out, float* __restrict__ stats,
              int n, int nh, Strides st, float scale, uint32_t seed, uint32_t thresh,
              float inv_keep) {
  static_assert(kD % 16 == 0 && kD <= kHeadDimCap, "head dim");
  constexpr int kNT = kD / 8;   // 8-wide column tiles of the output accumulator
  constexpr int kST = kBK / 8;  // 8-key column tiles of a score tile
  constexpr int ld = kD + 8;    // shared-memory row pitch (+16 bytes)
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBQ * ld;
  __nv_bfloat16* Vs = Ks + kBK * ld;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: which 8x8 matrix, which row
  const size_t row_stride = st.n;
  const size_t head_off = (size_t)b * st.b + (size_t)h * st.h;
  const float* key_bias = bias + (size_t)b * n;
  const int r0 = warp * 16;
  // Dropout hash inputs of rows g and g + 8 (unused at rate 0).
  uint32_t drop_a = 0, drop_b = 0;
  if constexpr (kDropout) {
    const uint32_t cell = (uint32_t)(b * nh + h);
    drop_a = dropout_row((uint32_t)(q0 + r0 + g), seed, cell);
    drop_b = dropout_row((uint32_t)(q0 + r0 + g + 8), seed, cell);
  }

  load_tile_async<kD, kThreads>(Qs, q + head_off, row_stride, q0, kBQ, n);
  load_tile_async<kD, kThreads>(Ks, k + head_off, row_stride, 0, kBK, n);
  cp_async_commit();
  load_tile_async<kD, kThreads>(Vs, v + head_off, row_stride, 0, kBK, n);
  cp_async_commit();

  float o[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float row_m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of this warp
  float row_l[2] = {0.f, 0.f};              // this thread's share of the row sums

  for (int k0 = 0; k0 < n; k0 += kBK) {
    cp_async_wait1();  // Q and this K tile have landed (this V tile may not have)
    __syncthreads();

    // This tile's key biases (-inf past N), read before the product so the
    // loads overlap it. Thread (g, t) holds keys 8j + 2t, +1.
    float kbias[kST][2];
#pragma unroll
    for (int j = 0; j < kST; ++j) {
      const int key = k0 + j * 8 + 2 * t;
      kbias[j][0] = key < n ? key_bias[key] : -INFINITY;
      kbias[j][1] = key + 1 < n ? key_bias[key + 1] : -INFINITY;
    }

    // S[16 x 64] = Q K^T for this warp's rows.
    float s[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + (r0 + (lane & 15)) * ld + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kST / 2; ++j) {
        uint32_t bk[4];  // K rows j*16.. as the B operand of two 8-key tiles
        ldmatrix_x4(bk, Ks + (j * 16 + (mi >> 1) * 8 + mr) * ld + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * j], a, bk[0], bk[1]);
        mma_bf16(s[2 * j + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this K tile: fetch the next
    if (k0 + kBK < n) load_tile_async<kD, kThreads>(Ks, k + head_off, row_stride, k0 + kBK, kBK, n);
    cp_async_commit();

    // Online softmax over rows g and g + 8; a row's 64 keys are spread over
    // the four threads of a quad.
    float mx[2] = {row_m[0], row_m[1]};
#pragma unroll
    for (int j = 0; j < kST; ++j) {
      s[j][0] = s[j][0] * scale + kbias[j][0];
      s[j][1] = s[j][1] * scale + kbias[j][1];
      s[j][2] = s[j][2] * scale + kbias[j][0];
      s[j][3] = s[j][3] * scale + kbias[j][1];
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = fast_exp_diff(row_m[i], mx[i]);
      row_m[i] = mx[i];
    }
    // P as the A operand of P V: score tiles 2kk and 2kk + 1 are the two
    // column halves of k-step kk.
    uint32_t pa[kBK / 16][4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kST; ++j) {
      float p0 = fast_exp_diff(s[j][0], mx[0]), p1 = fast_exp_diff(s[j][1], mx[0]);
      float p2 = fast_exp_diff(s[j][2], mx[1]), p3 = fast_exp_diff(s[j][3], mx[1]);
      ps[0] += p0 + p1;
      ps[1] += p2 + p3;
      if constexpr (kDropout) {  // l keeps the undropped sum
        const uint32_t key = (uint32_t)(k0 + j * 8 + 2 * t);
        p0 = dropout_keep(drop_a, key, thresh) ? p0 * inv_keep : 0.f;
        p1 = dropout_keep(drop_a, key + 1, thresh) ? p1 * inv_keep : 0.f;
        p2 = dropout_keep(drop_b, key, thresh) ? p2 * inv_keep : 0.f;
        p3 = dropout_keep(drop_b, key + 1, thresh) ? p3 * inv_keep : 0.f;
      }
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) row_l[i] = row_l[i] * alpha[i] + ps[i];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    cp_async_wait1();  // this V tile has landed (the next K tile may not have)
    __syncthreads();
    // O[16 x D] += P V.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kNT / 2; ++j) {
        uint32_t bv[4];  // V rows kk*16.. transposed: the B operand of two 8-wide tiles
        ldmatrix_x4_trans(bv, Vs + (kk * 16 + (mi & 1) * 8 + mr) * ld + j * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * j], pa[kk], bv[0], bv[1]);
        mma_bf16(o[2 * j + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this V tile: fetch the next
    if (k0 + kBK < n) load_tile_async<kD, kThreads>(Vs, v + head_off, row_stride, k0 + kBK, kBK, n);
    cp_async_commit();
  }

  // o = O / l in the input dtype; (m, l) to the f32 side output.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row_l[i] += __shfl_xor_sync(0xffffffffu, row_l[i], 1);
    row_l[i] += __shfl_xor_sync(0xffffffffu, row_l[i], 2);
  }
  const int qa = q0 + r0 + g, qb = qa + 8;
  const float inv_a = 1.f / row_l[0], inv_b = 1.f / row_l[1];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int c = j * 8 + 2 * t;
    if (qa < n)
      *reinterpret_cast<__nv_bfloat162*>(out + head_off + (size_t)qa * row_stride + c) =
          __floats2bfloat162_rn(o[j][0] * inv_a, o[j][1] * inv_a);
    if (qb < n)
      *reinterpret_cast<__nv_bfloat162*>(out + head_off + (size_t)qb * row_stride + c) =
          __floats2bfloat162_rn(o[j][2] * inv_b, o[j][3] * inv_b);
  }
  if (kStats && t == 0) {
    float* sr = stats + ((size_t)b * nh + h) * n * 2;
    if (qa < n) {
      sr[(size_t)qa * 2] = row_m[0];
      sr[(size_t)qa * 2 + 1] = row_l[0];
    }
    if (qb < n) {
      sr[(size_t)qb * 2] = row_m[1];
      sr[(size_t)qb * 2 + 1] = row_l[1];
    }
  }
}

template <int kD, bool kDropout, bool kStats>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* out,
                        void* stats, int bsz, int n, int nh, Strides st, float scale,
                        uint32_t seed, uint32_t thresh, float inv_keep, cudaStream_t s) {
  const size_t smem = smem_bf16(kD);
  auto* kernel = attn_fwd_bf16<kD, kDropout, kStats>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess)  // all of the SM's shared memory, so two blocks fit
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBQ - 1) / kBQ, nh, bsz);
  kernel<<<grid, kThreads, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)bias, (__nv_bfloat16*)out, (float*)stats, n, nh, st, scale, seed, thresh,
      inv_keep);
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
    // The flagship's head dim (896 / 4 heads), BF16_HEAD_DIMS in ops/attention.py.
    if (d != 224) return (int)cudaErrorInvalidValue;
    err = dropout ? launch_bf16<224, true, true>(q, k, v, bias, out, stats, bsz, n, nh, st, scale,
                                                 seed, thresh, inv_keep, s)
                  : launch_bf16<224, false, true>(q, k, v, bias, out, stats, bsz, n, nh, st,
                                                  scale, 0u, 0u, 1.f, s);
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
// must start on a 16-byte boundary (bf16: D = 224 only; f32: any D <= 256).
extern "C" int tf_self_attention(const void* q, const void* k, const void* v, const void* bias,
                                 void* out, int bsz, int n, int nh, int d, long long sb,
                                 long long sn, long long sh, float scale, int is_bf16,
                                 void* stream) {
  if (bsz <= 0 || n <= 0 || nh <= 0 || d <= 0 || d > kHeadDimCap) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Strides st{sb, sn, sh};
  cudaError_t err;
  if (is_bf16) {
    if (d != 224) return (int)cudaErrorInvalidValue;
    err = launch_bf16<224, false, false>(q, k, v, bias, out, nullptr, bsz, n, nh, st, scale, 0u, 0u,
                                         1.f, s);
  } else {
    err = launch_f32<false, false>(q, k, v, bias, out, nullptr, bsz, n, nh, d, st, scale, 0u, 0u,
                                   1.f, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
