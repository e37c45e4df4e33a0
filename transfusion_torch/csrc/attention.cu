// K2: self-attention forward with a key-padding bias, [B, N, H, D] layout.
//
// Replaces the Pallas kernel transfusion_tpu/ops/attention.py:226
// (_fwd_kernel, launched by _flash_fwd at :372 for flash_attention_train),
// at dropout rate 0 (eval). It computes
//   o = softmax(q k^T * scale + bias_key) v,   bias_key = 0 or -1e30,
// dividing by the row sum l after the P.V product, and writes the per-row
// f32 softmax statistics (m, l) to stats[B, H, N, 2] for the backward pass
// of a later port.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kHeadDimCap = 256;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// exp(a - b) that is 0 when a is -inf (a key past N or an empty running max).
__device__ __forceinline__ float exp_diff(float a, float b) {
  return a == -INFINITY ? 0.f : expf(a - b);
}

// ---------------------------------------------------------------- bf16 path
constexpr int kBQ = 64, kBK = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp(a - b) on the fast path, 0 when a is -inf (a key past N).
__device__ __forceinline__ float fast_exp_diff(float a, float b) {
  return a == -INFINITY ? 0.f : __expf(a - b);
}

// Start copying rows [row0, row0 + rows) of one head into shared memory
// (row pitch kD + 8); rows at or past n are zero-filled.
template <int kD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                size_t row_stride, int row0, int rows, int n) {
  constexpr int vecs = kD / 8, ld = kD + 8;
  for (int idx = threadIdx.x; idx < rows * vecs; idx += kThreads) {
    const int r = idx / vecs, c = (idx - r * vecs) * 8;
    __nv_bfloat16* s = dst + r * ld + c;
    if (row0 + r < n)
      cp_async16(s, src + (size_t)(row0 + r) * row_stride + c);
    else
      *reinterpret_cast<uint4*>(s) = make_uint4(0u, 0u, 0u, 0u);
  }
}

size_t smem_bf16(int d) { return sizeof(__nv_bfloat16) * (size_t)(kBQ + 2 * kBK) * (d + 8); }

// The head dim kD is a compile-time constant: every loop over it unrolls
// without guards, so the compiler can overlap one step's ldmatrix with the
// previous step's mma.
template <int kD>
__global__ void __launch_bounds__(kThreads, 2)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
              __nv_bfloat16* __restrict__ out, float* __restrict__ stats,
              int n, int nh, float scale) {
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
  const size_t row_stride = (size_t)nh * kD;
  const size_t head_off = (size_t)b * n * row_stride + (size_t)h * kD;
  const float* key_bias = bias + (size_t)b * n;
  const int r0 = warp * 16;

  load_tile_async<kD>(Qs, q + head_off, row_stride, q0, kBQ, n);
  load_tile_async<kD>(Ks, k + head_off, row_stride, 0, kBK, n);
  cp_async_commit();
  load_tile_async<kD>(Vs, v + head_off, row_stride, 0, kBK, n);
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
    if (k0 + kBK < n) load_tile_async<kD>(Ks, k + head_off, row_stride, k0 + kBK, kBK, n);
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
      const float p0 = fast_exp_diff(s[j][0], mx[0]), p1 = fast_exp_diff(s[j][1], mx[0]);
      const float p2 = fast_exp_diff(s[j][2], mx[1]), p3 = fast_exp_diff(s[j][3], mx[1]);
      ps[0] += p0 + p1;
      ps[1] += p2 + p3;
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
    if (k0 + kBK < n) load_tile_async<kD>(Vs, v + head_off, row_stride, k0 + kBK, kBK, n);
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
  if (t == 0) {
    float* st = stats + ((size_t)b * nh + h) * n * 2;
    if (qa < n) {
      st[(size_t)qa * 2] = row_m[0];
      st[(size_t)qa * 2 + 1] = row_l[0];
    }
    if (qb < n) {
      st[(size_t)qb * 2] = row_m[1];
      st[(size_t)qb * 2 + 1] = row_l[1];
    }
  }
}

template <int kD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* out,
                        void* stats, int bsz, int n, int nh, float scale, cudaStream_t s) {
  const size_t smem = smem_bf16(kD);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_bf16<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // all of the SM's shared memory, so two blocks fit
    err = cudaFuncSetAttribute(attn_fwd_bf16<kD>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBQ - 1) / kBQ, nh, bsz);
  attn_fwd_bf16<kD><<<grid, kThreads, smem, s>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const float*)bias, (__nv_bfloat16*)out, (float*)stats, n, nh, scale);
  return cudaSuccess;
}

// ----------------------------------------------------------------- f32 path
constexpr int kFQ = 32, kFK = 32;

__global__ void __launch_bounds__(kThreads)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ bias,
             float* __restrict__ out, float* __restrict__ stats,
             int n, int nh, int d, float scale) {
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
  const size_t row_stride = (size_t)nh * d;
  const size_t head_off = (size_t)b * n * row_stride + (size_t)h * d;

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
      Ps[r * (kFK + 1) + lane] = p;
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
  if (threadIdx.x < kFQ && q0 + threadIdx.x < n) {
    float* st = stats + (((size_t)b * nh + h) * n + q0 + threadIdx.x) * 2;
    st[0] = row_m[threadIdx.x];
    st[1] = row_l[threadIdx.x];
  }
}

size_t smem_f32(int d) {
  const int ld = d + 1;
  return sizeof(float) * ((size_t)(2 * kFQ + 2 * kFK) * ld + kFQ * (kFK + 1) + 3 * kFQ);
}

}  // namespace

extern "C" int tf_attention_fwd(const void* q, const void* k, const void* v, const void* bias,
                                void* out, void* stats, int bsz, int n, int nh, int d,
                                float scale, int is_bf16, void* stream) {
  if (bsz <= 0 || n <= 0 || nh <= 0 || d <= 0 || d > kHeadDimCap) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    // The flagship's head dim (896 / 4 heads), BF16_HEAD_DIMS in ops/attention.py.
    if (d != 224) return (int)cudaErrorInvalidValue;
    const cudaError_t err = launch_bf16<224>(q, k, v, bias, out, stats, bsz, n, nh, scale, s);
    if (err != cudaSuccess) return (int)err;
  } else {
    const size_t smem = smem_f32(d);
    cudaError_t err = cudaFuncSetAttribute(attn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + kFQ - 1) / kFQ, nh, bsz);
    attn_fwd_f32<<<grid, kThreads, smem, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)bias, (float*)out,
        (float*)stats, n, nh, d, scale);
  }
  return (int)cudaGetLastError();
}
