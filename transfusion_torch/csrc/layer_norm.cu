// K1: (residual-add +) LayerNorm over the last dim, forward.
//
// Replaces the Pallas kernels transfusion_tpu/ops/layer_norm.py:55
// (_ln_kernel) and :59 (_res_ln_kernel), reached through _ln_call and
// FusedLayerNorm on the fusion stack's norm1/norm2/final_norm.
//
// Semantics: s = x (+ r, rounded to the input dtype as the TPU kernel sums
// in the input dtype); mean and E[s^2] in f32; var = max(E[s^2] - mean^2, 0);
// y = (s - mean) * rsqrt(var + eps) * w + b with f32 affine; stored in the
// input dtype.
//
// Bound on the H100: memory bytes. One read of x (and r) and one write of y
// per element against a handful of flops; at d = 896 a row is 1.75 KB in
// bf16.
//
// Design: one warp per row, eight rows per 256-thread block. Each lane keeps
// its share of the row (at most kMaxPerLane values) in registers, so the
// row is read from device memory once; two warp-shuffle reductions give the
// sums. Loads and stores are 16 bytes a lane, so neighbouring lanes touch
// neighbouring addresses: d must be a multiple of 8 (every width of the
// fusion stack is) and the rows 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxPerLane = 32;  // d <= 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The residual sum rounded to T: bf16 + bf16 is exact in f32, then rounded.
template <typename T>
__device__ __forceinline__ float add_in(T a, T b) {
  return to_f(from_f<T>(to_f(a) + to_f(b)));
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ln_kernel(const T* __restrict__ x, const T* __restrict__ r,
          const float* __restrict__ w, const float* __restrict__ b,
          T* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  const T* rr = r ? r + (size_t)row * d : nullptr;
  T* orow = out + (size_t)row * d;

  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte access
  float v[kMaxPerLane];
  float sum = 0.f, sq = 0.f;
  // Lane l handles vectors l, l + 32, ... of the row.
#pragma unroll
  for (int i = 0; i < kMaxPerLane / kVec; ++i) {
    const int e0 = (lane + 32 * i) * kVec;
    if (e0 < d) {
      alignas(16) T xa[kVec];
      alignas(16) T ra[kVec];
      *reinterpret_cast<uint4*>(xa) = *reinterpret_cast<const uint4*>(xr + e0);
      if (rr) *reinterpret_cast<uint4*>(ra) = *reinterpret_cast<const uint4*>(rr + e0);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float s = rr ? add_in(xa[j], ra[j]) : to_f(xa[j]);
        v[i * kVec + j] = s;
        sum += s;
        sq += s * s;
      }
    }
  }
  sum = warp_sum(sum);
  sq = warp_sum(sq);
  const float inv_d = 1.0f / (float)d;
  const float mean = sum * inv_d;
  const float var = fmaxf(sq * inv_d - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < kMaxPerLane / kVec; ++i) {
    const int e0 = (lane + 32 * i) * kVec;
    if (e0 < d) {
      alignas(16) T ya[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        ya[j] = from_f<T>((v[i * kVec + j] - mean) * rstd * w[e0 + j] + b[e0 + j]);
      *reinterpret_cast<uint4*>(orow + e0) = *reinterpret_cast<uint4*>(ya);
    }
  }
}

}  // namespace

extern "C" int tf_layer_norm(const void* x, const void* r, const void* w, const void* b,
                             void* out, int rows, int d, float eps, int is_bf16,
                             void* stream) {
  const bool aligned = ((uintptr_t)x | (uintptr_t)r | (uintptr_t)out) % 16 == 0;
  if (d <= 0 || d > 32 * kMaxPerLane || d % 8 != 0 || rows <= 0 || !aligned)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    ln_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)r, (const float*)w, (const float*)b,
        (__nv_bfloat16*)out, rows, d, eps);
  } else {
    ln_kernel<float><<<grid, block, 0, s>>>((const float*)x, (const float*)r, (const float*)w,
                                            (const float*)b, (float*)out, rows, d, eps);
  }
  return (int)cudaGetLastError();
}
