// K6: multiscale RoIAlign backward, the gradient with respect to the packed
// channels-last FPN pyramid.
//
// Replaces the Pallas kernel transfusion_tpu/ops/roi_align_pallas.py:370
// (_bwd_kernel, launched by _fused_bwd at :464, the custom VJP of
// fused_roi_align). For every bin (p, q) of RoI r of image b with upstream
// gradient g[b, r, p, q, :], each of its ry x rx bilinear samples adds
//   w_corner * g * count_inv
// to the four pyramid cells the forward read, with the forward's sample
// placement, border rules and clamps (roi_align.cu, K5) recomputed exactly;
// at a clamped edge two corners are the same cell and both add to it.
// Samples outside [-1, hl] x [-1, wl] add nothing.
//
// The sums go into an f32 accumulator pyramid with atomicAdd; the wrapper
// zeroes it before the launch and casts it once to the pyramid's dtype
// after. Atomics add in an order that changes from run to run, so the
// result is compared with the TPU kernel's f32-accumulating variant
// (bwd_acc="f32") at a tolerance, not bit for bit.
//
// Bound on the H100: memory bytes: the f32 accumulator cells the RoIs touch
// are read and written, g is read once, about 16 flops per g element and
// sample. Design: K5's layout, one block per (b, RoI), one warp per bin row,
// lanes across channels with 16 bytes of g a lane; a sample's coordinates
// are computed once for the lane's channels, and its atomics to one corner
// cell are 32 lanes on neighbouring addresses, 16 bytes (four floats) an
// atomic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T>
struct Load16;

template <>
struct Load16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&f)[kN]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <>
struct Load16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&f)[kN]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

// w * gv added to kN consecutive floats, four at a time with the 128-bit
// atomicAdd of compute capability 9.x (cell is 16-byte aligned: C and the
// lane's channel offset are multiples of 4 floats).
template <int kN>
__device__ __forceinline__ void scatter(float* cell, const float (&gv)[kN], float w) {
  if (w == 0.f) return;
#pragma unroll
  for (int e = 0; e < kN; e += 4)
    atomicAdd(reinterpret_cast<float4*>(cell + e),
              make_float4(w * gv[e], w * gv[e + 1], w * gv[e + 2], w * gv[e + 3]));
}

// Block (32, pooled): threadIdx.y is the bin row, threadIdx.x the lane.
template <typename T>
__global__ void roi_align_bwd(const T* __restrict__ grad_out, const float* __restrict__ fparams,
                              const int* __restrict__ iparams, float* __restrict__ grad,
                              int n_rois, int h_tot, int w_max, int c, int pooled) {
  using L = Load16<T>;
  constexpr int kN = L::kN;
  const int r = blockIdx.x, b = blockIdx.y;
  const int ph = threadIdx.y, lane = threadIdx.x;
  const float* fp = fparams + ((size_t)b * n_rois + r) * 8;
  const int* ip = iparams + ((size_t)b * n_rois + r) * 4;
  const float y1 = fp[0], x1 = fp[1], bh = fp[2], bw = fp[3];
  const float hl = fp[4], wl = fp[5], count_inv = fp[6];
  const int ry = ip[0], rx = ip[1], off = ip[2];
  const float ryf = fmaxf((float)ry, 1.f), rxf = fmaxf((float)rx, 1.f);
  const int hl_i = (int)hl, wl_i = (int)wl;
  float* level = grad + ((size_t)b * h_tot + off) * w_max * c;
  const T* src = grad_out + (((size_t)b * n_rois + r) * pooled + ph) * pooled * c;

  for (int c0 = lane * kN; c0 < c; c0 += 32 * kN) {
    for (int pw = 0; pw < pooled; ++pw) {
      float gv[kN];
      L::load(src + (size_t)pw * c + c0, gv);
#pragma unroll
      for (int e = 0; e < kN; ++e) gv[e] *= count_inv;
      for (int iy = 0; iy < ry; ++iy) {
        // The forward's sample coordinates, rounded the same way.
        const float y = __fadd_rn(y1, __fmul_rn(bh, (float)ph + ((float)iy + 0.5f) / ryf));
        if (y < -1.f || y > hl) continue;
        const float yc = fminf(fmaxf(y, 0.f), hl - 1.f);
        const int y0 = (int)floorf(yc);
        const int y1i = min(y0 + 1, hl_i - 1);
        const float ly = yc - (float)y0, hy = 1.f - ly;
        for (int ix = 0; ix < rx; ++ix) {
          const float x = __fadd_rn(x1, __fmul_rn(bw, (float)pw + ((float)ix + 0.5f) / rxf));
          if (x < -1.f || x > wl) continue;
          const float xc = fminf(fmaxf(x, 0.f), wl - 1.f);
          const int x0 = (int)floorf(xc);
          const int x1i = min(x0 + 1, wl_i - 1);
          const float lx = xc - (float)x0, hx = 1.f - lx;
          scatter(level + ((size_t)y0 * w_max + x0) * c + c0, gv, hy * hx);
          scatter(level + ((size_t)y0 * w_max + x1i) * c + c0, gv, hy * lx);
          scatter(level + ((size_t)y1i * w_max + x0) * c + c0, gv, ly * hx);
          scatter(level + ((size_t)y1i * w_max + x1i) * c + c0, gv, ly * lx);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* grad_out, const void* fparams, const void* iparams, void* grad, int bsz,
           int n_rois, int h_tot, int w_max, int c, int pooled, cudaStream_t s) {
  if (c % Load16<T>::kN != 0) return (int)cudaErrorInvalidValue;
  roi_align_bwd<T><<<dim3(n_rois, bsz), dim3(32, pooled), 0, s>>>(
      (const T*)grad_out, (const float*)fparams, (const int*)iparams, (float*)grad, n_rois, h_tot,
      w_max, c, pooled);
  return (int)cudaGetLastError();
}

}  // namespace

// grad_out [B, R, P, P, C] in the pyramid's dtype; fparams/iparams as
// tf_roi_align_fwd's; grad the zeroed f32 accumulator [B, H_tot, W_max, C].
extern "C" int tf_roi_align_bwd(const void* grad_out, const void* fparams, const void* iparams,
                                void* grad, int bsz, int n_rois, int h_tot, int w_max, int c,
                                int pooled, int is_bf16, void* stream) {
  if (bsz <= 0 || n_rois <= 0 || c <= 0 || pooled <= 0 || pooled > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(grad_out, fparams, iparams, grad, bsz, n_rois, h_tot,
                                         w_max, c, pooled, s)
                 : launch<float>(grad_out, fparams, iparams, grad, bsz, n_rois, h_tot, w_max, c,
                                 pooled, s);
}
