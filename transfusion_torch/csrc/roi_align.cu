// K5: multiscale RoIAlign forward over a packed channels-last FPN pyramid.
//
// Replaces the Pallas kernel transfusion_tpu/ops/roi_align_pallas.py:267
// (_fwd_kernel, launched by _fused_fwd at :423 for fused_roi_align, which
// multiscale_roi_align dispatches at ops/roi_align.py:242).
//
// Semantics (torchvision/detectron2 RoIAlign, aligned=True, adaptive
// sampling): for RoI r of image b, with its level-relative start (y1, x1),
// bin sizes (bh, bw), per-axis sample counts (ry, rx; 0 allowed), level
// extent (hl, wl) and packed-row offset `off` (all from roi_sample_params),
// bin (p, q) averages ry x rx bilinear samples at
//   y = y1 + bh * (p + (iy + 0.5) / max(ry, 1)),  x likewise,
// where a sample outside [-1, hl] x [-1, wl] contributes 0 and others are
// clamped into [0, hl - 1] x [0, wl - 1]. The sum (f32) is multiplied by
// 1 / max(ry * rx, 1) and stored in the pyramid's dtype. Clamping keeps every
// read inside the RoI's own level, so the packed pyramid's padding columns
// are never addressed.
//
// Bound on the H100: memory bytes (four channel-vector reads per sample and
// a 7x7xC write per RoI against eight flops per read element). The bytes
// that must cross HBM are the pyramid cells the RoIs touch and the output;
// the four corner reads of every sample come mostly from L1/L2, and the
// per-sample coordinate arithmetic costs issue slots.
//
// Design: one block per (b, RoI), one warp per bin row, lanes across
// channels with 16 bytes a lane (8 bf16 or 4 f32 channels), so each
// bilinear read of a [C] channel vector is one coalesced 512-byte row of the
// channels-last pyramid (C = 256 in bf16) and the coordinate arithmetic of a
// sample is shared by 8 channels. The TPU kernel's separable weight
// matrices and window DMA served VMEM and the MXU; here the neighbouring
// pyramid cells of a RoI come through L1/L2, and the sample loop bounds are
// uniform across the warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 16 bytes of T, widened to floats.
template <typename T>
struct Vec16;

template <>
struct Vec16<__nv_bfloat16> {
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
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&f)[kN]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&f)[kN]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&f)[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// Block (32, pooled): threadIdx.y is the bin row, threadIdx.x the lane.
template <typename T>
__global__ void roi_align_fwd(const T* __restrict__ packed, const float* __restrict__ fparams,
                              const int* __restrict__ iparams, T* __restrict__ out,
                              int n_rois, int h_tot, int w_max, int c, int pooled) {
  using V = Vec16<T>;
  constexpr int kN = V::kN;
  const int r = blockIdx.x, b = blockIdx.y;
  const int ph = threadIdx.y, lane = threadIdx.x;
  const float* fp = fparams + ((size_t)b * n_rois + r) * 8;
  const int* ip = iparams + ((size_t)b * n_rois + r) * 4;
  const float y1 = fp[0], x1 = fp[1], bh = fp[2], bw = fp[3];
  const float hl = fp[4], wl = fp[5], count_inv = fp[6];
  const int ry = ip[0], rx = ip[1], off = ip[2];
  const float ryf = fmaxf((float)ry, 1.f), rxf = fmaxf((float)rx, 1.f);
  const int hl_i = (int)hl, wl_i = (int)wl;
  const T* level = packed + ((size_t)b * h_tot + off) * w_max * c;
  T* dst = out + (((size_t)b * n_rois + r) * pooled + ph) * pooled * c;

  for (int c0 = lane * kN; c0 < c; c0 += 32 * kN) {
    for (int pw = 0; pw < pooled; ++pw) {
      float acc[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[e] = 0.f;
      for (int iy = 0; iy < ry; ++iy) {
        // Rounded as the plain version rounds it (no fused multiply-add),
        // so both place every sample at the same f32 coordinate.
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
          float f00[kN], f01[kN], f10[kN], f11[kN];
          V::load(level + ((size_t)y0 * w_max + x0) * c + c0, f00);
          V::load(level + ((size_t)y0 * w_max + x1i) * c + c0, f01);
          V::load(level + ((size_t)y1i * w_max + x0) * c + c0, f10);
          V::load(level + ((size_t)y1i * w_max + x1i) * c + c0, f11);
          const float w00 = hy * hx, w01 = hy * lx, w10 = ly * hx, w11 = ly * lx;
#pragma unroll
          for (int e = 0; e < kN; ++e)
            acc[e] += w00 * f00[e] + w01 * f01[e] + w10 * f10[e] + w11 * f11[e];
        }
      }
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[e] *= count_inv;
      V::store(dst + (size_t)pw * c + c0, acc);
    }
  }
}

template <typename T>
int launch(const void* packed, const void* fparams, const void* iparams, void* out, int bsz,
           int n_rois, int h_tot, int w_max, int c, int pooled, cudaStream_t s) {
  if (c % Vec16<T>::kN != 0) return (int)cudaErrorInvalidValue;
  roi_align_fwd<T><<<dim3(n_rois, bsz), dim3(32, pooled), 0, s>>>(
      (const T*)packed, (const float*)fparams, (const int*)iparams, (T*)out, n_rois, h_tot,
      w_max, c, pooled);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tf_roi_align_fwd(const void* packed, const void* fparams, const void* iparams,
                                void* out, int bsz, int n_rois, int h_tot, int w_max, int c,
                                int pooled, int is_bf16, void* stream) {
  if (bsz <= 0 || n_rois <= 0 || c <= 0 || pooled <= 0 || pooled > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(packed, fparams, iparams, out, bsz, n_rois, h_tot, w_max,
                                         c, pooled, s)
                 : launch<float>(packed, fparams, iparams, out, bsz, n_rois, h_tot, w_max, c,
                                 pooled, s);
}
