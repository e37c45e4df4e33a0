// Pieces shared by the RoIAlign forward (roi_align.cu, K5) and backward
// (roi_align_bwd.cu, K6): 16-byte channel vectors and the separable
// bilinear weights of one axis.
//
// Per-RoI parameters, as ops/roi_align.py::roi_sample_params stacks them:
// floats [B, R, 8] = (y1, x1, bh, bw, hl, wl, count_inv, 0) and ints
// [B, R, 4] = (ry, rx, off, 0). A RoI's footprint is the rectangle of packed
// cells its samples can reach.
//
// Bilinear RoIAlign is separable. Sample (iy, ix) of bin (p, q) reads four
// cells with weight wy(iy) * wx(ix), so bin (p, q) sums
//   count_inv * sum_y sum_x Ay[p][y] * Ax[q][x] * F[y][x],
// where Ay[p][y] adds the y-weights of every sample of bin row p whose
// corner lies on row y (validity folded in as weight 0, and at a clamped
// edge both corners on the same row), and Ax likewise.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace roi {

// 16 bytes of T, widened to floats.
template <typename T>
struct Vec16;

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&f)[kN]) {
    widen(__ldg(reinterpret_cast<const uint4*>(p)), f);
  }
  __device__ __forceinline__ static void widen(const uint4& u, float (&f)[kN]) {
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
    widen(__ldg(reinterpret_cast<const uint4*>(p)), f);
  }
  __device__ __forceinline__ static void widen(const uint4& u, float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static void store(float* p, const float (&f)[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// Sample i of bin `bin` along one axis, placed as the plain version places
// it (no fused multiply-add): start + size * (bin + (i + 0.5) / max(count, 1)).
__device__ __forceinline__ float sample_pos(float start, float size, int bin, int i, float countf) {
  return __fadd_rn(start, __fmul_rn(size, (float)bin + ((float)i + 0.5f) / countf));
}

// Ay[bin][cell] (or Ax): the summed weight with which the `count` samples
// of bin `bin` read level-relative cell `cell` along an axis of `extent`
// cells. A sample outside [-1, extent] weighs 0; others are clamped into
// [0, extent - 1], read floor and floor + 1 (clamped), and weigh 1 - frac
// and frac.
__device__ __forceinline__ float axis_weight(float start, float size, int count, float extent,
                                             int bin, int cell) {
  const int ext = (int)extent;
  if (cell < 0 || cell >= ext) return 0.f;
  const float countf = fmaxf((float)count, 1.f);
  float w = 0.f;
  for (int i = 0; i < count; ++i) {
    const float pos = sample_pos(start, size, bin, i, countf);
    if (pos < -1.f || pos > extent) continue;
    const float pc = fminf(fmaxf(pos, 0.f), extent - 1.f);
    const int lo = (int)floorf(pc);
    const float frac = pc - (float)lo;
    if (lo == cell) w += 1.f - frac;
    if (min(lo + 1, ext - 1) == cell) w += frac;
  }
  return w;
}

// The cells [lo, hi] that the samples of bins first..last can reach along
// an axis: the clamped first sample of `first` and last sample of `last`
// (the coordinate is monotone in the sample order), the upper corner
// included. Needs count >= 1.
__device__ __forceinline__ void span(float start, float size, int count, float extent, int first,
                                     int last, int& lo, int& hi) {
  const float countf = fmaxf((float)count, 1.f);
  const float a = floorf(fminf(fmaxf(sample_pos(start, size, first, 0, countf), 0.f), extent - 1.f));
  const float b =
      floorf(fminf(fmaxf(sample_pos(start, size, last, count - 1, countf), 0.f), extent - 1.f));
  lo = (int)fminf(a, b);
  hi = min((int)fmaxf(a, b) + 1, (int)extent - 1);
}

// RoI r's footprint: the packed rows (x, y) and columns (z, w), inclusive,
// that its samples can reach; rows (0, -1) when it has none.
// ops/roi_align.py::roi_footprints states the same in PyTorch.
__device__ __forceinline__ int4 footprint(const float* fp, const int* ip, int pooled) {
  const int ry = ip[0], rx = ip[1], off = ip[2];
  if (ry <= 0 || rx <= 0) return make_int4(0, -1, 0, -1);
  int4 f;
  span(fp[0], fp[2], ry, fp[4], 0, pooled - 1, f.x, f.y);
  span(fp[1], fp[3], rx, fp[5], 0, pooled - 1, f.z, f.w);
  f.x += off;
  f.y += off;
  return f;
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async, L2 only); complete after cp_async_wait_all().
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace roi
