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
// Bound on the H100: memory bytes (the pyramid cells the RoIs touch, read
// once, and the 7x7xC output, written once); the arithmetic is a few flops
// per byte.
//
// Design: one block per (b, RoI). The block first computes the RoI's
// separable weights (roi_align.cuh) over its footprint window into shared
// memory: Ay[p][y] for every window row (count_inv folded in) and Ax[q][x]
// for every window column. Thread (q, lane) then owns output column q for
// 16 bytes of channels (8 bf16 or 4 f32), lanes across channels so that
// each read of a cell's channel vector is coalesced. For each bin row p in
// turn it walks the window rows that p reaches: the x-pass
// T = sum_x Ax[q][x] F[y][x] over the columns bin q reaches, then
// acc += Ay[p][y] T, and stores bin (p, q) once. Each window cell is read
// once per bin that reaches it (neighbouring bins share at most their
// boundary rows and columns), against four reads a sample before, and
// sample coordinates are computed once a RoI, in the tables, not once a
// sample, channel pass and warp. The TPU kernel's dense window product
// (roi_align_pallas.py:199-218) would round the bilinear weights to the
// product's input type; here every weight stays f32.
//
// What the card showed (ab_roi_align.py at the eval shape on an H100): the
// kernel waits on L2 round trips, so the loads of two window rows are
// issued together (one row at a time: 0.80 against 0.47 ms), and bin-row
// order keeps a single bin's sums in registers (80 registers instead of
// 128 for all 7 bin rows at once, and no y-pass over bin rows that do not
// reach the row: 0.42 ms), at the price of reading a row two bins share
// twice.

#include "roi_align.cuh"

namespace {

using roi::Vec16;

constexpr int kRowBlock = 2;  // window rows whose loads are issued together

// Window rows y .. y + NR - 1 of bin row p into acc: the x-pass over the
// columns of bin q, then each row's weight for p.
template <typename T, int NR>
__device__ __forceinline__ void window_rows(const T* row, size_t row_stride, int c, int xlo, int xhi,
                                            const float* axq, const float* ayp,
                                            float (&acc)[Vec16<T>::kN]) {
  using V = Vec16<T>;
  constexpr int kN = V::kN;
  float t[NR][kN];
#pragma unroll
  for (int k = 0; k < NR; ++k)
#pragma unroll
    for (int e = 0; e < kN; ++e) t[k][e] = 0.f;
#pragma unroll 2
  for (int x = xlo; x <= xhi; ++x) {
    float f[NR][kN];
#pragma unroll
    for (int k = 0; k < NR; ++k) V::load(row + k * row_stride + (size_t)x * c, f[k]);
    const float w = axq[x];
#pragma unroll
    for (int k = 0; k < NR; ++k)
#pragma unroll
      for (int e = 0; e < kN; ++e) t[k][e] += w * f[k][e];
  }
#pragma unroll
  for (int k = 0; k < NR; ++k)
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[e] += ayp[k] * t[k][e];
}

// Block (lanes * pooled) threads: thread t is bin column q = t / lanes,
// channel lane t % lanes. Dynamic shared memory: pooled * (h_tot + w_max)
// floats, enough for any footprint window.
template <typename T>
__global__ void __launch_bounds__(256) roi_align_fwd(
    const T* __restrict__ packed, const float* __restrict__ fparams, const int* __restrict__ iparams,
    T* __restrict__ out, int n_rois, int h_tot, int w_max, int c, int pooled, int lanes) {
  using V = Vec16<T>;
  constexpr int kN = V::kN;
  extern __shared__ float smem[];
  const int r = blockIdx.x, b = blockIdx.y;
  const float* fp = fparams + ((size_t)b * n_rois + r) * 8;
  const int* ip = iparams + ((size_t)b * n_rois + r) * 4;
  const float y1 = fp[0], x1 = fp[1], bh = fp[2], bw = fp[3];
  const float hl = fp[4], wl = fp[5], count_inv = fp[6];
  const int ry = ip[0], rx = ip[1], off = ip[2];
  const int4 foot = roi::footprint(fp, ip, pooled);
  const int ya = foot.x - off, xa = foot.z;
  const int hw = max(foot.y - foot.x + 1, 0), ww = max(foot.w - foot.z + 1, 0);
  float* ay = smem;                     // [pooled][hw]
  float* ax = smem + pooled * hw;       // [pooled][ww]

  for (int e = threadIdx.x; e < pooled * (hw + ww); e += blockDim.x) {
    if (e < pooled * hw) {
      ay[e] = roi::axis_weight(y1, bh, ry, hl, e / hw, ya + e % hw) * count_inv;
    } else {
      const int ex = e - pooled * hw;
      ax[ex] = roi::axis_weight(x1, bw, rx, wl, ex / ww, xa + ex % ww);
    }
  }
  __syncthreads();

  const int q = threadIdx.x / lanes, lane = threadIdx.x % lanes;
  if (q >= pooled) return;
  int xlo = 0, xhi = -1;
  if (ww > 0) {
    roi::span(x1, bw, rx, wl, q, q, xlo, xhi);
    xlo = max(xlo, xa);
    xhi = min(xhi, xa + ww - 1);
  }
  const float* axq = ax + q * ww - xa;
  const size_t row_stride = (size_t)w_max * c;
  const T* level = packed + ((size_t)b * h_tot + off) * row_stride;
  T* dst = out + (((size_t)b * n_rois + r) * pooled * pooled + q) * c;

  for (int c0 = lane * kN; c0 < c; c0 += lanes * kN) {
    for (int p = 0; p < pooled; ++p) {
      float acc[kN];
#pragma unroll
      for (int e = 0; e < kN; ++e) acc[e] = 0.f;
      if (hw > 0) {
        // The window rows bin row p reaches; a row shared by two bin rows
        // is read for each.
        int ylo, yhi;
        roi::span(y1, bh, ry, hl, p, p, ylo, yhi);
        const float* ayp = ay + p * hw - ya;
        int y = max(ylo, ya);
        yhi = min(yhi, ya + hw - 1);
        for (; y + kRowBlock - 1 <= yhi; y += kRowBlock)
          window_rows<T, kRowBlock>(level + y * row_stride + c0, row_stride, c, xlo, xhi, axq,
                                    ayp + y, acc);
        for (; y <= yhi; ++y)
          window_rows<T, 1>(level + y * row_stride + c0, row_stride, c, xlo, xhi, axq, ayp + y, acc);
      }
      V::store(dst + (size_t)p * pooled * c + c0, acc);
    }
  }
}

template <typename T>
int launch(const void* packed, const void* fparams, const void* iparams, void* out, int bsz,
           int n_rois, int h_tot, int w_max, int c, int pooled, cudaStream_t s) {
  constexpr int kN = Vec16<T>::kN;
  if (c % kN != 0) return (int)cudaErrorInvalidValue;
  const int lanes = min(min(c / kN, 32), 256 / pooled);
  const size_t smem = (size_t)pooled * (h_tot + w_max) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  roi_align_fwd<T><<<dim3(n_rois, bsz), lanes * pooled, smem, s>>>(
      (const T*)packed, (const float*)fparams, (const int*)iparams, (T*)out, n_rois, h_tot, w_max,
      c, pooled, lanes);
  return (int)cudaGetLastError();
}

}  // namespace

// packed [B, H_tot, W_max, C]; fparams [B, R, 8] f32 and iparams [B, R, 4]
// int32 as ops/roi_align.py::roi_sample_params stacks them; out
// [B, R, P, P, C] in the pyramid's dtype.
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
