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
// Samples outside [-1, hl] x [-1, wl] add nothing. The sums are f32, as in
// the TPU kernel's bwd_acc="float32" variant; the result is written once in
// the pyramid's dtype.
//
// Bound on the H100: memory bytes: the whole gradient pyramid written once
// (every cell, zeros included) and g read once.
//
// Design: the TPU kernel accumulated in order, by read-modify-write DMA,
// because its grid runs in order on one core. Here one block owns one tile
// of the output, TH packed rows x 16 cells x a slice of channels, and sums
// it in registers: nothing else writes those cells, so there are no atomics
// and no zeroed accumulator, and the result does not depend on the order
// in which blocks run. Tiles follow packed rows and may straddle a level
// boundary. The block sets one bit for each RoI of its image whose
// footprint (roi_align.cuh::footprint) meets the tile, then, RoI by RoI over
// the set bits, builds the RoI's separable weights over the tile
// (roi_align.cuh): Ay[p][row] (count_inv folded in) for its TH rows and
// Ax[q][col] for its 16 columns, with a bit mask of the bin rows and, per
// column, the bin columns whose weight is non-zero; meanwhile cp.async
// brings the RoI's g (P x P x the slice's channels) into shared memory, so
// one L2 round trip a RoI overlaps the table build instead of one a bin row.
// Thread (column, lane) owns TH cells down its column for 16 bytes of
// channels and adds, for each bin row p in the mask,
//   Ay[p][row] * sum_q Ax[q][col] g[p, q]
// to each of its cells. The weight tables rotate through three buffers and
// g through two, so one barrier a RoI separates building a RoI's tables
// from reading them. The epilogue stores every cell of the tile once, zeros
// included. At the train step's shape (128 RoIs an image, [8, 360, 256, 256]
// bf16) 8-row tiles beat 4 and 16 rows (chip_smoke.py / ab_roi_align.py on
// an H100).

#include "roi_align.cuh"

namespace {

using roi::Vec16;

constexpr int kTileRows = 8;   // TH
constexpr int kTileCols = 16;  // cells a tile spans along a row
constexpr int kLanes = 16;     // 16-byte channel vectors a cell: 128 bf16 or 64 f32 channels
constexpr int kTables = 3;     // weight-table buffers
constexpr int kMaxPooled = 8;  // bin masks and the staged g fit

// Block (kLanes * 16) threads: thread t is tile column t / kLanes, channel
// lane t % kLanes of this block's channel slice. Grid (16-column tiles x
// channel slices, row tiles, B). Dynamic shared memory, in order: g of the
// current RoI for this slice, two buffers [P * P][kLanes] of 16 bytes;
// Ay [kTables][P][TH] and Ax [kTables][P][16] floats; masks [kTables][16 + 1];
// one bit a RoI, set if its footprint meets the tile.
template <typename T>
__global__ void __launch_bounds__(kLanes * kTileCols) roi_align_bwd(
    const T* __restrict__ grad_out, const float* __restrict__ fparams,
    const int* __restrict__ iparams, T* __restrict__ grad, int n_rois, int h_tot, int w_max, int c,
    int pooled, int col_tiles) {
  using V = Vec16<T>;
  constexpr int kN = V::kN;
  constexpr int TH = kTileRows, TW = kTileCols;
  extern __shared__ uint4 smem[];
  const int pp = pooled * pooled;
  uint4* gs = smem;                                                      // [2][pp][kLanes]
  float* ay = reinterpret_cast<float*>(gs + 2 * pp * kLanes);            // [kTables][pooled][TH]
  float* ax = ay + kTables * pooled * TH;                                // [kTables][pooled][TW]
  unsigned* masks = reinterpret_cast<unsigned*>(ax + kTables * pooled * TW);  // [kTables][TW + 1]
  unsigned* hits = masks + kTables * (TW + 1);                           // [ceil(n_rois / 32)]

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * TH, col0 = (blockIdx.x % col_tiles) * TW;
  const int cs0 = (blockIdx.x / col_tiles) * kLanes * kN;  // first channel of the slice
  const int tid = threadIdx.x, nt = blockDim.x;
  const int col = tid / kLanes, lane = tid % kLanes, c0 = cs0 + lane * kN;
  const int words = (n_rois + 31) / 32;
  const float* fpb = fparams + (size_t)b * n_rois * 8;
  const int* ipb = iparams + (size_t)b * n_rois * 4;

  for (int e = tid; e < words; e += nt) hits[e] = 0u;
  for (int e = tid; e < TW + 1; e += nt) masks[e] = 0u;
  __syncthreads();
  for (int r = tid; r < n_rois; r += nt) {
    const int4 f = roi::footprint(fpb + (size_t)r * 8, ipb + (size_t)r * 4, pooled);
    if (f.x <= f.y && f.z <= f.w && f.x < row0 + TH && f.y >= row0 && f.z < col0 + TW && f.w >= col0)
      atomicOr(hits + r / 32, 1u << (r % 32));
  }
  __syncthreads();

  float acc[TH][kN];
#pragma unroll
  for (int j = 0; j < TH; ++j)
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[j][e] = 0.f;

  int k = 0;
  for (int w = 0; w < words; ++w) {
    for (unsigned m = hits[w]; m != 0u; m &= m - 1, ++k) {  // the same RoIs for every thread
      const int r = w * 32 + __ffs(m) - 1;
      // g[b, r, :, :, slice] into this RoI's stage, under the table build.
      uint4* gk = gs + (k & 1) * pp * kLanes;
      const T* gr = grad_out + ((size_t)b * n_rois + r) * pp * c + cs0;
      for (int e = tid; e < pp * kLanes; e += nt)
        if (cs0 + (e % kLanes) * kN < c) roi::cp_async16(gk + e, gr + (size_t)(e / kLanes) * c + (e % kLanes) * kN);

      const int tb = k % kTables;
      float* ayb = ay + tb * pooled * TH;
      float* axb = ax + tb * pooled * TW;
      unsigned* mb = masks + tb * (TW + 1);  // [TW] bin-column masks, then the bin-row mask
      const float* fp = fpb + (size_t)r * 8;
      const int* ip = ipb + (size_t)r * 4;
      const float y1 = fp[0], x1 = fp[1], bh = fp[2], bw = fp[3];
      const float hl = fp[4], wl = fp[5], count_inv = fp[6];
      const int ry = ip[0], rx = ip[1], off = ip[2];
      for (int e = tid; e < pooled * (TH + TW); e += nt) {
        if (e < pooled * TH) {
          const int p = e / TH, j = e % TH;
          const float wt = roi::axis_weight(y1, bh, ry, hl, p, row0 + j - off) * count_inv;
          ayb[e] = wt;
          if (wt != 0.f) atomicOr(mb + TW, 1u << p);
        } else {
          const int ex = e - pooled * TH, q = ex / TW, i = ex % TW;
          const float wt = roi::axis_weight(x1, bw, rx, wl, q, col0 + i);
          axb[ex] = wt;
          if (wt != 0.f) atomicOr(mb + i, 1u << q);
        }
      }
      // The next table buffer's masks: their last reader was RoI k - 2,
      // before the previous barrier; their next writer comes after the
      // barrier below.
      unsigned* next = masks + ((k + 1) % kTables) * (TW + 1);
      for (int e = tid; e < TW + 1; e += nt) next[e] = 0u;
      roi::cp_async_wait_all();
      __syncthreads();

      const unsigned qmask = mb[col];
      if (qmask != 0u && c0 < c) {
        for (unsigned pm = mb[TW]; pm != 0u; pm &= pm - 1) {
          const int p = __ffs(pm) - 1;
          float t[kN];
#pragma unroll
          for (int e = 0; e < kN; ++e) t[e] = 0.f;
          for (unsigned qm = qmask; qm != 0u; qm &= qm - 1) {
            const int q = __ffs(qm) - 1;
            float gv[kN];
            V::widen(gk[(p * pooled + q) * kLanes + lane], gv);
            const float wt = axb[q * TW + col];
#pragma unroll
            for (int e = 0; e < kN; ++e) t[e] += wt * gv[e];
          }
#pragma unroll
          for (int j = 0; j < TH; ++j) {
            const float a = ayb[p * TH + j];
#pragma unroll
            for (int e = 0; e < kN; ++e) acc[j][e] += a * t[e];
          }
        }
      }
    }
  }

  const int x = col0 + col;
  if (c0 < c && x < w_max) {
#pragma unroll
    for (int j = 0; j < TH; ++j)
      if (row0 + j < h_tot)
        V::store(grad + (((size_t)b * h_tot + row0 + j) * w_max + x) * c + c0, acc[j]);
  }
}

template <typename T>
int launch(const void* grad_out, const void* fparams, const void* iparams, void* grad, int bsz,
           int n_rois, int h_tot, int w_max, int c, int pooled, cudaStream_t s) {
  constexpr int kN = Vec16<T>::kN;
  if (c % kN != 0) return (int)cudaErrorInvalidValue;
  const int slices = (c + kLanes * kN - 1) / (kLanes * kN);
  const int col_tiles = (w_max + kTileCols - 1) / kTileCols;
  const size_t smem = (size_t)2 * pooled * pooled * kLanes * 16 +
                      (size_t)kTables * (pooled * (kTileRows + kTileCols) + kTileCols + 1) * 4 +
                      (size_t)(n_rois + 31) / 32 * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(col_tiles * slices, (h_tot + kTileRows - 1) / kTileRows, bsz);
  roi_align_bwd<T><<<grid, kLanes * kTileCols, smem, s>>>(
      (const T*)grad_out, (const float*)fparams, (const int*)iparams, (T*)grad, n_rois, h_tot,
      w_max, c, pooled, col_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// grad_out [B, R, P, P, C] in the pyramid's dtype; fparams/iparams as
// tf_roi_align_fwd's; grad [B, H_tot, W_max, C] in the pyramid's dtype,
// every cell written (the caller need not zero it). R may be 0: the
// gradient is then all zeros.
extern "C" int tf_roi_align_bwd(const void* grad_out, const void* fparams, const void* iparams,
                                void* grad, int bsz, int n_rois, int h_tot, int w_max, int c,
                                int pooled, int is_bf16, void* stream) {
  if (bsz <= 0 || n_rois < 0 || c <= 0 || h_tot <= 0 || w_max <= 0 || pooled <= 0 ||
      pooled > kMaxPooled)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(grad_out, fparams, iparams, grad, bsz, n_rois, h_tot,
                                         w_max, c, pooled, s)
                 : launch<float>(grad_out, fparams, iparams, grad, bsz, n_rois, h_tot, w_max, c,
                                 pooled, s);
}
