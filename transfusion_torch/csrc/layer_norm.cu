// K1: (residual-add +) LayerNorm over the last dim, forward.
//
// Replaces the Pallas kernels transfusion_tpu/ops/layer_norm.py:55
// (_ln_kernel) and :59 (_res_ln_kernel), reached through _ln_call and
// FusedLayerNorm on the fusion stack's norm1/norm2/final_norm; the port also
// runs the narration encoder's flax LayerNorms through it (same arithmetic).
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
// Design:
// - The width is a template parameter for the widths the model runs (896,
//   384), so every loop is unrolled with no bounds test and every load of a
//   row is issued before its first add. D = 0 is the generic instantiation
//   (any multiple of 8 up to 1024, with bounds tests).
// - A row belongs to a group of kG lanes, each holding kPer 16-byte vectors,
//   sized so that no lane idles at the fixed widths (896 bf16: 16 lanes x 7,
//   two rows a warp; 384 bf16: 16 x 3; f32: 32 x 7 and 32 x 3). The
//   statistics are shuffles within the group.
// - w and b are staged once a block in shared memory with 16-byte loads, in
//   planes of float4 so that the epilogue's 16-byte reads are conflict-free;
//   the epilogue reads no global memory.
// - Two ways of bringing the rows in:
//   rows: a block of 256 threads takes 256 / kG rows into registers;
//   ring: persistent blocks whose warps each walk their own tiles of
//     32 / kG rows, each warp bringing its tiles of x (and r) into shared
//     memory with cp.async.bulk through an mbarrier ring of RingShape's
//     stages, so a warp keeps that many tiles in flight whatever its
//     registers.
//   The ring serves the fixed widths only. It takes the residual form and
//   a plain input of kRingMinRows rows or more: below that a plain input
//   is under one wave of rows blocks, whose loads all go out at once. The
//   generic width takes the rows design. scripts/ab_layer_norm.py builds
//   copies with K1_DESIGN defined as 1 (rows) or 2 (ring) to time either
//   design at every shape.
// - x may be a batch-strided view: row i lies at x + (i / rows_per_batch) *
//   batch_stride + (i % rows_per_batch) * d, so the final norm reads
//   x[:, :n] in place; r and the output are contiguous. A ring tile never
//   crosses a batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"

// 0: the design by form and row count, as above; 1 or 2 forces rows or the
// ring at the fixed widths (A/B builds only).
#ifndef K1_DESIGN
#define K1_DESIGN 0
#endif

namespace {

constexpr int kThreads = 256;  // rows design: threads a block
constexpr int kMaxD = 1024;
constexpr int kRingMinRows = 16384;

// Ring design: warps a block and tiles in flight a warp. The residual form
// moves two tiles a stage, so it takes fewer stages and more warps.
template <bool kRes>
struct RingShape {
  static constexpr int kWarps = kRes ? 8 : 4;
  static constexpr int kStages = kRes ? 2 : 3;
};

// 16 bytes of T widened to floats, and back.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void widen(const uint4& u, float (&f)[kN]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ uint4 narrow(const float (&f)[kN]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
  // The residual sum rounded to bf16: the f32 sum of two bf16 values, then
  // one rounding, as the plain version's bf16 add.
  static __device__ __forceinline__ uint4 add(const uint4& a, const uint4& b) {
    float fa[kN], fb[kN];
    widen(a, fa);
    widen(b, fb);
#pragma unroll
    for (int i = 0; i < kN; ++i) fa[i] += fb[i];
    return narrow(fa);
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void widen(const uint4& u, float (&f)[kN]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 narrow(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ uint4 add(const uint4& a, const uint4& b) {
    float fa[kN], fb[kN];
    widen(a, fa);
    widen(b, fb);
#pragma unroll
    for (int i = 0; i < kN; ++i) fa[i] += fb[i];
    return narrow(fa);
  }
};

// Lanes a row (kG), 16-byte vectors a lane (kPer) and a row (kNV; the most,
// for D = 0) at width D.
template <typename T, int D>
struct Geom {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kNV = (D > 0 ? D : kMaxD) / kVec;
  static constexpr int kG = (D == 0 || kNV % 32 == 0) ? 32 : (kNV % 16 == 0 ? 16 : 8);
  static constexpr int kPer = kNV / kG;
  static constexpr int kRowsPerWarp = 32 / kG;
  static constexpr int kP = kVec / 4;  // float4s of w (or b) a vector
  static_assert(D % kVec == 0 && kNV % kG == 0, "width must split evenly over the lane group");
};

// w and b into shared memory as planes wb[p][v] (w) and wb[kP + p][v] (b):
// float4 p of vector v.
template <typename T, int D>
__device__ __forceinline__ void stage_affine(const float* __restrict__ w, const float* __restrict__ b,
                                             float4* wb, int d) {
  using G = Geom<T, D>;
  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  for (int q = threadIdx.x; q < d / 4; q += blockDim.x) {
    const int v = q / G::kP, p = q % G::kP;
    wb[p * G::kNV + v] = __ldg(w4 + q);
    wb[(G::kP + p) * G::kNV + v] = __ldg(b4 + q);
  }
}

// The lane's vectors of one row from `xr` (and `rr`): global or shared.
template <typename T, int D, bool kRes, bool kGlobal>
__device__ __forceinline__ void load_row(const T* xr, const T* rr, int lane, int nv,
                                         uint4 (&xa)[Geom<T, D>::kPer], uint4 (&ra)[Geom<T, D>::kPer]) {
  using G = Geom<T, D>;
#pragma unroll
  for (int i = 0; i < G::kPer; ++i) {
    const int v = lane + i * G::kG;
    if (D > 0 || v < nv) {
      const uint4* px = reinterpret_cast<const uint4*>(xr) + v;
      xa[i] = kGlobal ? __ldcs(px) : *px;
      if (kRes) {
        const uint4* pr = reinterpret_cast<const uint4*>(rr) + v;
        ra[i] = kGlobal ? __ldcs(pr) : *pr;
      }
    }
  }
}

// The lane's share of a row: s = x (+ r, rounded to T) left in `xa` as T
// values (a bf16 row stays packed, half the registers of floats), and its
// partial sums of s and s^2.
template <typename T, int D, bool kRes>
__device__ __forceinline__ void sum_row(uint4 (&xa)[Geom<T, D>::kPer], const uint4 (&ra)[Geom<T, D>::kPer], int lane,
                                        int nv, float& sum, float& sq) {
  using G = Geom<T, D>;
  sum = 0.f;
  sq = 0.f;
#pragma unroll
  for (int i = 0; i < G::kPer; ++i) {
    if (D > 0 || lane + i * G::kG < nv) {
      if (kRes) xa[i] = Vec<T>::add(xa[i], ra[i]);
      float v[G::kVec], s = 0.f, q = 0.f;
      Vec<T>::widen(xa[i], v);
#pragma unroll
      for (int j = 0; j < G::kVec; ++j) {
        s += v[j];
        q = fmaf(v[j], v[j], q);
      }
      sum += s;
      sq += q;
    }
  }
}

// Group statistics, affine from shared memory, 16-byte stores of y. Every
// lane of the warp calls it (the shuffles span the warp); `live` lanes store.
template <typename T, int D>
__device__ __forceinline__ void finish_row(const uint4 (&sa)[Geom<T, D>::kPer], float sum, float sq, const float4* wb,
                                           int lane, int d, float eps, T* orow, bool live) {
  using G = Geom<T, D>;
#pragma unroll
  for (int o = G::kG / 2; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const float inv_d = D > 0 ? 1.0f / (float)D : 1.0f / (float)d;
  const float mean = sum * inv_d;
  const float var = fmaxf(sq * inv_d - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  if (!live) return;
  const int nv = D > 0 ? G::kNV : d / G::kVec;
#pragma unroll
  for (int i = 0; i < G::kPer; ++i) {
    const int vec = lane + i * G::kG;
    if (D > 0 || vec < nv) {
      float y[G::kVec];
      Vec<T>::widen(sa[i], y);
#pragma unroll
      for (int p = 0; p < G::kP; ++p) {
        const float4 wq = wb[p * G::kNV + vec];
        const float4 bq = wb[(G::kP + p) * G::kNV + vec];
        y[4 * p + 0] = (y[4 * p + 0] - mean) * rstd * wq.x + bq.x;
        y[4 * p + 1] = (y[4 * p + 1] - mean) * rstd * wq.y + bq.y;
        y[4 * p + 2] = (y[4 * p + 2] - mean) * rstd * wq.z + bq.z;
        y[4 * p + 3] = (y[4 * p + 3] - mean) * rstd * wq.w + bq.w;
      }
      reinterpret_cast<uint4*>(orow)[vec] = Vec<T>::narrow(y);
    }
  }
}

__device__ __forceinline__ size_t x_offset(int row, int rows_per_batch, long long batch_stride, int d) {
  return (size_t)(row / rows_per_batch) * (size_t)batch_stride + (size_t)(row % rows_per_batch) * d;
}

// ----------------------------------------------------------- rows design
template <typename T, int D, bool kRes>
__global__ void __launch_bounds__(kThreads)
layer_norm_rows(const T* __restrict__ x, const T* __restrict__ r, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ out, int rows, int d, int rows_per_batch,
                long long batch_stride, float eps) {
  using G = Geom<T, D>;
  __shared__ float4 wb[2 * G::kP * G::kNV];
  const int lane = threadIdx.x % G::kG;
  const int row = blockIdx.x * (kThreads / G::kG) + threadIdx.x / G::kG;
  const bool live = row < rows;
  const int nv = D > 0 ? G::kNV : d / G::kVec;
  uint4 xa[G::kPer], ra[G::kPer];
#pragma unroll
  for (int i = 0; i < G::kPer; ++i) xa[i] = ra[i] = make_uint4(0, 0, 0, 0);
  // The row's loads go out first; staging w and b overlaps them.
  if (live)
    load_row<T, D, kRes, true>(x + x_offset(row, rows_per_batch, batch_stride, d),
                               kRes ? r + (size_t)row * d : nullptr, lane, nv, xa, ra);
  stage_affine<T, D>(w, b, wb, d);
  __syncthreads();
  float sum, sq;
  sum_row<T, D, kRes>(xa, ra, lane, nv, sum, sq);
  finish_row<T, D>(xa, sum, sq, wb, lane, d, eps, out + (size_t)row * d, live);
}

// ----------------------------------------------------------- ring design
template <typename T, int D, bool kRes>
struct Ring : RingShape<kRes> {
  using G = Geom<T, D>;
  using RingShape<kRes>::kWarps;
  using RingShape<kRes>::kStages;
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kTensorBytes = G::kRowsPerWarp * kRowBytes;  // one tile of x (or r)
  static constexpr int kStageBytes = (kRes ? 2 : 1) * kTensorBytes;
  static constexpr int kAffineBytes = 2 * G::kP * G::kNV * 16;
  static constexpr int kRingOffset = (kAffineBytes + kWarps * kStages * 8 + 127) / 128 * 128;
  static constexpr int kSmemBytes = kRingOffset + kWarps * kStages * kStageBytes;
  static_assert(D > 0, "the ring serves the fixed widths");
};

// Tile t of rows: its batch, its first row within the batch, its row count.
__device__ __forceinline__ void tile_rows(int t, int tiles_per_batch, int rows_per_tile, int rows_per_batch,
                                          int& batch, int& first, int& n) {
  batch = t / tiles_per_batch;
  first = (t - batch * tiles_per_batch) * rows_per_tile;
  n = min(rows_per_tile, rows_per_batch - first);
}

template <typename T, int D, bool kRes>
__global__ void __launch_bounds__(RingShape<kRes>::kWarps * 32)
layer_norm_ring(const T* __restrict__ x, const T* __restrict__ r, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ out, int rows, int rows_per_batch,
                long long batch_stride, float eps) {
  using G = Geom<T, D>;
  using RG = Ring<T, D, kRes>;
  extern __shared__ __align__(128) unsigned char smem[];
  float4* wb = reinterpret_cast<float4*>(smem);
  const int warp = threadIdx.x / 32, lane32 = threadIdx.x % 32;
  constexpr int kStages = RG::kStages;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + RG::kAffineBytes) + warp * kStages;
  unsigned char* ring = smem + RG::kRingOffset + warp * kStages * RG::kStageBytes;
  const int tiles_per_batch = (rows_per_batch + G::kRowsPerWarp - 1) / G::kRowsPerWarp;
  const int tiles = tiles_per_batch * (rows / rows_per_batch);
  const int nw = gridDim.x * RG::kWarps;
  const int first_tile = blockIdx.x * RG::kWarps + warp;

  // Lane 0 of a warp brings tile t of x (and r) into stage s.
  auto fetch = [&](int t, int s) {
    int batch, first, n;
    tile_rows(t, tiles_per_batch, G::kRowsPerWarp, rows_per_batch, batch, first, n);
    const uint32_t bytes = (uint32_t)(n * RG::kRowBytes);
    unsigned char* dst = ring + s * RG::kStageBytes;
    mbar_arrive_expect_tx(&bar[s], kRes ? 2 * bytes : bytes);
    bulk_load(dst, x + (size_t)batch * batch_stride + (size_t)first * D, bytes, &bar[s]);
    if (kRes) bulk_load(dst + RG::kTensorBytes, r + ((size_t)batch * rows_per_batch + first) * D, bytes, &bar[s]);
  };
  if (lane32 == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
    fence_mbar_init();
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      if (first_tile + s * nw < tiles) fetch(first_tile + s * nw, s);
  }
  __syncwarp();
  stage_affine<T, D>(w, b, wb, D);
  __syncthreads();

  const int g = lane32 / G::kG, lane = lane32 % G::kG;
  int k = 0;
  for (int t = first_tile; t < tiles; t += nw, ++k) {
    const int s = k % kStages;
    mbar_wait(&bar[s], (uint32_t)((k / kStages) & 1));
    int batch, first, n;
    tile_rows(t, tiles_per_batch, G::kRowsPerWarp, rows_per_batch, batch, first, n);
    const bool live = g < n;
    uint4 xa[G::kPer], ra[G::kPer];
    const unsigned char* st = ring + s * RG::kStageBytes + g * RG::kRowBytes;
    load_row<T, D, kRes, false>(reinterpret_cast<const T*>(st), reinterpret_cast<const T*>(st + RG::kTensorBytes),
                                lane, G::kNV, xa, ra);
    // The sums consume every value read from the stage, so once the warp
    // has passed the barrier below the stage may be refilled.
    float sum, sq;
    sum_row<T, D, kRes>(xa, ra, lane, G::kNV, sum, sq);
    __syncwarp();
    if (lane32 == 0 && t + kStages * nw < tiles) fetch(t + kStages * nw, s);
    finish_row<T, D>(xa, sum, sq, wb, lane, D, eps, out + ((size_t)batch * rows_per_batch + first + g) * D, live);
  }
}

// ------------------------------------------------------------------ host
struct Args {
  const void *x, *r, *w, *b;
  void* out;
  int rows, d, rows_per_batch;
  long long batch_stride;
  float eps;
  cudaStream_t stream;
};

template <typename T, int D, bool kRes>
int launch_rows(const Args& a) {
  using G = Geom<T, D>;
  const int per_block = kThreads / G::kG;
  layer_norm_rows<T, D, kRes><<<(a.rows + per_block - 1) / per_block, kThreads, 0, a.stream>>>(
      (const T*)a.x, (const T*)a.r, (const float*)a.w, (const float*)a.b, (T*)a.out, a.rows, a.d,
      a.rows_per_batch, a.batch_stride, a.eps);
  return (int)cudaGetLastError();
}

// Per device: the SM count, the ring blocks an SM holds (0 until found) and
// the dynamic shared-memory limit set for the instantiation on it.
constexpr int kMaxDevices = 64;

template <typename T, int D, bool kRes>
int launch_ring(const Args& a) {
  using G = Geom<T, D>;
  using RG = Ring<T, D, kRes>;
  static std::atomic<int> sms[kMaxDevices], resident[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev].load(std::memory_order_acquire) == 0) {
    // Racing threads repeat the same idempotent calls and store the same values.
    int n = 0, k = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cudaFuncSetAttribute(layer_norm_ring<T, D, kRes>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         RG::kSmemBytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, layer_norm_ring<T, D, kRes>, RG::kWarps * 32,
                                                  RG::kSmemBytes);
    if (k < 1) return (int)cudaErrorInvalidConfiguration;
    sms[dev].store(n, std::memory_order_relaxed);
    resident[dev].store(k, std::memory_order_release);
  }
  const int tiles = (a.rows_per_batch + G::kRowsPerWarp - 1) / G::kRowsPerWarp * (a.rows / a.rows_per_batch);
  const int blocks = min((tiles + RG::kWarps - 1) / RG::kWarps,
                         sms[dev].load(std::memory_order_relaxed) * resident[dev].load(std::memory_order_acquire));
  layer_norm_ring<T, D, kRes><<<blocks, RG::kWarps * 32, RG::kSmemBytes, a.stream>>>(
      (const T*)a.x, (const T*)a.r, (const float*)a.w, (const float*)a.b, (T*)a.out, a.rows, a.rows_per_batch,
      a.batch_stride, a.eps);
  return (int)cudaGetLastError();
}

// A fixed width: the ring for the residual form and from kRingMinRows rows,
// else rows (or the design K1_DESIGN forces).
template <typename T, int D, bool kRes>
int launch_fixed(const Args& a) {
  if constexpr (K1_DESIGN == 1) return launch_rows<T, D, kRes>(a);
  else if constexpr (K1_DESIGN == 2 || kRes) return launch_ring<T, D, kRes>(a);
  else return a.rows >= kRingMinRows ? launch_ring<T, D, kRes>(a) : launch_rows<T, D, kRes>(a);
}

template <typename T, bool kRes>
int launch(const Args& a) {
  if (a.d == 896) return launch_fixed<T, 896, kRes>(a);
  if (a.d == 384) return launch_fixed<T, 384, kRes>(a);
  return launch_rows<T, 0, kRes>(a);
}

}  // namespace

// x rows as above (rows_per_batch divides rows; batch_stride in elements),
// residual (or NULL) and out contiguous [rows, d].
extern "C" int tf_layer_norm(const void* x, const void* r, const void* w, const void* b, void* out, int rows,
                             int d, int rows_per_batch, long long batch_stride, float eps, int is_bf16,
                             void* stream) {
  const size_t elt = is_bf16 ? 2 : 4;
  const bool aligned = ((uintptr_t)x | (uintptr_t)r | (uintptr_t)out | (uintptr_t)w | (uintptr_t)b) % 16 == 0 &&
                       (batch_stride * elt) % 16 == 0;
  if (d <= 0 || d > kMaxD || d % 8 != 0 || rows <= 0 || rows_per_batch <= 0 || rows % rows_per_batch != 0 ||
      batch_stride < 0 || !aligned)
    return (int)cudaErrorInvalidValue;
  const Args a{x, r, w, b, out, rows, d, rows_per_batch, batch_stride, eps, (cudaStream_t)stream};
  if (is_bf16) return r ? launch<__nv_bfloat16, true>(a) : launch<__nv_bfloat16, false>(a);
  return r ? launch<float, true>(a) : launch<float, false>(a);
}
