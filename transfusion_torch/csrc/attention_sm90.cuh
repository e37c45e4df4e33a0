// Shared by the Hopper (sm_90a) attention kernels, forward (attention.cu:
// K2, K7) and backward (attention_bwd.cu: K3, K4), bf16 at head dim 224:
// the TMA tensor maps of a head's rows, the shared-memory descriptors of a
// tile as a K-major or MN-major wgmma operand (layout in sm90.cuh), the
// register A operand packed from an accumulator, and the ring of TMA stages
// that two consumer warpgroups stream through.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kD = 224;            // the one bf16 head dim (BF16_HEAD_DIMS in ops/attention.py)
constexpr int kChunks = kD / 32;   // 32-column chunks of a tile (64-byte swizzle rows)
constexpr int kRows = 64;          // rows of a streamed stage and of a warpgroup's slab; wgmma's M
constexpr int kThreadsSm90 = 256;  // two consumer warpgroups, up to 255 registers a thread
constexpr uint32_t kSbo = 512;     // 8 rows x 64 bytes

__host__ __device__ constexpr uint32_t tile_bytes(int rows) { return (uint32_t)rows * kD * 2; }
__host__ __device__ constexpr uint32_t chunk_bytes(int rows) { return (uint32_t)rows * 64; }

// Element strides of batch, sequence position and head: (N H D, H D, D) for
// [B, N, H, D], (H N D, D, N D) for [B, H, N, D]. The head dim is contiguous.
struct Strides {
  long long b, n, h;
};

__host__ __device__ inline Strides blhd_strides(int n, int nh) {
  return Strides{(long long)n * nh * kD, (long long)nh * kD, kD};
}

// [B, H, N, D]: rows of one head lie closer together than its heads.
__host__ __device__ inline bool heads_first(Strides st) { return st.h > st.n; }

struct Dropout {
  uint32_t seed, thresh;
  float inv_keep;
};

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched through the
// runtime, so the library needs no link against libcuda.
EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A bf16 [B, N, H, 224] or [B, H, N, 224] tensor (element strides st) as a
// 4-D TMA map whose box is one 32-column chunk of `rows` rows of one head.
// The map's dims run by increasing stride, {D, H, N, B} or {D, N, H, B}
// ([B, H, N, D], heads_first), as the encoder's documentation lays them out.
// Rows past N (within a batch) and columns past 224 come back as zeros.
bool head_map(CUtensorMap* map, const void* base, int bsz, int n, int nh, Strides st, int rows) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const bool hf = heads_first(st);
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)(hf ? n : nh), (cuuint64_t)(hf ? nh : n),
                              (cuuint64_t)bsz};
  const cuuint64_t strides[3] = {(cuuint64_t)(hf ? st.n : st.h) * 2, (cuuint64_t)(hf ? st.h : st.n) * 2,
                                 (cuuint64_t)st.b * 2};  // bytes, dims 1-3
  const cuuint32_t box[4] = {32, hf ? (cuuint32_t)rows : 1u, hf ? 1u : (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The seven chunk boxes of rows [row0, row0 + rows) of head h, batch b, in
// the coordinate order of head_map's dims.
__device__ __forceinline__ void load_head_tile(unsigned char* dst, const CUtensorMap* map,
                                               uint64_t* bar, int rows, int h, int row0, int b,
                                               bool hf = false) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    tma_load_4d(dst + c * chunk_bytes(rows), map, bar, c * 32, hf ? row0 : h, hf ? h : row0, b);
}

// Descriptor of a K-major 64-row operand for k-step kk (16 columns of d):
// chunk kk / 2, second half of the 64-byte row for odd kk. `slab` selects
// rows [64 slab, 64 slab + 64) of a taller tile.
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile, int rows, int slab, int kk) {
  return smem_desc(cta_addr(tile + (kk >> 1) * chunk_bytes(rows) + slab * chunk_bytes(kRows) +
                            (kk & 1) * 32),
                   16, kSbo);
}
// Descriptor of a 64-row tile as the MN-major B operand (k = its rows,
// N = the 224 columns) for k-step kk (rows 16 kk ..).
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile, int kk) {
  return smem_desc(cta_addr(tile + kk * 1024), chunk_bytes(kRows), kSbo);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator element e of 8-column block j (m64nN fragment): row g (+ 8 for
// e >= 2), column 8 j + 2 t + (e & 1), in lane (g, t) = (lane / 4, lane % 4)
// of each warp's 16 rows. Two blocks 2kk, 2kk + 1 pack into the register A
// operand of k-step kk.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* x) {
  a[0] = pack_bf16(x[0], x[1]);
  a[1] = pack_bf16(x[2], x[3]);
  a[2] = pack_bf16(x[4], x[5]);
  a[3] = pack_bf16(x[6], x[7]);
}

// exp(a - b) on the fast path, 0 when a is -inf (a key past N).
__device__ __forceinline__ float fast_exp_diff(float a, float b) {
  return a == -INFINITY ? 0.f : __expf(a - b);
}

// 2^x by the special-function unit (0 for -inf).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
}

// kStages stages, each holding one 64-row tile of two tensors (K and V in
// K2/K7 and K3, Q and dO in K4), tile t in stage t % kStages; every stage
// of a tensor is tile_bytes(64) after the one before.
template <int kStages>
struct StageRing {
  uint64_t* full;        // [kStages] mbarriers: the stage's TMA bytes have landed
  uint32_t* released;    // [kStages] counts of consumer warpgroups done with the stage
  unsigned char* a;      // stage 0 of the first tensor
  unsigned char* b;      // the same of the second
  const CUtensorMap* map_a;
  const CUtensorMap* map_b;
  int h, b_idx, n_tiles;
  bool hf = false;       // head_map's coordinate order ([B, H, N, D])

  static __device__ __forceinline__ int stage(int t) { return (int)((unsigned)t % kStages); }
  __device__ __forceinline__ void load(int t) const {
    const int s = stage(t);
    mbar_arrive_expect_tx(&full[s], 2 * tile_bytes(kRows));
    load_head_tile(a + s * tile_bytes(kRows), map_a, &full[s], kRows, h, t * kRows, b_idx, hf);
    load_head_tile(b + s * tile_bytes(kRows), map_b, &full[s], kRows, h, t * kRows, b_idx, hf);
  }
  __device__ __forceinline__ void wait(int t) const {
    mbar_wait(&full[stage(t)], ((unsigned)t / kStages) & 1);
  }
  // Called by every thread of a consumer warpgroup once its products on tile
  // t have completed: the second warpgroup to finish refills the stage with
  // tile t + kStages. The count only grows, so its parity tells first from
  // second.
  __device__ __forceinline__ void release(int t, int wg) const {
    named_bar_sync(5 + wg, 128);  // the whole warpgroup is done with the stage
    if ((threadIdx.x & 127) == 0) {
      const uint32_t before = atomicAdd(&released[stage(t)], 1u);
      if ((before & 1u) && t + kStages < n_tiles) load(t + kStages);
    }
  }
};
using Ring = StageRing<2>;  // K3 and K4

}  // namespace
