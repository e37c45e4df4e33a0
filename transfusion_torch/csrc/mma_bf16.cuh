// Building blocks of the attention forward kernels (K2, K7) and helpers
// shared with the backward (K3/K4): cp.async tile loads into padded
// shared-memory rows, ldmatrix fragment loads, the mma.sync m16n8k16 bf16
// product with f32 accumulation, bf16 packing and the fast exp.
//
// Fragment conventions (PTX ISA, mma.m16n8k16): in lane (g, t) = (lane / 4,
// lane % 4) the 16x8 f32 accumulator holds rows g and g + 8, columns 2t and
// 2t + 1 (c0, c1 in row g; c2, c3 in row g + 8). Two neighbouring 16x8
// accumulators therefore pack straight into the A operand of the next
// product (a0 = row g of the first, a1 = row g + 8 of the first, a2/a3 the
// same of the second), which is how probabilities and their gradients go
// from one product to the next without touching shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

static __device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most one committed group is still in flight.
static __device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

static __device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
static __device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d[16x8] += a[16x16] b[16x8], bf16 in, f32 accumulate.
static __device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// exp(a - b) on the fast path, 0 when a is -inf (a key past N).
static __device__ __forceinline__ float fast_exp_diff(float a, float b) {
  return a == -INFINITY ? 0.f : __expf(a - b);
}

// Start copying rows [row0, row0 + rows) of one head into shared memory
// (row pitch kD + 8, so ldmatrix reads are free of bank conflicts); rows at
// or past n are zero-filled. All kThreads threads of the block take part.
template <int kD, int kThreads>
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
