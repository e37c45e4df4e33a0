// Hopper (sm_90a) building blocks for the attention kernels (attention.cu,
// attention_bwd.cu) and the LayerNorm ring (layer_norm.cu): TMA tile loads
// and plain bulk copies completed on an mbarrier, named barriers, and the
// asynchronous warpgroup product wgmma.mma_async with its shared-memory
// matrix descriptors. Plain PTX through inline asm, so the build needs only
// the CUDA toolkit.
//
// Shared-memory operand layout used throughout: a tile of R rows x 224 bf16
// columns is stored as seven column chunks of 32 values (64 bytes), each
// chunk R rows of 64 bytes with the 64-byte swizzle, which is what one TMA
// box {32, 1, R, 1} with CU_TENSOR_MAP_SWIZZLE_64B writes. Every chunk
// starts on a 1024-byte boundary, so the swizzle pattern (512 bytes) lines up
// with the absolute address bits wgmma swizzles on.
//   K-major operand (rows = M or N, contiguous along k): descriptor start =
//     chunk base + 32 bytes per odd 16-wide k-step, SBO = 512 (8 rows x 64 B).
//   MN-major operand (rows = k, contiguous along N): start = tile base +
//     1024 bytes per 16-row k-step, LBO = chunk stride (R x 64 B, the step
//     between 32-wide column groups), SBO = 512 (the step between 8-row groups).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

static __device__ __forceinline__ uint32_t cta_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier
static __device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(cta_addr(bar)), "r"(count)
               : "memory");
}
static __device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also announces `bytes` of TMA traffic to come.
static __device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(cta_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase of parity 1 as complete). A wait that lasts about ten
// seconds traps, so a protocol error fails the launch instead of hanging it.
static __device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = cta_addr(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > 20000000000ll) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------------- TMA
// Copy the box at coordinates (c0, c1, c2, c3) (innermost first) of the
// tensor map into shared memory; completion is counted on `bar` in bytes.
static __device__ __forceinline__ void tma_load_4d(void* dst, const void* tmap, uint64_t* bar,
                                                   int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(cta_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(cta_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copy `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory; completion is counted on `bar`.
static __device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(cta_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(cta_addr(bar))
               : "memory");
}

// ------------------------------------------------------------ named barriers
static __device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
static __device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------------- wgmma
static __device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most kPending committed groups of this warpgroup are in flight.
template <int kPending>
static __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Keep the compiler from moving register reads or writes of an accumulator
// across the asynchronous product that owns it.
template <int kN>
static __device__ __forceinline__ void fence_regs(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor with the 64-byte swizzle (layout type 2).
static __device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)2 << 62);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory, both
// K-major (rows contiguous along k).
static __device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 224] (+)= A[64 x 16] B[16 x 224]: A from registers (the layout of
// an m64n16 accumulator, packed to bf16 pairs), B from shared memory
// MN-major (rows of B along k, each contiguous along n).
static __device__ __forceinline__ void wgmma_m64n224k16_rs_mn(float (&d)[112], const uint32_t (&a)[4], uint64_t desc_b,
                                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, {%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

