// Attention-probability dropout mask shared by K2 (forward) and K3/K4
// (backward): the murmur3-finalizer hash of
// transfusion_tpu/ops/attention.py:207 (_dropout_keep_mask) over GLOBAL
// (query, key) indices, the cell b * H + h and the seed, in uint32 with
// wrap-around. A probability is kept when the hash is >= thresh, where
// thresh = uint32(rate * 4294967295.0) (computed by the wrapper). Every pass
// regenerates the same bits whatever its tiling, so no mask is stored.
#pragma once

#include <stdint.h>

// The part of the hash input that depends on the query row only.
static __device__ __forceinline__ uint32_t dropout_row(uint32_t row, uint32_t seed,
                                                       uint32_t cell) {
  return row * 0x9E3779B9u + (seed + cell * 0xC2B2AE35u);
}

static __device__ __forceinline__ bool dropout_keep(uint32_t row_part, uint32_t col,
                                                    uint32_t thresh) {
  uint32_t x = row_part + col * 0x85EBCA6Bu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}
