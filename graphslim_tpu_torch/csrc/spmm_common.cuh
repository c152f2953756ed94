// Shared device code of the blocked SpMM (spmm_blocked.cu) and the
// shared-memory row gather (smem_gather.cu): staging a tile of source rows
// in shared memory, and a warp's copy of one row.  With VEC (row pitch and
// slab start multiples of 4 floats, so every row is 16-byte aligned) the
// lanes move float4s, otherwise floats; either way a warp reads whole
// 128-byte lines.

#pragma once

#include <cuda_runtime.h>

namespace spmm {

constexpr int NT = 256;    // threads of a block
constexpr int NW = NT / 32;

// Copies rows [row0, row0 + nrows) x columns [c0, c0 + w) of the row-major
// matrix x (row pitch ld floats) into tile (row pitch `pitch` floats), by
// all threads of the block.  The caller synchronizes.
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* tile, int pitch,
                                           const float* __restrict__ x,
                                           size_t ld, int row0, int nrows,
                                           int c0, int w) {
  if (VEC) {
    const int w4 = w >> 2;
    for (int i = threadIdx.x; i < nrows * w4; i += blockDim.x) {
      const int r = i / w4, c = i - r * w4;
      reinterpret_cast<float4*>(tile + (size_t)r * pitch)[c] =
          reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * ld +
                                          c0)[c];
    }
  } else {
    for (int i = threadIdx.x; i < nrows * w; i += blockDim.x) {
      const int r = i / w, c = i - r * w;
      tile[(size_t)r * pitch + c] = x[(size_t)(row0 + r) * ld + c0 + c];
    }
  }
}

// dst[0..d) = src[0..d) by one warp, any width d.
template <bool VEC>
__device__ __forceinline__ void row_copy(float* dst, const float* src,
                                         int lane, int d) {
  if (VEC) {
    for (int c = lane; c < (d >> 2); c += 32)
      reinterpret_cast<float4*>(dst)[c] =
          reinterpret_cast<const float4*>(src)[c];
  } else {
    for (int c = lane; c < d; c += 32) dst[c] = src[c];
  }
}

}  // namespace spmm
