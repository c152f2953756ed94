// Shared device code of the blocked SpMM (spmm_blocked.cu) and the
// shared-memory row gather (smem_gather.cu): staging a tile of source rows
// in shared memory, and a warp's access to one row of up to 128 columns.
//
// A warp owns a row; its 32 lanes cover a slab of at most SLAB = 128
// columns.  With VEC (row pitch and slab start multiples of 4 floats, so
// every row is 16-byte aligned) lane l holds the float4 at columns
// 4l..4l+3; otherwise lane l holds columns l, l+32, l+64, l+96.  Either way
// a lane keeps 4 floats and the warp reads 128-byte lines.

#pragma once

#include <cuda_runtime.h>

namespace spmm {

constexpr int SLAB = 128;  // columns a warp covers at once
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

// acc += v * row[0..w) for this lane's 4 columns of the slab.
template <bool VEC>
__device__ __forceinline__ void row_fma(float acc[4], float v,
                                        const float* row, int lane, int w) {
  if (VEC) {
    if (4 * lane < w) {
      const float4 t = reinterpret_cast<const float4*>(row)[lane];
      acc[0] = fmaf(v, t.x, acc[0]);
      acc[1] = fmaf(v, t.y, acc[1]);
      acc[2] = fmaf(v, t.z, acc[2]);
      acc[3] = fmaf(v, t.w, acc[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lane + 32 * k < w) acc[k] = fmaf(v, row[lane + 32 * k], acc[k]);
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

template <bool VEC>
__device__ __forceinline__ void row_store(float* row, const float acc[4],
                                          int lane, int w) {
  if (VEC) {
    if (4 * lane < w)
      reinterpret_cast<float4*>(row)[lane] =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (lane + 32 * k < w) row[lane + 32 * k] = acc[k];
  }
}

}  // namespace spmm
