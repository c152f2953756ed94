// Blocked SpMM for Hopper: out = A @ x over the (dst_tile, src_tile)-blocked,
// dst-sorted COO layout of graphslim_tpu_torch/kernels/spmm_blocked.py.
// Replaces the TPU kernel `kern` of
// graphslim_tpu/kernels/pallas_spmm_blocked.py::spmm_blocked.
//
// One thread block owns one destination tile (td rows) and one slab of up
// to 128 columns, and walks that tile's stored blocks in order, so nothing
// is summed across thread blocks: no atomics, and a result repeats bit for
// bit.  Inside the tile a warp owns the rows r = warp, warp + 8, ...; the
// block's `bounds` give each row's run of dst-sorted entries.  The warp
// loads 32 entries' (src_local, val) at once, hands them round with
// shuffles, and sums val * x[src] in registers, lanes over columns.  The
// tile's first block writes every row (zeros for an empty one), later
// blocks add to the rows they touch; the same lane reads and writes the
// same addresses, so no synchronization is needed between blocks.
//
// A stored block is either staged (blk_src >= 0: the source tile of x is
// copied into shared memory once, rows are gathered from there) or direct
// (blk_src < 0: src_local holds global rows, read through L2).  The layout
// (build_blocked) stages a block only when its entries reuse the tile's
// rows often enough for the copy to pay.
//
// Bound by bytes: entries x 8 B + one read of x + one write of out.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libspmm_blocked.so spmm_blocked.cu

#include <cuda_runtime.h>

#include "spmm_common.cuh"

namespace spmm {

struct Layout {
  const int* tile_ptr;    // [n_tiles + 1] first stored block of a dst tile
  const int* blk_ptr;     // [n_blocks + 1] first entry of a block
  const int* blk_src;     // [n_blocks] source tile, or -1 for a direct block
  const int* bounds;      // [n_blocks, td + 1] first entry with dst_local >= r
  const int* src_local;   // [entries] row within the source tile (or global)
  const float* val;       // [entries]
  int n_rows, n_src, td, ts;
};

template <bool VEC>
__global__ void __launch_bounds__(NT)
    spmm_blocked_kernel(Layout L, const float* __restrict__ x,
                        float* __restrict__ out, int d) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * SLAB;
  const int w = min(SLAB, d - c0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = t * L.td;
  const int rows = min(L.td, L.n_rows - row0);
  const int b0 = L.tile_ptr[t], b1 = L.tile_ptr[t + 1];
  int staged = -1;

  for (int b = b0; b < b1; ++b) {
    const int src = L.blk_src[b];
    if (src >= 0 && src != staged) {
      __syncthreads();  // every warp is done with the previous tile
      const int s0 = src * L.ts;
      stage_rows<VEC>(tile, SLAB, x, (size_t)d, s0, min(L.ts, L.n_src - s0),
                      c0, w);
      __syncthreads();
      staged = src;
    }
    const int* bnd = L.bounds + (size_t)b * (L.td + 1);
    const int* srcl = L.src_local + L.blk_ptr[b];
    const float* val = L.val + L.blk_ptr[b];
    const bool first = b == b0;
    for (int r = warp; r < rows; r += NW) {
      const int lo = bnd[r], hi = bnd[r + 1];
      if (!first && lo == hi) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int e0 = lo; e0 < hi; e0 += 32) {
        const int e = e0 + lane;
        const int s_l = e < hi ? srcl[e] : 0;
        const float v_l = e < hi ? val[e] : 0.f;
        const int cnt = min(32, hi - e0);
#pragma unroll 4
        for (int j = 0; j < cnt; ++j) {
          const int s = __shfl_sync(0xffffffffu, s_l, j);
          const float v = __shfl_sync(0xffffffffu, v_l, j);
          const float* row = src >= 0 ? tile + (size_t)s * SLAB
                                      : x + (size_t)s * d + c0;
          row_fma<VEC>(acc, v, row, lane, w);
        }
      }
      float* o = out + (size_t)(row0 + r) * d + c0;
      if (!first) row_fma<VEC>(acc, 1.f, o, lane, w);
      row_store<VEC>(o, acc, lane, w);
    }
  }
  if (b0 == b1) {  // a tile with no entry at all
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = warp; r < rows; r += NW)
      row_store<VEC>(out + (size_t)(row0 + r) * d + c0, zero, lane, w);
  }
}

}  // namespace spmm

// Launches the kernel on `stream` over n_tiles destination tiles and
// ceil(d / 128) column slabs, with smem_bytes of shared memory for the
// staged source tile (0 when the layout has no staged block).  `vec` says
// that d is a multiple of 4 and x, out are 16-byte aligned.  Returns the
// CUDA error code of the launch.
extern "C" int spmm_blocked(const int* tile_ptr, const int* blk_ptr,
                            const int* blk_src, const int* bounds,
                            const int* src_local, const float* val,
                            const float* x, float* out, int n_rows,
                            int n_src, int d, int td, int ts, int n_tiles,
                            int smem_bytes, int vec, void* stream) {
  spmm::Layout L;
  L.tile_ptr = tile_ptr;
  L.blk_ptr = blk_ptr;
  L.blk_src = blk_src;
  L.bounds = bounds;
  L.src_local = src_local;
  L.val = val;
  L.n_rows = n_rows;
  L.n_src = n_src;
  L.td = td;
  L.ts = ts;
  const dim3 grid(n_tiles, (d + spmm::SLAB - 1) / spmm::SLAB);
  auto kernel = vec ? spmm::spmm_blocked_kernel<true>
                    : spmm::spmm_blocked_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, spmm::NT, smem_bytes, (cudaStream_t)stream>>>(L, x, out, d);
  return (int)cudaGetLastError();
}
