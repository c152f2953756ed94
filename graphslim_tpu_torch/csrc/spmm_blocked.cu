// Blocked SpMM for Hopper: out = A @ x over the (dst_tile, src_tile)-blocked,
// dst-sorted COO layout of graphslim_tpu_torch/kernels/spmm_blocked.py.
// Replaces the TPU kernel `kern` of
// graphslim_tpu/kernels/pallas_spmm_blocked.py::spmm_blocked.
//
// One thread block owns one destination tile (td rows) and a slab of
// columns, and walks that tile's stored blocks in order, so nothing is
// summed across thread blocks: no atomics, and a result repeats bit for
// bit.  A slab is all of d up to 128 columns (160 when d is no multiple
// of 4): one walk of the entries.  Wider rows, and a staged source tile of
// all d columns that would not fit shared memory, take slabs of 128
// columns (grid.y), one walk each (kernels/spmm_blocked.py: launch_plan).
//
// Inside the tile a warp owns the rows r = warp, warp + 8, ...; the
// block's `bounds` give each row's run of dst-sorted entries.  The warp
// loads 32 entries' (src_local, val) at once and hands them round with
// shuffles.  Its lanes form G = 32 / lpr groups of lpr lanes: a group takes
// every G-th entry and its lanes cover the row's columns, nv items
// (one float4, or up to 5 floats when d is no multiple of 4) a lane at
// lpr = 32.  A
// row of at most 16 items takes lpr = items and several entries at once
// (d = 40: 3 entries of 10 float4s, 30 of 32 lanes busy); the groups' sums
// then meet over shuffles in group order.  A lane issues the loads of
// several entries before their FMAs (struct Tuning).  A row of a matrix
// whose width is no multiple of 4 is only 4-byte aligned, so there the
// lanes read floats: consecutive lanes, consecutive columns, the same
// 128-byte lines as float4s.  The tile's first block writes every row
// (zeros for an empty one), later blocks add to the rows they touch; the
// same lane reads and writes the same addresses, so no synchronization is
// needed between blocks.
//
// A stored block is either staged (blk_src >= 0: the source tile of x is
// copied into shared memory once, rows are gathered from there) or direct
// (blk_src < 0: src_local holds global rows, read through L2).  The layout
// (build_blocked) stages a block only when its entries reuse the tile's
// rows often enough for the copy to pay.  A staged tile holds the slab's
// columns.
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

// One row's share of a lane: items u + lpr * k (k < NV) of the slab's
// `items` float4s (VEC) or floats.
template <bool VEC, int NV>
struct RowPart {
  float4 t[NV];
  // loads every item first (predicated, no branch between the loads)
  __device__ __forceinline__ void load(const float* row, int u, int lpr,
                                       int items, bool ok) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int it = u + lpr * k;
      const bool in = ok && it < items;
      if (VEC) {
        t[k] = in ? reinterpret_cast<const float4*>(row)[it]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        t[k].x = in ? row[it] : 0.f;
      }
    }
  }
  __device__ __forceinline__ void axpy(float (&acc)[NV][4], float v) const {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      acc[k][0] = fmaf(v, t[k].x, acc[k][0]);
      if (VEC) {
        acc[k][1] = fmaf(v, t[k].y, acc[k][1]);
        acc[k][2] = fmaf(v, t[k].z, acc[k][2]);
        acc[k][3] = fmaf(v, t[k].w, acc[k][3]);
      }
    }
  }
};

template <bool VEC, int NV>
__device__ __forceinline__ void row_put(float* row, const float (&acc)[NV][4],
                                        int u, int lpr, int items) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int it = u + lpr * k;
    if (it < items) {
      if (VEC)
        reinterpret_cast<float4*>(row)[it] =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      else
        row[it] = acc[k][0];
    }
  }
}

// slab: columns a block covers (d up to 128, or 160 floats; else 128);
// lpr: lanes a row group, 32 unless NARROW (then 32 / lpr groups a warp,
// each taking every G-th entry).
// Loads a lane keeps in flight and blocks an SM should hold, per kind of
// row access (chosen from timings on the H100 at the arxiv twin's shapes):
// rows of at most 16 float4s, several entries a warp: 4 entries, 6 blocks
// (40 registers); wider float4 rows: 8 entries, 4 blocks (64 registers);
// rows of floats (d no multiple of 4): 2 entries, the compiler's choice.
template <bool VEC, int NV, bool NARROW>
struct Tuning {
  static constexpr int EB = NARROW ? 4 : VEC ? 8 : 2;
  static constexpr int MINB = NARROW ? 6 : VEC ? 4 : 1;
};

template <bool VEC, int NV, bool NARROW>
__global__ void __launch_bounds__(NT, (Tuning<VEC, NV, NARROW>::MINB))
    spmm_blocked_kernel(Layout L, const float* __restrict__ x,
                        float* __restrict__ out, int d, int slab, int lpr_) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  constexpr int U = VEC ? 4 : 1;    // floats an item
  // entries whose loads a lane has in flight at once
  constexpr int EB = Tuning<VEC, NV, NARROW>::EB;
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * slab;
  const int w = min(slab, d - c0), items = w / U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpr = NARROW ? lpr_ : 32;
  const int G = NARROW ? 32 / lpr : 1;
  const int g = NARROW ? lane / lpr : 0, u = lane - g * lpr;
  const int row0 = t * L.td;
  const int rows = min(L.td, L.n_rows - row0);
  const int b0 = L.tile_ptr[t], b1 = L.tile_ptr[t + 1];
  int staged = -1;

  for (int b = b0; b < b1; ++b) {
    const int src = L.blk_src[b];
    if (src >= 0 && src != staged) {
      __syncthreads();  // every warp is done with the previous tile
      const int s0 = src * L.ts;
      stage_rows<VEC>(tile, slab, x, (size_t)d, s0, min(L.ts, L.n_src - s0),
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
      float acc[NV][4] = {};
      for (int e0 = lo; e0 < hi; e0 += 32) {
        const int e = e0 + lane;
        const int s_l = e < hi ? srcl[e] : 0;
        const float v_l = e < hi ? val[e] : 0.f;
        const int cnt = min(32, hi - e0);
        for (int j = 0; j < cnt; j += EB * G) {
          // entries j + q G + g (q < EB) go to group g: their loads first
          RowPart<VEC, NV> part[EB];
          float v[EB];
#pragma unroll
          for (int q = 0; q < EB; ++q) {
            const int at = j + q * G + g;
            const int s = __shfl_sync(0xffffffffu, s_l, at & 31);
            const float vq = __shfl_sync(0xffffffffu, v_l, at & 31);
            const bool ok = (!NARROW || g < G) && at < cnt;
            v[q] = ok ? vq : 0.f;
            const float* row = src >= 0 ? tile + (size_t)s * slab
                                        : x + (size_t)s * d + c0;
            part[q].load(row, u, lpr, items, ok);
          }
#pragma unroll
          for (int q = 0; q < EB; ++q) part[q].axpy(acc, v[q]);
        }
      }
      if (NARROW) {   // the groups' sums, in group order
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int c = 0; c < U; ++c) {
            float tot = 0.f;
            for (int h = 0; h < G; ++h)
              tot += __shfl_sync(0xffffffffu, acc[k][c], u + h * lpr);
            acc[k][c] = tot;
          }
        if (g != 0) continue;
      }
      float* o = out + (size_t)(row0 + r) * d + c0;
      if (!first) {
        RowPart<VEC, NV> old;
        old.load(o, u, lpr, items, true);
        old.axpy(acc, 1.f);
      }
      row_put<VEC, NV>(o, acc, u, lpr, items);
    }
  }
  if (b0 == b1 && g == 0) {  // a tile with no entry at all
    const float zero[NV][4] = {};
    for (int r = warp; r < rows; r += NW)
      row_put<VEC, NV>(out + (size_t)(row0 + r) * d + c0, zero, u, lpr,
                       items);
  }
}

}  // namespace spmm

template <bool VEC>
static cudaError_t launch(const spmm::Layout& L, const float* x, float* out,
                          int d, int slab, int lpr, int nv, dim3 grid,
                          int smem, cudaStream_t stream) {
  // nv: one float4 (128 columns) or up to 5 floats (160) a lane
  void (*kernel)(spmm::Layout, const float*, float*, int, int, int) =
      nullptr;
  if (lpr < 32) {
    kernel = spmm::spmm_blocked_kernel<VEC, 1, true>;
  } else if constexpr (VEC) {
    if (nv == 1) kernel = spmm::spmm_blocked_kernel<true, 1, false>;
  } else {
    switch (nv) {
      case 1: kernel = spmm::spmm_blocked_kernel<false, 1, false>; break;
      case 2: kernel = spmm::spmm_blocked_kernel<false, 2, false>; break;
      case 3: kernel = spmm::spmm_blocked_kernel<false, 3, false>; break;
      case 4: kernel = spmm::spmm_blocked_kernel<false, 4, false>; break;
      case 5: kernel = spmm::spmm_blocked_kernel<false, 5, false>; break;
    }
  }
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, spmm::NT, smem, stream>>>(L, x, out, d, slab, lpr);
  return cudaGetLastError();
}

// Launches the kernel on `stream` over n_tiles destination tiles and
// ceil(d / slab) column slabs (one up to 128 or 160 columns), with
// smem_bytes of shared memory for the staged source tile (0 when the
// layout has no staged block), lpr lanes a row group and nv items a lane
// (kernels/spmm_blocked.py: launch_plan).  `vec` says that d is a multiple
// of 4 and x, out are 16-byte aligned.  Returns the CUDA error code.
extern "C" int spmm_blocked(const int* tile_ptr, const int* blk_ptr,
                            const int* blk_src, const int* bounds,
                            const int* src_local, const float* val,
                            const float* x, float* out, int n_rows,
                            int n_src, int d, int td, int ts, int n_tiles,
                            int smem_bytes, int vec, int slab, int lpr,
                            int nv, void* stream) {
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
  if (slab < 1 || lpr < 1 || lpr > 32 || (lpr < 32 && nv != 1) ||
      (vec && slab % 4))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles, (d + slab - 1) / slab);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec ? launch<true>(L, x, out, d, slab, lpr, nv, grid,
                                  smem_bytes, s)
                   : launch<false>(L, x, out, d, slab, lpr, nv, grid,
                                   smem_bytes, s));
}
