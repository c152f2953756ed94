// Row gather for Hopper: out[e] = x[idx[e]].  Replaces the TPU probe kernel
// `kern` of benchmark/probe_spmm.py::vmem_gather, which held the source
// tile in on-chip memory.  Two kernels:
//
// gather_direct_kernel (what gather_rows launches): rows are read from x
// through L2.  Bound by bytes (out + idx + x), but at the sizes the port
// gathers (1 MB or less) the transfer is far below the ~2 MB the card must
// keep in flight to reach its bandwidth, so the time is a chain of
// latencies: index load, row load, store.  The design keeps that chain one
// link long for every thread and spreads it over the card: the copy is cut
// into pieces of 16 bytes (4 bytes when d is not a multiple of 4 or a
// pointer is unaligned), piece t = (e, c) with e = t / dv and c = t % dv;
// a thread owns one piece: it loads the index, the piece, and stores it.
// The grid is sized to the pieces, not to rows per warp, so a gather of a
// thousand rows still covers the SMs.
//
// smem_gather_kernel (the probe's function, staged): a thread block has
// 227 KB of shared memory against the probe's 2 MB source, so each block
// owns a slice of ts source rows, copies it into shared memory (the
// staging code the blocked SpMM shares, spmm_common.cuh) and serves the
// indices of its chunk that fall into the slice: a warp reads 32 indices
// at once, votes on which fall into the slice, and copies those rows,
// lanes over columns.
//
// Every out row is written exactly once: the copy is exact and repeats bit
// for bit.  Indices outside [0, n_src) are not served (their out rows stay
// unwritten); the wrapper's callers pass valid ones.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libsmem_gather.so smem_gather.cu

#include <cuda_runtime.h>

#include "spmm_common.cuh"

namespace spmm {

template <int VW> struct Piece;
template <> struct Piece<4> { using type = float4; };
template <> struct Piece<1> { using type = float; };

// Piece t of this launch's share: row e0 + t / dv, piece t % dv of the row
// (dv = d / VW pieces a row).  npieces < 2^31 (the wrapper cuts the index
// vector over blockIdx.y otherwise).
template <int VW, typename IDX>
__global__ void __launch_bounds__(NT)
    gather_direct_kernel(const float* __restrict__ x,
                         const IDX* __restrict__ idx, float* __restrict__ out,
                         int n_src, int dv, int n_idx, int e_per_y) {
  using V = typename Piece<VW>::type;
  const int e0 = blockIdx.y * e_per_y;
  const int ne = min(e_per_y, n_idx - e0);
  const unsigned npieces = (unsigned)ne * (unsigned)dv;
  const unsigned t = blockIdx.x * (unsigned)NT + threadIdx.x;
  if (t >= npieces) return;
  const unsigned e = t / (unsigned)dv, c = t - e * (unsigned)dv;
  const long long row = (long long)idx[e0 + e];
  if ((unsigned long long)row >= (unsigned long long)n_src) return;
  reinterpret_cast<V*>(out)[(size_t)(e0 + e) * dv + c] =
      reinterpret_cast<const V*>(x)[(size_t)row * dv + c];
}

template <bool VEC, typename IDX>
__global__ void __launch_bounds__(NT)
    smem_gather_kernel(const float* __restrict__ x,
                       const IDX* __restrict__ idx, float* __restrict__ out,
                       int n_src, int d, int n_idx, int ts,
                       int e_per_block) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * ts;
  const int rows = min(ts, n_src - s0);
  const int e0 = blockIdx.y * e_per_block;
  const int e1 = min(n_idx, e0 + e_per_block);

  stage_rows<VEC>(tile, d, x, (size_t)d, s0, rows, 0, d);
  __syncthreads();
  for (int eb = e0 + warp * 32; eb < e1; eb += NT) {
    const int e = eb + lane;
    const int i = e < e1 ? (int)(idx[e] - s0) : -1;
    unsigned m = __ballot_sync(0xffffffffu, (unsigned)i < (unsigned)rows);
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      const int r = __shfl_sync(0xffffffffu, i, j);
      row_copy<VEC>(out + (size_t)(eb + j) * d, tile + (size_t)r * d, lane,
                    d);
    }
  }
}

}  // namespace spmm

template <bool VEC, typename IDX>
static int launch_staged(const float* x, const void* idx, float* out,
                         int n_src, int d, int n_idx, int ts,
                         int e_per_block, int smem_bytes,
                         cudaStream_t stream) {
  const dim3 grid((n_src + ts - 1) / ts,
                  (n_idx + e_per_block - 1) / e_per_block);
  auto kernel = spmm::smem_gather_kernel<VEC, IDX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, spmm::NT, smem_bytes, stream>>>(
      x, static_cast<const IDX*>(idx), out, n_src, d, n_idx, ts,
      e_per_block);
  return (int)cudaGetLastError();
}

// Launches the staged gather on `stream`: ceil(n_src / ts) source slices
// times ceil(n_idx / e_per_block) index chunks (e_per_block a multiple of
// 256), each block staging its slice in smem_bytes = ts * d * 4 bytes of
// shared memory.  idx holds int32, or with idx64 int64.  `vec` says that d
// is a multiple of 4 and x, out are 16-byte aligned.  Returns the CUDA
// error code of the launch.
extern "C" int smem_gather(const float* x, const void* idx, int idx64,
                           float* out, int n_src, int d, int n_idx, int ts,
                           int e_per_block, int smem_bytes, int vec,
                           void* stream) {
  using Launch = int (*)(const float*, const void*, float*, int, int, int,
                         int, int, int, cudaStream_t);
  static const Launch table[4] = {
      launch_staged<false, int>, launch_staged<false, long long>,
      launch_staged<true, int>, launch_staged<true, long long>};
  return table[(vec ? 2 : 0) + (idx64 ? 1 : 0)](
      x, idx, out, n_src, d, n_idx, ts, e_per_block, smem_bytes,
      (cudaStream_t)stream);
}

template <int VW, typename IDX>
static int launch_direct(const float* x, const void* idx, float* out,
                         int n_src, int d, int n_idx, int e_per_y,
                         cudaStream_t stream) {
  const int dv = d / VW;
  const unsigned pieces = (unsigned)min(e_per_y, n_idx) * (unsigned)dv;
  const dim3 grid((pieces + spmm::NT - 1) / spmm::NT,
                  (n_idx + e_per_y - 1) / e_per_y);
  spmm::gather_direct_kernel<VW, IDX><<<grid, spmm::NT, 0, stream>>>(
      x, static_cast<const IDX*>(idx), out, n_src, dv, n_idx, e_per_y);
  return (int)cudaGetLastError();
}

// Launches the direct gather on `stream`.  `vec`: d is a multiple of 4 and
// x, out are 16-byte aligned (16-byte pieces, else 4-byte ones).  e_per_y
// indices go to each blockIdx.y, with e_per_y * (pieces a row) < 2^31.
// Returns the CUDA error code.
extern "C" int gather_direct(const float* x, const void* idx, int idx64,
                             float* out, int n_src, int d, int n_idx,
                             int e_per_y, int vec, void* stream) {
  using Launch = int (*)(const float*, const void*, float*, int, int, int,
                         int, cudaStream_t);
  static const Launch table[4] = {
      launch_direct<1, int>, launch_direct<1, long long>,
      launch_direct<4, int>, launch_direct<4, long long>};
  return table[(vec ? 2 : 0) + (idx64 ? 1 : 0)](
      x, idx, out, n_src, d, n_idx, e_per_y, (cudaStream_t)stream);
}
