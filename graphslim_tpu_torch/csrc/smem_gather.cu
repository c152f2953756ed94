// Shared-memory row gather for Hopper: out[e] = x[idx[e]].  Replaces the
// TPU probe kernel `kern` of benchmark/probe_spmm.py::vmem_gather, which
// held the source tile in on-chip memory; a thread block has 227 KB of
// shared memory, so here each block owns a slice of ts source rows.
//
// Block (s, c) serves the indices of chunk c that fall into source rows
// [s * ts, (s + 1) * ts).  A warp reads 32 indices at once, votes on which
// fall into the slice, and copies those rows, lanes over columns.  STAGED:
// the slice is first copied into shared memory (the staging code the
// blocked SpMM shares, spmm_common.cuh) and rows are gathered from there.
// Not STAGED (direct): rows are read from x through L2; the wrapper then
// passes one slice that spans all of x, so no index is scanned twice.
// Every out row is written by exactly one warp: the copy is exact and
// repeats bit for bit.  Indices outside [0, n_src) are not served (their
// out rows stay unwritten); the wrapper's callers pass valid ones.
//
// Bound by bytes: out + idx + x.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libsmem_gather.so smem_gather.cu

#include <cuda_runtime.h>

#include "spmm_common.cuh"

namespace spmm {

template <bool VEC, bool STAGED, typename IDX>
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

  if (STAGED) {
    stage_rows<VEC>(tile, d, x, (size_t)d, s0, rows, 0, d);
    __syncthreads();
  }
  for (int eb = e0 + warp * 32; eb < e1; eb += NT) {
    const int e = eb + lane;
    const int i = e < e1 ? (int)(idx[e] - s0) : -1;
    unsigned m = __ballot_sync(0xffffffffu, (unsigned)i < (unsigned)rows);
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      const int r = __shfl_sync(0xffffffffu, i, j);
      const float* src =
          STAGED ? tile + (size_t)r * d : x + (size_t)(s0 + r) * d;
      row_copy<VEC>(out + (size_t)(eb + j) * d, src, lane, d);
    }
  }
}

}  // namespace spmm

template <bool VEC, bool STAGED, typename IDX>
static int launch(const float* x, const void* idx, float* out, int n_src,
                  int d, int n_idx, int ts, int e_per_block, int smem_bytes,
                  cudaStream_t stream) {
  const dim3 grid((n_src + ts - 1) / ts,
                  (n_idx + e_per_block - 1) / e_per_block);
  auto kernel = spmm::smem_gather_kernel<VEC, STAGED, IDX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, spmm::NT, smem_bytes, stream>>>(
      x, static_cast<const IDX*>(idx), out, n_src, d, n_idx, ts,
      e_per_block);
  return (int)cudaGetLastError();
}

// Launches the gather on `stream`: ceil(n_src / ts) source slices times
// ceil(n_idx / e_per_block) index chunks (e_per_block a multiple of 256).
// idx holds int32, or with idx64 int64.  smem_bytes = ts * d * 4 stages
// each slice in shared memory; 0 reads the rows from x directly.  `vec`
// says that d is a multiple of 4 and x, out are 16-byte aligned.  Returns
// the CUDA error code of the launch.
extern "C" int smem_gather(const float* x, const void* idx, int idx64,
                           float* out, int n_src, int d, int n_idx, int ts,
                           int e_per_block, int smem_bytes, int vec,
                           void* stream) {
  using Launch = int (*)(const float*, const void*, float*, int, int, int,
                         int, int, int, cudaStream_t);
  static const Launch table[8] = {
      launch<false, false, int>, launch<false, false, long long>,
      launch<false, true, int>,  launch<false, true, long long>,
      launch<true, false, int>,  launch<true, false, long long>,
      launch<true, true, int>,   launch<true, true, long long>};
  const int which =
      (vec ? 4 : 0) + (smem_bytes > 0 ? 2 : 0) + (idx64 ? 1 : 0);
  return table[which](x, idx, out, n_src, d, n_idx, ts, e_per_block,
                      smem_bytes, (cudaStream_t)stream);
}
