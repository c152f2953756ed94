// C interface of the PGE pair-MLP kernels (see pge_kernels.cuh), loaded
// from Python with ctypes.  Every pointer is a device pointer allocated by
// the wrapper (graphslim_tpu_torch/kernels/pge.py); nothing is allocated
// here.  Each function launches on the given stream and returns
// cudaGetLastError() so a refused launch reaches the caller.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libpge.so pge.cu

#include <cuda_runtime.h>

#include "pge_kernels.cuh"

namespace {

pge::Params make_params(const float* a, const float* b, const float* wmid,
                        const float* bmid, const float* gamma,
                        const float* beta, const float* wlast, float* ws,
                        float* stat, int n, int H, int L2) {
  pge::Params A;
  A.a = a;
  A.b = b;
  A.wmid = wmid;
  A.bmid = bmid;
  A.gamma = gamma;
  A.beta = beta;
  A.wlast = wlast;
  A.n = n;
  A.H = H;
  A.L2 = L2;
  A.nj = (n + pge::TJ - 1) / pge::TJ;
  A.ntiles = ((n + pge::TI - 1) / pge::TI) * A.nj;
  A.ws = ws;
  A.stat = stat;
  return A;
}

}  // namespace

template <int NBG>
static cudaError_t launch_fwd(const pge::Params& A, float* out, int keep,
                              int grid, cudaStream_t stream) {
  const int smem = pge::fwd_smem_bytes(A.H);
  cudaError_t err = cudaFuncSetAttribute(
      pge::pge_fwd_kernel<NBG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  pge::pge_fwd_kernel<NBG><<<grid, pge::FT, smem, stream>>>(A, out, keep);
  return cudaGetLastError();
}

// The forward's kernel at width H (its column-group width).
static const void* fwd_kernel(int H) {
  switch (pge::fwd_nbg(H)) {
    case 1: return (const void*)pge::pge_fwd_kernel<1>;
    case 2: return (const void*)pge::pge_fwd_kernel<2>;
    case 3: return (const void*)pge::pge_fwd_kernel<3>;
    default: return (const void*)pge::pge_fwd_kernel<4>;
  }
}

// Widths the forward takes: multiples of 64 whose operands fit a block's
// shared memory (up to 320).
static bool fwd_width_ok(int H) {
  return H >= 64 && H % 64 == 0 &&
         pge::fwd_smem_bytes(H) <= pge::MAX_SMEM_BLOCK;
}

// keep: ws and stat are per tile (the backward reads them); else ws holds
// (L2 - 1) x P x H floats a block and there are no statistics.
extern "C" int pge_fwd(const float* a, const float* b, const float* wmid,
                       const float* bmid, const float* gamma,
                       const float* beta, const float* wlast, float* out,
                       float* ws, float* stat, int n, int H, int L2,
                       int grid, int keep, void* stream) {
  pge::Params A = make_params(a, b, wmid, bmid, gamma, beta, wlast, ws,
                              stat, n, H, L2);
  cudaStream_t s = (cudaStream_t)stream;
  if (!fwd_width_ok(H)) return (int)cudaErrorInvalidValue;
  switch (pge::fwd_nbg(H)) {
    case 1: return (int)launch_fwd<1>(A, out, keep, grid, s);
    case 2: return (int)launch_fwd<2>(A, out, keep, grid, s);
    case 3: return (int)launch_fwd<3>(A, out, keep, grid, s);
    default: return (int)launch_fwd<4>(A, out, keep, grid, s);
  }
}

// Bytes of dynamic shared memory of a forward block at width H, or -1 for
// a width it does not take.
extern "C" int pge_fwd_smem_bytes(int H) {
  return fwd_width_ok(H) ? pge::fwd_smem_bytes(H) : -1;
}

// Opts the backward kernel into its dynamic shared memory (above 48 KB)
// and the largest shared-memory carve-out.
static cudaError_t prepare_bwd(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      pge::pge_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(pge::pge_bwd_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// dbuf: per block nbuf x P x H floats for the raw dX of middle layers,
// nbuf = min(2, L2 - 1); null for L2 <= 1.
extern "C" int pge_bwd(const float* a, const float* b, const float* wmid,
                       const float* bmid, const float* gamma,
                       const float* beta, const float* wlast,
                       const float* g, float* dwmid, float* dbmid,
                       float* dgamma, float* dbeta, float* dwlast,
                       float* da_part, float* db_part, float* dbuf,
                       float* ws, float* stat, int n, int H, int L2,
                       int grid, void* stream) {
  pge::Params A = make_params(a, b, wmid, bmid, gamma, beta, wlast, ws,
                              stat, n, H, L2);
  pge::Grads G;
  G.g = g;
  G.dwmid = dwmid;
  G.dbmid = dbmid;
  G.dgamma = dgamma;
  G.dbeta = dbeta;
  G.dwlast = dwlast;
  G.da_part = da_part;
  G.db_part = db_part;
  G.dbuf = dbuf;
  G.ni = (n + pge::TI - 1) / pge::TI;
  G.nbuf = L2 >= 2 ? (L2 - 1 < 2 ? L2 - 1 : 2) : 0;
  if (H > pge::MAX_H_BWD || (G.nbuf > 0 && dbuf == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = pge::bwd_smem_bytes(H);
  cudaError_t err = prepare_bwd(smem);
  if (err != cudaSuccess) return (int)err;
  pge::pge_bwd_kernel<<<grid, pge::NT4, smem, (cudaStream_t)stream>>>(A, G);
  return (int)cudaGetLastError();
}

// Blocks of the forward (bwd = 0) or backward (bwd = 1) kernel that fit on
// one SM at once at width H, into *out; returns the CUDA error code.
extern "C" int pge_blocks_per_sm(int bwd, int H, int* out) {
  if (bwd) {
    const int smem = pge::bwd_smem_bytes(H);
    cudaError_t err = prepare_bwd(smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, pge::pge_bwd_kernel, pge::NT4, smem);
  }
  if (!fwd_width_ok(H)) return (int)cudaErrorInvalidValue;
  const int smem = pge::fwd_smem_bytes(H);
  const void* k = fwd_kernel(H);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, pge::FT,
                                                           smem);
}

// Bytes of dynamic shared memory of a backward block at width H.
extern "C" int pge_bwd_smem_bytes(int H) {
  return pge::bwd_smem_bytes(H);
}

#ifdef PGE_PHASES
// Diagnostic builds only: sets the mask of skipped phases.
extern "C" int pge_set_skip(int bits) {
  return (int)cudaMemcpyToSymbol(pge::g_skip, &bits, sizeof(int));
}
#endif
