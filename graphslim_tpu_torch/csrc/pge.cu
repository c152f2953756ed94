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

extern "C" int pge_fwd(const float* a, const float* b, const float* wmid,
                       const float* bmid, const float* gamma,
                       const float* beta, const float* wlast, float* out,
                       float* ws, float* stat, int n, int H, int L2,
                       int grid, int bf16, void* stream) {
  pge::Params A = make_params(a, b, wmid, bmid, gamma, beta, wlast, ws,
                              stat, n, H, L2);
  if (bf16)
    pge::pge_fwd_kernel<true><<<grid, pge::NT, 0, (cudaStream_t)stream>>>(
        A, out);
  else
    pge::pge_fwd_kernel<false><<<grid, pge::NT, 0, (cudaStream_t)stream>>>(
        A, out);
  return (int)cudaGetLastError();
}

// Opts the backward kernel into its dynamic shared memory (above 48 KB)
// and the largest shared-memory carve-out, so that two blocks fit an SM.
template <bool BF16>
static cudaError_t prepare_bwd(int smem) {
  auto kernel = pge::pge_bwd_kernel<BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
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
                       int grid, int bf16, void* stream) {
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
  const int smem = pge::bwd_smem_bytes(H, bf16 != 0);
  cudaError_t err = bf16 ? prepare_bwd<true>(smem) : prepare_bwd<false>(smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int nt_mma = pge::BwdThreads<true>::N;
  constexpr int nt_simt = pge::BwdThreads<false>::N;
  if (bf16)
    pge::pge_bwd_kernel<true><<<grid, nt_mma, smem, (cudaStream_t)stream>>>(
        A, G);
  else
    pge::pge_bwd_kernel<false><<<grid, nt_simt, smem, (cudaStream_t)stream>>>(
        A, G);
  return (int)cudaGetLastError();
}

// Blocks of the forward (bwd = 0) or backward (bwd = 1) kernel that fit on
// one SM at once at width H, into *out; returns the CUDA error code.
extern "C" int pge_blocks_per_sm(int bwd, int bf16, int H, int* out) {
  if (bwd) {
    const int smem = pge::bwd_smem_bytes(H, bf16 != 0);
    cudaError_t err =
        bf16 ? prepare_bwd<true>(smem) : prepare_bwd<false>(smem);
    if (err != cudaSuccess) return (int)err;
    const void* k = bf16 ? (const void*)pge::pge_bwd_kernel<true>
                         : (const void*)pge::pge_bwd_kernel<false>;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, k, bf16 ? pge::BwdThreads<true>::N : pge::BwdThreads<false>::N,
        smem);
  }
  const void* k = bf16 ? (const void*)pge::pge_fwd_kernel<true>
                       : (const void*)pge::pge_fwd_kernel<false>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, pge::NT,
                                                           0);
}

// Bytes of dynamic shared memory of a backward block at width H.
extern "C" int pge_bwd_smem_bytes(int H, int bf16) {
  return pge::bwd_smem_bytes(H, bf16 != 0);
}

#ifdef PGE_PHASES
// Diagnostic builds only: sets the mask of skipped phases.
extern "C" int pge_set_skip(int bits) {
  return (int)cudaMemcpyToSymbol(pge::g_skip, &bits, sizeof(int));
}
#endif
