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
  if (bf16)
    pge::pge_bwd_kernel<true><<<grid, pge::NT, 0, (cudaStream_t)stream>>>(
        A, G);
  else
    pge::pge_bwd_kernel<false><<<grid, pge::NT, 0, (cudaStream_t)stream>>>(
        A, G);
  return (int)cudaGetLastError();
}

// Blocks of the forward (bwd = 0) or backward (bwd = 1) kernel that fit on
// one SM at once, into *out; returns the CUDA error code.
extern "C" int pge_blocks_per_sm(int bwd, int bf16, int* out) {
  const void* k =
      bwd ? (bf16 ? (const void*)pge::pge_bwd_kernel<true>
                  : (const void*)pge::pge_bwd_kernel<false>)
          : (bf16 ? (const void*)pge::pge_fwd_kernel<true>
                  : (const void*)pge::pge_fwd_kernel<false>);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, pge::NT,
                                                           0);
}
