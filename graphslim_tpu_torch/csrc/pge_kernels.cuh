// Fused PGE pair-MLP forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernels graphslim_tpu/kernels/pallas_pge.py::_fwd_kernel
// (forward) and ::_bwd_kernel (backward).  What they compute,
// for each (TI x TJ) = (16 x 128) tile of the [n, n] score matrix:
//
//   h0[p] = a[i] + b[j]                       pair p = (i, j) of the tile
//   for l in 0..L2:  (l > 0: h = x @ wmid[l-1] + bmid[l-1])
//                    BatchNorm over the tile's valid pairs (eps 1e-5), ReLU
//   out[i, j] = x_final[p] . wlast            (no final bias)
//
// The BatchNorm statistics range over the tile's 2048 pairs: the tile
// shape is part of the math.  Edge tiles mask the pairs with i >= n or
// j >= n out of the statistics (count = valid pairs).
//
// Design.  A tile's activations (2048 pairs x H channels, 2 MB at H = 256)
// do not fit in shared memory, and BatchNorm needs a whole layer's
// statistics before the layer can be applied.  So every tile has a
// workspace in device memory: the pre-BN activations of each hidden
// matmul layer and the BatchNorm statistics.  A layer is one matmul pass
// that writes its pre-BN output to the workspace, then a statistics pass;
// the next layer's matmul applies BN + ReLU while it loads its input.
// Layer-0 statistics factor exactly over the tile's valid rows and
// columns (mean = mean_i a + mean_j b, var = var_i a + var_j b), so h0 is
// never stored.  The backward reads the forward's workspace instead of
// recomputing it (the TPU kernel recomputed; 1.9 GB at the slice's
// shapes is cheap on an 80 GB card) and keeps two gradient buffers per
// block.
//
// Blocks are persistent (a grid-stride loop over tiles) and run in no
// order, so nothing is accumulated across blocks: the backward writes
// per-block partials of the parameter gradients and per-tile partials of
// da/db, which the wrapper sums afterwards (deterministic, no atomics).
//
// Matmuls: with mm_bf16 set (the main path), every operand is rounded to
// bf16 (round to nearest even) as it is staged in shared memory and the
// product runs on the tensor cores (mma.sync m16n8k16, fp32 accumulators)
// -- the TPU kernel's MM_DTYPE numerics.  Without it they run on the CUDA
// cores in full fp32 (128 x 64 output tile, 8 x 4 outputs per thread).
//
// Bound on the H100 at the slice's shapes (n = 1354, H = 256, L2 = 1):
// the forward's hidden matmul is 2 * 1354^2 * 256 * 256 = 240 GFLOP of
// valid pairs, 0.24 ms at the 989 TFLOP/s bf16 tensor-core peak; the
// backward twice that (dW and dX).  The forward's function is the 7.3 MB
// of scores, so it is bound by operations; the backward reads the 1.9 GB
// workspace as an input, 0.56 ms at 3.35 TB/s, so it is bound by bytes
// (recomputing instead would cost 0.73 ms of operations).  The per-pair
// passes (statistics, BatchNorm backward) stream each tile's 2 MB of
// activations through device memory several times more; PERF.md holds
// the measured times.
//
// tools/pge_kernel_phases.py builds a diagnostic copy of this file by
// exact text replacement: it guards the statements listed in its GUARDS,
// A_LOAD and B_LOAD with a runtime skip mask.  A change to any of those
// lines updates that tool in the same change (it stops with "not found"
// otherwise).

#pragma once

namespace pge {

constexpr int TI = 16;            // score-tile rows
constexpr int TJ = 128;           // score-tile cols
constexpr int P = TI * TJ;        // pairs per tile (BatchNorm population)
constexpr int NT = 256;           // threads per block
constexpr int BM = 128;           // fp32 matmul output tile rows
constexpr int BN = 64;            // fp32 matmul output tile cols
constexpr int BK = 16;            // fp32 matmul depth step
constexpr int BMP = BM + 4;       // padded shared-memory row lengths
constexpr int BNP = BN + 4;
constexpr int MBM = 128;          // bf16 (tensor-core) output tile rows
constexpr int MBN = 128;          // bf16 output tile cols
constexpr int WARPS_M = MBM / 32; // warp grid over the output tile
constexpr int WARPS_N = NT / 32 / WARPS_M;
constexpr int MK = 32;            // bf16 depth step
constexpr int MKP = MK + 8;       // padded bf16 row length
constexpr int SMEM_BYTES =        // shared by the two matmul versions
    (BK * BMP + BK * BNP) * 4 > (MBM + MBN) * MKP * 2
        ? (BK * BMP + BK * BNP) * 4
        : (MBM + MBN) * MKP * 2;
constexpr float EPS = 1e-5f;

struct Params {
  const float* a;       // [n, H]
  const float* b;       // [n, H]
  const float* wmid;    // [L2, H, H]
  const float* bmid;    // [L2, H]
  const float* gamma;   // [L2 + 1, H]
  const float* beta;    // [L2 + 1, H]
  const float* wlast;   // [H]
  int n, H, L2, nj, ntiles;
  float* ws;            // per tile: L2 x P x H pre-BN activations
  float* stat;          // per tile: stat_rows(L2) x H
};

struct Tile {
  int i, j, nvr, nvc;
  float count;
};

__device__ __forceinline__ Tile make_tile(int t, int n, int nj) {
  Tile T;
  T.i = t / nj;
  T.j = t % nj;
  T.nvr = min(TI, n - T.i * TI);
  T.nvc = min(TJ, n - T.j * TJ);
  T.count = (float)(T.nvr * T.nvc);
  return T;
}

__device__ __forceinline__ bool valid(const Tile& T, int p) {
  return (p / TJ) < T.nvr && (p % TJ) < T.nvc;
}

__device__ __forceinline__ float round_bf16(float x) {
  unsigned u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// Rows of H floats in a block's statistics scratch (kernels/pge.py sizes
// it the same way).
__host__ __device__ constexpr int stat_rows(int L2) {
  return 4 * (L2 + 1) + 2;
}

// Per-block statistics scratch: mean, invstd, scale, shift per layer, then
// the current tile's dgamma and dbeta.
struct Stat {
  float* base;
  int H, L;   // L = L2 + 1 BatchNorm layers
  __device__ float* mean(int l) const { return base + l * H; }
  __device__ float* invstd(int l) const { return base + (L + l) * H; }
  __device__ float* scale(int l) const { return base + (2 * L + l) * H; }
  __device__ float* shift(int l) const { return base + (3 * L + l) * H; }
  __device__ float* tdg() const { return base + 4 * L * H; }
  __device__ float* tdb() const { return base + (4 * L + 1) * H; }
};

struct Ctx {
  Params A;
  Tile T;
  Stat S;
  float* Z;    // this tile's pre-BN workspace: Z[l-1] = layer l, l >= 1
  __device__ explicit Ctx(const Params& prm) : A(prm) {
    S.H = A.H;
    S.L = A.L2 + 1;
  }
  // Point at tile t: its coordinates, workspace and statistics.
  __device__ void at(int t) {
    T = make_tile(t, A.n, A.nj);
    Z = A.ws + (size_t)t * A.L2 * P * A.H;
    S.base = A.stat + (size_t)t * stat_rows(A.L2) * A.H;
  }
  __device__ float* zbuf(int l) const {
    return Z + (size_t)(l - 1) * P * A.H;
  }
  // Pre-BN value of layer l at pair p, channel c.
  __device__ float zval(int l, int p, int c) const {
    if (l == 0) {
      int gi = T.i * TI + p / TJ, gj = T.j * TJ + p % TJ;
      float av = gi < A.n ? A.a[(size_t)gi * A.H + c] : 0.f;
      float bv = gj < A.n ? A.b[(size_t)gj * A.H + c] : 0.f;
      return av + bv;
    }
    return zbuf(l)[(size_t)p * A.H + c];
  }
  // Post-BN-ReLU value of layer l (the input of layer l + 1).
  __device__ float xval(int l, int p, int c) const {
    return fmaxf(zval(l, p, c) * S.scale(l)[c] + S.shift(l)[c], 0.f);
  }
};

// ---------------------------------------------------------------------------
// Block-wide matmul C[M, N] = sum_k A(m, k) B(k, n) over shared-memory
// tiles.  Loaders return one element; A_MCONTIG / B_KCONTIG pick the
// thread-to-element map whose global reads are coalesced for the source's
// contiguous axis.  epi(m, n, v0, v1) receives 2 consecutive columns of a
// row.  N must be a multiple of BN (64) and K of MK (32); rows m >= M are
// skipped.  With bf16 set the product runs on the tensor cores
// (gemm_mma), else on the CUDA cores in fp32 (gemm_simt).
// ---------------------------------------------------------------------------
template <bool A_MCONTIG, bool B_KCONTIG, class FA, class FB, class FE>
__device__ void gemm_simt(int M, int N, int K, FA ldA, FB ldB, FE epi,
                          float* As, float* Bs) {
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += BK) {
        if (A_MCONTIG) {
          const int m = tid & (BM - 1);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int k = (tid >> 7) + 2 * q;
            As[k * BMP + m] = (m0 + m < M) ? ldA(m0 + m, k0 + k) : 0.f;
          }
        } else {
          const int k = tid & (BK - 1);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int m = (tid >> 4) + 16 * q;
            As[k * BMP + m] = (m0 + m < M) ? ldA(m0 + m, k0 + k) : 0.f;
          }
        }
        if (B_KCONTIG) {
          const int k = tid & (BK - 1);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int n = (tid >> 4) + 16 * q;
            Bs[k * BNP + n] = ldB(k0 + k, n0 + n);
          }
        } else {
          const int n = tid & (BN - 1);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int k = (tid >> 6) + 4 * q;
            Bs[k * BNP + n] = ldB(k0 + k, n0 + n);
          }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          const float4 a0 = *reinterpret_cast<const float4*>(
              &As[kk * BMP + tr * 8]);
          const float4 a1 = *reinterpret_cast<const float4*>(
              &As[kk * BMP + tr * 8 + 4]);
          const float4 bv = *reinterpret_cast<const float4*>(
              &Bs[kk * BNP + tc * 4]);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
          const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j],
                                                         acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + tr * 8 + i;
        if (m < M) {
          epi(m, n0 + tc * 4, acc[i][0], acc[i][1]);
          epi(m, n0 + tc * 4 + 2, acc[i][2], acc[i][3]);
        }
      }
    }
  }
}

// D[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element q of this thread's share of a ROWS x MK operand tile: row r (m
// of A, n of B) and depth k.  RCONTIG: the source is contiguous along r
// (a warp reads 32 consecutive rows), else along k (MK consecutive k).
template <bool RCONTIG, int ROWS>
__device__ __forceinline__ void tile_elem(int q, int& r, int& k) {
  const int tid = threadIdx.x;
  if (RCONTIG) {
    r = tid % ROWS;
    k = tid / ROWS + (NT / ROWS) * q;
  } else {
    k = tid % MK;
    r = tid / MK + (NT / MK) * q;
  }
}

// Tensor-core version: operands rounded to bf16 (round to nearest even)
// into shared memory, k-contiguous rows (As[m][k], Bs[n][k]) padded to
// MKP so the fragment reads hit distinct banks; mma.sync m16n8k16.  Eight
// warps as WARPS_M x WARPS_N, each computing 32 x (MBN / WARPS_N) of the
// MBM x MBN output tile.  The (output tile, depth step) sequence is one
// loop, and the next step's operands are read into registers while this
// step's products run.
template <bool A_MCONTIG, bool B_KCONTIG, class FA, class FB, class FE>
__device__ void gemm_mma(int M, int N, int K, FA ldA, FB ldB, FE epi,
                         unsigned short* As, unsigned short* Bs) {
  constexpr int EA = MBM * MK / NT, EB = MBN * MK / NT;  // staged/thread
  constexpr int NJ = MBN / WARPS_N / 8;   // n8 tiles of a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp / WARPS_N) * 32;
  const int wn = (warp % WARPS_N) * (MBN / WARPS_N);
  const int nk = K / MK, nn = (N + MBN - 1) / MBN;
  const int steps = (M + MBM - 1) / MBM * nn * nk;
  float ra[EA], rb[EB];
  auto fetch = [&](int s) {
    const int t = s / nk, k0 = (s % nk) * MK;
    const int m0 = (t / nn) * MBM, n0 = (t % nn) * MBN;
#pragma unroll
    for (int q = 0; q < EA; ++q) {
      int r, k;
      tile_elem<A_MCONTIG, MBM>(q, r, k);
      ra[q] = (m0 + r < M) ? ldA(m0 + r, k0 + k) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < EB; ++q) {
      int r, k;
      tile_elem<!B_KCONTIG, MBN>(q, r, k);
      rb[q] = (n0 + r < N) ? ldB(k0 + k, n0 + r) : 0.f;
    }
  };
  auto bf = [](float v) {
    return (unsigned short)(__float_as_uint(round_bf16(v)) >> 16);
  };
  float acc[2][NJ][4];
  fetch(0);
  for (int s = 0; s < steps; ++s) {
    if (s % nk == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    }
#pragma unroll
    for (int q = 0; q < EA; ++q) {
      int r, k;
      tile_elem<A_MCONTIG, MBM>(q, r, k);
      As[r * MKP + k] = bf(ra[q]);
    }
#pragma unroll
    for (int q = 0; q < EB; ++q) {
      int r, k;
      tile_elem<!B_KCONTIG, MBN>(q, r, k);
      Bs[r * MKP + k] = bf(rb[q]);
    }
    __syncthreads();
    if (s + 1 < steps) fetch(s + 1);
#pragma unroll
    for (int kk = 0; kk < MK; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned short* ap =
            &As[(wm + i * 16 + gid) * MKP + kk + tig * 2];
        af[i][0] = *reinterpret_cast<const unsigned*>(ap);
        af[i][1] = *reinterpret_cast<const unsigned*>(ap + 8 * MKP);
        af[i][2] = *reinterpret_cast<const unsigned*>(ap + 8);
        af[i][3] = *reinterpret_cast<const unsigned*>(ap + 8 * MKP + 8);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const unsigned short* bp =
            &Bs[(wn + j * 8 + gid) * MKP + kk + tig * 2];
        const unsigned b0 = *reinterpret_cast<const unsigned*>(bp);
        const unsigned b1 = *reinterpret_cast<const unsigned*>(bp + 8);
        mma_bf16(acc[0][j], af[0], b0, b1);
        mma_bf16(acc[1][j], af[1], b0, b1);
      }
    }
    __syncthreads();
    if (s % nk == nk - 1) {
      const int t = s / nk;
      const int m0 = (t / nn) * MBM, n0 = (t % nn) * MBN;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = m0 + wm + i * 16 + gid;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = n0 + wn + j * 8 + tig * 2;
          if (n >= N) continue;
          if (m < M) epi(m, n, acc[i][j][0], acc[i][j][1]);
          if (m + 8 < M) epi(m + 8, n, acc[i][j][2], acc[i][j][3]);
        }
      }
    }
  }
}

template <bool BF16, bool A_MCONTIG, bool B_KCONTIG, class FA, class FB,
          class FE>
__device__ void block_gemm(int M, int N, int K, FA ldA, FB ldB, FE epi,
                           unsigned char* smem) {
  if constexpr (BF16) {
    unsigned short* As = reinterpret_cast<unsigned short*>(smem);
    gemm_mma<A_MCONTIG, B_KCONTIG>(M, N, K, ldA, ldB, epi, As,
                                   As + MBM * MKP);
  } else {
    float* As = reinterpret_cast<float*>(smem);
    gemm_simt<A_MCONTIG, B_KCONTIG>(M, N, K, ldA, ldB, epi, As,
                                    As + BK * BMP);
  }
}

// ---------------------------------------------------------------------------
// Passes over one tile (thread per channel unless noted).  Every thread
// reaches every __syncthreads(); callers sync between passes.
// ---------------------------------------------------------------------------

// Layer-0 statistics from the factorization over valid rows and columns.
__device__ void stats0(const Ctx& C) {
  const Params& A = C.A;
  const Tile& T = C.T;
  for (int c = threadIdx.x; c < A.H; c += NT) {
    double sa = 0, saa = 0, sb = 0, sbb = 0;
    for (int r = 0; r < T.nvr; ++r) {
      double v = A.a[(size_t)(T.i * TI + r) * A.H + c];
      sa += v;
      saa += v * v;
    }
    for (int q = 0; q < T.nvc; ++q) {
      double v = A.b[(size_t)(T.j * TJ + q) * A.H + c];
      sb += v;
      sbb += v * v;
    }
    double mean = sa / T.nvr + sb / T.nvc;
    double e2 = ((double)T.nvc * saa + (double)T.nvr * sbb + 2.0 * sa * sb)
                / ((double)T.nvr * T.nvc);
    float invstd = rsqrtf((float)(e2 - mean * mean) + EPS);
    float scale = invstd * A.gamma[c];
    C.S.mean(0)[c] = (float)mean;
    C.S.invstd(0)[c] = invstd;
    C.S.scale(0)[c] = scale;
    C.S.shift(0)[c] = A.beta[c] - (float)mean * scale;
  }
}

// Statistics of layer l >= 1 from its pre-BN workspace.
__device__ void stats(const Ctx& C, int l) {
  const Params& A = C.A;
  const float* z = C.zbuf(l);
  for (int c = threadIdx.x; c < A.H; c += NT) {
    double s = 0, ss = 0;
    for (int r = 0; r < C.T.nvr; ++r) {
      for (int q = 0; q < C.T.nvc; ++q) {
        double v = z[(size_t)(r * TJ + q) * A.H + c];
        s += v;
        ss += v * v;
      }
    }
    double mean = s / C.T.count;
    float invstd = rsqrtf((float)(ss / C.T.count - mean * mean) + EPS);
    float scale = invstd * A.gamma[l * A.H + c];
    C.S.mean(l)[c] = (float)mean;
    C.S.invstd(l)[c] = invstd;
    C.S.scale(l)[c] = scale;
    C.S.shift(l)[c] = A.beta[l * A.H + c] - (float)mean * scale;
  }
}

// Hidden layer l >= 1: Z_l = X_{l-1} @ wmid[l-1] + bmid[l-1].
template <bool BF16>
__device__ void layer_fwd(const Ctx& C, int l, unsigned char* smem) {
  const int H = C.A.H;
  const float* W = C.A.wmid + (size_t)(l - 1) * H * H;
  const float* bias = C.A.bmid + (size_t)(l - 1) * H;
  float* z = C.zbuf(l);
  block_gemm<BF16, false, false>(
      P, H, H,
      [&](int p, int k) { return C.xval(l - 1, p, k); },
      [&](int k, int n) { return W[(size_t)k * H + n]; },
      [&](int p, int n, float v0, float v1) {
        *reinterpret_cast<float2*>(&z[(size_t)p * H + n]) =
            make_float2(v0 + bias[n], v1 + bias[n + 1]);
      },
      smem);
}

// Forward of one tile up to the top layer's statistics, into the tile's
// workspace, which the backward reads.
template <bool BF16>
__device__ void tile_forward(const Ctx& C, unsigned char* smem) {
  stats0(C);
  __syncthreads();
  for (int l = 1; l <= C.A.L2; ++l) {
    layer_fwd<BF16>(C, l, smem);
    __syncthreads();
    stats(C, l);
    __syncthreads();
  }
}

template <bool BF16>
__global__ void __launch_bounds__(NT, 2)
pge_fwd_kernel(Params A, float* out) {
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  Ctx C(A);
  for (int t = blockIdx.x; t < A.ntiles; t += gridDim.x) {
    C.at(t);
    tile_forward<BF16>(C, smem);
    // out[i, j] = relu(BN(z_top)) . wlast: a warp per pair, its lanes
    // over the channels (coalesced reads), then a shuffle reduction
    const int lane = threadIdx.x & 31;
    for (int p = threadIdx.x >> 5; p < P; p += NT / 32) {
      if (!valid(C.T, p)) continue;   // the same for the whole warp
      float s = 0.f;
#pragma unroll 8
      for (int c = lane; c < A.H; c += 32)
        s += C.xval(A.L2, p, c) * A.wlast[c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0)
        out[(size_t)(C.T.i * TI + p / TJ) * A.n + C.T.j * TJ + p % TJ] = s;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

struct Grads {
  const float* g;     // [n, n] upstream gradient of the scores
  float* dwmid;       // per block [L2, H, H]
  float* dbmid;       // per block [L2, H]
  float* dgamma;      // per block [L2 + 1, H]
  float* dbeta;       // per block [L2 + 1, H]
  float* dwlast;      // per block [H]
  float* da_part;     // [nj, ni * TI, H]
  float* db_part;     // [ni, nj * TJ, H]
  float* dbuf;        // per block: 2 x P x H gradient buffers
  int ni;
};

// The per-pair passes below walk a channel's P pairs in groups of U: the
// group's loads are issued before its stores, so U loads are in flight
// (the stores to D could alias the loads, which stops the compiler from
// hoisting them itself).  U divides TJ: a group lies in one tile row.
constexpr int U = 16;

// Upstream gradient through layer l's ReLU: dy = relu'(pre) * up, where
// up = g * wlast for the top layer and D (the gradient of x_l) otherwise.
// Writes dy to D (0 at invalid pairs) and reduces this tile's dgamma and
// dbeta of layer l.
__device__ void relu_back(const Ctx& C, const Grads& G, int l, bool top,
                          float* D, float* pdgamma, float* pdbeta,
                          float* pdwlast) {
  const Params& A = C.A;
  const int H = A.H;
  for (int c = threadIdx.x; c < H; c += NT) {
    const float mu = C.S.mean(l)[c], is = C.S.invstd(l)[c];
    const float gm = A.gamma[l * H + c], bt = A.beta[l * H + c];
    const float wl = A.wlast[c];
    float dgam = 0.f, dbet = 0.f, dwl = 0.f;
    for (int p0 = 0; p0 < P; p0 += U) {
      float z[U], up[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u;
        const bool ok = valid(C.T, p);
        z[u] = ok ? C.zval(l, p, c) : 0.f;
        if (top) {
          const int gi = C.T.i * TI + p / TJ, gj = C.T.j * TJ + p % TJ;
          up[u] = ok ? G.g[(size_t)gi * A.n + gj] : 0.f;
        } else {
          up[u] = ok ? D[(size_t)p * H + c] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u;
        float dy = 0.f;
        if (valid(C.T, p)) {
          const float xh = (z[u] - mu) * is;
          const float pre = xh * gm + bt;
          if (top) dwl += fmaxf(pre, 0.f) * up[u];
          dy = pre > 0.f ? (top ? up[u] * wl : up[u]) : 0.f;
          dgam += dy * xh;
          dbet += dy;
        }
        D[(size_t)p * H + c] = dy;
      }
    }
    C.S.tdg()[c] = dgam;
    C.S.tdb()[c] = dbet;
    pdgamma[l * H + c] += dgam;
    pdbeta[l * H + c] += dbet;
    if (top) pdwlast[c] += dwl;
  }
}

// Batch-statistics BatchNorm backward of layer l, in place on D:
// dz = (gamma dy - gamma dbeta / count - xhat gamma dgamma / count) invstd.
__device__ void bn_back(const Ctx& C, int l, float* D, float* pdbmid) {
  const Params& A = C.A;
  const int H = A.H;
  for (int c = threadIdx.x; c < H; c += NT) {
    const float mu = C.S.mean(l)[c], is = C.S.invstd(l)[c];
    const float gm = A.gamma[l * H + c];
    const float m1 = gm * C.S.tdb()[c] / C.T.count;
    const float m2 = gm * C.S.tdg()[c] / C.T.count;
    float dbm = 0.f;
    for (int p0 = 0; p0 < P; p0 += U) {
      // an invalid first pair: the rest of the group (same row, later
      // columns) is invalid too
      if (!valid(C.T, p0)) continue;
      float z[U], dy[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u;
        const bool ok = valid(C.T, p);
        z[u] = ok ? C.zval(l, p, c) : 0.f;
        dy[u] = D[(size_t)p * H + c];  // 0 at invalid pairs (relu_back)
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u;
        if (!valid(C.T, p)) continue;    // stays 0
        const float xh = (z[u] - mu) * is;
        const float dz = (gm * dy[u] - m1 - xh * m2) * is;
        D[(size_t)p * H + c] = dz;
        dbm += dz;
      }
    }
    if (l > 0) pdbmid[(l - 1) * H + c] += dbm;
  }
}

template <bool BF16>
__global__ void __launch_bounds__(NT, 2)
pge_bwd_kernel(Params A, Grads G) {
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  const int H = A.H, L2 = A.L2;
  const size_t PH = (size_t)P * H;
  Ctx C(A);
  float* Dbuf[2] = {G.dbuf + blockIdx.x * 2 * PH,
                    G.dbuf + (blockIdx.x * 2 + 1) * PH};
  float* pdwmid = G.dwmid + (size_t)blockIdx.x * L2 * H * H;
  float* pdbmid = G.dbmid + (size_t)blockIdx.x * L2 * H;
  float* pdgamma = G.dgamma + (size_t)blockIdx.x * (L2 + 1) * H;
  float* pdbeta = G.dbeta + (size_t)blockIdx.x * (L2 + 1) * H;
  float* pdwlast = G.dwlast + (size_t)blockIdx.x * H;

  for (int t = blockIdx.x; t < A.ntiles; t += gridDim.x) {
    C.at(t);   // the forward kernel's workspace and statistics
    float* D = Dbuf[0];
    float* D2 = Dbuf[1];
    relu_back(C, G, L2, true, D, pdgamma, pdbeta, pdwlast);
    __syncthreads();
    for (int l = L2; l >= 1; --l) {
      bn_back(C, l, D, pdbmid);
      __syncthreads();
      const float* W = A.wmid + (size_t)(l - 1) * H * H;
      float* dW = pdwmid + (size_t)(l - 1) * H * H;
      // dW += X_{l-1}^T @ dZ_l   (reduction over the tile's pairs)
      block_gemm<BF16, true, false>(
          H, H, P,
          [&](int m, int p) { return C.xval(l - 1, p, m); },
          [&](int p, int n) { return D[(size_t)p * H + n]; },
          [&](int m, int n, float v0, float v1) {
            float2* o = reinterpret_cast<float2*>(&dW[(size_t)m * H + n]);
            float2 w = *o;
            w.x += v0;
            w.y += v1;
            *o = w;
          },
          smem);
      // dX_{l-1} = dZ_l @ W^T
      block_gemm<BF16, false, true>(
          P, H, H,
          [&](int p, int k) { return D[(size_t)p * H + k]; },
          [&](int k, int n) { return W[(size_t)n * H + k]; },
          [&](int p, int n, float v0, float v1) {
            *reinterpret_cast<float2*>(&D2[(size_t)p * H + n]) =
                make_float2(v0, v1);
          },
          smem);
      __syncthreads();
      relu_back(C, G, l - 1, false, D2, pdgamma, pdbeta, pdwlast);
      __syncthreads();
      float* tmp = D;
      D = D2;
      D2 = tmp;
    }
    bn_back(C, 0, D, pdbmid);
    __syncthreads();
    // da[i] = sum over the tile's columns, db[j] = sum over its rows.
    for (int c = threadIdx.x; c < H; c += NT) {
      for (int r = 0; r < TI; ++r) {
        float s = 0.f;
        for (int q = 0; q < TJ; ++q) s += D[(size_t)(r * TJ + q) * H + c];
        G.da_part[((size_t)C.T.j * G.ni * TI + C.T.i * TI + r) * H + c] = s;
      }
      for (int q = 0; q < TJ; ++q) {
        float s = 0.f;
        for (int r = 0; r < TI; ++r) s += D[(size_t)(r * TJ + q) * H + c];
        G.db_part[((size_t)C.T.i * A.nj * TJ + C.T.j * TJ + q) * H + c] = s;
      }
    }
    __syncthreads();
  }
}

}  // namespace pge
