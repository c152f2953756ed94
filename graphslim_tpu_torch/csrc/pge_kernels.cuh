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
// shapes is cheap on an 80 GB card).  A tile's gradient never goes
// through device memory: BatchNorm and ReLU backward are applied while
// the operands of the two products are staged, and layer 0 keeps only row
// and column sums (see "Backward" below).
//
// Blocks are persistent (a grid-stride loop over tiles) and run in no
// order, so nothing is accumulated across blocks: the backward writes
// per-block partials of the parameter gradients and per-tile partials of
// da/db, which the wrapper sums afterwards (deterministic, no atomics).
//
// Matmuls: with mm_bf16 set (the main path), every operand is rounded to
// bf16 (round to nearest even) as it is staged in shared memory and the
// product runs on the tensor cores with fp32 accumulators (mma.sync
// m16n8k16 in the forward, wgmma m64n64k16 in the backward) -- the TPU
// kernel's MM_DTYPE numerics.  Without it they run on the CUDA
// cores in full fp32 (128 x 64 output tile, 8 x 4 outputs per thread).
// The forward stages element by element (gemm_mma, gemm_simt); the
// backward four elements at a time: into swizzled tiles that wgmma reads,
// with the workspace operand in a cp.async ring (gemm_stage4), or in fp32
// (gemm_simt4).
//
// Bound on the H100 at the slice's shapes (n = 1354, H = 256, L2 = 1):
// the forward's hidden matmul is 2 * 1354^2 * 256 * 256 = 240 GFLOP of
// valid pairs, 0.24 ms at the 989 TFLOP/s bf16 tensor-core peak; the
// backward twice that (dW and dX).  The forward's function is the 7.3 MB
// of scores, so it is bound by operations; the backward reads the 1.9 GB
// workspace as an input, 0.56 ms at 3.35 TB/s, so it is bound by bytes
// (recomputing instead would cost 0.73 ms of operations).  What holds
// the backward above that bound: it reads each tile's 2 MB of z five
// times (the reduction pass, twice for each product, whose 128 x 128
// output tiles restage the operand), and a step of a product is short
// against the latency of device memory, so the loads have to be kept
// several steps ahead without registers.  PERF.md holds the measured
// times of both kernels and of their phases.
//
// tools/pge_kernel_phases.py times diagnostic builds of this file (wrong
// results, only the time counts).  With -DPGE_PHASES a phase is skipped
// when its bit is set in the device variable g_skip (the bits are listed
// below); -DPGE_CONST=bits replaces an operand's staging by a constant at
// compile time.  Without the macros the guards are constant false and
// compile away.

#pragma once

namespace pge {

#ifdef PGE_PHASES
__device__ int g_skip;
#define PGE_SKIP(bits) (g_skip & (bits))
#else
#define PGE_SKIP(bits) 0
#endif
#ifndef PGE_CONST
#define PGE_CONST 0
#endif

// Bits of g_skip (a phase, or a part of every step of gemm_stage4) ...
enum Skip {
  SKIP_FWD_MATMUL = 1, SKIP_FWD_STATS = 2, SKIP_FWD_DOT = 4,
  SKIP_DW = 8, SKIP_DX = 16, SKIP_REDUCE = 32, SKIP_L0_SUMS = 64,
  SKIP_FINISH0 = 128, SKIP_STEP_FETCH = 256, SKIP_STEP_CONVERT = 512,
  SKIP_STEP_MMA = 1024
};
// ... and of PGE_CONST: the forward matmul's A or B operand; the
// backward's dz without its loads or without its arithmetic; the dW
// product's X operand.
enum Const {
  CONST_FWD_A = 1, CONST_FWD_B = 2, CONST_DZ_NOLOAD = 4, CONST_DZ_NOCVT = 8,
  CONST_X = 16
};
constexpr unsigned BF16_ONES = 0x3f803f80u;   // two bf16 1.0

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
// row; done(m0, n0) runs on every thread once an output tile's epilogue
// is through (it may synchronize).  The output tile is 128 rows by MBN
// (bf16) or BN (fp32) columns.  N must be a multiple of BN (64) and K of
// MK (32); rows m >= M are skipped.  With bf16 set the product runs on
// the tensor cores (gemm_mma), else on the CUDA cores in fp32 (gemm_simt).
// ---------------------------------------------------------------------------
// One depth step of the fp32 product from the staged tiles As[k][m],
// Bs[k][n]: thread (tr, tc) owns rows tr * 8 .. + 7, columns tc * 4 .. + 3.
__device__ __forceinline__ void simt_step(float (&acc)[8][4], const float* As,
                                          const float* Bs, int tr, int tc) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(
        &As[kk * BMP + tr * 8]);
    const float4 a1 = *reinterpret_cast<const float4*>(
        &As[kk * BMP + tr * 8 + 4]);
    const float4 bv = *reinterpret_cast<const float4*>(
        &Bs[kk * BNP + tc * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
  }
}

template <bool A_MCONTIG, bool B_KCONTIG, class FA, class FB, class FE,
          class FD>
__device__ void gemm_simt(int M, int N, int K, FA ldA, FB ldB, FE epi,
                          FD done, float* As, float* Bs) {
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
        simt_step(acc, As, Bs, tr, tc);
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
      done(m0, n0);
    }
  }
}

// The fp32 product of the backward, staged four elements at a time (the
// operands are computed while they are staged, which per element costs
// more than the products: see gemm_stage4 below, whose conventions this
// follows).  ldA(row, depth) and ldB(row, depth) return 4 values that are
// consecutive in the source: along the rows (RC: A(m..m+3, k),
// B(n..n+3, k)) or along the depth (A(m, k..k+3), B(n, k..k+3)).  A
// thread's three loads are started before the first is stored.  M a
// multiple of 4, N of BN, K of BK; rows m >= M are staged as zeros.
template <bool RC, class FA, class FB, class FE, class FD>
__device__ void gemm_simt4(int M, int N, int K, FA ldA, FB ldB, FE epi,
                           FD done, float* As, float* Bs) {
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // this thread's float4s of the A tile (two, AQ rows or depths apart) and
  // of the B tile (one)
  const int am = RC ? (tid & 31) * 4 : tid >> 2;
  const int ak = RC ? tid >> 5 : (tid & 3) * 4;
  const int bn = RC ? (tid & 15) * 4 : tid >> 2;
  const int bk = RC ? tid >> 4 : (tid & 3) * 4;
  constexpr int AQ = RC ? NT / 32 : NT / 4;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += BK) {
        float4 va[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int m = am + (RC ? 0 : q * AQ), k = ak + (RC ? q * AQ : 0);
          va[q] = m0 + m < M ? ldA(m0 + m, k0 + k) : zero;
        }
        const float4 vb = ldB(n0 + bn, k0 + bk);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int m = am + (RC ? 0 : q * AQ), k = ak + (RC ? q * AQ : 0);
          if (RC) {
            *reinterpret_cast<float4*>(&As[k * BMP + m]) = va[q];
          } else {
            As[k * BMP + m] = va[q].x;
            As[(k + 1) * BMP + m] = va[q].y;
            As[(k + 2) * BMP + m] = va[q].z;
            As[(k + 3) * BMP + m] = va[q].w;
          }
        }
        if (RC) {
          *reinterpret_cast<float4*>(&Bs[bk * BNP + bn]) = vb;
        } else {
          Bs[bk * BNP + bn] = vb.x;
          Bs[(bk + 1) * BNP + bn] = vb.y;
          Bs[(bk + 2) * BNP + bn] = vb.z;
          Bs[(bk + 3) * BNP + bn] = vb.w;
        }
        __syncthreads();
        simt_step(acc, As, Bs, tr, tc);
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
      done(m0, n0);
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
template <bool A_MCONTIG, bool B_KCONTIG, class FA, class FB, class FE,
          class FD>
__device__ void gemm_mma(int M, int N, int K, FA ldA, FB ldB, FE epi,
                         FD done, unsigned short* As, unsigned short* Bs) {
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
      done(m0, n0);
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core matmul of the backward, staged four elements at a time.
//
// gemm_mma above fetches one element per call; with an operand that is
// computed while it is staged (dz needs a load of z, five per-channel
// constants, the pair's mask and its upstream gradient) the per-element
// index arithmetic and 4-byte accesses cost more than the products.  Here
// a thread fetches 4 elements that are consecutive in the source: one
// 16-byte load, per-pair work once, constants as float4 from shared
// memory, one 8-byte store of 4 bf16.  Both operands keep the source's
// contiguous axis in shared memory, so the stores are as wide as the
// loads, and wgmma reads them from there (transposing where the
// contiguous axis is not the depth).
//
// RC = false: sources contiguous along the depth k: A(m, k..k+3),
// B(n, k..k+3), stored K-major.  RC = true: contiguous along the rows:
// A(m..m+3, k), B(n..n+3, k), stored MN-major.
//
// One operand comes from cache (weights, layer-0 activations):
// ldS(row, depth) loads and finishes it one step ahead and holds 4 packed
// bf16 (2 registers), cvS(raw, row, depth) hands them on.  The other comes
// from the workspace through a ring in shared memory (gemm_stage4).  The
// walk over (output tile, depth step) keeps its coordinates by increment:
// a division per step and thread costs as much as the products.  Rows
// beyond M or N are staged as zeros.  epi and done as for gemm_mma.  The
// block has NT4 = 512 threads, 4 warpgroups as 2 x 2 over the MBM x MBN
// output tile: 32 accumulators a thread, which with the staged operand's
// registers fits 128 registers, and one block an SM leaves L1 its share of
// the SM's memory.
// ---------------------------------------------------------------------------
constexpr int NT4 = 512;      // threads of a block that runs gemm_stage4
constexpr int MK4 = 64;       // depth step
constexpr int TILE4 = MBM * MK4;   // elements of an operand tile (16 KB)
constexpr int PANEL4 = 64 * MK4;   // of its 64 rows wide MN-major panel
constexpr int BUF4_BYTES = 2 * TILE4 * 2;   // an A and a B tile

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ uint2 pack4(float4 v) {
  return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// 16 bytes from device memory to shared memory without passing through
// registers; a thread's copies complete in the order of its commits.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(a), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most PENDING of this thread's committed groups are open.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(PENDING) : "memory");
}

// wgmma (the tensor cores' warpgroup instruction): 128 threads compute
// D[64 x 64] (+)= A[64 x 16] B[16 x 64] with both operands read from
// shared memory through a descriptor, asynchronously.  The operand tiles
// are stored in the 128-byte swizzle: rows of 128 bytes, the 16-byte chunk
// index of a row xor-ed with (row & 7), 8 rows (1024 bytes) an atom; the
// tile's base is 1024-byte aligned.  A row runs along the depth (K-major,
// 64 depth values a row) or, with TA / TB set, along the operand's rows
// (MN-major: a row holds 64 rows of the operand at one depth value, and
// `lbo` is the distance between such 64-wide panels).
__device__ __forceinline__ unsigned long long wg_desc(const void* p,
                                                      unsigned lbo) {
  const unsigned long long a = (unsigned)__cvta_generic_to_shared(p);
  return ((a & 0x3FFFFull) >> 4) | ((unsigned long long)(lbo >> 4) << 16) |
         (64ull << 32) | (1ull << 62);   // 1024 bytes an atom, 128B swizzle
}

// `accumulate` 0: D = A B, else D += A B.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float* d,
                                                unsigned long long da,
                                                unsigned long long db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// Orders this thread's register and shared-memory writes before the
// warpgroup's next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits for the warpgroup's committed wgmmas; the accumulators are not to
// be read (or moved by the compiler) before it.
__device__ __forceinline__ void wgmma_wait(float* d) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Makes shared-memory stores visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int RING_STAGES = 2;   // steps of workspace loads in flight
constexpr int RING_FLOATS = RING_STAGES * (MK4 / 16) * NT4 * 4;

// ASYNC_A says which operand comes from the workspace (A or B); the other
// is `ldS`/`cvS` as described above.  The workspace operand's loads cost no
// registers: copy(row, depth, slot) starts copies of NSRC float4 into the
// thread's own slot of a ring in shared memory, RING_STAGES / NSRC steps
// ahead of their use, and cv(slot, row, depth) reads them back and returns
// the 4 packed bf16.  All blocks walk their tiles in step, so with loads
// only one step ahead the card's memory idled while the products ran and
// the products waited while it worked; holding more steps in registers
// spilled.  A thread reads only what it copied itself, so the ring needs
// no barrier, only the thread's own wait.
//
// `oper` holds nbuf (1 or 2) pairs of operand tiles.  With two, a step's
// products run while the next step is converted into the other pair, and
// a step has one barrier: before it every warpgroup has waited for the
// products of the step before, the last readers of the pair that the
// next step overwrites.  With one, a step waits for its own products and
// ends at a second barrier.
template <bool RC, bool ASYNC_A, int NSRC, class IS, class CV, class LS,
          class CS, class FE, class FD>
__device__ void gemm_stage4(int M, int N, int K, IS copy, CV cv, LS ldS,
                            CS cvS, FE epi, FD done, unsigned short* oper,
                            int nbuf, float* ring) {
  static_assert(MBM == 128 && MBN == 128 && MK4 % 16 == 0,
                "2 x 2 warpgroups of 64 x 64, whole k16 steps");
  constexpr int V = MK4 / 16;              // float4s a thread and operand
  constexpr int F = MK4 / 4;               // float4s of a depth-contiguous row
  constexpr int NS = RING_STAGES / NSRC;   // steps in flight
  constexpr int STAGE = RING_FLOATS / NS;  // floats of a step's copies
  using RawS = decltype(ldS(0, 0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 3) * 64, wn = ((warp >> 2) & 1) * 64;
  const int steps = (M + MBM - 1) / MBM * ((N + MBN - 1) / MBN) * (K / MK4);
  // this thread's q-th float4 of an operand tile: row r, depth k
  const int r_base = RC ? (tid & 31) * 4 : tid / F;
  const int k_base = RC ? tid >> 5 : (tid % F) * 4;
  constexpr int R_STEP = RC ? 0 : NT4 / F, K_STEP = RC ? NT4 / 32 : 0;
  // descriptors of this warpgroup's 64 rows of each operand tile of the
  // first pair; a k16 sub-step is 32 bytes along a K-major row, 16 rows
  // of an MN-major tile
  unsigned short* const Bs0 = oper + TILE4;
  const unsigned long long desc_a =
      RC ? wg_desc(oper + (wm >> 6) * PANEL4, PANEL4 * 2)
         : wg_desc(oper + wm * MK4, 16);
  const unsigned long long desc_b =
      RC ? wg_desc(Bs0 + (wn >> 6) * PANEL4, PANEL4 * 2)
         : wg_desc(Bs0 + wn * MK4, 16);
  constexpr int KADV = (RC ? 16 * 128 : 32) >> 4;
  // this thread's slots of the ring: stage, then q
  float* my_ring = ring + tid * 4 * NSRC;
  constexpr int Q_FLOATS = NT4 * 4 * NSRC;
  const int skip = PGE_SKIP(~0);   // read once
  RawS rs[V];
  // next (output tile, depth step): depth fastest, then columns, then rows
  auto advance = [&](int& m0, int& n0, int& k0) {
    k0 += MK4;
    if (k0 == K) {
      k0 = 0;
      n0 += MBN;
      if (n0 >= N) {
        n0 = 0;
        m0 += MBM;
      }
    }
  };
  int m0 = 0, n0 = 0, k0 = 0;      // this step
  int fm0 = 0, fn0 = 0, fk0 = 0;   // the next step of ldS
  int am0 = 0, an0 = 0, ak0 = 0;   // the next step of the ring
  // starts step t's copies into its stage and commits them (an empty
  // group past the last step keeps the count of groups in step)
  auto fetch_ring = [&](int t) {
    if (t < steps) {
      float* slot = my_ring + (t % NS) * STAGE;
      const int base = ASYNC_A ? am0 : an0, rows = ASYNC_A ? M : N;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int r = r_base + q * R_STEP, k = ak0 + k_base + q * K_STEP;
        if (base + r < rows) copy(base + r, k, slot + q * Q_FLOATS);
      }
    }
    cp_async_commit();
    advance(am0, an0, ak0);
  };
  auto fetch_regs = [&](bool live) {
    if (live) {
      const int base = ASYNC_A ? fn0 : fm0, rows = ASYNC_A ? N : M;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int r = r_base + q * R_STEP, k = fk0 + k_base + q * K_STEP;
        if (base + r < rows) rs[q] = ldS(base + r, k);
      }
    }
    advance(fm0, fn0, fk0);
  };
  float acc[32];   // n8 tile j of the warpgroup's 64 columns at 4 * j
  for (int t = 0; t < NS; ++t) fetch_ring(t);
  fetch_regs(true);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & (nbuf - 1);
    cp_async_wait<NS - 1>();   // step s's copies have landed
    if (!(skip & SKIP_STEP_CONVERT)) {
      unsigned short* As = oper + buf * (BUF4_BYTES / 2);
      const float* slot = my_ring + (s % NS) * STAGE;
      const int zbase = ASYNC_A ? m0 : n0, zrows = ASYNC_A ? M : N;
      const int sbase = ASYNC_A ? n0 : m0, srows = ASYNC_A ? N : M;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int r = r_base + q * R_STEP, kl = k_base + q * K_STEP;
        // 128-byte swizzle: chunk of 8 elements ^ (row & 7)
        const int off =
            RC ? (r >> 6) * PANEL4 + kl * 64 +
                     ((((r & 63) >> 3) ^ (kl & 7)) << 3) + (r & 7)
               : r * MK4 + (((kl >> 3) ^ (r & 7)) << 3) + (kl & 7);
        uint2 vz = make_uint2(0u, 0u), vs = make_uint2(0u, 0u);
        if (zbase + r < zrows) vz = cv(slot + q * Q_FLOATS, zbase + r, k0 + kl);
        if (sbase + r < srows) vs = cvS(rs[q], sbase + r, k0 + kl);
        *reinterpret_cast<uint2*>(As + off) = ASYNC_A ? vz : vs;
        *reinterpret_cast<uint2*>(As + TILE4 + off) = ASYNC_A ? vs : vz;
      }
    }
    wgmma_wait(acc);   // the step before's products (two pairs of tiles)
    fence_async_smem();
    __syncthreads();
    if (!(skip & SKIP_STEP_MMA)) {
      // started before the fetches, which then run beside the products
      const unsigned long long boff = buf * (BUF4_BYTES >> 4);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < MK4 / 16; ++kk)
        wgmma_m64n64k16<RC, RC>(acc, desc_a + boff + kk * KADV,
                                desc_b + boff + kk * KADV, k0 | kk);
      wgmma_commit();
    }
    fetch_ring((skip & SKIP_STEP_FETCH) ? steps : s + NS);
    fetch_regs(s + 1 < steps && !(skip & SKIP_STEP_FETCH));
    if (k0 + MK4 == K) {
      wgmma_wait(acc);
      const int m = m0 + wm + (warp & 3) * 16 + gid;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + wn + j * 8 + tig * 2;
        if (n >= N) continue;
        if (m < M) epi(m, n, acc[4 * j], acc[4 * j + 1]);
        if (m + 8 < M) epi(m + 8, n, acc[4 * j + 2], acc[4 * j + 3]);
      }
      done(m0, n0);
    } else if (nbuf == 1) {
      wgmma_wait(acc);
    }
    if (nbuf == 1) __syncthreads();
    advance(m0, n0, k0);
  }
  cp_async_wait<0>();
}

template <bool BF16, bool A_MCONTIG, bool B_KCONTIG, class FA, class FB,
          class FE, class FD>
__device__ void block_gemm(int M, int N, int K, FA ldA, FB ldB, FE epi,
                           FD done, unsigned char* smem) {
  if constexpr (BF16) {
    unsigned short* As = reinterpret_cast<unsigned short*>(smem);
    gemm_mma<A_MCONTIG, B_KCONTIG>(M, N, K, ldA, ldB, epi, done, As,
                                   As + MBM * MKP);
  } else {
    float* As = reinterpret_cast<float*>(smem);
    gemm_simt<A_MCONTIG, B_KCONTIG>(M, N, K, ldA, ldB, epi, done, As,
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
      [&](int p, int k) {
        if (PGE_CONST & CONST_FWD_A) return (float)((p ^ k) & 7);
        return C.xval(l - 1, p, k);
      },
      [&](int k, int n) {
        if (PGE_CONST & CONST_FWD_B) return (float)((k + n) & 7);
        return W[(size_t)k * H + n];
      },
      [&](int p, int n, float v0, float v1) {
        *reinterpret_cast<float2*>(&z[(size_t)p * H + n]) =
            make_float2(v0 + bias[n], v1 + bias[n + 1]);
      },
      [](int, int) {}, smem);
}

// Forward of one tile up to the top layer's statistics, into the tile's
// workspace, which the backward reads.
template <bool BF16>
__device__ void tile_forward(const Ctx& C, unsigned char* smem) {
  stats0(C);
  __syncthreads();
  for (int l = 1; l <= C.A.L2; ++l) {
    if (!PGE_SKIP(SKIP_FWD_MATMUL)) layer_fwd<BF16>(C, l, smem);
    __syncthreads();
    if (!PGE_SKIP(SKIP_FWD_STATS)) stats(C, l);
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
        if (!PGE_SKIP(SKIP_FWD_DOT)) s += C.xval(A.L2, p, c) * A.wlast[c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0)
        out[(size_t)(C.T.i * TI + p / TJ) * A.n + C.T.j * TJ + p % TJ] = s;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Backward: apply on load, reduce in the epilogue.
//
// A tile's gradient never goes through device memory.  For each hidden
// layer l from the top:
//   reduce_pass   one sweep over z_l gives the tile's dgamma, dbeta (and
//                 dwlast at the top); from them the per-channel constants
//                 of dz_l = dy*sg - c1 - xhat*c2, kept in shared memory;
//   dW product    dW_{l-1} += X_{l-1}^T dz_l: X_{l-1} (BN + ReLU of
//                 z_{l-1}) and dz_l are both computed while the operand is
//                 staged;
//   dX product    dX_{l-1} = dz_l W^T, dz_l computed on load again.  Its
//                 output tile is not stored for layer 0: it lands in
//                 shared memory, where l0_tile_sums applies ReLU' of
//                 a[i] + b[j] and keeps only the sums over the tile's rows
//                 and columns.  The pairs are ordered so that a 128-row
//                 output tile holds all 16 tile rows of 8 tile columns:
//                 the column sums are complete within it and the row sums
//                 add up in a [16, H] buffer in shared memory.
//   finish0       xhat_0 = (a[i] + b[j] - mu) invstd has closed-form row
//                 and column sums, so dgamma_0, dbeta_0, da and db follow
//                 from the row and column sums of dy_0 alone.
// A middle layer (L2 >= 2) writes its raw dX once to a per-block buffer;
// the layer below reads it in its reduce_pass and in its two products.
// Every sum has a fixed order (no atomics): runs repeat bit for bit.
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
  float* dbuf;        // per block: nbuf x P x H raw dX of middle layers
  int ni, nbuf;       // nbuf = min(2, L2 - 1), 0 for L2 <= 1
};

constexpr int TM = 128;           // output-tile rows of both matmuls
constexpr int MAX_SMEM_BLOCK = 232448;   // shared memory of a block, H100
constexpr int NCONST = 7;         // per-channel constant rows (BwdSmem)
constexpr int MAX_H_BWD = 1024;   // reduce_pass: a thread per 4 channels
                                  // (256 threads cover 1024)

// Threads of a backward block and blocks an SM should hold: the tensor-
// core version runs gemm_stage4 (one block of 512), the fp32 version
// gemm_simt4 (two of 256).
template <bool BF16>
struct BwdThreads {
  static constexpr int N = BF16 ? NT4 : NT;
  static constexpr int BLOCKS = BF16 ? 1 : 2;
};

// Output-tile columns of the matmul version, and the row pitch of the
// shared-memory copy of a dX output tile.
template <bool BF16>
struct OutTile {
  static constexpr int TN = BF16 ? MBN : BN;
  static constexpr int EP = TN + 4;
};

// Dynamic shared memory of the backward kernel: matmul operands (also the
// column-sum scratch of l0_tile_sums), the dX output tile (also the
// scratch of reduce_pass), the [TI, H] row sums, the constants, the
// tile's upstream gradient, and for the tensor-core version the ring of
// workspace loads in flight.
__host__ __device__ constexpr int bwd_rest_bytes(int H, bool bf16) {
  return TM * ((bf16 ? MBN : BN) + 4) * 4 + (TI + NCONST) * H * 4 + P * 4
         + (bf16 ? RING_FLOATS * 4 : 0);
}

// Pairs of operand tiles of the tensor-core version: two where a block's
// shared memory holds them (H <= 256), else one.
__host__ __device__ constexpr int bwd_oper_bufs(int H) {
  return 2 * BUF4_BYTES + bwd_rest_bytes(H, true) <= MAX_SMEM_BLOCK ? 2 : 1;
}

// The fp32 version's operand tiles and column-sum scratch fit 16 KB.
__host__ __device__ constexpr int bwd_oper_bytes(int H, bool bf16) {
  return bf16 ? bwd_oper_bufs(H) * BUF4_BYTES : 16 * 1024;
}

__host__ __device__ constexpr int bwd_smem_bytes(int H, bool bf16) {
  return bwd_oper_bytes(H, bf16) + bwd_rest_bytes(H, bf16);
}

struct BwdSmem {
  unsigned char* oper;
  float* E;      // [TM, EP]
  float* R;      // [TI, H]
  float* SC;     // layer l: scale, shift (the forward's ReLU decision)
  float* SH;
  float* WS;     // dy * sg = (pre > 0) * up * WS
  float* K0;     // dz = dy * sg - K0 - z * K1
  float* K1;
  float* PSC;    // layer l - 1: scale, shift
  float* PSH;
  float* GS;     // [P] g of the tile's pairs, 0 outside [n, n]
  float* ring;   // [RING_FLOATS] (tensor-core version)
  template <bool BF16>
  __device__ void carve(unsigned char* base, int H) {
    oper = base;
    E = reinterpret_cast<float*>(base + bwd_oper_bytes(H, BF16));
    R = E + TM * OutTile<BF16>::EP;
    SC = R + TI * H;
    SH = SC + H;
    WS = SH + H;
    K0 = WS + H;
    K1 = K0 + H;
    PSC = K1 + H;
    PSH = PSC + H;
    GS = PSH + H;
    ring = GS + P;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A float4 of the workspace, read once per pass: it bypasses L1, which the
// backward's shared memory leaves about 28 KB of an SM, too little to hold
// a line for every load in flight.
__device__ __forceinline__ float4 ld4_stream(const float* p) {
  float4 v;
  asm volatile("ld.global.L1::no_allocate.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float gval(const Ctx& C, const Grads& G, int p) {
  return G.g[(size_t)(C.T.i * TI + p / TJ) * C.A.n + C.T.j * TJ + p % TJ];
}

// One sweep over layer l >= 1 of the tile: dgamma, dbeta, sum of xhat, and
// for the top layer dwlast, where dy = relu'(pre) * up and up = g * wlast
// (TOP) or the raw dX in Din.  A thread owns 4 channels and every Gp-th
// pair, UR loads in flight; the groups' partial sums meet in `scratch`
// (4 sums x block size x 4 floats: 16 or 32 KB of the E tile) and
// are added in group order.  Leaves the constants of dz_l and the scale
// and shift of layer l - 1 in shared memory and adds the tile's share to
// the block's partial gradients.  Ends synchronized.
template <bool TOP>
__device__ void reduce_pass(const Ctx& C, const Grads& G, int l,
                            const float* Din, const BwdSmem& M,
                            float* pdgamma, float* pdbeta, float* pdwlast,
                            float* pdbmid) {
  constexpr int UR = 4;
  float* scratch = M.E;   // [4 sums, Gp, H], at most 32 KB
  const Params& A = C.A;
  const int H = A.H, Q = H >> 2, Gp = blockDim.x / Q;
  const int cq = threadIdx.x % Q, pg = threadIdx.x / Q, c4 = cq * 4;
  const float* Z = C.zbuf(l);
  if (pg < Gp) {
    const float4 mu = ld4(C.S.mean(l) + c4), is = ld4(C.S.invstd(l) + c4);
    const float4 sc = ld4(C.S.scale(l) + c4), sh = ld4(C.S.shift(l) + c4);
    const float4 wl = TOP ? ld4(A.wlast + c4) : make_float4(1, 1, 1, 1);
    float sb[4] = {0, 0, 0, 0}, sg[4] = {0, 0, 0, 0};
    float sw[4] = {0, 0, 0, 0}, sx[4] = {0, 0, 0, 0};
    const float muv[4] = {mu.x, mu.y, mu.z, mu.w};
    const float isv[4] = {is.x, is.y, is.z, is.w};
    const float scv[4] = {sc.x, sc.y, sc.z, sc.w};
    const float shv[4] = {sh.x, sh.y, sh.z, sh.w};
    const float wlv[4] = {wl.x, wl.y, wl.z, wl.w};
    for (int p0 = pg; p0 < P; p0 += Gp * UR) {
      float4 z[UR], up[UR];
      float gv[UR];
      bool ok[UR];
#pragma unroll
      for (int u = 0; u < UR; ++u) {
        const int p = p0 + u * Gp;
        ok[u] = p < P && valid(C.T, p);
        z[u] = ok[u] ? ld4_stream(Z + (size_t)p * H + c4)
                     : make_float4(0, 0, 0, 0);
        gv[u] = TOP && ok[u] ? M.GS[p] : 0.f;
        up[u] = !TOP && ok[u] ? ld4_stream(Din + (size_t)p * H + c4)
                              : make_float4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < UR; ++u) {
        if (!ok[u]) continue;
        const float zv[4] = {z[u].x, z[u].y, z[u].z, z[u].w};
        const float uv[4] = {up[u].x, up[u].y, up[u].z, up[u].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float xh = (zv[k] - muv[k]) * isv[k];
          const float pre = fmaf(zv[k], scv[k], shv[k]);
          const float upv = TOP ? gv[u] * wlv[k] : uv[k];
          const float dy = pre > 0.f ? upv : 0.f;
          sb[k] += dy;
          sg[k] += dy * xh;
          sx[k] += xh;
          if (TOP) sw[k] += fmaxf(pre, 0.f) * gv[u];
        }
      }
    }
    float* o = scratch + (size_t)pg * H + c4;
    const size_t stride = (size_t)Gp * H;
    *reinterpret_cast<float4*>(o) = make_float4(sb[0], sb[1], sb[2], sb[3]);
    *reinterpret_cast<float4*>(o + stride) =
        make_float4(sg[0], sg[1], sg[2], sg[3]);
    *reinterpret_cast<float4*>(o + 2 * stride) =
        make_float4(sx[0], sx[1], sx[2], sx[3]);
    *reinterpret_cast<float4*>(o + 3 * stride) =
        make_float4(sw[0], sw[1], sw[2], sw[3]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    float dbet = 0.f, dgam = 0.f, sxh = 0.f, dwl = 0.f;
    for (int q = 0; q < Gp; ++q) {
      const float* o = scratch + (size_t)q * H + c;
      const size_t stride = (size_t)Gp * H;
      dbet += o[0];
      dgam += o[stride];
      sxh += o[2 * stride];
      dwl += o[3 * stride];
    }
    const float is = C.S.invstd(l)[c], mu = C.S.mean(l)[c];
    const float sgc = A.gamma[l * H + c] * is;
    const float c1 = sgc * dbet / C.T.count, c2 = sgc * dgam / C.T.count;
    M.SC[c] = C.S.scale(l)[c];
    M.SH[c] = C.S.shift(l)[c];
    M.WS[c] = TOP ? A.wlast[c] * sgc : sgc;
    M.K1[c] = is * c2;
    M.K0[c] = c1 - mu * (is * c2);
    M.PSC[c] = C.S.scale(l - 1)[c];
    M.PSH[c] = C.S.shift(l - 1)[c];
    pdgamma[l * H + c] += dgam;
    pdbeta[l * H + c] += dbet;
    if (TOP) pdwlast[c] += dwl;
    // sum of dz over the pairs (analytically 0), from the same sums
    pdbmid[(l - 1) * H + c] += sgc * dbet - C.T.count * c1 - c2 * sxh;
  }
  __syncthreads();
}

// The top layer is layer 0 (L2 = 0): row and column sums of
// dy_0 = relu'(pre_0) g wlast straight from a, b and g, a thread per
// channel; R in shared memory, the column sums in the tile's db slot.
__device__ void layer0_direct(const Ctx& C, const Grads& G, float* R,
                              float* ccol, float* pdwlast) {
  const Params& A = C.A;
  const Tile& T = C.T;
  const int H = A.H;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const float sc = C.S.scale(0)[c], sh = C.S.shift(0)[c];
    const float wl = A.wlast[c];
    float dwl = 0.f;
    for (int r = 0; r < TI; ++r) {
      float rs = 0.f;
      if (r < T.nvr) {
        const float av = A.a[(size_t)(T.i * TI + r) * H + c];
        for (int q = 0; q < T.nvc; ++q) {
          const float bv = A.b[(size_t)(T.j * TJ + q) * H + c];
          const float pre = fmaf(av + bv, sc, sh);
          const float gv = gval(C, G, r * TJ + q);
          if (pre > 0.f) {
            rs += gv * wl;
            dwl += pre * gv;
          }
        }
      }
      R[r * H + c] = rs;
    }
    for (int q = 0; q < TJ; ++q) {
      float cs = 0.f;
      if (q < T.nvc) {
        const float bv = A.b[(size_t)(T.j * TJ + q) * H + c];
        for (int r = 0; r < T.nvr; ++r) {
          const float av = A.a[(size_t)(T.i * TI + r) * H + c];
          const float pre = fmaf(av + bv, sc, sh);
          if (pre > 0.f) cs += gval(C, G, r * TJ + q) * wl;
        }
      }
      ccol[(size_t)q * H + c] = cs;
    }
    pdwlast[c] += dwl;
  }
}

// After output tile (m0, n0) of the layer-0 dX product: E holds raw dX_0
// of pairs m0 .. m0 + 127 (pair m = tile column m / 16, tile row m % 16)
// for channels n0 .. n0 + TN.  Applies relu'(pre_0) and the pair mask,
// writes the 8 columns' sums over the tile rows to ccol and adds the row
// sums over these 8 columns into R.  A thread owns a channel and 16 / NH
// tile rows; the NH row groups' column sums meet in Cc.
template <bool BF16>
__device__ void l0_tile_sums(const Ctx& C, int m0, int n0,
                             const BwdSmem& M, float* ccol) {
  constexpr int TN = OutTile<BF16>::TN, EP = OutTile<BF16>::EP;
  constexpr int NTH = BwdThreads<BF16>::N;
  constexpr int NH = NTH / TN, RPT = TI / NH, NQ = TM / TI;
  float* Cc = reinterpret_cast<float*>(M.oper);   // [NH, NQ, TN]
  const Tile& T = C.T;
  const int H = C.A.H;
  const int cl = threadIdx.x % TN, hh = threadIdx.x / TN, c = n0 + cl;
  const int q0 = m0 / TI;
  const bool okc = c < H;   // a 128-wide output tile of a narrower layer
  __syncthreads();   // every warp's part of E is written
  const float sc = okc ? M.PSC[c] : 0.f, sh = okc ? M.PSH[c] : 0.f;
  float av[RPT], rs[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = hh * RPT + k;
    av[k] = okc && r < T.nvr ? C.A.a[(size_t)(T.i * TI + r) * H + c] : 0.f;
    rs[k] = 0.f;
  }
#pragma unroll
  for (int ql = 0; ql < NQ; ++ql) {
    const int q = q0 + ql;
    const bool okq = okc && q < T.nvc;
    const float bv = okq ? C.A.b[(size_t)(T.j * TJ + q) * H + c] : 0.f;
    float cs = 0.f;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      const int r = hh * RPT + k;
      const float pre = fmaf(av[k] + bv, sc, sh);
      const float e = M.E[(ql * TI + r) * EP + cl];
      const float dy = (okq && r < T.nvr && pre > 0.f) ? e : 0.f;
      cs += dy;
      rs[k] += dy;
    }
    Cc[(hh * NQ + ql) * TN + cl] = cs;
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k)
    if (okc) M.R[(hh * RPT + k) * H + c] += rs[k];
  __syncthreads();
  for (int o = threadIdx.x; o < NQ * TN; o += NTH) {
    const int ql = o / TN, c2 = o % TN;
    float s = 0.f;
#pragma unroll
    for (int h = 0; h < NH; ++h) s += Cc[(h * NQ + ql) * TN + c2];
    if (n0 + c2 < H) ccol[(size_t)(q0 + ql) * H + n0 + c2] = s;
  }
  __syncthreads();   // Cc is the next step's operand buffer
}

// Layer 0 from the row sums R [TI, H] (shared memory) and column sums
// ccol [TJ, H] (the tile's db slot) of dy_0: dbeta_0, dgamma_0, then
// da[r] = sum_q dz_0 and db[q] = sum_r dz_0 in closed form.  The sums
// over rows and columns run in double; a thread per channel.
__device__ void finish0(const Ctx& C, const Grads& G, const float* R,
                        float* ccol, float* pdgamma, float* pdbeta) {
  const Params& A = C.A;
  const Tile& T = C.T;
  const int H = A.H;
  const float nvr = (float)T.nvr, nvc = (float)T.nvc;
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    const float mu = C.S.mean(0)[c], is = C.S.invstd(0)[c];
    const float* ar = A.a + (size_t)(T.i * TI) * H + c;
    const float* bq = A.b + (size_t)(T.j * TJ) * H + c;
    double dbs = 0, sar = 0, sa = 0, sbc = 0, sb = 0;
    for (int r = 0; r < T.nvr; ++r) {
      const double av = ar[(size_t)r * H], rv = R[r * H + c];
      dbs += rv;
      sar += av * rv;
      sa += av;
    }
#pragma unroll 8
    for (int q = 0; q < T.nvc; ++q) {
      const double bv = bq[(size_t)q * H], cv = ccol[(size_t)q * H + c];
      sbc += bv * cv;
      sb += bv;
    }
    const float dbet = (float)dbs;
    const float dgam = (float)((double)is * (sar + sbc - (double)mu * dbs));
    const float sgc = A.gamma[c] * is;
    const float c1 = sgc * dbet / T.count;
    const float c2i = sgc * dgam / T.count * is;
    pdgamma[c] += dgam;
    pdbeta[c] += dbet;
    const float fsa = (float)sa, fsb = (float)sb;
    float* da = G.da_part +
                ((size_t)T.j * G.ni * TI + T.i * TI) * H + c;
    for (int r = 0; r < TI; ++r) {
      float v = 0.f;
      if (r < T.nvr)
        v = sgc * R[r * H + c] - nvc * c1 -
            c2i * (nvc * ar[(size_t)r * H] + fsb - nvc * mu);
      da[(size_t)r * H] = v;
    }
#pragma unroll 8
    for (int q = 0; q < TJ; ++q) {
      float v = 0.f;
      if (q < T.nvc)
        v = sgc * ccol[(size_t)q * H + c] - nvr * c1 -
            c2i * (nvr * bq[(size_t)q * H] + fsa - nvr * mu);
      ccol[(size_t)q * H + c] = v;
    }
  }
}

// The block's partial parameter gradients.
struct Partials {
  float *dwmid, *dbmid, *dgamma, *dbeta, *dwlast;
};

// Hidden layer l >= 1 of the tile: the reduction pass, then
// dW_{l-1} += X_{l-1}^T dz_l and dX_{l-1} = dz_l W^T with dz_l computed as
// the operands are staged.  TOP: l is the top layer (the upstream gradient
// is g wlast), else it is the raw dX in Din.  The dX product keeps only
// row and column sums for layer 0 (l == 1) and writes raw dX to Dout for
// a middle layer.
template <bool BF16, bool TOP>
__device__ void bwd_layer(const Ctx& C, const Grads& G, const BwdSmem& M,
                          int l, const float* Din, float* Dout, float* ccol,
                          const Partials& pd) {
  constexpr int TN = OutTile<BF16>::TN, EP = OutTile<BF16>::EP;
  const Params& A = C.A;
  const int H = A.H;
  const bool to0 = l == 1;
  if (!PGE_SKIP(SKIP_REDUCE))
    reduce_pass<TOP>(C, G, l, Din, M, pd.dgamma, pd.dbeta, pd.dwlast,
                     pd.dbmid);
  const float* Z = C.zbuf(l);
  const float* W = A.wmid + (size_t)(l - 1) * H * H;
  float* dW = pd.dwmid + (size_t)(l - 1) * H * H;
  auto epi_dw = [&](int m, int n, float v0, float v1) {
    float2* o = reinterpret_cast<float2*>(&dW[(size_t)m * H + n]);
    float2 w = *o;
    w.x += v0;
    w.y += v1;
    *o = w;
  };
  auto epi_dx = [&](int m, int n, float v0, float v1) {
    float* o = to0 ? &M.E[(m % TM) * EP + n % TN] : &Dout[(size_t)m * H + n];
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  };
  auto done_dx = [&](int m0, int n0) {
    if (to0 && !PGE_SKIP(SKIP_L0_SUMS))
      l0_tile_sums<BF16>(C, m0, n0, M, ccol);
  };
  auto noop = [](int, int) {};
  // row m of the dX product is pair m, for layer 0 pair (m % TI, m / TI)
  auto pair_of = [&](int m) { return to0 ? (m % TI) * TJ + m / TI : m; };

  // dz_l of a pair at channels c .. c + 3, from z_l there, the upstream
  // gradient (g of the pair, or the raw dX of a middle layer) and the
  // layer's constants
  auto dz4 = [&](const float4& z, const float4& up, int c) {
    const float4 sc = ld4(M.SC + c), sh = ld4(M.SH + c);
    const float4 ws = ld4(M.WS + c), k0 = ld4(M.K0 + c);
    const float4 k1 = ld4(M.K1 + c);
    float4 v;
    v.x = (fmaf(z.x, sc.x, sh.x) > 0.f ? up.x * ws.x : 0.f) - k0.x -
          z.x * k1.x;
    v.y = (fmaf(z.y, sc.y, sh.y) > 0.f ? up.y * ws.y : 0.f) - k0.y -
          z.y * k1.y;
    v.z = (fmaf(z.z, sc.z, sh.z) > 0.f ? up.z * ws.z : 0.f) - k0.z -
          z.z * k1.z;
    v.w = (fmaf(z.w, sc.w, sh.w) > 0.f ? up.w * ws.w : 0.f) - k0.w -
          z.w * k1.w;
    return v;
  };
  // X_{l-1} of pair p, channels m .. m + 3: a[i] + b[j] (layer 0, from
  // cache) or the workspace, then BatchNorm and ReLU
  auto x4 = [&](int m, int p) {
    float4 z;
    if (to0) {
      const int gi = C.T.i * TI + p / TJ, gj = C.T.j * TJ + p % TJ;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 av = gi < A.n ? ld4(A.a + (size_t)gi * H + m) : zero;
      const float4 bv = gj < A.n ? ld4(A.b + (size_t)gj * H + m) : zero;
      z = make_float4(av.x + bv.x, av.y + bv.y, av.z + bv.z, av.w + bv.w);
    } else {
      z = ld4_stream(C.zbuf(l - 1) + (size_t)p * H + m);
    }
    const float4 sc = ld4(M.PSC + m), sh = ld4(M.PSH + m);
    return make_float4(fmaxf(fmaf(z.x, sc.x, sh.x), 0.f),
                       fmaxf(fmaf(z.y, sc.y, sh.y), 0.f),
                       fmaxf(fmaf(z.z, sc.z, sh.z), 0.f),
                       fmaxf(fmaf(z.w, sc.w, sh.w), 0.f));
  };

  if constexpr (BF16) {
    unsigned short* As = reinterpret_cast<unsigned short*>(M.oper);
    // the workspace operand: the copies of z_l (and of the raw dX of a
    // middle layer) into the thread's ring slot, and dz_l from the slot
    constexpr int NSRC = TOP ? 1 : 2;
    auto dz_copy = [&](int p, int c, float* slot) {
      if ((PGE_CONST & CONST_DZ_NOLOAD) || !valid(C.T, p)) return;
      cp_async16(slot, Z + (size_t)p * H + c);
      if (!TOP) cp_async16(slot + 4, Din + (size_t)p * H + c);
    };
    auto dz_val = [&](const float* slot, int p, int c) {
      if (PGE_CONST & CONST_DZ_NOCVT)
        return make_uint2(BF16_ONES, BF16_ONES);
      if (!valid(C.T, p)) return make_uint2(0u, 0u);
      float4 up;
      if (TOP) {
        const float g = M.GS[p];
        up = make_float4(g, g, g, g);
      } else {
        up = ld4(slot + 4);
      }
      return pack4(dz4(ld4(slot), up, c));
    };
    // X_{l-1} is finished at once and held as 4 bf16 (holding the loads
    // instead cost registers and gained nothing)
    auto x_ld = [&](int m, int p) {
      if (PGE_CONST & CONST_X) return make_uint2(BF16_ONES, BF16_ONES);
      return pack4(x4(m, p));
    };
    auto held = [](const uint2& v, int, int) { return v; };
    // dW += X_{l-1}^T @ dZ_l   (reduction over the tile's pairs)
    const int nbuf = bwd_oper_bufs(H);
    if (!PGE_SKIP(SKIP_DW)) gemm_stage4<true, false, NSRC>(
        H, H, P,
        [&](int n, int p, float* slot) { dz_copy(p, n, slot); },
        [&](const float* slot, int n, int p) { return dz_val(slot, p, n); },
        x_ld, held, epi_dw, noop, As, nbuf, M.ring);
    // dX_{l-1} = dZ_l @ W^T
    if (!PGE_SKIP(SKIP_DX)) gemm_stage4<false, true, NSRC>(
        P, H, H,
        [&](int m, int k, float* slot) { dz_copy(pair_of(m), k, slot); },
        [&](const float* slot, int m, int k) {
          return dz_val(slot, pair_of(m), k);
        },
        [&](int n, int k) { return pack4(ld4(W + (size_t)n * H + k)); },
        held, epi_dx, done_dx, As, nbuf, M.ring);
  } else {
    float* As = reinterpret_cast<float*>(M.oper);
    auto dz_ld = [&](int p, int c) {
      if (!valid(C.T, p)) return make_float4(0.f, 0.f, 0.f, 0.f);
      float4 up;
      if (TOP) {
        const float g = M.GS[p];
        up = make_float4(g, g, g, g);
      } else {
        up = ld4(Din + (size_t)p * H + c);
      }
      return dz4(ld4(Z + (size_t)p * H + c), up, c);
    };
    gemm_simt4<true>(
        H, H, P, x4, [&](int n, int p) { return dz_ld(p, n); }, epi_dw, noop,
        As, As + BK * BMP);
    gemm_simt4<false>(
        P, H, H, [&](int m, int k) { return dz_ld(pair_of(m), k); },
        [&](int n, int k) { return ld4(W + (size_t)n * H + k); }, epi_dx,
        done_dx, As, As + BK * BMP);
  }
  __syncthreads();
}

template <bool BF16>
__global__ void __launch_bounds__(BwdThreads<BF16>::N,
                                  BwdThreads<BF16>::BLOCKS)
pge_bwd_kernel(Params A, Grads G) {
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const int H = A.H, L2 = A.L2;
  const size_t PH = (size_t)P * H;
  Ctx C(A);
  BwdSmem M;
  M.carve<BF16>(bwd_smem, H);
  Partials pd;
  pd.dwmid = G.dwmid + (size_t)blockIdx.x * L2 * H * H;
  pd.dbmid = G.dbmid + (size_t)blockIdx.x * L2 * H;
  pd.dgamma = G.dgamma + (size_t)blockIdx.x * (L2 + 1) * H;
  pd.dbeta = G.dbeta + (size_t)blockIdx.x * (L2 + 1) * H;
  pd.dwlast = G.dwlast + (size_t)blockIdx.x * H;
  // raw dX of a middle layer l sits in the block's buffer (l & 1) % nbuf
  float* blockbuf = G.dbuf + (size_t)blockIdx.x * G.nbuf * PH;

  for (int t = blockIdx.x; t < A.ntiles; t += gridDim.x) {
    C.at(t);   // the forward kernel's workspace and statistics
    // the tile's db slot holds the column sums of dy_0 until finish0
    float* ccol = G.db_part +
                  ((size_t)C.T.i * A.nj * TJ + C.T.j * TJ) * H;
    for (int i = threadIdx.x; i < TI * H; i += blockDim.x) M.R[i] = 0.f;
    for (int p = threadIdx.x; p < P; p += blockDim.x)
      M.GS[p] = valid(C.T, p) ? gval(C, G, p) : 0.f;
    __syncthreads();
    if (L2 == 0) layer0_direct(C, G, M.R, ccol, pd.dwlast);
    for (int l = L2; l >= 1; --l) {
      float* Dout = l == 1 ? nullptr : blockbuf + ((l - 1) & 1) % G.nbuf * PH;
      if (l == L2)
        bwd_layer<BF16, true>(C, G, M, l, nullptr, Dout, ccol, pd);
      else
        bwd_layer<BF16, false>(C, G, M, l, blockbuf + (l & 1) % G.nbuf * PH,
                               Dout, ccol, pd);
    }
    __syncthreads();
    if (!PGE_SKIP(SKIP_FINISH0))
      finish0(C, G, M.R, ccol, pd.dgamma, pd.dbeta);
    __syncthreads();
  }
}

}  // namespace pge
