// MSGC's edge scorer, forward and backward, for sm_90a, with a plain C
// interface loaded from Python with ctypes (graphslim_tpu_torch/kernels/
// edge_scorer.py allocates every buffer; nothing is allocated here).
//
// The scorer takes each skeleton entry e = (r, c) through
//   h0 = [x_r | x_c]                          [E, 2d]
//   z1 = h0 W1 + b1,  a1 = relu(BN1(z1))      [E, H]
//   z2 = a1 W2 + b2,  a2 = relu(BN2(z2))      [E, H]
//   s  = sigmoid(a2 w3 + b3)                  [E]
// with BatchNorm over all E entries (batch statistics, biased variance,
// eps 1e-5).  It replaces no TPU kernel: the JAX package's MSGC scorer is
// plain JAX (graphslim_tpu/reduce/msgc.py).  It was added because the
// tensor-op version builds the gathered rows and about eleven [E, H]
// float32 intermediates (the biases, BatchNorm's centring, scaling and
// shift, the ReLUs) as separate passes, each 1 GB at the MSGC arxiv cell
// (E about 1.025 M, H 256), and keeps them for the backward.
//
// Bound on the H100 at that cell's shapes (2d = H = 256): the forward's two
// products are 2·E·(2d·H + H·H) = 0.269 TFLOP in float32 (TF32 is off by
// the configuration), 4.02 ms at the 67 TFLOP/s CUDA-core peak, so it is
// bound by operations.  The design keeps the products on the CUDA cores
// (SIMT FFMA, a thread owning an 8 x 8 tile) and removes the elementwise
// passes and their memory:
//
// * forward: the gather of [x_r | x_c] is the first product's operand
//   load, its epilogue adds b1, writes z1 and per-tile column sums of z1
//   and z1² (float64); two ordered passes combine the tiles (no atomics:
//   runs are bit-equal) and give BN1's mean and 1/std; BN1 and ReLU are the
//   second product's operand load, whose epilogue adds b2 and writes z2
//   and its sums; the head kernel applies BN2, ReLU, the dot with w3, b3
//   and the sigmoid.  Only z1 and z2 reach device memory, and only z2 is
//   kept for the backward, so the rest of the step (MSGC's nested-gradient
//   match) runs beside one [E, H] tensor.
// * backward: z1 is recomputed by the forward's first product; one pass
//   over z2 takes BN2's backward sums (Σdy, Σdy·x̂, Σx̂,
//   the w3 gradient, Σ of the logit gradient); dz2 is formed in the
//   operand loads of both products that read it (dW2 = a1ᵀ dz2, split over
//   E with ordered partials; da1 = dz2 W2ᵀ); the latter's epilogue applies
//   ReLU's mask, takes BN1's backward sums and writes dy1 over z2, which no
//   later kernel reads (a block owns whole rows, so it reads its z2 rows
//   before it writes them).  dz1 is formed inside per-node segment sums
//   over the entries of each row and each column node ([2n, H]), from
//   which small products give dW1 and the feature gradient: exact by
//   linearity, and no float atomics.  At most two [E, H] buffers live.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libedge_scorer.so edge_scorer.cu

#include <cuda_runtime.h>

#include <stddef.h>

namespace es {

constexpr int NT = 256;      // threads of every block
// The forward products' block tile and k-step depth, and the backward
// products' depth, as measured on an H100 at the MSGC arxiv cell's size: a
// forward under no gradient took 7.90 ms at depth 16 against 8.47 ms at
// depth 8, and at depth 8 64 x 256 tiles took 8.68 ms against 8.42 ms; the
// backward was 0.5 ms slower at depth 16 than at 8.
constexpr int FBM = 128, FBN = 128, FBK = 16, BBK = 8;
constexpr int HEAD_ROWS = 8; // rows of the head kernel's block (a warp each)
constexpr int B1_ROWS = 512; // rows of one block of BN2's backward sums
constexpr int GROUPS = 64;   // first-level groups of the ordered column sums
constexpr double EPS = 1e-5;

// ---------------------------------------------------------------------------
// Operands: logical matrices, zero outside their bounds.  COLC: consecutive
// elements lie along the second index.  run<N>(r, c, v) reads N consecutive
// elements from (r, c) along that index: as float4 / float2 loads where the
// run lies inside the matrix and is aligned, else one element at a time.
// ---------------------------------------------------------------------------

// the width of the vector loads of a run of N
template <int N>
__host__ __device__ constexpr int vec_width() {
  return N % 4 == 0 ? 4 : (N % 2 == 0 ? 2 : 1);
}

// a run of N from index i of a row of n floats may be read as vectors
template <int N>
__device__ __forceinline__ bool vec_ok(int i, int n) {
  return i + N <= n && i % vec_width<N>() == 0 && n % vec_width<N>() == 0;
}

template <int N>
__device__ __forceinline__ void ldv(const float* p, float* v) {
  if constexpr (vec_width<N>() == 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (vec_width<N>() == 2) {
#pragma unroll
    for (int i = 0; i < N; i += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + i);
      v[i] = t.x; v[i + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// a run read one element at a time
template <int N, class L>
__device__ __forceinline__ void run_each(const L& l, int r, int c, float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = L::COLC ? l(r, c + i) : l(r + i, c);
}

struct Dense {  // row-major [rows, cols]
  const float* p;
  int rows, cols;
  static constexpr bool COLC = true;
  __device__ float operator()(int r, int c) const {
    return (r < rows && c < cols) ? p[(size_t)r * cols + c] : 0.f;
  }
  template <int N>
  __device__ void run(int r, int c, float* v) const {
    if (r < rows && vec_ok<N>(c, cols)) ldv<N>(p + (size_t)r * cols + c, v);
    else run_each<N>(*this, r, c, v);
  }
};

struct DenseT {  // [rows, cols], the transpose of a row-major [cols, rows]
  const float* p;
  int rows, cols;
  static constexpr bool COLC = false;
  __device__ float operator()(int r, int c) const {
    return (r < rows && c < cols) ? p[(size_t)c * rows + r] : 0.f;
  }
  template <int N>
  __device__ void run(int r, int c, float* v) const {
    if (c < cols && vec_ok<N>(r, rows)) ldv<N>(p + (size_t)c * rows + r, v);
    else run_each<N>(*this, r, c, v);
  }
};

struct Gather {  // h0 = [x_rows[e] | x_cols[e]]: [E, 2d]
  const float* feat;
  const int* rows;
  const int* cols;
  int E, d;
  static constexpr bool COLC = true;
  __device__ float operator()(int e, int k) const {
    if (e >= E || k >= 2 * d) return 0.f;
    const int node = k < d ? rows[e] : cols[e];
    return feat[(size_t)node * d + (k < d ? k : k - d)];
  }
  template <int N>
  __device__ void run(int e, int k, float* v) const {
    const int kk = k < d ? k : k - d;
    if (e < E && vec_ok<N>(kk, d)) {
      const int node = k < d ? rows[e] : cols[e];
      ldv<N>(feat + (size_t)node * d + kk, v);
    } else {
      run_each<N>(*this, e, k, v);
    }
  }
};

// BatchNorm's elementwise steps, each rounded as the plain version's tensor
// ops round it (no FMA contraction): x̂ = (z − μ)·ist, y = x̂·γ + β.  So a
// ReLU mask taken from the same z is the same on both sides.
__device__ __forceinline__ float bn_xhat(float z, float mu, float ist) {
  return __fmul_rn(__fsub_rn(z, mu), ist);
}
__device__ __forceinline__ float bn_y(float xh, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(xh, gamma), beta);
}

struct Bn {  // one BatchNorm's statistics and affine parameters
  const float *mu, *ist, *gamma, *beta;
  __device__ float xhat(float z, int j) const {
    return bn_xhat(z, mu[j], ist[j]);
  }
  __device__ float y(float xh, int j) const {
    return bn_y(xh, gamma[j], beta[j]);
  }
};

// a run of N columns of a BatchNorm's parameters from column j
template <int N>
struct BnRun {
  float mu[N], ist[N], gamma[N], beta[N];
  __device__ void load(const Bn& bn, int j) {
    ldv<N>(bn.mu + j, mu);
    ldv<N>(bn.ist + j, ist);
    ldv<N>(bn.gamma + j, gamma);
    ldv<N>(bn.beta + j, beta);
  }
  __device__ float xhat(float z, int i) const {
    return bn_xhat(z, mu[i], ist[i]);
  }
  __device__ float y(float xh, int i) const {
    return bn_y(xh, gamma[i], beta[i]);
  }
};

struct BnRelu {  // a = relu(BN(z)): [E, H]
  const float* z;
  Bn bn;
  int E, H;
  static constexpr bool COLC = true;
  __device__ float operator()(int e, int j) const {
    if (e >= E || j >= H) return 0.f;
    return fmaxf(bn.y(bn.xhat(z[(size_t)e * H + j], j), j), 0.f);
  }
  template <int N>
  __device__ void run(int e, int j, float* v) const {
    if (e < E && vec_ok<N>(j, H)) {
      BnRun<N> b;
      b.load(bn, j);
      ldv<N>(z + (size_t)e * H + j, v);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = fmaxf(b.y(b.xhat(v[i], i), i), 0.f);
    } else {
      run_each<N>(*this, e, j, v);
    }
  }
};

// dz = p·dy − c1 − x̂·c2 with p = γ·ist, the BatchNorm backward once its
// sums c1 = p·Σdy/E and c2 = p·Σ(dy·x̂)/E are known; rounded as the plain
// version's ops.
__device__ __forceinline__ float bn_dz(float dy, float xh, float p, float c1,
                                       float c2) {
  return __fsub_rn(__fsub_rn(__fmul_rn(p, dy), c1), __fmul_rn(xh, c2));
}

struct Dz2 {  // dz2 from z2, the logit gradient dl and BN2's sums: [E, H]
  const float* z;
  const float* dl;
  Bn bn;
  const float *w3, *c1, *c2;
  int E, H;
  static constexpr bool COLC = true;
  __device__ float operator()(int e, int j) const {
    if (e >= E || j >= H) return 0.f;
    const float xh = bn.xhat(z[(size_t)e * H + j], j);
    const float dy = bn.y(xh, j) > 0.f ? dl[e] * w3[j] : 0.f;
    return bn_dz(dy, xh, __fmul_rn(bn.gamma[j], bn.ist[j]), c1[j], c2[j]);
  }
  template <int N>
  __device__ void run(int e, int j, float* v) const {
    if (e < E && vec_ok<N>(j, H)) {
      BnRun<N> b;
      b.load(bn, j);
      float w[N], k1[N], k2[N];
      ldv<N>(w3 + j, w);
      ldv<N>(c1 + j, k1);
      ldv<N>(c2 + j, k2);
      ldv<N>(z + (size_t)e * H + j, v);
      const float d = dl[e];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float xh = b.xhat(v[i], i);
        const float dy = b.y(xh, i) > 0.f ? d * w[i] : 0.f;
        v[i] = bn_dz(dy, xh, __fmul_rn(b.gamma[i], b.ist[i]), k1[i], k2[i]);
      }
    } else {
      run_each<N>(*this, e, j, v);
    }
  }
};

struct BlockDiag {  // [2n, 2d]: feat in the (rows, first half) and
                    // (columns, second half) blocks, zero elsewhere
  const float* feat;
  int n, d;
  static constexpr bool COLC = true;
  __device__ float operator()(int i, int k) const {
    if (i >= 2 * n || k >= 2 * d || (i < n) != (k < d)) return 0.f;
    return feat[(size_t)(i < n ? i : i - n) * d + (k < d ? k : k - d)];
  }
  template <int N>
  __device__ void run(int i, int k, float* v) const {
    run_each<N>(*this, i, k, v);
  }
};

struct SegCat {  // [n, 2H] = [S_rows | S_cols] of the [2n, H] segment sums
  const float* S;
  int n, H;
  static constexpr bool COLC = true;
  __device__ float operator()(int i, int k) const {
    if (i >= n || k >= 2 * H) return 0.f;
    return k < H ? S[(size_t)i * H + k] : S[(size_t)(n + i) * H + k - H];
  }
  template <int N>
  __device__ void run(int i, int k, float* v) const {
    run_each<N>(*this, i, k, v);
  }
};

struct W1T {  // [2H, d]: rows k < H read W1[:d]ᵀ, the others W1[d:]ᵀ
  const float* W1;
  int d, H;
  static constexpr bool COLC = false;
  __device__ float operator()(int k, int c) const {
    if (k >= 2 * H || c >= d) return 0.f;
    return k < H ? W1[(size_t)c * H + k] : W1[(size_t)(d + c) * H + k - H];
  }
  template <int N>
  __device__ void run(int k, int c, float* v) const {
    run_each<N>(*this, k, c, v);
  }
};

// ---------------------------------------------------------------------------
// Epilogues of a row product: the value stored at (m, n) from the sum, and
// NQ column statistics of it, summed over the block's rows.
// ---------------------------------------------------------------------------

struct Store {
  float* out;
  static constexpr int NQ = 0;
  __device__ float operator()(int, int, float acc, float*) const {
    return acc;
  }
};

struct StoreBias {  // z = acc + b; statistics z and z²
  float* out;
  const float* bias;
  static constexpr int NQ = 2;
  __device__ float operator()(int, int n, float acc, float* q) const {
    const float v = acc + bias[n];
    q[0] = v;
    q[1] = v * v;
    return v;
  }
};

struct ReluMask {  // dy1 = da1 where BN1's output is positive; statistics
                   // dy1, dy1·x̂1 and x̂1
  float* out;
  const float* z1;
  Bn bn;
  int H;
  static constexpr int NQ = 3;
  __device__ float operator()(int m, int n, float acc, float* q) const {
    const float xh = bn.xhat(z1[(size_t)m * H + n], n);
    const float dy = bn.y(xh, n) > 0.f ? acc : 0.f;
    q[0] = dy;
    q[1] = dy * xh;
    q[2] = xh;
    return dy;
  }
};

// ---------------------------------------------------------------------------
// Staging of one tile of an operand through registers into shared memory
// ---------------------------------------------------------------------------

// Rows [r0, r0 + R) and columns [c0, c0 + C) of a logical matrix, EPT
// elements a thread, consecutive along the matrix's contiguous index.
template <int R, int C, bool COLC>
struct Stage {
  static constexpr int EPT = R * C / NT;
  static_assert(EPT >= 1 && R * C == EPT * NT, "tile does not fit the block");
  float v[EPT];

  __device__ __forceinline__ void at(int& r, int& c) const {
    const int t = threadIdx.x;
    if constexpr (COLC) {
      constexpr int TPR = C / EPT;
      r = t / TPR;
      c = (t % TPR) * EPT;
    } else {
      constexpr int TPC = R / EPT;
      c = t / TPC;
      r = (t % TPC) * EPT;
    }
  }

  template <class L>
  __device__ __forceinline__ void fetch(const L& l, int r0, int c0) {
    int r, c;
    at(r, c);
    l.template run<EPT>(r0 + r, c0 + c, v);
  }

  // element (r, c) of the tile to s[r * ld + c], or s[c * ld + r] (TRANS)
  template <bool TRANS>
  __device__ __forceinline__ void stash(float* s, int ld) const {
    int r, c;
    at(r, c);
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int rr = COLC ? r : r + i, cc = COLC ? c + i : c;
      s[TRANS ? cc * ld + rr : rr * ld + cc] = v[i];
    }
  }
};

// One k-step of a thread's 8 x 8 tile: rows ty*4 + {0..3} and
// BM/2 + ty*4 + {0..3} of As[k][m], columns likewise of Bs[k][n].
template <int BM, int BN, int BK>
__device__ __forceinline__ void mma_step(const float* As, const float* Bs,
                                         int lda, int ty, int tx,
                                         float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[8], b[8];
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * lda + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + kk * lda + BM / 2 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * BN + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + kk * BN + BN / 2 + tx * 4);
    a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
    a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
    b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
    b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int BM, int BN, int BK>
constexpr int gemm_smem_bytes() {
  const int tiles = 4 * (2 * BK * (BM + 4) + 2 * BK * BN);
  const int red = 8 * (BM / 8) * BN;  // doubles: one statistic's rows
  return tiles > red ? tiles : red;
}

// ---------------------------------------------------------------------------
// Row product: C[M, N] = A[M, K] · B[K, N], a block a BM x BN tile, with
// the epilogue's statistics summed over the tile's rows into
// part[blockIdx.x][q][N] (float64).
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK, class LA, class LB, class EP>
__global__ void __launch_bounds__(NT, 2)
    gemm_rows(LA la, LB lb, EP ep, int M, int N, int K, double* part) {
  static_assert((BM / 8) * (BN / 8) == NT, "a thread owns 8 x 8");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDA = BM + 4;
  float* As = reinterpret_cast<float*>(smem);  // [2][BK][LDA]
  float* Bs = As + 2 * BK * LDA;                // [2][BK][BN]
  const int tid = threadIdx.x, tx = tid % (BN / 8), ty = tid / (BN / 8);
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  Stage<BM, BK, LA::COLC> sa;
  Stage<BK, BN, LB::COLC> sb;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int KT = (K + BK - 1) / BK;
  sa.fetch(la, m0, 0);
  sb.fetch(lb, 0, n0);
  sa.template stash<true>(As, LDA);
  sb.template stash<false>(Bs, BN);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) {
      sa.fetch(la, m0, (kt + 1) * BK);
      sb.fetch(lb, (kt + 1) * BK, n0);
    }
    mma_step<BM, BN, BK>(As + cur * BK * LDA, Bs + cur * BK * BN, LDA, ty, tx,
                     acc);
    if (kt + 1 < KT) {
      sa.template stash<true>(As + (cur ^ 1) * BK * LDA, LDA);
      sb.template stash<false>(Bs + (cur ^ 1) * BK * BN, BN);
    }
    __syncthreads();
  }

  constexpr int NQ = EP::NQ > 0 ? EP::NQ : 1;
  float q[NQ][8];
#pragma unroll
  for (int s = 0; s < NQ; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j) q[s][j] = 0.f;
  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int nb = n0 + h * (BN / 2) + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float qq[NQ];
        v[j] = 0.f;
        if (m < M && nb + j < N) {
          v[j] = ep(m, nb + j, acc[i][h * 4 + j], qq);
#pragma unroll
          for (int s = 0; s < EP::NQ; ++s) q[s][h * 4 + j] += qq[s];
        }
      }
      if (m < M) {
        float* o = ep.out + (size_t)m * N + nb;
        if (vec && nb + 3 < N) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (nb + j < N) o[j] = v[j];
        }
      }
    }
  }

  if constexpr (EP::NQ > 0) {
    double* red = reinterpret_cast<double*>(smem);  // [BM / 8][BN]
    __syncthreads();
    for (int s = 0; s < EP::NQ; ++s) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[ty * BN + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4)] =
            q[s][j];
      __syncthreads();
      for (int c = tid; c < BN; c += NT) {
        double t = 0.0;
        for (int y = 0; y < BM / 8; ++y) t += red[y * BN + c];
        if (n0 + c < N) part[((size_t)blockIdx.x * EP::NQ + s) * N + n0 + c] = t;
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// Reduction product: part[chunk] = Xᵀ Y over the rows of one chunk, X
// [E, M], Y [E, N]; a block a BM x BN tile of the [M, N] output and one
// chunk of rows (a multiple of BK).
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK, class LX, class LY>
__global__ void __launch_bounds__(NT, 2)
    gemm_red(LX lx, LY ly, int M, int N, int E, int chunk, float* part) {
  static_assert((BM / 8) * (BN / 8) == NT, "a thread owns 8 x 8");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LDA = BM + 4;
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + 2 * BK * LDA;
  const int tid = threadIdx.x, tx = tid % (BN / 8), ty = tid / (BN / 8);
  const int tiles_n = (N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM, n0 = (blockIdx.x % tiles_n) * BN;
  const int e0 = blockIdx.y * chunk;
  const int e1 = min(E, e0 + chunk);

  Stage<BK, BM, LX::COLC> sa;
  Stage<BK, BN, LY::COLC> sb;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int KT = (e1 - e0 + BK - 1) / BK;
  if (KT > 0) {
    sa.fetch(lx, e0, m0);
    sb.fetch(ly, e0, n0);
    sa.template stash<false>(As, LDA);
    sb.template stash<false>(Bs, BN);
  }
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) {
      sa.fetch(lx, e0 + (kt + 1) * BK, m0);
      sb.fetch(ly, e0 + (kt + 1) * BK, n0);
    }
    mma_step<BM, BN, BK>(As + cur * BK * LDA, Bs + cur * BK * BN, LDA, ty, tx,
                     acc);
    if (kt + 1 < KT) {
      sa.template stash<false>(As + (cur ^ 1) * BK * LDA, LDA);
      sb.template stash<false>(Bs + (cur ^ 1) * BK * BN, BN);
    }
    __syncthreads();
  }

  float* out = part + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// out[i] = Σ_p part[p][i] in float64, in the order of p.
__global__ void sum_parts(const float* part, int P, int size, float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  double t = 0.0;
  for (int p = 0; p < P; ++p) t += part[(size_t)p * size + i];
  out[i] = (float)t;
}

// out[g][c] = Σ of in[t][c] over the g-th of G equal ranges of t, in a fixed
// order: a block is 32 columns x 8 lanes of t.
__global__ void colsum(const double* in, int T, int C, int G, double* out) {
  __shared__ double red[8][32];
  const int cx = threadIdx.x, ly = threadIdx.y;
  const int c = blockIdx.x * 32 + cx, g = blockIdx.y;
  const int t0 = (int)((long long)T * g / G), t1 = (int)((long long)T * (g + 1) / G);
  double s = 0.0;
  if (c < C)
    for (int t = t0 + ly; t < t1; t += 8) s += in[(size_t)t * C + c];
  red[ly][cx] = s;
  __syncthreads();
  if (ly == 0 && c < C) {
    double r = 0.0;
    for (int y = 0; y < 8; ++y) r += red[y][cx];
    out[(size_t)g * C + c] = r;
  }
}

// BatchNorm's mean and 1/std from Σz and Σz² over E rows.
__global__ void bn_stats(const double* sum, int E, int H, float* mu,
                         float* ist) {
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    const double mean = sum[j] / E;
    const double var = fmax(sum[H + j] / E - mean * mean, 0.0);
    mu[j] = (float)mean;
    ist[j] = (float)(1.0 / sqrt(var + EPS));
  }
}

// The backward's BatchNorm constants and gradients from Σdy, Σdy·x̂, Σx̂.
__device__ void bn_backward(double sdb, double sdg, double sxh, float gamma,
                            float ist, int E, float* c1, float* c2,
                            float* dgamma, float* dbeta, float* dbias) {
  const float p = gamma * ist;
  const float k1 = (float)((double)p * sdb / E);
  const float k2 = (float)((double)p * sdg / E);
  *c1 = k1;
  *c2 = k2;
  *dgamma = (float)sdg;
  *dbeta = (float)sdb;
  *dbias = (float)((double)p * sdb - (double)E * k1 - (double)k2 * sxh);
}

// sum: [5][H] = Σ dl·a2, Σdy2, Σdy2·x̂2, Σx̂2, and Σ dl at [4][0].
__global__ void head_grads(const double* sum, const float* gamma,
                           const float* ist, int E, int H, float* c1,
                           float* c2, float* dw3, float* db3, float* dgamma,
                           float* dbeta, float* db2) {
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    dw3[j] = (float)sum[j];
    bn_backward(sum[H + j], sum[2 * H + j], sum[3 * H + j], gamma[j], ist[j],
                E, c1 + j, c2 + j, dgamma + j, dbeta + j, db2 + j);
  }
  if (threadIdx.x == 0) *db3 = (float)sum[4 * H];
}

// sum: [3][H] = Σdy1, Σdy1·x̂1, Σx̂1.
__global__ void bn1_grads(const double* sum, const float* gamma,
                          const float* ist, int E, int H, float* c1,
                          float* c2, float* dgamma, float* dbeta,
                          float* db1) {
  for (int j = threadIdx.x; j < H; j += blockDim.x)
    bn_backward(sum[j], sum[H + j], sum[2 * H + j], gamma[j], ist[j], E,
                c1 + j, c2 + j, dgamma + j, dbeta + j, db1 + j);
}

// The head: s[e] = sigmoid(relu(BN2(z2[e])) · w3 + b3), a warp a row; lane
// 0's sum of the butterfly is the row's.
__global__ void head_fwd(const float* z2, Bn bn, const float* w3,
                         const float* b3, int E, int H, float* s) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * HEAD_ROWS + (threadIdx.x >> 5);
  if (e >= E) return;
  const float* z = z2 + (size_t)e * H;
  float t = 0.f;
  for (int j = lane; j < H; j += 32)
    t += fmaxf(bn.y(bn.xhat(z[j], j), j), 0.f) * w3[j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, off);
  if (lane == 0) s[e] = 1.f / (1.f + expf(-(t + b3[0])));
}

// BN2's backward sums over B1_ROWS rows a block: the logit gradient
// dl = g·s·(1 − s) (also written out), and per column Σ dl·a2 (w3's
// gradient), Σdy2, Σdy2·x̂2 and Σx̂2 with dy2 = dl·w3 where BN2's output is
// positive; Σ dl in part[b][4][0].  part: [blocks][5][H], float64.
__global__ void head_bwd_sums(const float* z2, const float* s, const float* g,
                              Bn bn, const float* w3, int E, int H,
                              float* dl_out, double* part) {
  __shared__ float dl[B1_ROWS];
  const int e0 = blockIdx.x * B1_ROWS;
  const int rows = min(B1_ROWS, E - e0);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const float si = s[e0 + i];
    const float v = g[e0 + i] * si * (1.f - si);
    dl[i] = v;
    dl_out[e0 + i] = v;
  }
  __syncthreads();
  double* out = part + (size_t)blockIdx.x * 5 * H;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    const float w = w3[j];
    double q0 = 0.0, q1 = 0.0, q2 = 0.0, q3 = 0.0;
    const float* z = z2 + (size_t)e0 * H + j;
#pragma unroll 4
    for (int i = 0; i < rows; ++i) {
      const float xh = bn.xhat(z[(size_t)i * H], j);
      const float y = bn.y(xh, j);
      const float d = dl[i];
      const float dy = y > 0.f ? d * w : 0.f;
      q0 += (double)(d * fmaxf(y, 0.f));
      q1 += (double)dy;
      q2 += (double)(dy * xh);
      q3 += (double)xh;
    }
    out[j] = q0;
    out[H + j] = q1;
    out[2 * H + j] = q2;
    out[3 * H + j] = q3;
    out[4 * H + j] = 0.0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int i = 0; i < rows; ++i) t += dl[i];
    out[4 * H] = t;
  }
}

// Segment sums of dz1 = p·dy1 − c1 − x̂1·c2 over each node's entries: block
// b < n sums the entries whose row is b, block n + b those whose column is
// b, in the order of perm (ptr: [2n + 1] offsets into perm), a thread a
// column.  The block stages SEG_IDX entry indices at a time in shared
// memory, so the loads of the rows do not wait on the index's.  (On an H100
// at the MSGC arxiv cell's size, two and four columns a thread made a
// forward and backward 0.7 and 1.3 ms slower.)
constexpr int SEG_IDX = 256;

__global__ void seg_sums(const float* dy1, const float* z1, Bn bn,
                         const float* c1, const float* c2, const int* ptr,
                         const int* perm, int H, float* S) {
  __shared__ int idx[SEG_IDX];
  const int b = blockIdx.x, j = threadIdx.x;
  const int p0 = ptr[b], p1 = ptr[b + 1];
  const bool live = j < H;
  const int jj = live ? j : 0;
  const float mu = bn.mu[jj], ist = bn.ist[jj];
  const float p = __fmul_rn(bn.gamma[jj], ist), k1 = c1[jj], k2 = c2[jj];
  double t = 0.0;
  for (int q0 = p0; q0 < p1; q0 += SEG_IDX) {
    const int nq = min(SEG_IDX, p1 - q0);
    __syncthreads();
    for (int i = threadIdx.x; i < nq; i += blockDim.x) idx[i] = perm[q0 + i];
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int q = 0; q < nq; ++q) {
      const size_t at = (size_t)idx[q] * H + j;
      t += (double)bn_dz(dy1[at], bn_xhat(z1[at], mu, ist), p, k1, k2);
    }
  }
  if (live) S[(size_t)b * H + j] = (float)t;
}

// ---------------------------------------------------------------------------
// Launch helpers
// ---------------------------------------------------------------------------

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int SMEM = cmax(cmax(gemm_smem_bytes<64, 256, BBK>(),
                               gemm_smem_bytes<128, 128, BBK>()),
                          gemm_smem_bytes<FBM, FBN, FBK>());

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

template <int BM, int BN, int BK, class LA, class LB, class EP>
cudaError_t row_product(LA la, LB lb, EP ep, int M, int N, int K, double* part,
                        int smem, cudaStream_t st) {
  if (smem < gemm_smem_bytes<BM, BN, BK>()) return cudaErrorInvalidValue;
  dim3 grid(cdiv(M, BM), cdiv(N, BN));
  gemm_rows<BM, BN, BK><<<grid, NT, smem, st>>>(la, lb, ep, M, N, K, part);
  return cudaGetLastError();
}

// rows of one chunk of a reduction product: about four blocks an SM
inline int red_chunk(int E, int M, int N) {
  const int tiles = cdiv(M, 128) * cdiv(N, 128);
  const int want = tiles >= 528 ? 1 : 528 / tiles;
  const int chunk = cdiv(cdiv(E, want), BBK) * BBK;
  return chunk > 256 ? chunk : 256;
}

template <class LX, class LY>
cudaError_t reduce_product(LX lx, LY ly, int M, int N, int E, float* part,
                           float* out, int smem, cudaStream_t st) {
  if (smem < gemm_smem_bytes<128, 128, BBK>()) return cudaErrorInvalidValue;
  const int chunk = red_chunk(E, M, N);
  const int P = cdiv(E, chunk);
  dim3 grid(cdiv(M, 128) * cdiv(N, 128), P);
  gemm_red<128, 128, BBK><<<grid, NT, smem, st>>>(lx, ly, M, N, E, chunk,
                                                  part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_parts<<<cdiv((long long)M * N, NT), NT, 0, st>>>(part, P, M * N, out);
  return cudaGetLastError();
}

// in [T][C] float64 → out [C], in two ordered passes through mid [G][C].
cudaError_t column_sums(const double* in, int T, int C, double* mid,
                        double* out, cudaStream_t st) {
  const int G = T < GROUPS ? T : GROUPS;
  colsum<<<dim3(cdiv(C, 32), G), dim3(32, 8), 0, st>>>(in, T, C, G, mid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum<<<dim3(cdiv(C, 32), 1), dim3(32, 8), 0, st>>>(mid, G, C, 1, out);
  return cudaGetLastError();
}

inline size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

// Scratch of the forward: per-tile statistics, their mid sums and sums.
struct FwdScratch {
  double *part, *mid, *sum;
  static size_t bytes(int E, int H, void* base, FwdScratch* s) {
    const int T = cdiv(E, FBM);
    size_t off = 0;
    auto take = [&](size_t b) {
      const size_t at = off;
      off += align256(b);
      return base ? (char*)base + at : nullptr;
    };
    double* part = (double*)take(sizeof(double) * (size_t)T * 2 * H);
    double* mid = (double*)take(sizeof(double) * (size_t)GROUPS * 2 * H);
    double* sum = (double*)take(sizeof(double) * 2 * H);
    if (s) *s = FwdScratch{part, mid, sum};
    return off;
  }
};

// Scratch of the backward: the logit gradient, the BatchNorm constants,
// the column sums, the segment sums and one region of partials that the
// stages use in turn.
struct BwdScratch {
  float *dl, *c, *S, *fpart;
  double *part, *mid, *sum;
  static size_t bytes(int E, int n, int d, int H, void* base, BwdScratch* s) {
    const size_t t_head = (size_t)cdiv(E, B1_ROWS) * 5 * H * sizeof(double);
    const size_t t_rows = (size_t)cdiv(E, 64) * 3 * H * sizeof(double);
    const size_t p_w2 = (size_t)cdiv(E, red_chunk(E, H, H)) * H * H * sizeof(float);
    const size_t p_w1 = (size_t)cdiv(2 * n, red_chunk(2 * n, 2 * d, H)) * 2 *
                        d * H * sizeof(float);
    const size_t t_fwd = (size_t)cdiv(E, FBM) * 2 * H * sizeof(double);
    size_t region = t_head;
    if (t_fwd > region) region = t_fwd;
    if (t_rows > region) region = t_rows;
    if (p_w2 > region) region = p_w2;
    if (p_w1 > region) region = p_w1;
    size_t off = 0;
    auto take = [&](size_t b) {
      const size_t at = off;
      off += align256(b);
      return base ? (char*)base + at : nullptr;
    };
    float* dl = (float*)take(sizeof(float) * (size_t)E);
    float* c = (float*)take(sizeof(float) * 4 * H);
    float* S = (float*)take(sizeof(float) * (size_t)2 * n * H);
    double* mid = (double*)take(sizeof(double) * (size_t)GROUPS * 5 * H);
    double* sum = (double*)take(sizeof(double) * 5 * H);
    char* reg = take(region);
    if (s) *s = BwdScratch{dl, c, S, (float*)reg, (double*)reg, mid, sum};
    return off;
  }
};

}  // namespace es

using namespace es;

#define ES_TRY(x)                          \
  do {                                     \
    cudaError_t err_ = (x);                \
    if (err_ != cudaSuccess) return err_;  \
  } while (0)

extern "C" int es_smem_bytes() { return SMEM; }

extern "C" long long es_fwd_scratch_bytes(int E, int H) {
  return (long long)FwdScratch::bytes(E, H, nullptr, nullptr);
}

extern "C" long long es_bwd_scratch_bytes(int E, int n, int d, int H) {
  return (long long)BwdScratch::bytes(E, n, d, H, nullptr, nullptr);
}

// The forward.  st: [4][H] = mean and 1/std of BN1, then of BN2.
extern "C" int es_forward(const float* feat, const int* rows, const int* cols,
                          const float* W1, const float* b1, const float* W2,
                          const float* b2, const float* w3, const float* b3,
                          const float* g1, const float* be1, const float* g2,
                          const float* be2, float* z1, float* z2, float* st,
                          float* scores, void* scratch, int E, int d, int H,
                          int smem, void* stream) {
  if (E < 1 || d < 1 || H < 1 || H > 256) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  FwdScratch w;
  FwdScratch::bytes(E, H, scratch, &w);
  const Bn bn1{st, st + H, g1, be1}, bn2{st + 2 * H, st + 3 * H, g2, be2};

  ES_TRY((row_product<FBM, FBN, FBK>(Gather{feat, rows, cols, E, d},
                                Dense{W1, 2 * d, H}, StoreBias{z1, b1}, E,
                                H, 2 * d, w.part, smem, s)));
  ES_TRY(column_sums(w.part, cdiv(E, FBM), 2 * H, w.mid, w.sum, s));
  bn_stats<<<1, NT, 0, s>>>(w.sum, E, H, st, st + H);
  ES_TRY(cudaGetLastError());

  ES_TRY((row_product<FBM, FBN, FBK>(BnRelu{z1, bn1, E, H}, Dense{W2, H, H},
                                StoreBias{z2, b2}, E, H, H, w.part, smem,
                                s)));
  ES_TRY(column_sums(w.part, cdiv(E, FBM), 2 * H, w.mid, w.sum, s));
  bn_stats<<<1, NT, 0, s>>>(w.sum, E, H, st + 2 * H, st + 3 * H);
  ES_TRY(cudaGetLastError());

  head_fwd<<<cdiv(E, HEAD_ROWS), 32 * HEAD_ROWS, 0, s>>>(z2, bn2, w3, b3, E,
                                                         H, scores);
  return cudaGetLastError();
}

// The backward for the score gradient gs [E], from the forward's z2, its
// statistics st and its scores.  z1 is recomputed first into the buffer z1
// (the forward's product, bit for bit), so the forward keeps one [E, H]
// tensor while the rest of the step runs; z2 is overwritten (dy1).
// seg_ptr [2n + 1] and seg_perm [2E]: the entries of each row node, then of
// each column node, as offsets into the permutation.
extern "C" int es_backward(
    const float* feat, const int* rows, const int* cols, const float* W1,
    const float* b1, const float* W2, const float* w3, const float* g1,
    const float* be1, const float* g2, const float* be2, float* z1,
    float* z2, const float* st, const float* scores, const float* gs,
    const int* seg_ptr, const int* seg_perm, float* dfeat, float* dW1,
    float* db1, float* dW2, float* db2, float* dw3, float* db3, float* dg1,
    float* dbe1, float* dg2, float* dbe2, void* scratch, int E, int n, int d,
    int H, int smem, void* stream) {
  if (E < 1 || n < 1 || d < 1 || H < 1 || H > 256) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  BwdScratch w;
  BwdScratch::bytes(E, n, d, H, scratch, &w);
  const Bn bn1{st, st + H, g1, be1}, bn2{st + 2 * H, st + 3 * H, g2, be2};
  float *c1b = w.c, *c2b = w.c + H, *c1a = w.c + 2 * H, *c2a = w.c + 3 * H;

  // z1 again (its statistics, already in st, land in the scratch unread)
  ES_TRY((row_product<FBM, FBN, FBK>(Gather{feat, rows, cols, E, d},
                                     Dense{W1, 2 * d, H}, StoreBias{z1, b1},
                                     E, H, 2 * d, w.part, smem, s)));

  // BN2 and the head
  const int TB = cdiv(E, B1_ROWS);
  head_bwd_sums<<<TB, NT, 0, s>>>(z2, scores, gs, bn2, w3, E, H, w.dl,
                                  w.part);
  ES_TRY(cudaGetLastError());
  ES_TRY(column_sums(w.part, TB, 5 * H, w.mid, w.sum, s));
  head_grads<<<1, NT, 0, s>>>(w.sum, g2, st + 3 * H, E, H, c1b, c2b, dw3, db3,
                              dg2, dbe2, db2);
  ES_TRY(cudaGetLastError());
  const Dz2 dz2{z2, w.dl, bn2, w3, c1b, c2b, E, H};

  // dW2 = a1ᵀ dz2, then dy1 = relu'·(dz2 W2ᵀ) over z2 with BN1's sums
  ES_TRY(reduce_product(BnRelu{z1, bn1, E, H}, dz2, H, H, E, w.fpart, dW2,
                        smem, s));
  ES_TRY((row_product<64, 256, BBK>(dz2, DenseT{W2, H, H}, ReluMask{z2, z1, bn1, H}, E, H,
                        H, w.part, smem, s)));
  ES_TRY(column_sums(w.part, cdiv(E, 64), 3 * H, w.mid, w.sum, s));
  bn1_grads<<<1, NT, 0, s>>>(w.sum, g1, st + H, E, H, c1a, c2a, dg1, dbe1,
                             db1);
  ES_TRY(cudaGetLastError());

  // dz1's segment sums, then dW1 and the feature gradient
  seg_sums<<<2 * n, cdiv(H, 32) * 32, 0, s>>>(z2, z1, bn1, c1a, c2a, seg_ptr,
                                              seg_perm, H, w.S);
  ES_TRY(cudaGetLastError());
  ES_TRY(reduce_product(BlockDiag{feat, n, d}, Dense{w.S, 2 * n, H}, 2 * d, H,
                        2 * n, w.fpart, dW1, smem, s));
  ES_TRY((row_product<128, 128, BBK>(SegCat{w.S, n, H}, W1T{W1, d, H}, Store{dfeat}, n, d,
                         2 * H, nullptr, smem, s)));
  return cudaSuccess;
}
