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
// statistics before the layer can be applied.  The forward takes a
// layer's statistics in the epilogue of its product and runs the top
// layer's product a second time for the output dot (see "Forward"
// below); a launch whose result feeds the backward
// also writes every hidden layer's pre-BN activations and the statistics
// to a per-tile workspace in device memory, which the backward reads
// instead of recomputing them (the TPU kernel recomputed; 1.9 GB at the
// slice's shapes is cheap on an 80 GB card).  Layer-0 statistics factor
// exactly over the tile's valid rows and columns (mean = mean_i a +
// mean_j b, var = var_i a + var_j b), so h0 is never stored.  A tile's
// gradient never goes through device memory: BatchNorm and ReLU backward
// are applied while the operands of the two products are staged, and
// layer 0 keeps only row and column sums (see "Backward" below).
//
// Blocks are persistent (a grid-stride loop over tiles) and run in no
// order, so nothing is accumulated across blocks: the backward writes
// per-block partials of the parameter gradients and per-tile partials of
// da/db, which the wrapper sums afterwards (deterministic, no atomics).
//
// Matmuls: every operand is rounded to bf16 (round to nearest even) as it
// is staged in shared memory and the product runs on the tensor cores with
// fp32 accumulators (wgmma from 128-byte-swizzled tiles: m64n256k16 in the
// forward at H = 256, m64n64k16 in the backward) -- the TPU kernel's
// MM_DTYPE numerics, and the only precision these kernels take.  The
// forward builds its operand four elements at a time with the whole width
// H as one output chunk (fwd_product); the backward four elements at a
// time into 128 x 128 output tiles, with the workspace operand in a
// cp.async ring (gemm_stage4).
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
// times of both kernels and of their phases.  The launch of the forward
// that keeps the workspace is bound below by its 1.96 GB of writes:
// 0.585 ms at 3.35 TB/s.
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

// Bits of g_skip (a phase, or a part of every step of gemm_stage4; in the
// forward: its wgmma, its statistics epilogue, its second product for the
// output dot, its store of z) ...
enum Skip {
  SKIP_FWD_MATMUL = 1, SKIP_FWD_STATS = 2, SKIP_FWD_DOT = 4,
  SKIP_DW = 8, SKIP_DX = 16, SKIP_REDUCE = 32, SKIP_L0_SUMS = 64,
  SKIP_FINISH0 = 128, SKIP_STEP_FETCH = 256, SKIP_STEP_CONVERT = 512,
  SKIP_STEP_MMA = 1024, SKIP_FWD_STORE = 2048
};
// ... and of PGE_CONST: the forward matmul's A operand (X) or its B
// operand (W); the backward's dz without its loads or without its
// arithmetic; the dW product's X operand.
enum Const {
  CONST_FWD_A = 1, CONST_FWD_B = 2, CONST_DZ_NOLOAD = 4, CONST_DZ_NOCVT = 8,
  CONST_X = 16
};
constexpr unsigned BF16_ONES = 0x3f803f80u;   // two bf16 1.0

constexpr int TI = 16;            // score-tile rows
constexpr int TJ = 128;           // score-tile cols
constexpr int P = TI * TJ;        // pairs per tile (BatchNorm population)
constexpr int MBM = 128;          // backward (wgmma) output tile rows
constexpr int MBN = 128;          // backward output tile cols
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
};

// ---------------------------------------------------------------------------
// Tensor-core matmul of the backward, staged four elements at a time.
//
// Fetching one element per call with an operand that is computed while it
// is staged (dz needs a load of z, five per-channel constants, the pair's
// mask and its upstream gradient) the per-element index arithmetic and
// 4-byte accesses cost more than the products.  Here a thread fetches 4
// elements that are consecutive in the source: one
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
// beyond M or N are staged as zeros.  epi(m, n, v0, v1) receives 2
// consecutive columns of a row of the product; done(m0, n0) runs on every
// thread once an output tile's epilogue is through (it may synchronize).
// The block has NT4 = 512 threads, 4 warpgroups as 2 x 2 over the MBM x MBN
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

// wgmma D[64 x N] (+)= A[64 x 16] B[16 x N], both operands K-major in
// the 128-byte swizzle (as wgmma_m64n64k16 with TA = TB = 0): N / 2
// accumulators a thread, n8 block j at d[4 j .. 4 j + 3].  One instruction
// covers the forward's whole output chunk, so A is read from shared
// memory once per k16 step, not once per 64 columns.
template <int N>
__device__ __forceinline__ void wgmma_kmajor(float* d, unsigned long long da,
                                             unsigned long long db,
                                             int accumulate);

template <>
__device__ __forceinline__ void wgmma_kmajor<64>(float* d,
                                               unsigned long long da,
                                               unsigned long long db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_kmajor<128>(float* d,
                                               unsigned long long da,
                                               unsigned long long db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,"
      "%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_kmajor<192>(float* d,
                                               unsigned long long da,
                                               unsigned long long db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,"
      "%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,"
      "%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,"
      "%87,%88,%89,%90,%91,%92,%93,%94,%95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_kmajor<256>(float* d,
                                               unsigned long long da,
                                               unsigned long long db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,"
      "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,"
      "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,"
      "%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,"
      "%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,"
      "%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,"
      "%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,"
      "%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
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


__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// Forward.
//
// A block of FT = 256 threads (two warpgroups) an SM walks its tiles.  A
// hidden layer's product runs over the tile's 16 chunks of FM = 128 pairs
// with the whole width H as one output chunk: 64 pairs x H channels a
// warpgroup, one wgmma m64nHk16 per k16 step.  That is 128 fp32
// accumulators a thread at H = 256, which 255 registers hold (245 used, no
// spills) with one block an SM; this design keeps the two warpgroups that
// compute the operand also issuing the products, rather than adding a
// producer warpgroup with setmaxnreg, because the operand is computed by
// threads, not copied (TMA would not help), and every register of the
// consumers is taken by their accumulators.  The A operand of a chunk is
// built once per depth step of 64, not once per output-column block, and
// is read once per k16 step by the one wgmma, and W, the same for every
// tile, stays in shared memory in bf16 (loaded once a block when L2 = 1
// and H <= 256).
// Above H = 256 the columns go in groups of at most 4 x 64 and the A
// operand is built once per group ("halves"); the shared memory of a
// block holds the operands up to H = 320.
//
// A chunk's pairs are 16 tile rows x 8 tile columns (row m of the chunk is
// pair (m % 16, 8c + m / 16)), so its layer-0 operand needs the tile's 16
// rows of a' = a*s + t (shared memory, once a tile) and 8 rows of b
// (shared memory, once a chunk): X0 = relu(b*s + a') is two loads and an
// FMA a float4, rounded to bf16 (round to nearest even) on the 8-byte
// swizzled store.  A middle layer's operand is relu(z*s + t) from the
// workspace.  Two A tiles: step s's wgmma runs while step s + 1 is built
// into the other (one barrier a step, as in gemm_stage4).
//
// Statistics come from the accumulators, in float64 from the first add on
// (z and z^2 of an fp32 z are exact there, so E[z^2] - mean^2 cancels no
// fp32 rounding): per channel, each thread's two pairs (masked when
// outside [n, n]) are added, the warp's 8 row groups are reduce-scattered
// over shuffles in 3 rounds, and each warp adds its 16 pairs' sums into
// its own float64 slot in shared memory.  Slots are added
// in warp order once the tile's 16 chunks are through: a fixed order, no
// atomics.  The output dot needs the top layer's statistics, so the top
// product runs a second time and its epilogue applies BN + ReLU and the
// dot with wlast, reduced over the channels of a pair row (4 lanes) with
// nothing stored.  Only a launch whose result feeds the backward (keep)
// writes the top layer's z and the statistics; a no-grad launch keeps only
// middle layers' z, in a per-block buffer (none at L2 <= 1).  Both run the
// same arithmetic, so their scores are equal bit for bit.
// ---------------------------------------------------------------------------
constexpr int FT = 256;            // threads of a forward block
constexpr int FM = 128;            // pairs of a chunk (rows of the product)
constexpr int FK = 64;             // depth step
constexpr int NCHUNK = P / FM;     // chunks of a tile
constexpr int FTILE = FM * FK;     // bf16 elements of an A operand tile
constexpr int WTILE = 64 * FK;     // of a 64 x 64 tile of W
constexpr int MAX_NBG = 4;         // 64-column blocks of an output group
constexpr int FWARPS = FT / 32;

__host__ __device__ constexpr int fwd_groups(int H) {
  return (H / 64 + MAX_NBG - 1) / MAX_NBG;
}
// 64-column blocks of a group (the last group may have fewer)
__host__ __device__ constexpr int fwd_nbg(int H) {
  return (H / 64 + fwd_groups(H) - 1) / fwd_groups(H);
}
// W of a group, two A tiles, per-warp float64 sums and sums of squares,
// a' [TI, H], the chunk's b rows [8, H], 6 per-channel rows, and the
// pairs' partial dots when there is more than one group.
__host__ __device__ constexpr int fwd_smem_bytes(int H) {
  return fwd_nbg(H) * (H / 64) * WTILE * 2 + 2 * FTILE * 2 +
         2 * FWARPS * fwd_nbg(H) * 64 * 8 + (TI + 8 + 6) * H * 4 +
         (fwd_groups(H) > 1 ? P * 4 : 0);
}

struct FwdSmem {
  unsigned short* W;   // [nbg x H/64] K-major 64 x 64 tiles of W (n rows)
  unsigned short* A;   // [2][FM x FK] K-major tiles of X
  double* SS;          // [FWARPS][nbg * 64] sums of z
  double* SQ;          //                    sums of z^2
  float* AP;           // [TI, H] a * s0 + t0
  float* BB;           // [8, H] b rows of the chunk
  float *SCi, *SHi;    // BatchNorm scale, shift of the operand's layer
  float *SCo, *SHo;    // of the product's layer
  float *BI, *WL;      // bias of the product's layer, wlast
  float* RD;           // [P] partial dots across groups
  __device__ void carve(unsigned char* base, int H) {
    const int ncol = fwd_nbg(H) * 64;
    W = reinterpret_cast<unsigned short*>(base);
    A = W + ncol * H;
    SS = reinterpret_cast<double*>(A + 2 * FTILE);
    SQ = SS + FWARPS * ncol;
    AP = reinterpret_cast<float*>(SQ + FWARPS * ncol);
    BB = AP + TI * H;
    SCi = BB + 8 * H;
    SHi = SCi + H;
    SCo = SHi + H;
    SHo = SCo + H;
    BI = SHo + H;
    WL = BI + H;
    RD = WL + H;
  }
};

__device__ __forceinline__ float4 relu_fma4(float4 x, float4 s, float4 t) {
  return make_float4(fmaxf(fmaf(x.x, s.x, t.x), 0.f),
                     fmaxf(fmaf(x.y, s.y, t.y), 0.f),
                     fmaxf(fmaf(x.z, s.z, t.z), 0.f),
                     fmaxf(fmaf(x.w, s.w, t.w), 0.f));
}

// Layer-0 statistics (float64, from the factorization over the tile's
// valid rows and columns) into SCi / SHi (and the tile's statistics when
// S is set), then a' = a * s + t for the tile's 16 rows.
__device__ void fwd_layer0(const Params& A, const Tile& T, const FwdSmem& M,
                           float* S) {
  const int H = A.H;
  for (int c = threadIdx.x; c < H; c += FT) {
    double sa = 0, saa = 0, sb = 0, sbb = 0;
    for (int r = 0; r < T.nvr; ++r) {
      const double v = A.a[(size_t)(T.i * TI + r) * H + c];
      sa += v;
      saa += v * v;
    }
    for (int q = 0; q < T.nvc; ++q) {
      const double v = A.b[(size_t)(T.j * TJ + q) * H + c];
      sb += v;
      sbb += v * v;
    }
    const double mean = sa / T.nvr + sb / T.nvc;
    const double e2 =
        ((double)T.nvc * saa + (double)T.nvr * sbb + 2.0 * sa * sb) /
        ((double)T.nvr * T.nvc);
    const float invstd = rsqrtf((float)(e2 - mean * mean) + EPS);
    const float scale = invstd * A.gamma[c];
    const float shift = A.beta[c] - (float)mean * scale;
    M.SCi[c] = scale;
    M.SHi[c] = shift;
    if (S) {
      S[c] = (float)mean;
      S[(A.L2 + 1) * H + c] = invstd;
      S[2 * (A.L2 + 1) * H + c] = scale;
      S[3 * (A.L2 + 1) * H + c] = shift;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TI * H; e += FT) {
    const int r = e / H, c = e - r * H;
    M.AP[e] = r < T.nvr
                  ? fmaf(A.a[(size_t)(T.i * TI + r) * H + c], M.SCi[c],
                         M.SHi[c])
                  : 0.f;
  }
  __syncthreads();
}

// L2 = 0: out = relu(b * s + a') . wlast, a warp per pair.
__device__ void fwd_dot0(const Params& A, const Tile& T, const FwdSmem& M,
                         float* out) {
  const int H = A.H, lane = threadIdx.x & 31;
  for (int p = threadIdx.x >> 5; p < P; p += FWARPS) {
    if (!valid(T, p)) continue;
    const int i = p / TJ, j = p % TJ;
    const float* b = A.b + (size_t)(T.j * TJ + j) * H;
    float s = 0.f;
    for (int k = 4 * lane; k < H; k += 128) {
      const float4 x = relu_fma4(ld4(b + k), ld4(M.SCi + k),
                                 ld4(M.AP + i * H + k));
      const float4 w = ld4(M.WL + k);
      s += x.x * w.x + x.y * w.y + x.z * w.z + x.w * w.w;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[(size_t)(T.i * TI + i) * A.n + T.j * TJ + j] = s;
  }
  __syncthreads();
}

// Builds the A operand of chunk c, depth block kb of layer l's product into
// As: a thread owns 4 depth values of the chunk rows rr + 16 q (q < 8),
// which are the pairs (rr, 8c + q).
__device__ __forceinline__ void fwd_stage(const Params& A, const FwdSmem& M,
                                          const float* Zp, int l, int c,
                                          int kb, unsigned short* As) {
  const int H = A.H, k4 = threadIdx.x & 15, rr = threadIdx.x >> 4;
  const int k = kb * FK + 4 * k4;
  unsigned short* dst = As + rr * FK + ((((4 * k4) >> 3) ^ (rr & 7)) << 3) +
                        ((4 * k4) & 7);
  if (PGE_CONST & CONST_FWD_A) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      *reinterpret_cast<uint2*>(dst + 16 * q * FK) =
          make_uint2(BF16_ONES, BF16_ONES);
    return;
  }
  if (l == 1) {
    const float4 ap = ld4(M.AP + rr * H + k), s = ld4(M.SCi + k);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      *reinterpret_cast<uint2*>(dst + 16 * q * FK) =
          pack4(relu_fma4(ld4(M.BB + q * H + k), s, ap));
  } else {
    const float4 s = ld4(M.SCi + k), t = ld4(M.SHi + k);
    float4 z[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      z[q] = ld4(Zp + (size_t)(rr * TJ + c * 8 + q) * H + k);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      *reinterpret_cast<uint2*>(dst + 16 * q * FK) =
          pack4(relu_fma4(z[q], s, t));
  }
}

// Columns n0 .. n0 + 64 nbg of layer l's W into shared memory as bf16
// K-major tiles: tile kb holds W[64 kb + k][n0 + r] at row r (r < 64 nbg),
// the B operand of one wgmma over the group's columns.
__device__ void fwd_load_w(const Params& A, const FwdSmem& M, int l, int n0,
                           int nbg) {
  const int H = A.H, ncol = nbg * 64;
  const float* W = A.wmid + (size_t)(l - 1) * H * H;
  for (int e = threadIdx.x; e < H * ncol / 4; e += FT) {
    const int k = e / (ncol / 4), n = (e - k * (ncol / 4)) * 4;
    float4 v = ld4(W + (size_t)k * H + n0 + n);
    if (PGE_CONST & CONST_FWD_B)
      v = make_float4((float)((k + n) & 7), 1.f, 2.f, 3.f);
    const float vv[4] = {v.x, v.y, v.z, v.w};
    const int kb = k / FK, kl = k % FK;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = n + u;
      M.W[kb * ncol * FK + r * FK + (((kl >> 3) ^ (r & 7)) << 3) +
          (kl & 7)] = (unsigned short)(__float_as_uint(round_bf16(vv[u])) >>
                                       16);
    }
  }
  fence_async_smem();
  __syncthreads();
}

template <int NA>
__device__ __forceinline__ void wgmma_wait_all(float (&acc)[NA]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// One round of the reduce-scatter over a warp's 8 row groups: lanes XOR
// apart exchange the half of their 4 * 2J partials that the other keeps.
template <int J>
__device__ __forceinline__ void rs_round(double (&v)[32], bool upper,
                                         int x) {
#pragma unroll
  for (int jj = 0; jj < J; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const double lo = v[jj * 4 + e], hi = v[(jj + J) * 4 + e];
      const double mine = upper ? hi : lo, theirs = upper ? lo : hi;
      v[jj * 4 + e] = mine + __shfl_xor_sync(0xffffffffu, theirs, x);
    }
}

// Layer l's product over the tile for column group g of NB 64-column
// blocks (columns n0 ..): 16 chunks of nkb depth steps, each chunk closed
// by its epilogue.  dot = false: z = X_{l-1} W + bias, stored to Zl when
// it is set, and the chunk's per-channel sums added to the warps' slots
// (stride ncol).  dot = true: out = relu(z * s + t) . wlast, the group's
// share of each pair's dot added in RD across groups.  The wgmma and its
// waits sit outside any data-dependent branch: a wgmma behind one is
// serialized by the compiler.
template <int NB>
__device__ void fwd_group(const Params& A, const Tile& T, const FwdSmem& M,
                          float* Zl, const float* Zp, int l, bool dot,
                          float* out, int g, int n0, int ncol) {
  const int H = A.H, nkb = H / FK, ngroups = fwd_groups(H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, gid = lane >> 2, tig = lane & 3;
  const int skip = PGE_SKIP(~0);
  float acc[NB * 32];   // n8 block j of the group at acc[4 j]
  const unsigned long long da = wg_desc(M.A + wg * 64 * FK, 16);
  const unsigned long long dw = wg_desc(M.W, 16);
  int s = 0;   // steps so far: step s builds its A tile in buffer s & 1
#pragma unroll 1
  for (int c = 0; c < NCHUNK; ++c) {
    if (l == 1) {   // the chunk's 8 rows of b
      for (int e = tid; e < 2 * H; e += FT) {
        const int q = e / (H / 4), k = (e - q * (H / 4)) * 4;
        const int j = T.j * TJ + c * 8 + q;
        *reinterpret_cast<float4*>(M.BB + q * H + k) =
            j < A.n ? ld4(A.b + (size_t)j * H + k)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int kb = 0; kb < nkb; ++kb, ++s) {
      const int buf = s & 1;
      fwd_stage(A, M, Zp, l, c, kb, M.A + buf * FTILE);
      wgmma_wait_all(acc);   // step s - 1, the last reader of buf ^ 1
      fence_async_smem();
      __syncthreads();
      if (!(skip & SKIP_FWD_MATMUL)) {
        const unsigned long long a = da + buf * (FTILE * 2 >> 4);
        const unsigned long long w = dw + kb * (NB * WTILE * 2 >> 4);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < FK / 16; ++kk)
          wgmma_kmajor<NB * 64>(acc, a + kk * 2, w + kk * 2, kb | kk);
        wgmma_commit();
      }
    }
    wgmma_wait_all(acc);
    // this warp's pairs: tile column 8c + warp, tile rows gid and gid + 8
    const int jt = c * 8 + warp;
    const bool okc = jt < T.nvc;
    const bool ok_lo = okc && gid < T.nvr, ok_hi = okc && gid + 8 < T.nvr;
    const size_t p_lo = (size_t)gid * TJ + jt, p_hi = p_lo + 8 * TJ;
    float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      double v[32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + jb * 64 + j * 8 + tig * 2;
        const float2 bi = *reinterpret_cast<const float2*>(M.BI + n);
        const float z00 = acc[jb * 32 + 4 * j] + bi.x;
        const float z01 = acc[jb * 32 + 4 * j + 1] + bi.y;
        const float z10 = acc[jb * 32 + 4 * j + 2] + bi.x;
        const float z11 = acc[jb * 32 + 4 * j + 3] + bi.y;
        if (dot) {
          const float2 sc = *reinterpret_cast<const float2*>(M.SCo + n);
          const float2 sh = *reinterpret_cast<const float2*>(M.SHo + n);
          const float2 wl = *reinterpret_cast<const float2*>(M.WL + n);
          d_lo += fmaxf(fmaf(z00, sc.x, sh.x), 0.f) * wl.x;
          d_lo += fmaxf(fmaf(z01, sc.y, sh.y), 0.f) * wl.y;
          d_hi += fmaxf(fmaf(z10, sc.x, sh.x), 0.f) * wl.x;
          d_hi += fmaxf(fmaf(z11, sc.y, sh.y), 0.f) * wl.y;
          continue;
        }
        if (Zl && !(skip & SKIP_FWD_STORE)) {
          *reinterpret_cast<float2*>(Zl + p_lo * H + n) =
              make_float2(z00, z01);
          *reinterpret_cast<float2*>(Zl + p_hi * H + n) =
              make_float2(z10, z11);
        }
        // float64 from here: z * z is exact, and no sum rounds in fp32
        const double a0 = ok_lo ? z00 : 0.0, a1 = ok_lo ? z01 : 0.0;
        const double b0 = ok_hi ? z10 : 0.0, b1 = ok_hi ? z11 : 0.0;
        v[4 * j] = a0 + b0;
        v[4 * j + 1] = a1 + b1;
        v[4 * j + 2] = a0 * a0 + b0 * b0;
        v[4 * j + 3] = a1 * a1 + b1 * b1;
      }
      if (dot || (skip & SKIP_FWD_STATS)) continue;
      // reduce-scatter over the 8 row groups: lane bit 4, 3, 2 is bit 2,
      // 1, 0 of gid and of the n8 block j it keeps
      rs_round<4>(v, (gid >> 2) & 1, 16);
      rs_round<2>(v, (gid >> 1) & 1, 8);
      rs_round<1>(v, gid & 1, 4);
      const int cl = jb * 64 + gid * 8 + tig * 2;
      double* ss = M.SS + warp * ncol + cl;
      double* sq = M.SQ + warp * ncol + cl;
      ss[0] += v[0];
      ss[1] += v[1];
      sq[0] += v[2];
      sq[1] += v[3];
    }
    if (dot) {
      d_lo += __shfl_xor_sync(0xffffffffu, d_lo, 1);
      d_lo += __shfl_xor_sync(0xffffffffu, d_lo, 2);
      d_hi += __shfl_xor_sync(0xffffffffu, d_hi, 1);
      d_hi += __shfl_xor_sync(0xffffffffu, d_hi, 2);
      if (tig == 0) {
        if (ngroups > 1) {
          d_lo += g ? M.RD[p_lo] : 0.f;
          d_hi += g ? M.RD[p_hi] : 0.f;
          M.RD[p_lo] = d_lo;
          M.RD[p_hi] = d_hi;
        }
        const size_t o = (size_t)(T.i * TI + gid) * A.n + T.j * TJ + jt;
        if (g == ngroups - 1 && ok_lo) out[o] = d_lo;
        if (g == ngroups - 1 && ok_hi) out[o + (size_t)8 * A.n] = d_hi;
      }
    }
  }
}

// Layer l's product over the tile, for every column group.  dot = false:
// the statistics of z into SCo / SHo (and S) as well.
template <int NBG>
__device__ void fwd_product(const Params& A, const Tile& T, const FwdSmem& M,
                            float* Zl, const float* Zp, int l, bool dot,
                            float* S, float* out, int& w_loaded) {
  const int H = A.H, ngroups = fwd_groups(H), tid = threadIdx.x;
  const int ncol = NBG * 64;   // stride of a warp's slots
  for (int c = tid; c < H; c += FT) M.BI[c] = A.bmid[(l - 1) * H + c];
  for (int g = 0; g < ngroups; ++g) {
    const int n0 = g * NBG * 64, nbg = min(NBG, H / 64 - g * NBG);
    if (w_loaded != l * 64 + g) {
      __syncthreads();   // the last reads of the tiles it overwrites
      fwd_load_w(A, M, l, n0, nbg);
      w_loaded = l * 64 + g;
    }
    // of the widths the forward takes (H <= 320) only 320 has a group of
    // fewer blocks (3 + 2); another instance of the product in the kernel
    // of H = 256 would cost it registers
    if (nbg == NBG) {
      fwd_group<NBG>(A, T, M, Zl, Zp, l, dot, out, g, n0, ncol);
    } else {
      if constexpr (NBG == 3)
        fwd_group<2>(A, T, M, Zl, Zp, l, dot, out, g, n0, ncol);
    }
    if (dot) continue;
    // the group's statistics: warp slots added in warp order
    __syncthreads();
    if (tid < nbg * 64) {
      const int c = n0 + tid;
      double s = 0, q = 0;
#pragma unroll
      for (int w = 0; w < FWARPS; ++w) {
        s += M.SS[w * ncol + tid];
        q += M.SQ[w * ncol + tid];
        M.SS[w * ncol + tid] = 0.0;
        M.SQ[w * ncol + tid] = 0.0;
      }
      const double mean = s / T.count;
      const float invstd = rsqrtf((float)(q / T.count - mean * mean) + EPS);
      const float scale = invstd * A.gamma[l * H + c];
      const float shift = A.beta[l * H + c] - (float)mean * scale;
      M.SCo[c] = scale;
      M.SHo[c] = shift;
      if (S) {
        const int L = A.L2 + 1;
        S[l * H + c] = (float)mean;
        S[(L + l) * H + c] = invstd;
        S[(2 * L + l) * H + c] = scale;
        S[(3 * L + l) * H + c] = shift;
      }
    }
    __syncthreads();
  }
}

// keep: the launch feeds the backward, so the tile's workspace (every
// layer's z) and statistics are written; else middle layers' z go to the
// block's own buffer in A.ws ((L2 - 1) x P x H) and nothing else is kept.
template <int NBG>
__global__ void __launch_bounds__(FT, 1)
pge_fwd_kernel(Params A, float* out, int keep) {
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  FwdSmem M;
  M.carve(fwd_smem, A.H);
  const int H = A.H, L2 = A.L2;
  const size_t PH = (size_t)P * H;
  for (int c = threadIdx.x; c < H; c += FT) M.WL[c] = A.wlast[c];
  for (int e = threadIdx.x; e < 2 * FWARPS * NBG * 64; e += FT) M.SS[e] = 0.0;
  int w_loaded = -1;
  for (int t = blockIdx.x; t < A.ntiles; t += gridDim.x) {
    const Tile T = make_tile(t, A.n, A.nj);
    float* ws = keep ? A.ws + (size_t)t * L2 * PH
                     : A.ws + (size_t)blockIdx.x * max(L2 - 1, 0) * PH;
    float* S = keep ? A.stat + (size_t)t * stat_rows(L2) * H : nullptr;
    __syncthreads();   // the tile before's last reads of AP, SCi, SHi
    fwd_layer0(A, T, M, S);
    if (L2 == 0) {
      fwd_dot0(A, T, M, out);
      continue;
    }
    for (int l = 1; l <= L2; ++l) {
      fwd_product<NBG>(A, T, M, keep || l < L2 ? ws + (l - 1) * PH : nullptr,
                       l >= 2 ? ws + (l - 2) * PH : nullptr, l, false, S,
                       out, w_loaded);
      if (l < L2) {
        for (int c = threadIdx.x; c < H; c += FT) {
          M.SCi[c] = M.SCo[c];
          M.SHi[c] = M.SHo[c];
        }
        __syncthreads();
      }
    }
    if (PGE_SKIP(SKIP_FWD_DOT)) continue;
    fwd_product<NBG>(A, T, M, nullptr, L2 >= 2 ? ws + (L2 - 2) * PH : nullptr,
                     L2, true, S, out, w_loaded);
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

// Row pitch of the shared-memory copy of a dX output tile (MBN columns).
constexpr int EP = MBN + 4;

// Dynamic shared memory of the backward kernel: matmul operands (also the
// column-sum scratch of l0_tile_sums), the dX output tile (also the
// scratch of reduce_pass), the [TI, H] row sums, the constants, the
// tile's upstream gradient and the ring of workspace loads in flight.
__host__ __device__ constexpr int bwd_rest_bytes(int H) {
  return TM * EP * 4 + (TI + NCONST) * H * 4 + P * 4 + RING_FLOATS * 4;
}

// Pairs of operand tiles: two where a block's shared memory holds them
// (H <= 256), else one.
__host__ __device__ constexpr int bwd_oper_bufs(int H) {
  return 2 * BUF4_BYTES + bwd_rest_bytes(H) <= MAX_SMEM_BLOCK ? 2 : 1;
}

__host__ __device__ constexpr int bwd_oper_bytes(int H) {
  return bwd_oper_bufs(H) * BUF4_BYTES;
}

__host__ __device__ constexpr int bwd_smem_bytes(int H) {
  return bwd_oper_bytes(H) + bwd_rest_bytes(H);
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
  float* ring;   // [RING_FLOATS]
  __device__ void carve(unsigned char* base, int H) {
    oper = base;
    E = reinterpret_cast<float*>(base + bwd_oper_bytes(H));
    R = E + TM * EP;
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
// (4 sums x block size x 4 floats: 32 KB of the E tile) and
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
__device__ void l0_tile_sums(const Ctx& C, int m0, int n0,
                             const BwdSmem& M, float* ccol) {
  constexpr int TN = MBN, NH = NT4 / TN, RPT = TI / NH, NQ = TM / TI;
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
  for (int o = threadIdx.x; o < NQ * TN; o += NT4) {
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
template <bool TOP>
__device__ void bwd_layer(const Ctx& C, const Grads& G, const BwdSmem& M,
                          int l, const float* Din, float* Dout, float* ccol,
                          const Partials& pd) {
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
    float* o = to0 ? &M.E[(m % TM) * EP + n % MBN] : &Dout[(size_t)m * H + n];
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  };
  auto done_dx = [&](int m0, int n0) {
    if (to0 && !PGE_SKIP(SKIP_L0_SUMS))
      l0_tile_sums(C, m0, n0, M, ccol);
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
  __syncthreads();
}

__global__ void __launch_bounds__(NT4, 1)
pge_bwd_kernel(Params A, Grads G) {
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const int H = A.H, L2 = A.L2;
  const size_t PH = (size_t)P * H;
  Ctx C(A);
  BwdSmem M;
  M.carve(bwd_smem, H);
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
        bwd_layer<true>(C, G, M, l, nullptr, Dout, ccol, pd);
      else
        bwd_layer<false>(C, G, M, l, blockbuf + (l & 1) % G.nbuf * PH, Dout,
                         ccol, pd);
    }
    __syncthreads();
    if (!PGE_SKIP(SKIP_FINISH0))
      finish0(C, G, M.R, ccol, pd.dgamma, pd.dbeta);
    __syncthreads();
  }
}

}  // namespace pge
