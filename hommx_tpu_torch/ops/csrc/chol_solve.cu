// K3: batched SPD direct solve with one refinement sweep, one cell per block,
// as a blocked right-looking Cholesky (panel width NB = 32).
//
// Replaces the TPU kernel hommx_tpu/ops/chol_kernel.py::_chol_kernel_rolled
// (and its unrolled twin _chol_kernel), called through fused_chol_solve.
// For every cell c it solves Ks[c] X = Fs[:, :, c] for the s right-hand
// sides with the reference's algorithm: n padded to P = ceil(n / 32) panels
// with decoupled identity rows and zero right-hand sides; per panel an
// unblocked Cholesky of the diagonal block with clamped pivots
// sqrt(max(p, eps)) (never raises; a NaN pivot stays NaN, a non-SPD cell
// gives large-but-finite factors), its inverse Dinv by forward Gauss-Jordan,
// the panel L_ip = A_ip Dinv^T and the trailing update A_ij -= L_ip L_jp^T;
// blocked forward and backward substitution; then ONE refinement sweep
// R = F - Ks X against the original, full Ks and X += solve(R).
//
// Layouts: Ks (C, n, n) cell-major, row-major per cell; Fs and X (n, s, C)
// cell-minor, as the JAX package's kernel takes them.
//
// What bounds it.  At the elasticity cell (n = 192, s = 6) one cell is
// n^3/3 = 2.36 MFLOP of factorization, 4 triangular solves of n^2 s =
// 0.88 MFLOP and a refinement matvec of 2 n^2 s = 0.44 MFLOP: 3.69 MFLOP
// against 157 KB of traffic, 23.5 FLOP per byte.  TF32 tensor cores are
// ruled out (they round inputs the way the TPU's bf16 passes did, which cost
// 3.3e-3 on A*), so the ceiling is the float32 CUDA-core rate, 67 TFLOP/s:
// ~59 us per 1080-cell chunk against ~50 us of memory time.
//
// What the design does about it:
// - Shared memory holds only the P(P+1)/2 lower 32 x 32 tiles of the padded
//   operator, packed by tile columns (86 KB at n = 192 instead of 147 KB),
//   and two (n_pad, s) right-hand-side arrays: 95,232 B a cell at n = 192,
//   s = 6, so two 256-thread blocks (two cells) stay resident on one SM and
//   one cell's loads, barriers and latency-bound diagonal steps overlap the
//   other's panel products (__launch_bounds__(256, 2): at most 128
//   registers a thread).  Its largest n is 288 (9 panels, 45 tiles); the
//   large instance below takes every larger n.
// - Each tile is stored column-major with stride 32 (element (r, c) at
//   c * 32 + r).  Ks is symmetric, so tile (I, J) of the lower triangle is
//   loaded from the rows J*32.. of the row-major Ks: every tile column is a
//   contiguous 128-byte run of global memory, copied by 16-byte cp.async
//   where n is a multiple of 4 (a masked 4-byte path for ragged n, with the
//   identity padding written on load).  The factor thus reads the upper
//   triangle of Ks where the plain version reads the lower one; the two
//   agree up to the assembly's rounding, and the refinement runs against
//   the full row-major Ks.  Column walks (all lanes down one tile column)
//   are conflict-free; the row walks of the backward substitution start
//   each lane at its own diagonal (k = (kk + lane) mod 32), which spreads
//   them over the 32 banks too.
// - The diagonal tile is factored by one warp in registers (lane r holds
//   row r; pivots and columns travel by shuffles, the pivot's reciprocal
//   square root by rsqrtf), inverted column by column (the reference's
//   forward Gauss-Jordan sweep, reordered), and Dinv_p replaces it in its
//   slot: the substitutions need only Dinv_p and the off-diagonal panels.
//   Warp 0 factors tile p + 1 while the other warps finish panel p's
//   trailing update: 2 barriers per panel instead of 192 column steps with
//   two barriers each.
// - The panel (L_ip = A_ip Dinv_p^T) and the trailing update (A_ij -=
//   L_ip L_jp^T, lower tiles only) are register-tiled FP32 products: one
//   warp per 32 x 32 output tile, each lane an 8 x 4 accumulator fed by
//   three float4 reads of shared memory per k (12 floats per 32 FMAs).
// - The substitutions are blocked: one warp per right-hand side walks the
//   panels, applying Dinv_p (or its transpose) and then panel p to the
//   other tiles, lane r on row r, with no block-wide barrier: P steps of
//   32-wide products instead of 192-step serial chains.
// - The refinement re-reads Ks[c] from global memory (the factor overwrote
//   the shared copy), one warp per four rows, coalesced, all s right-hand
//   sides at once, with every load of the four rows in flight together.
//
// Where the time goes (tools/k3_probe.py, H100): a cell's block spends most
// of its cycles in chains of dependent steps (the six diagonal tiles, the
// substitutions, the residual's loads) with few warps busy; the second
// resident cell fills some of that time.  The products themselves are a
// small share.
//
// The large instance (chol_solve_large_kernel, hommx_chol_solve_large_f32)
// takes every n the small one cannot hold (n > 288 at s <= 8: the 5^3-8^3
// cubes, the 13^2-16^2 squares and up), with the same algorithm, layouts and
// diagonal-tile helpers.  A cell's packed lower tiles do not fit on chip
// (338 KB at n = 375, 4.7 MB at n = 1536), so they live in a per-cell global
// workspace that the wrapper allocates; the right-hand sides and the first
// solution live beside them.  What bounds it: the factor's n^3/3 FLOP at the
// FP32 rate, and the workspace's traffic, which at chunk sizes spills the
// 50 MB L2 to HBM (0.29 GB of workspace for the 6^3 cube's 309 cells).
// Updating every trailing tile once a 32-wide panel read and wrote ~P^3/6
// tiles of 8 KB a cell (1540 at the 6^3 cube: 3.9 GB a chunk, 2.4x the FLOP
// bound at the HBM rate), one 32-deep product for each 8 KB moved.  So the
// factor runs by outer panels of kOuter = 4 tile columns (128 columns):
// - The strip.  Its lower diagonal block (10 tiles, 40 KB) is loaded and
//   factored in shared memory by the small instance's right-looking loop
//   (Dinv in its diagonal tiles), in every CTA of the cell; rank 0 writes it
//   back.  The rows below it, kGroup = 4 at a time (16 tiles), are read once,
//   solved against it (L_ik = (A_ik - sum_{k' < k} L_ik' L_kk'^T) Dinv_k^T,
//   one warp a tile) and written once; the groups are split over the
//   cluster.  The first forward substitution rides along (y of the block's
//   rows, then b_i -= L_ik y_k for the rows below), so the first solve
//   reads the factor once, backward.
// - The trailing update.  Every lower tile right of the strip, A_ij -=
//   sum_k L_ik L_jk^T over the strip's 128 columns, runs by blocks of 4 x 4
//   tiles (128 x 128): the lower triangle's blocks in column order, split
//   over the cluster; a block column's strip rows (16 tiles, every depth)
//   staged once, a block row's (4 tiles a depth) double-buffered by
//   cp.async so that the next depth (or the next block's first) arrives
//   while the product runs.  Each thread holds an 8 x 8 accumulator (rows
//   and columns in two 4-wide slices, 32 apart, so that eight lanes read
//   128 contiguous bytes or one broadcast word): four float4 reads of
//   shared memory per 64 FMAs (the small instance's tile product: three per
//   32).  Two warps own a 64 x 64 quadrant and skip it where it holds no
//   lower tile (a diagonal block's upper quadrant, rows past the edge).
//   Each trailing tile is read, updated by a 128-deep sum and written once
//   an outer panel: 536 tiles read and written a 6^3 cell instead of 1540,
//   strip included (ops/chol_kernel.py::workspace_traffic_bytes).  Full
//   FP32 on the CUDA cores; every sum runs in a fixed order, so identical
//   launches are bitwise equal.
// Outer panel 0 reads its tiles straight from Ks (the upper triangle, with
// the identity padding written on load), so Ks is copied into the workspace
// by the first strip and trailing update, not by a pass of its own.  Where a
// chunk has fewer cells than the card has SMs, a cell is a cluster of CS
// CTAs (1, 2, 4 or 8) that split the strip's row groups and the trailing
// blocks; two cluster barriers an outer panel order the workspace (every
// read of it goes through L2: cp.async.cg, ld.global.cg).  No mbarrier is
// waited on.  Where a chunk is a little over a full wave (the 6^3 beam's 309
// cells against 264 slots), clusters of two CTAs solve a cell a CTA in the
// full waves and the last wave's cells two CTAs each (`apart`), so that the
// last wave runs shorter.  Rank 0 then runs the substitutions by the same
// outer panels (a few round trips to memory an outer panel instead of one
// or more a 32-wide panel), the cell's CTAs split the refinement residual
// against the full Ks by rows, and rank 0 runs the second solve and writes
// X.  Shared memory is 27 tiles (110,592 B) at every n, so two CTAs share an
// SM (__launch_bounds__(256, 2): at most 128 registers a thread; one CTA
// with 255 ran 19-60% slower).  Where the time goes (tools/k3_probe.py
// --large, H100, 309 cells of the 6^3 cube): the trailing products ~25% of
// a CTA's cycles at ~41 TFLOP/s over the card's slots, the strip ~29%
// (the block's factor, a chain of four 32 x 32 factorizations, 11%), the
// substitutions 17%, the residual 13%; the last wave runs with under half
// the slots busy for ~30% of the kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NB = 32;            // panel width and tile side
constexpr int TILE = NB * NB;     // floats per tile: column stride NB, no padding
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRhs = 8;        // at most kWarps: one warp per right-hand side
constexpr int kMaxPanels = 9;     // n <= 288
constexpr unsigned FULL = 0xffffffffu;

// The large instance: outer panels of kOuter tile columns, whose strip
// keeps its lower diagonal block (kDiagTiles), kGroup rows (kOuter tiles
// each) and its part of the first forward substitution (one tile) in
// shared memory; trailing blocks of kBlk x kBlk tiles, whose
// operands take kBlk * kOuter tiles (B, every depth) and 2 * kBlk (A, one
// depth, double-buffered); the substitutions' block and rows of an outer
// panel, their x segments, partial sums and vectors; at most kMaxCluster
// CTAs a cell.
constexpr int kOuter = 4;
constexpr int kDiagTiles = kOuter * (kOuter + 1) / 2;
constexpr int kGroup = 4;
constexpr int kBlk = 4;
constexpr int kSolveRows = 3;  // substitutions: rows a stage staged with the block
constexpr int kWideRows = 5;   // .. and without it
constexpr int kLargeTiles = kDiagTiles + kGroup * kOuter + 1;  // 27: + y of the strip
constexpr int kMaxCluster = 8;
static_assert(kBlk * kOuter + 2 * kBlk <= kLargeTiles, "the trailing update's operands");
static_assert((kDiagTiles + kOuter * kSolveRows) * TILE +
                      (kSolveRows + kWarps + kOuter + 1) * kMaxRhs * NB <=
                  kLargeTiles * TILE,
              "the substitutions' block, rows, x segments, partial sums and vectors");
static_assert(kOuter * kWideRows <= kDiagTiles + kOuter * kSolveRows, "the wide stages");
static_assert(kSolveRows <= kWarps && kWideRows <= kWarps && kWarps % kOuter == 0,
              "a warp a row, two warps a column");
static_assert(kGroup <= kWarps, "one warp a row in the strip's panel step");

// Phase marks.  They expand to nothing here; tools/k3_probe.py builds a copy
// with K3_PROBE defined, in which thread 0 of every block adds up clock64
// cycles per phase (0 loads, 1 the first diagonal tile, 2 panels, 3
// trailing updates with the next diagonal tile, 4 substitutions, 5
// refinement matvec, 6 output).  In the large instance (one record per
// CTA): 0 the first diagonal tile, 1 loading Dinv_p, 2 panel tiles and
// their cluster barrier, 3 trailing products, read-modify-writes and their
// cluster barrier, 4 substitutions (rank 0), 5 refinement residual, 6
// output, 7 staging the trailing update's windows.
#ifdef K3_PROBE
__device__ long long g_k3_cycles[K3_PROBE_CELLS * 8];
#define K3_MARK_START long long k3_t = clock64(), k3_c[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define K3_MARK(k)                     \
  if (tid == 0) {                      \
    const long long t = clock64();     \
    k3_c[k] += t - k3_t;               \
    k3_t = t;                          \
  }
#define K3_MARK_END                                                      \
  if (tid == 0 && blockIdx.x < K3_PROBE_CELLS)                           \
    for (int q = 0; q < 8; ++q) g_k3_cycles[blockIdx.x * 8 + q] = k3_c[q];
#else
#define K3_MARK_START
#define K3_MARK(k)
#define K3_MARK_END
#endif

// The warp's sums of v[0..7], in 9 shuffles instead of 8 x 5: each round
// halves the values a lane keeps, trading the other half with its partner;
// lane l ends with the sum of v[l & 7].
__device__ __forceinline__ float warp_sum8(const float (&v)[8], int lane) {
  float h[4], g[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool up = lane & 4;
    h[i] = (up ? v[i + 4] : v[i]) + __shfl_xor_sync(FULL, up ? v[i] : v[i + 4], 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool up = lane & 2;
    g[i] = (up ? h[i + 2] : h[i]) + __shfl_xor_sync(FULL, up ? h[i] : h[i + 2], 2);
  }
  const bool up = lane & 1;
  float t = (up ? g[1] : g[0]) + __shfl_xor_sync(FULL, up ? g[0] : g[1], 1);
  t += __shfl_xor_sync(FULL, t, 8);
  return t + __shfl_xor_sync(FULL, t, 16);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// Lower tiles packed by tile columns: column j holds tiles (j, j) .. (P-1, j).
__device__ __forceinline__ int tile_index(int i, int j, int P) {
  return j * P - (j * (j - 1)) / 2 + (i - j);
}

// Elements (gi .. gi+3, gj) of the padded operator into dst[0..3], taken
// from K[gj][gi ..] (symmetric Ks, row-major); outside n x n the identity.
__device__ __forceinline__ void load_chunk(float* dst, const float* Kc, int n, int gi, int gj,
                                           bool vec) {
  if (vec && gj < n && gi < n) {  // n % 4 == 0: the chunk is inside or outside whole
    cp_async16(dst, Kc + (size_t)gj * n + gi);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int g = gi + e;
    if (gj < n && g < n)
      cp_async4(dst + e, Kc + (size_t)gj * n + g);
    else
      dst[e] = g == gj ? 1.f : 0.f;
  }
}

// One warp: the diagonal tile D (column-major) is factored and replaced by
// Dinv = L_pp^-1 (column-major).  Both sweeps are chains of 32 dependent
// steps, so what sits on the chain is kept short: the pivot's reciprocal
// square root is one rsqrtf (within 2 ulp of 1 / sqrtf; the IEEE sqrtf and
// division sat on the chain), and the inverse runs by columns, lane m on
// column m of Dinv, with L broadcast from shared memory and no shuffles.
// The loops are unrolled, so that the arrays stay in registers (rolled
// versions over shared memory or a rotated array ran slower).
__device__ void factor_diag(float* D, int lane, float eps) {
  // unblocked right-looking Cholesky, lane r holding row r: column j is
  // A(:, j) / sqrt(max(p, eps)) for rows >= j (so L(j, j) = p /
  // sqrt(max(p, eps))), then A -= col col^T; a[j] becomes L(lane, j)
  float a[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) a[k] = D[k * NB + lane];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const float p = __shfl_sync(FULL, a[j], j);
    const float l = lane >= j ? a[j] * rsqrtf(p < eps ? eps : p) : 0.f;  // NaN stays NaN
    a[j] = l;
#pragma unroll
    for (int k = j + 1; k < NB; ++k) a[k] -= l * __shfl_sync(FULL, l, k);
  }
  float own = a[0];  // L(lane, lane)
#pragma unroll
  for (int k = 1; k < NB; ++k) own = lane == k ? a[k] : own;
  const float own_inv = 1.f / own;
#pragma unroll
  for (int k = 0; k < NB; ++k) D[k * NB + lane] = a[k];
  __syncwarp();
  // the forward substitution L x = e_m of the reference's Gauss-Jordan
  // sweep, by columns: x_i = (delta_im - sum_{k<i} L(i, k) x_k) / L(i, i)
  float x[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    float acc = i == lane ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < i; ++k) acc -= D[k * NB + i] * x[k];
    x[i] = acc * __shfl_sync(FULL, own_inv, i);
  }
  __syncwarp();  // every lane has read L
#pragma unroll
  for (int i = 0; i < NB; i += 4) st4(D + lane * NB + i, make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]));
}

// acc(r, c) = sum_k A(r0 + r, k) * B(c0 + c, k) for a lane's 8 x 4 block of
// a 32 x 32 product of two column-major tiles.
__device__ __forceinline__ void tile_product(float (&acc)[8][4], const float* A, const float* B,
                                             int r0, int c0) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
  for (int k = 0; k < NB; ++k) {
    const float4 a0 = ld4(A + k * NB + r0), a1 = ld4(A + k * NB + r0 + 4);
    const float4 b = ld4(B + k * NB + c0);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += av[r] * bv[c];
  }
}

// A lane's 8 x 4 block: rows r0 .. r0+7, columns c0 .. c0+3; a quarter warp
// covers 4 row groups x 2 column groups, so its float4 reads hit distinct
// banks (or the same word).
__device__ __forceinline__ void lane_block(int lane, int& r0, int& c0) {
  r0 = (lane & 3) * 8;
  c0 = (lane >> 2) * 4;
}

// The panel tile, in place: L_ip = A_ip Dinv^T (one warp).
__device__ void panel_tile(float* A, const float* Dinv, int lane) {
  int r0, c0;
  lane_block(lane, r0, c0);
  float acc[8][4];
  tile_product(acc, A, Dinv, r0, c0);
  __syncwarp();  // every lane has read all of A
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float* col = A + (c0 + c) * NB + r0;
    st4(col, make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]));
    st4(col + 4, make_float4(acc[4][c], acc[5][c], acc[6][c], acc[7][c]));
  }
}

// The trailing update of one tile: A_ij -= L_ip L_jp^T (one warp).
__device__ void update_tile(float* Aij, const float* Li, const float* Lj, int lane) {
  int r0, c0;
  lane_block(lane, r0, c0);
  float acc[8][4];
  tile_product(acc, Li, Lj, r0, c0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float* col = Aij + (c0 + c) * NB + r0;
    const float4 x0 = ld4(col), x1 = ld4(col + 4);
    st4(col, make_float4(x0.x - acc[0][c], x0.y - acc[1][c], x0.z - acc[2][c],
                         x0.w - acc[3][c]));
    st4(col + 4, make_float4(x1.x - acc[4][c], x1.y - acc[5][c], x1.z - acc[6][c],
                             x1.w - acc[7][c]));
  }
}

// v(r) = sum over 32 k of W(r, k) y(k) for one lane's row r, in four
// partial sums (the chain of 32 dependent FMAs would be latency-bound), y
// read as float4.  Not transposed: W(r, k) at W[k * NB] (W offset by the
// lane), the same k in every lane, so y is a broadcast.  Transposed: W(r,
// k) at W[k] (W offset by lane * NB), a row walk read as float4 from each
// lane's own diagonal on, so that a quarter warp hits distinct banks.
template <bool transposed>
__device__ __forceinline__ float dot32(const float* W, const float* y, int r) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < NB / 4; ++kk) {
    const int k = 4 * (transposed ? (kk + r) & (NB / 4 - 1) : kk);
    const float4 y4 = ld4(y + k);
    const float4 w4 = transposed ? ld4(W + k)
                                 : make_float4(W[k * NB], W[(k + 1) * NB], W[(k + 2) * NB],
                                               W[(k + 3) * NB]);
    v[0] += w4.x * y4.x;
    v[1] += w4.y * y4.y;
    v[2] += w4.z * y4.z;
    v[3] += w4.w * y4.w;
  }
  return (v[0] + v[1]) + (v[2] + v[3]);
}

// L L^T X = B in place on B (column q at q * npad), from the factored tiles:
// one warp per right-hand side walks the panels, lane r on row r of each
// tile, with no block-wide barrier (warps >= s wait at the closing one).
__device__ void cho_solve(const float* tiles, float* B, int P, int npad, int s, int tid) {
  const int lane = tid & 31, q = tid >> 5;
  if (q < s) {
    float* const b = B + q * npad;
    // forward: y_p = Dinv_p b_p, then b_i -= L_ip y_p for i > p
    for (int p = 0; p < P; ++p) {
      float* const bp = b + p * NB;
      const float y = dot32<false>(tiles + tile_index(p, p, P) * TILE + lane, bp, lane);
      __syncwarp();
      bp[lane] = y;
      __syncwarp();
      for (int i = p + 1; i < P; ++i)
        b[i * NB + lane] -= dot32<false>(tiles + tile_index(i, p, P) * TILE + lane, bp, lane);
      __syncwarp();
    }
    // backward: x_p = Dinv_p^T b_p, then b_i -= L_pi^T x_p for i < p; the
    // row walks start at each lane's own diagonal, so they hit 32 banks
    for (int p = P - 1; p >= 0; --p) {
      float* const bp = b + p * NB;
      const float x = dot32<true>(tiles + tile_index(p, p, P) * TILE + lane * NB, bp, lane);
      __syncwarp();
      bp[lane] = x;
      __syncwarp();
      for (int i = 0; i < p; ++i)
        b[i * NB + lane] -= dot32<true>(tiles + tile_index(p, i, P) * TILE + lane * NB, bp, lane);
      __syncwarp();
    }
  }
  __syncthreads();
}

// The refinement's right-hand side B = F - Ks Xs, one warp per kRows rows:
// their Ks entries (at most 9 a lane per row) and F entries (lane q holds
// right-hand side q) are requested before any is used, so a warp keeps up to
// 40 loads in flight.  Padded rows get a zero residual.
__device__ void residual(const float* __restrict__ Kc, const float* __restrict__ F,
                         const float* Xs, float* B, int C, int c, int n, int npad, int s,
                         int tid) {
  constexpr int kPerLane = kMaxPanels;  // n <= 32 * kMaxPanels
  constexpr int kRows = 4;
  const int lane = tid & 31, warp = tid >> 5;
  for (int i0 = warp; i0 < npad; i0 += kRows * kWarps) {
    int rows[kRows];
    float kv[kRows][kPerLane], f[kRows];
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const int i = rows[h] = i0 + h * kWarps;
      f[h] = i < n && lane < s ? F[((size_t)i * s + lane) * C + c] : 0.f;
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int j = lane + 32 * t;
        kv[h][t] = i < n && j < n ? __ldg(Kc + (size_t)i * n + j) : 0.f;
      }
    }
    float acc[kRows][kMaxRhs];
#pragma unroll
    for (int h = 0; h < kRows; ++h)
#pragma unroll
      for (int q = 0; q < kMaxRhs; ++q) acc[h][q] = 0.f;
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      if (32 * t >= n) break;  // uniform; lane + 32 t < npad below
#pragma unroll
      for (int q = 0; q < kMaxRhs; ++q) {
        if (q < s) {
          const float x = Xs[q * npad + lane + 32 * t];
#pragma unroll
          for (int h = 0; h < kRows; ++h) acc[h][q] += kv[h][t] * x;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const float mine = warp_sum8(acc[h], lane);  // (K Xs)(row, lane) for lane < s
      if (rows[h] < npad && lane < s) B[lane * npad + rows[h]] = f[h] - mine;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
chol_solve_f32_kernel(const float* __restrict__ K, const float* __restrict__ F,
                      float* __restrict__ X, int C, int n, int s, int P, float eps, bool vec) {
  extern __shared__ float4 smem4[];
  const int npad = P * NB, ntiles = P * (P + 1) / 2;
  float* const tiles = reinterpret_cast<float*>(smem4);  // ntiles x TILE
  float* const B = tiles + ntiles * TILE;                // npad x s: right-hand side / solution
  float* const Xs = B + npad * s;                        // npad x s: first solution
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Kc = K + (size_t)c * n * n;
  K3_MARK_START

  // ---- loads: tile column 0 (group 0), then the other tiles (group 1) ----
  {
    const int lc = tid >> 3, lr = (tid & 7) * 4;  // this thread's chunk of every tile
    for (int J = 0; J < P; ++J) {
      for (int I = J; I < P; ++I)
        load_chunk(tiles + tile_index(I, J, P) * TILE + lc * NB + lr, Kc, n, I * NB + lr,
                   J * NB + lc, vec);
      if (J == 0) cp_async_commit();
    }
    cp_async_commit();
  }
  for (int t = tid; t < npad * s; t += kThreads) {
    const int q = t / npad, i = t - q * npad;
    B[t] = i < n ? F[((size_t)i * s + q) * C + c] : 0.f;
  }
  cp_async_wait<1>();
  __syncthreads();
  K3_MARK(0)

  // ---- factorization: right-looking by panels ----------------------------
  // Warp 0 factors diagonal tile p + 1 as soon as it has applied panel p to
  // it, while warps 1.. apply panel p to the other trailing tiles.
  if (warp == 0) factor_diag(tiles, lane, eps);
  __syncthreads();
  K3_MARK(1)
  for (int p = 0; p < P; ++p) {
    const float* const Dp = tiles + tile_index(p, p, P) * TILE;
    for (int i = p + 1 + warp; i < P; i += kWarps)
      panel_tile(tiles + tile_index(i, p, P) * TILE, Dp, lane);
    if (p == 0) cp_async_wait<0>();
    __syncthreads();
    K3_MARK(2)
    const int m = P - 1 - p;
    if (warp == 0) {
      if (m > 0) {
        float* const Dn = tiles + tile_index(p + 1, p + 1, P) * TILE;
        const float* const Ln = tiles + tile_index(p + 1, p, P) * TILE;
        update_tile(Dn, Ln, Ln, lane);
        __syncwarp();
        factor_diag(Dn, lane, eps);
      }
    } else {
      // trailing tiles (i, j), p < j <= i < P, by tile columns; u = 0 is
      // (p + 1, p + 1), warp 0's
      for (int u = warp; u < m * (m + 1) / 2; u += kWarps - 1) {
        int j = p + 1, i = u;
        while (i >= P - j) {
          i -= P - j;
          ++j;
        }
        i += j;
        update_tile(tiles + tile_index(i, j, P) * TILE, tiles + tile_index(i, p, P) * TILE,
                    tiles + tile_index(j, p, P) * TILE, lane);
      }
    }
    __syncthreads();
    K3_MARK(3)
  }

  // ---- solve, keep X, residual against the full original Ks, solve again --
  cho_solve(tiles, B, P, npad, s, tid);
  K3_MARK(4)
  for (int t = tid; t < npad * s; t += kThreads) Xs[t] = B[t];
  __syncthreads();
  residual(Kc, F, Xs, B, C, c, n, npad, s, tid);
  __syncthreads();
  K3_MARK(5)
  cho_solve(tiles, B, P, npad, s, tid);
  K3_MARK(4)
  for (int t = tid; t < n * s; t += kThreads) {
    const int i = t / s, q = t - i * s;
    X[(size_t)t * C + c] = Xs[q * npad + i] + B[q * npad + i];
  }
  __syncthreads();
  K3_MARK(6)
  K3_MARK_END
}

// ---- the large instance ---------------------------------------------------

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster; orders memory cluster-wide
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Phase marks of the large instance.  They cost nothing here; in the
// K3_PROBE build thread 0 of every CTA adds up clock64 cycles per phase (0
// the strip's diagonal block: load, factor, store; 1 the strip's rows:
// solve and store; 2 trailing products; 3 trailing read-modify-writes of
// the workspace; 4 substitutions (rank 0); 5 refinement residual; 6
// output; 7 staging waits of the trailing update (its B rows and A
// buffers); 8 cluster barriers; 9 loading the strip's rows) and records its
// start and end on %globaltimer (ns): 12 int64 a CTA.
#ifdef K3_PROBE
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ long long g_k3l[K3_PROBE_CELLS * 12];

struct LargeProbe {
  long long t, start, c[10];
  __device__ void begin() {
    t = clock64();
    start = global_ns();
    for (int q = 0; q < 10; ++q) c[q] = 0;
  }
  __device__ void mark(int k) {
    if (threadIdx.x == 0) {
      const long long x = clock64();
      c[k] += x - t;
      t = x;
    }
  }
  __device__ void end() {
    if (threadIdx.x == 0 && blockIdx.x < K3_PROBE_CELLS) {
      long long* const g = g_k3l + blockIdx.x * 12;
      for (int q = 0; q < 10; ++q) g[q] = c[q];
      g[10] = start;
      g[11] = global_ns();
    }
  }
};
#else
struct LargeProbe {
  __device__ void begin() {}
  __device__ void mark(int) {}
  __device__ void end() {}
};
#endif

// The block, one 16-byte chunk a thread: tile (I, J) of the padded operator
// into dst (column-major) by cp.async, from Ks (from_k; the identity
// padding written on load) or from its workspace tile Wt.  The caller
// commits and waits.
__device__ __forceinline__ void fetch_tile(float* dst, const float* Kc, const float* Wt, int n,
                                           int I, int J, bool from_k, bool vec, int tid) {
  static_assert(4 * kThreads == TILE, "one 16-byte chunk a thread");
  if (from_k)  // 4 tid = column (tid >> 3) * NB + row (tid & 7) * 4
    load_chunk(dst + 4 * tid, Kc, n, I * NB + (tid & 7) * 4, J * NB + (tid >> 3), vec);
  else
    cp_async16(dst + 4 * tid, Wt + 4 * tid);
}

// The block: a shared-memory tile into its workspace tile.
__device__ __forceinline__ void store_tile(float* dst, const float* src, int tid) {
  st4(dst + 4 * tid, ld4(src + 4 * tid));
}

// Rows gi .. gi+3 of the padded operator's column gj, from K[gj][gi ..]
// (symmetric Ks, row-major): what load_chunk loads, into registers.
__device__ __forceinline__ float4 load4(const float* Kc, int n, int gi, int gj, bool vec) {
  if (vec && gj < n && gi < n)  // n % 4 == 0: the four are inside or outside whole
    return __ldg(reinterpret_cast<const float4*>(Kc + (size_t)gj * n + gi));
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int g = gi + e;
    v[e] = gj < n && g < n ? __ldg(Kc + (size_t)gj * n + g) : (g == gj ? 1.f : 0.f);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The strip of the outer panel of tile columns p0 .. p0+w-1 (w <= kOuter),
// in shared memory S: its lower diagonal block DB (tile (p0+a, p0+b) at
// tile_index(a, b, w)) factored by the small instance's right-looking loop
// in every CTA (warp 0 factors the next diagonal tile while the others
// update), Dinv in its diagonal tiles, rank 0 writing it back; then the rows
// below, kGroup at a time (group g by rank g mod CS): tiles (i, p0+k) at
// G + (r * kOuter + k) * TILE for row i = i0 + r, read once, solved against
// DB depth by depth (L_ik = A_ik Dinv_k^T, then A_ij -= L_ik L_jk^T for
// j > k), written once.  The first forward substitution rides along: y
// of the block's rows (Y: y_a of right-hand side q at (a * kMaxRhs + q) *
// NB) from their right-hand sides in Bv, which rank 0 stores in Xv (the
// cluster's other CTAs may still read those rows of Bv), then b_i -= sum_k
// L_ik y_k for the rows below, each by the CTA that solves the row.
__device__ void large_strip(float* S, float* Wc, const float* Kc, float* Bv, float* Xv, int n,
                            int npad, int s, int P, int p0, int w, int rank, int CS, bool from_k,
                            bool vec, float eps, LargeProbe& pr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* const DB = S;
  float* const G = S + kDiagTiles * TILE;
  float* const Y = G + kGroup * kOuter * TILE;
  for (int b = 0; b < w; ++b)
    for (int a = b; a < w; ++a)
      fetch_tile(DB + tile_index(a, b, w) * TILE, Kc,
                 Wc + (size_t)tile_index(p0 + a, p0 + b, P) * TILE, n, p0 + a, p0 + b, from_k,
                 vec, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) factor_diag(DB, lane, eps);
  __syncthreads();
  for (int a = 0; a < w; ++a) {
    const float* const Da = DB + tile_index(a, a, w) * TILE;
    for (int i = a + 1 + warp; i < w; i += kWarps)
      panel_tile(DB + tile_index(i, a, w) * TILE, Da, lane);
    __syncthreads();
    const int m = w - 1 - a;
    if (warp == 0) {
      if (m > 0) {
        float* const Dn = DB + tile_index(a + 1, a + 1, w) * TILE;
        const float* const Ln = DB + tile_index(a + 1, a, w) * TILE;
        update_tile(Dn, Ln, Ln, lane);
        __syncwarp();
        factor_diag(Dn, lane, eps);
      }
    } else {
      // tiles (i, j), a < j <= i < w, by tile columns; u = 0 is warp 0's
      for (int u = warp; u < m * (m + 1) / 2; u += kWarps - 1) {
        int j = a + 1, i = u;
        while (i >= w - j) {
          i -= w - j;
          ++j;
        }
        i += j;
        update_tile(DB + tile_index(i, j, w) * TILE, DB + tile_index(i, a, w) * TILE,
                    DB + tile_index(j, a, w) * TILE, lane);
      }
    }
    __syncthreads();
  }
  if (rank == 0)
    for (int b = 0; b < w; ++b)
      for (int a = b; a < w; ++a)
        store_tile(Wc + (size_t)tile_index(p0 + a, p0 + b, P) * TILE,
                   DB + tile_index(a, b, w) * TILE, tid);
  // y_a = Dinv_a (b_a - sum_{b < a} L_ab y_b), one warp a right-hand side
  if (warp < s) {
    for (int a = 0; a < w; ++a) {
      float v = __ldcg(Bv + warp * npad + (p0 + a) * NB + lane);
      for (int b = 0; b < a; ++b)
        v -= dot32<false>(DB + tile_index(a, b, w) * TILE + lane, Y + (b * kMaxRhs + warp) * NB,
                          lane);
      float* const y = Y + (a * kMaxRhs + warp) * NB;
      y[lane] = v;
      __syncwarp();
      const float ya = dot32<false>(DB + tile_index(a, a, w) * TILE + lane, y, lane);
      __syncwarp();
      y[lane] = ya;
      __syncwarp();
      if (rank == 0) Xv[warp * npad + (p0 + a) * NB + lane] = ya;
    }
  }
  __syncthreads();
  pr.mark(0);
  for (int i0 = p0 + w + rank * kGroup; i0 < P; i0 += CS * kGroup) {
    const int rows = min(kGroup, P - i0);
    __syncthreads();  // G is free
    for (int r = 0; r < rows; ++r)
      for (int k = 0; k < w; ++k)
        fetch_tile(G + (r * kOuter + k) * TILE, Kc,
                   Wc + (size_t)tile_index(i0 + r, p0 + k, P) * TILE, n, i0 + r, p0 + k, from_k,
                   vec, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    pr.mark(9);
    for (int k = 0; k < w; ++k) {
      if (warp < rows)
        panel_tile(G + (warp * kOuter + k) * TILE, DB + tile_index(k, k, w) * TILE, lane);
      __syncthreads();
      const int right = w - 1 - k;  // tiles right of depth k in each row
      for (int u = warp; u < rows * right; u += kWarps) {
        const int r = u / right, j = k + 1 + u % right;
        update_tile(G + (r * kOuter + j) * TILE, G + (r * kOuter + k) * TILE,
                    DB + tile_index(j, k, w) * TILE, lane);
      }
      __syncthreads();
    }
    for (int u = warp; u < rows * s; u += kWarps) {  // b_i -= L_ik y_k, k in order
      const int r = u / s, q = u - r * s;
      float* const b = Bv + q * npad + (i0 + r) * NB + lane;
      float v = __ldcg(b);
      for (int k = 0; k < w; ++k)
        v -= dot32<false>(G + (r * kOuter + k) * TILE + lane, Y + (k * kMaxRhs + q) * NB, lane);
      *b = v;
    }
    for (int r = 0; r < rows; ++r)
      for (int k = 0; k < w; ++k)
        store_tile(Wc + (size_t)tile_index(i0 + r, p0 + k, P) * TILE,
                   G + (r * kOuter + k) * TILE, tid);
    pr.mark(1);
  }
}

// Block t of a lower triangle of nb x nb blocks, in column order: block row
// bi, block column bj.
__device__ __forceinline__ void block_at(int t, int nb, int& bi, int& bj) {
  bj = 0;
  while (t >= nb - bj) {
    t -= nb - bj;
    ++bj;
  }
  bi = bj + t;
}

// One depth (32) of a 128 x 128 block product, acc(r, c) += sum_k A(r, k)
// B(c, k), A and B four column-major tiles each (rows 32 u .. 32 u + 31 in
// tile u).  The thread's rows are rows rr .. rr+3 of tiles ta and ta + 1,
// its columns columns cc .. cc+3 of tiles tb and tb + 1: four float4 reads
// of shared memory per 64 FMAs.
__device__ __forceinline__ void block_product(float (&acc)[8][8], const float* A, const float* B,
                                              int ta, int rr, int tb, int cc) {
  const float* const A0 = A + ta * TILE + rr;
  const float* const B0 = B + tb * TILE + cc;
#pragma unroll 2  // 4 spilled more in the epilogue and ran 3-4% slower
  for (int k = 0; k < NB; ++k) {
    const float4 a0 = ld4(A0 + k * NB), a1 = ld4(A0 + TILE + k * NB);
    const float4 b0 = ld4(B0 + k * NB), b1 = ld4(B0 + TILE + k * NB);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] += av[r] * bv[c];
  }
}

// The trailing update of the outer panel at p0 (a full kOuter wide): every
// lower tile (i, j), r0 <= j <= i < P (r0 = p0 + kOuter), A_ij -= sum over
// k < kOuter of L_{i,p0+k} L_{j,p0+k}^T, by blocks of kBlk x kBlk tiles, the
// lower triangle's blocks in column order, block t by rank t mod CS.  In S:
// Bs, the block column's strip rows at every depth (tile (j0+u, p0+k) at
// (k * kBlk + u) * TILE), staged when the column changes; As, two buffers of
// a block row's tiles at one depth (tile (i0+u, p0+k) at (b * kBlk + u) *
// TILE), the next depth (or the next block's first) staged while the
// current one runs; a diagonal block's A is its Bs.  Each pair of warps
// owns a 64 x 64 quadrant (tiles ta, ta + 1 by tb, tb + 1) and skips it
// where none of its tiles is a lower tile before P (the diagonal block's
// upper quadrant, an edge block's rows past P); a tile of a computed
// quadrant past P or above the diagonal is not stored.  The old tile comes
// from Ks in outer panel 0, from the workspace after.
__device__ void large_trailing(float* S, float* Wc, const float* Kc, int n, int P, int p0,
                               int rank, int CS, bool from_k, bool vec, LargeProbe& pr) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warps 2q, 2q+1 take quadrant q; eight lanes read 128 contiguous bytes
  // of A (rr) and one word of B (cc)
  const int ta = 2 * ((warp >> 1) & 1), rr = (lane & 7) * 4;
  const int tb = 2 * (warp >> 2), cc = ((lane >> 3) + 4 * (warp & 1)) * 4;
  float* const Bs = S;
  float* const As = S + kBlk * kOuter * TILE;
  const int r0 = p0 + kOuter, nb = (P - r0 + kBlk - 1) / kBlk, blocks = nb * (nb + 1) / 2;
  // A's tiles of block t at depth k into buffer b (none on a diagonal
  // block or past the last block): one commit group either way
  auto stage_a = [&](int t, int k, int b) {
    if (t < blocks) {
      int bi, bj;
      block_at(t, nb, bi, bj);
      if (bi != bj)
        for (int i = r0 + bi * kBlk, u = 0; u < kBlk && i < P; ++u, ++i)
          cp_async16(As + (b * kBlk + u) * TILE + 4 * tid,
                     Wc + (size_t)tile_index(i, p0 + k, P) * TILE + 4 * tid);
    }
    cp_async_commit();
  };
  int staged_bj = -1, step = 0;
  stage_a(rank, 0, 0);
  for (int t = rank; t < blocks; t += CS) {
    int bi, bj;
    block_at(t, nb, bi, bj);
    const int i0 = r0 + bi * kBlk, j0 = r0 + bj * kBlk;
    if (bj != staged_bj) {  // every warp is past the last product's barrier
      staged_bj = bj;
      for (int k = 0; k < kOuter; ++k)
        for (int j = j0, u = 0; u < kBlk && j < P; ++u, ++j)
          cp_async16(Bs + (k * kBlk + u) * TILE + 4 * tid,
                     Wc + (size_t)tile_index(j, p0 + k, P) * TILE + 4 * tid);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    // the quadrant holds a lower tile before P (uniform in the warp)
    const bool mine = i0 + ta < P && j0 + tb <= min(i0 + ta + 1, P - 1);
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    for (int k = 0; k < kOuter; ++k, ++step) {
      if (k + 1 < kOuter)
        stage_a(t, k + 1, (step + 1) & 1);
      else
        stage_a(t + CS, 0, (step + 1) & 1);
      cp_async_wait<1>();
      __syncthreads();
      pr.mark(7);
      const float* const B = Bs + k * kBlk * TILE;
      if (mine)
        block_product(acc, bi == bj ? B : As + (step & 1) * kBlk * TILE, B, ta, rr, tb, cc);
      __syncthreads();  // buffer step & 1 is free
      pr.mark(2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int i = i0 + ta + h, j = j0 + tb + v;
        if (mine && i < P && j <= i) {
          float* const Wt = Wc + (size_t)tile_index(i, j, P) * TILE;
          float4 old[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            old[c] = from_k ? load4(Kc, n, i * NB + rr, j * NB + cc + c, vec)
                            : ldcg4(Wt + (cc + c) * NB + rr);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int q = 4 * v + c;
            st4(Wt + (cc + c) * NB + rr,
                make_float4(old[c].x - acc[4 * h][q], old[c].y - acc[4 * h + 1][q],
                            old[c].z - acc[4 * h + 2][q], old[c].w - acc[4 * h + 3][q]));
          }
        }
      }
    }
    pr.mark(3);
  }
  cp_async_wait<0>();
}

// v[q] += dot32<transposed>(W, y + q * NB, r) for the right-hand sides q <
// s, with the same partial sums and rounding, each W read once for all.
template <bool transposed>
__device__ __forceinline__ void dot32_rhs(float (&v)[kMaxRhs], const float* W, const float* y,
                                          int s, int r) {
  float p[kMaxRhs][4];
#pragma unroll
  for (int q = 0; q < kMaxRhs; ++q) p[q][0] = p[q][1] = p[q][2] = p[q][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NB / 4; ++kk) {
    const int k = 4 * (transposed ? (kk + r) & (NB / 4 - 1) : kk);
    const float4 w4 = transposed ? ld4(W + k)
                                 : make_float4(W[k * NB], W[(k + 1) * NB], W[(k + 2) * NB],
                                               W[(k + 3) * NB]);
#pragma unroll
    for (int q = 0; q < kMaxRhs; ++q) {
      if (q < s) {
        const float4 y4 = ld4(y + q * NB + k);
        p[q][0] += w4.x * y4.x;
        p[q][1] += w4.y * y4.y;
        p[q][2] += w4.z * y4.z;
        p[q][3] += w4.w * y4.w;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kMaxRhs; ++q) v[q] += (p[q][0] + p[q][1]) + (p[q][2] + p[q][3]);
}

// L L^T X = B in place on Bv ((npad, s) by columns q * npad, global), from
// the factored workspace, by the factor's outer panels of kOuter tile
// columns, with shared memory S: each outer panel costs a few round trips
// to memory instead of one or more a 32-wide panel.  Forward: the block's
// rows first (y_a = Dinv_a (b_a - sum_{b < a} L_ab y_b), one warp a
// right-hand side), then b_i -= sum_k L_ik y_k for the rows below, a warp a
// row, kSolveRows rows a stage (the first staged with the block).
// Backward: the partial sums sum_{i below} L_ik^T x_i first, two warps a
// tile column k, the rows' x beside their tiles, then the block's rows
// (x_a = Dinv_a^T (b_a - partial_a - sum_{b > a} L_ba^T x_b)), the block
// staged with the last rows.  Bv is read through L2 (other CTAs of the
// cluster write parts of it).  Without `forward`, the backward half alone
// (Bv holds L^-1 B).
__device__ void cho_solve_ws(const float* Wc, float* Bv, float* S, int P, int npad, int s,
                             bool forward, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  float* const DB = S;                                    // tile (p0+a, p0+b) at tile_index(a, b, w)
  float* const G = DB + kDiagTiles * TILE;                // row r, depth k at (k kSolveRows + r)
  float* const xs = G + kOuter * kSolveRows * TILE;       // x of row r, q at (r kMaxRhs + q) NB
  float* const part = xs + kSolveRows * kMaxRhs * NB;     // warp w, q at (w kMaxRhs + q) NB
  float* const Y = part + kWarps * kMaxRhs * NB;          // y or x of block row a, q
  float* const tmp = Y + kOuter * kMaxRhs * NB;           // q at q NB
  // n tiles from src into dst, uncommitted
  auto copy = [&](float* dst, const float* src, int ntiles) {
    for (int t = tid; t < ntiles * (TILE / 4); t += kThreads) cp_async16(dst + 4 * t, src + 4 * t);
  };
  auto copy_block = [&](int p0, int w) {
    for (int b = 0; b < w; ++b)
      copy(DB + tile_index(b, b, w) * TILE, Wc + (size_t)tile_index(p0 + b, p0 + b, P) * TILE,
           w - b);
  };
  auto copy_rows = [&](float* dst, int cap, int p0, int w, int i0, int rows) {
    for (int k = 0; k < w; ++k)
      copy(dst + k * cap * TILE, Wc + (size_t)tile_index(i0, p0 + k, P) * TILE, rows);
  };
  for (int p0 = 0; forward && p0 < P; p0 += kOuter) {
    const int w = min(kOuter, P - p0);
    int i0 = p0 + w, rows = max(0, min(kSolveRows, P - i0)), cap = kSolveRows;
    float* Gr = G;
    copy_block(p0, w);
    copy_rows(Gr, cap, p0, w, i0, rows);
    cp_async_commit();
    float bb[kOuter];
#pragma unroll
    for (int a = 0; a < kOuter; ++a)
      bb[a] = warp < s && a < w ? __ldcg(Bv + warp * npad + (p0 + a) * NB + lane) : 0.f;
    cp_async_wait<0>();
    __syncthreads();
    if (warp < s) {
#pragma unroll
      for (int a = 0; a < kOuter; ++a) {
        if (a < w) {
          float v = bb[a];
          for (int b = 0; b < a; ++b)
            v -= dot32<false>(DB + tile_index(a, b, w) * TILE + lane,
                              Y + (b * kMaxRhs + warp) * NB, lane);
          tmp[warp * NB + lane] = v;
          __syncwarp();
          const float y = dot32<false>(DB + tile_index(a, a, w) * TILE + lane, tmp + warp * NB,
                                       lane);
          Y[(a * kMaxRhs + warp) * NB + lane] = y;
          Bv[warp * npad + (p0 + a) * NB + lane] = y;
          __syncwarp();
        }
      }
    }
    __syncthreads();
    while (rows > 0) {
      if (warp < rows) {  // b_i -= sum_k L_ik y_k
        const int i = i0 + warp;
        float bq[kMaxRhs];
#pragma unroll
        for (int q = 0; q < kMaxRhs; ++q) bq[q] = q < s ? __ldcg(Bv + q * npad + i * NB + lane) : 0.f;
        for (int k = 0; k < w; ++k) {  // in panel order, as one panel at a time would
          float v[kMaxRhs];
#pragma unroll
          for (int q = 0; q < kMaxRhs; ++q) v[q] = 0.f;
          dot32_rhs<false>(v, Gr + (k * cap + warp) * TILE + lane, Y + k * kMaxRhs * NB, s, lane);
#pragma unroll
          for (int q = 0; q < kMaxRhs; ++q) bq[q] -= v[q];
        }
#pragma unroll
        for (int q = 0; q < kMaxRhs; ++q)
          if (q < s) Bv[q * npad + i * NB + lane] = bq[q];
      }
      __syncthreads();  // the rows' tiles are free
      i0 += rows;
      // later stages take the block's room too: kWideRows rows
      Gr = S;
      cap = kWideRows;
      rows = max(0, min(cap, P - i0));
      if (rows > 0) {
        copy_rows(Gr, cap, p0, w, i0, rows);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
    }
  }
  for (int p0 = (P - 1) / kOuter * kOuter; p0 >= 0; p0 -= kOuter) {
    const int w = min(kOuter, P - p0);
    const int k = warp & (kOuter - 1), h = warp / kOuter;  // this warp's column, row parity
    float acc[kMaxRhs];
#pragma unroll
    for (int q = 0; q < kMaxRhs; ++q) acc[q] = 0.f;
    for (int i0 = p0 + w, last = 0; !last;) {
      const int rows = max(0, min(kSolveRows, P - i0));
      last = i0 + rows >= P;
      copy_rows(G, kSolveRows, p0, w, i0, rows);
      if (last) copy_block(p0, w);
      cp_async_commit();
      for (int t = tid; t < rows * s * NB; t += kThreads) {  // the rows' x, final
        const int r = t / (s * NB), q = (t / NB) % s, l = t & 31;
        xs[(r * kMaxRhs + q) * NB + l] = __ldcg(Bv + q * npad + (i0 + r) * NB + l);
      }
      cp_async_wait<0>();
      __syncthreads();
      if (k < w)
        for (int r = h; r < rows; r += kWarps / kOuter)
          dot32_rhs<true>(acc, G + (k * kSolveRows + r) * TILE + lane * NB,
                          xs + r * kMaxRhs * NB, s, lane);
      __syncthreads();
      i0 += rows;
    }
#pragma unroll
    for (int q = 0; q < kMaxRhs; ++q)
      if (q < s) part[(warp * kMaxRhs + q) * NB + lane] = acc[q];
    float bb[kOuter];
#pragma unroll
    for (int a = 0; a < kOuter; ++a)
      bb[a] = warp < s && a < w ? __ldcg(Bv + warp * npad + (p0 + a) * NB + lane) : 0.f;
    __syncthreads();
    if (warp < s) {
#pragma unroll
      for (int a = kOuter - 1; a >= 0; --a) {
        if (a < w) {
          float v = bb[a];
          for (int g = a; g < kWarps; g += kOuter) v -= part[(g * kMaxRhs + warp) * NB + lane];
          for (int b = a + 1; b < w; ++b)
            v -= dot32<true>(DB + tile_index(b, a, w) * TILE + lane * NB,
                             Y + (b * kMaxRhs + warp) * NB, lane);
          tmp[warp * NB + lane] = v;
          __syncwarp();
          const float x = dot32<true>(DB + tile_index(a, a, w) * TILE + lane * NB,
                                      tmp + warp * NB, lane);
          Y[(a * kMaxRhs + warp) * NB + lane] = x;
          Bv[warp * npad + (p0 + a) * NB + lane] = x;
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }
}

// The refinement's right-hand side Bv = F - Ks Xv over the full Ks for rows
// i < n of the row groups g = rank, rank + CS, .. of kWarps * kRows rows
// (padded rows get zero): one warp per kRows rows, the lanes across the
// columns, each lane's products added in column order and the lanes'
// sums by a tree, as the small instance's residual does; Xv (written by
// rank 0 before a cluster barrier, and not read before it by the others)
// through L1.  (Four columns a lane by float4 ran no faster and moved X
// further from float64 on the beam's ill-conditioned cells.)
__device__ void residual_ws(const float* __restrict__ Kc, const float* __restrict__ F,
                            const float* Xv, float* Bv, int C, int c, int n, int npad, int s,
                            int rank, int CS, int tid) {
  constexpr int kRows = 4;
  const int lane = tid & 31, warp = tid >> 5;
  for (int g0 = rank * kWarps * kRows; g0 < npad; g0 += CS * kWarps * kRows) {
    const int i0 = g0 + warp * kRows;
    if (i0 >= npad) break;  // uniform in the warp
    float acc[kRows][kMaxRhs];
#pragma unroll
    for (int h = 0; h < kRows; ++h)
#pragma unroll
      for (int q = 0; q < kMaxRhs; ++q) acc[h][q] = 0.f;
#pragma unroll 2
    for (int j = lane; j < n; j += 32) {
      float kv[kRows];
#pragma unroll
      for (int h = 0; h < kRows; ++h)
        kv[h] = i0 + h < n ? __ldg(Kc + (size_t)(i0 + h) * n + j) : 0.f;
#pragma unroll
      for (int q = 0; q < kMaxRhs; ++q) {
        if (q < s) {
          const float x = Xv[q * npad + j];
#pragma unroll
          for (int h = 0; h < kRows; ++h) acc[h][q] += kv[h] * x;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kRows; ++h) {
      const int i = i0 + h;
      const float mine = warp_sum8(acc[h], lane);  // (K Xv)(i, lane) for lane < s
      if (lane < s) Bv[lane * npad + i] = (i < n ? F[((size_t)i * s + lane) * C + c] : 0.f) - mine;
    }
  }
}

// A cell per cluster of CS CTAs, but for the first `apart` clusters, whose
// CTAs solve a cell each (grid apart CS + (C - apart CS) CS): a chunk a
// little over a full wave runs its last cells on CS CTAs each.  W: the cells' packed lower tiles (C x P(P+1)/2 x TILE floats); V:
// per cell the right-hand sides Bv and the first solution Xv ((npad, s)
// each, by columns).  Every CTA of a cluster meets the same cluster
// barriers: the cells of an `apart` cluster have the same P.
__global__ void __launch_bounds__(kThreads, 2)
chol_solve_large_kernel(const float* __restrict__ K, const float* __restrict__ F,
                        float* __restrict__ X, float* __restrict__ W, float* __restrict__ V,
                        int C, int n, int s, int P, int CS, int apart, float eps, bool vec) {
  extern __shared__ float4 smem4[];
  float* const S = reinterpret_cast<float*>(smem4);
  const int npad = P * NB;
  const int g = blockIdx.x / CS, hw = (int)cluster_rank();
  const bool alone = g < apart;
  const int c = alone ? g * CS + hw : apart * CS + (g - apart);
  const int rank = alone ? 0 : hw, cs = alone ? 1 : CS;  // within the cell
  const int tid = threadIdx.x;
  const float* const Kc = K + (size_t)c * n * n;
  float* const Wc = W + (size_t)c * (P * (P + 1) / 2) * TILE;
  float* const Bv = V + (size_t)c * 2 * npad * s;
  float* const Xv = Bv + (size_t)npad * s;
  LargeProbe pr;
  pr.begin();
  if (rank == 0)
    for (int t = tid; t < npad * s; t += kThreads) {
      const int q = t / npad, i = t - q * npad;
      Bv[t] = i < n ? F[((size_t)i * s + q) * C + c] : 0.f;
    }
  cluster_sync();

  // ---- the factor and the first forward substitution, by outer panels of
  // kOuter tile columns ------------------------------------------------------
  for (int p0 = 0; p0 < P; p0 += kOuter) {
    const int w = min(kOuter, P - p0);
    large_strip(S, Wc, Kc, Bv, Xv, n, npad, s, P, p0, w, rank, cs, p0 == 0, vec, eps, pr);
    if (p0 + w == P) break;
    cluster_sync();
    pr.mark(8);
    large_trailing(S, Wc, Kc, n, P, p0, rank, cs, p0 == 0, vec, pr);
    cluster_sync();
    pr.mark(8);
  }

  // ---- rank 0 ends the first solve (backward, from y in Xv) and keeps X;
  // the cell's CTAs split the residual against the full Ks by rows; rank 0
  // solves again --------------------------------------------------------------
  if (rank == 0) {
    for (int t = tid; t < npad * s; t += kThreads) Bv[t] = __ldcg(Xv + t);
    __syncthreads();
    cho_solve_ws(Wc, Bv, S, P, npad, s, false, tid);
    pr.mark(4);
    for (int t = tid; t < npad * s; t += kThreads) Xv[t] = __ldcg(Bv + t);
  }
  cluster_sync();
  pr.mark(8);
  residual_ws(Kc, F, Xv, Bv, C, c, n, npad, s, rank, cs, tid);
  cluster_sync();
  pr.mark(5);
  if (rank != 0) {
    pr.end();
    return;
  }
  cho_solve_ws(Wc, Bv, S, P, npad, s, true, tid);
  pr.mark(4);
  for (int t = tid; t < n * s; t += kThreads) {
    const int i = t / s, q = t - i * s;
    X[(size_t)t * C + c] = __ldcg(Xv + q * npad + i) + __ldcg(Bv + q * npad + i);
  }
  pr.mark(6);
  pr.end();
}

// Dynamic shared memory of one block: the packed lower tiles and two
// (npad, s) right-hand-side arrays (ops/chol_kernel.py::chol_launch_config).
long smem_bytes(int P, int s) {
  return 4L * ((long)P * (P + 1) / 2 * TILE + 2L * P * NB * s);
}

cudaError_t set_attributes(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(chol_solve_f32_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// The large instance's shared memory, the same at every n: the strip's
// diagonal block and one group of rows, which the trailing update's operands
// and the substitutions' staging reuse.
long large_smem_bytes() { return 4L * kLargeTiles * TILE; }

cudaError_t set_large_attributes(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(chol_solve_large_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

void large_launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int ctas, int CS,
                         int smem, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

}  // namespace

extern "C" {

// The launch.  The configuration (threads, P, tile stride, smem) is the
// wrapper's chol_launch_config(n, s); the wrapper has checked device, type
// and shapes.  A configuration this kernel does not run, including a
// shared-memory count that differs from its own, is refused with
// cudaErrorInvalidValue.
int hommx_chol_solve_f32(const float* K, const float* F, float* X, int C, int n, int s,
                         float eps, int threads, int P, int tile_stride, int smem,
                         cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (C <= 0 || n <= 0 || s <= 0 || s > kMaxRhs || threads != kThreads || tile_stride != NB ||
      P != (n + NB - 1) / NB || P > kMaxPanels || smem_bytes(P, s) != smem)
    return bad;
  const cudaError_t err = set_attributes(smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = n % 4 == 0 && reinterpret_cast<std::uintptr_t>(K) % 16 == 0;
  chol_solve_f32_kernel<<<C, kThreads, smem, stream>>>(K, F, X, C, n, s, P, eps, vec);
  return (int)cudaGetLastError();
}

// The large instance: the configuration (threads, P, CS CTAs a cell, outer
// panel width in tile columns, smem) is the wrapper's chol_launch_config(n,
// s, C); W (C x P(P+1)/2 x 1024 floats) and V (C x 2 x 32P x s floats) are
// its workspaces, allocated by the wrapper, 16-byte aligned.  A
// configuration this kernel does not run, including a shared-memory count
// or an outer panel width that differs from its own, is refused with
// cudaErrorInvalidValue.
int hommx_chol_solve_large_f32(const float* K, const float* F, float* X, float* W, float* V,
                               int C, int n, int s, float eps, int threads, int P, int CS,
                               int apart, int outer, int smem, cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (C <= 0 || n <= 0 || s <= 0 || s > kMaxRhs || threads != kThreads ||
      P != (n + NB - 1) / NB || CS < 1 || CS > kMaxCluster || (CS & (CS - 1)) != 0 ||
      apart < 0 || apart * CS > C || outer != kOuter ||
      large_smem_bytes() != smem || reinterpret_cast<std::uintptr_t>(W) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(V) % 16 != 0)
    return bad;
  const cudaError_t err = set_large_attributes(smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = n % 4 == 0 && reinterpret_cast<std::uintptr_t>(K) % 16 == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  large_launch_config(cfg, attr, apart * CS + (C - apart * CS) * CS, CS, smem, stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, chol_solve_large_kernel, K, F, X, W, V, C, n,
                                           s, P, CS, apart, eps, vec);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The large instance's occupancy: CTAs resident on one SM, and clusters of
// CS CTAs the card holds at once (cudaOccupancyMaxActiveClusters).
int hommx_chol_large_occupancy(int CS, int smem, int* blocks_per_sm, int* clusters) {
  cudaError_t err = set_large_attributes(smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, chol_solve_large_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  large_launch_config(cfg, attr, CS, CS, smem, 0);
  return (int)cudaOccupancyMaxActiveClusters(clusters, chol_solve_large_kernel, &cfg);
}

// Blocks of the kernel resident on one SM at ``smem`` bytes of dynamic
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor) into *out.
int hommx_chol_blocks_per_sm(int smem, int* out) {
  const cudaError_t err = set_attributes(smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, chol_solve_f32_kernel, kThreads,
                                                            smem);
}

#ifdef K3_PROBE
// The probe's per-block cycle counts (K3_PROBE_CELLS x 8 int64) into dst.
int hommx_k3_phases(void* dst, cudaStream_t stream) {
  return (int)cudaMemcpyFromSymbolAsync(dst, g_k3_cycles, sizeof(g_k3_cycles), 0,
                                        cudaMemcpyDeviceToDevice, stream);
}

// The large instance's per-CTA records (K3_PROBE_CELLS x 12 int64: ten
// phases' cycles, start and end in ns) into dst.
int hommx_k3_large_phases(void* dst, cudaStream_t stream) {
  return (int)cudaMemcpyFromSymbolAsync(dst, g_k3l, sizeof(g_k3l), 0, cudaMemcpyDeviceToDevice,
                                        stream);
}
#endif

}  // extern "C"
