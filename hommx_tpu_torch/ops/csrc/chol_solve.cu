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
// cubes, the 13^2-16^2 squares and up), with the same algorithm, layouts
// and helpers.  A cell's packed lower tiles do not fit on chip (338 KB at
// n = 375, 4.7 MB at n = 1536), so they live in a per-cell global workspace
// that the wrapper allocates; the right-hand sides and the first solution
// live beside them.  Per panel p:
// - every CTA of the cell loads Dinv_p (tile (p, p) of the workspace);
// - the panel tiles L_ip = A_ip Dinv_p^T are split over the cell's workers
//   (warps of all its CTAs), computed in shared memory and written back;
// - the trailing update A_ij -= L_ip L_jp^T streams each tile through
//   registers (read, subtract, write: the workspace is read-modify-written
//   through L2), with L_ip and L_jp staged in shared memory: the whole
//   column when its m = P-1-p tiles fit the 24-tile region, else in parts,
//   a J window of 16 tiles against I windows of 8 below it.  Worker 0
//   (warp 0 of rank 0) takes tile (p+1, p+1) alone, factors it at once and
//   stores Dinv_{p+1}, as warp 0 does in the small instance.
// Panel 0 reads its tiles straight from Ks (the upper triangle, with the
// identity padding written on load), so Ks is copied into the workspace by
// its first trailing update, not by a pass of its own.
// Where a chunk has fewer cells than the card has SMs, a cell is a cluster
// of CS CTAs (1, 2, 4 or 8) that split the panel tiles and the trailing
// update; two cluster barriers a panel order the workspace (every read of it
// goes through L2: cp.async.cg, ld.global.cg).  No mbarrier is waited on.
// Rank 0 then runs the substitutions (the small instance's warp products on
// tiles staged from the workspace, 16 at a time: forward right-looking,
// backward left-looking, both down one contiguous tile column per panel)
// and the refinement residual against the full Ks, and writes X.
// Shared memory is 26 tiles (106,496 B) at every n, so two CTAs share an
// SM.  What bounds it: the factor's n^3/3 FLOP at the FP32 rate and the
// workspace's ~P^3/6 tile read-modify-writes (8 KB each; 151 MB a cell at
// n = 1536), which at chunk sizes spill L2 to HBM.  Where the time goes
// (tools/k3_probe.py --large, H100): on the 6^3 beam's 309-cell chunk the
// trailing update takes ~60% of a CTA's cycles, the substitutions ~19% and
// the residual ~10%; for one 8^3 cell on 8 CTAs, rank 0's substitutions and
// residual take ~42% of its cycles while the other ranks have finished.
// More CTAs a cell than the fewest that give every SM one ran slower.

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

// The large instance: a staging region of kStage tiles, split into a J
// window of kStage - kWinB tiles and I windows of kWinB where a panel's
// column does not fit it whole; kSolveTiles tiles at a time in the
// substitutions; at most kMaxCluster CTAs a cell.
constexpr int kStage = 24;
constexpr int kWinB = 8;
constexpr int kSolveTiles = 16;
constexpr int kLargeTiles = kStage + 2;  // + Dinv_p and worker 0's diagonal tile
constexpr int kMaxCluster = 8;

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

// Rows gi .. gi+7 of the padded operator's column gj, from K[gj][gi ..]
// (symmetric Ks, row-major): what load_chunk loads, into registers.
__device__ __forceinline__ void load8(float (&v)[8], const float* Kc, int n, int gi, int gj,
                                      bool vec) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g0 = gi + 4 * h;
    if (vec && gj < n && g0 < n) {  // n % 4 == 0: the four are inside or outside whole
      const float4 x = __ldg(reinterpret_cast<const float4*>(Kc + (size_t)gj * n + g0));
      v[4 * h] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = g0 + e;
        v[4 * h + e] = gj < n && g < n ? __ldg(Kc + (size_t)gj * n + g) : (g == gj ? 1.f : 0.f);
      }
    }
  }
}

// One warp: tile (I, J) of the padded operator into dst (column-major) by
// cp.async, from Ks (from_k: panel 0, before any update) or from the
// workspace tile Wt; the caller commits and waits.
__device__ __forceinline__ void warp_fetch_tile(float* dst, const float* Kc, const float* Wt,
                                                int n, int I, int J, bool from_k, bool vec,
                                                int lane) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int t = lane + 32 * e, lc = t >> 3, lr = (t & 7) * 4;  // 4 t = lc * NB + lr
    if (from_k)
      load_chunk(dst + 4 * t, Kc, n, I * NB + lr, J * NB + lc, vec);
    else
      cp_async16(dst + 4 * t, Wt + 4 * t);
  }
}

__device__ __forceinline__ void warp_store_tile(float* dst, const float* src, int lane) {
#pragma unroll
  for (int e = 0; e < 8; ++e) st4(dst + 4 * (lane + 32 * e), ld4(src + 4 * (lane + 32 * e)));
}

// The block: tiles (a .. b-1, p), contiguous in the workspace's tile column
// p, into dst by cp.async (committed; the caller waits).
__device__ __forceinline__ void stage_tiles(float* dst, const float* Wc, int P, int p, int a,
                                            int b, int tid) {
  const float* src = Wc + (size_t)tile_index(a, p, P) * TILE;
  for (int t = tid; t < (b - a) * (TILE / 4); t += kThreads) cp_async16(dst + 4 * t, src + 4 * t);
  cp_async_commit();
}

// One warp, tile (I, J) of the trailing update: A_IJ - Li Lj^T, with A_IJ
// read from Ks (from_k) or the workspace tile Wt and the result written to
// dst, the workspace tile (global) or, for the diagonal tile that worker 0
// factors next, shared memory; A's loads are issued before the product.
__device__ void update_tile_ws(float* dst, const float* Li, const float* Lj, const float* Kc,
                               const float* Wt, int n, int I, int J, bool from_k, bool vec,
                               int lane) {
  int r0, c0;
  lane_block(lane, r0, c0);
  float old[4][8];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (from_k) {
      load8(old[c], Kc, n, I * NB + r0, J * NB + c0 + c, vec);
    } else {
      const float* col = Wt + (c0 + c) * NB + r0;
      const float4 x0 = ldcg4(col), x1 = ldcg4(col + 4);
      old[c][0] = x0.x, old[c][1] = x0.y, old[c][2] = x0.z, old[c][3] = x0.w;
      old[c][4] = x1.x, old[c][5] = x1.y, old[c][6] = x1.z, old[c][7] = x1.w;
    }
  }
  float acc[8][4];
  tile_product(acc, Li, Lj, r0, c0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float* col = dst + (c0 + c) * NB + r0;
    st4(col, make_float4(old[c][0] - acc[0][c], old[c][1] - acc[1][c], old[c][2] - acc[2][c],
                         old[c][3] - acc[3][c]));
    st4(col + 4, make_float4(old[c][4] - acc[4][c], old[c][5] - acc[5][c],
                             old[c][6] - acc[6][c], old[c][7] - acc[7][c]));
  }
}

// L L^T X = B in place on Bv ((npad, s) by columns q * npad, global), from
// the factored workspace; the block, with R (kStage tiles) and D (one tile)
// of shared memory.  Forward right-looking: y_p = Dinv_p b_p, then
// b_i -= L_ip y_p for i > p; backward left-looking: x_p = Dinv_p^T (b_p -
// sum_{i > p} L_ip^T x_i).  Both walk tile column p, kSolveTiles tiles at a
// time, one warp a tile for all s right-hand sides.
__device__ void cho_solve_ws(const float* Wc, float* Bv, float* R, float* D, int P, int npad,
                             int s, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  float* const xseg = R + kSolveTiles * TILE;   // kSolveTiles x kMaxRhs x 32
  float* const part = xseg + kSolveTiles * kMaxRhs * NB;  // kWarps x kMaxRhs x 32
  float* const yin = part + kWarps * kMaxRhs * NB;         // kMaxRhs x 32
  float* const yout = yin + kMaxRhs * NB;                  // kMaxRhs x 32
  for (int p = 0; p < P; ++p) {
    stage_tiles(D, Wc, P, p, p, p + 1, tid);
    if (tid < s * NB) yin[tid] = Bv[(tid >> 5) * npad + p * NB + (tid & 31)];
    cp_async_wait<0>();
    __syncthreads();
    if (warp < s) {
      const float y = dot32<false>(D + lane, yin + warp * NB, lane);
      yout[warp * NB + lane] = y;
      Bv[warp * npad + p * NB + lane] = y;
    }
    for (int a = p + 1; a < P; a += kSolveTiles) {
      const int b = min(a + kSolveTiles, P);
      stage_tiles(R, Wc, P, p, a, b, tid);
      cp_async_wait<0>();
      __syncthreads();  // also: yout is written
      for (int i = a + warp; i < b; i += kWarps) {
        const float* const T = R + (i - a) * TILE + lane;
        for (int q = 0; q < s; ++q)
          Bv[q * npad + i * NB + lane] -= dot32<false>(T, yout + q * NB, lane);
      }
      __syncthreads();
    }
    __syncthreads();
  }
  for (int p = P - 1; p >= 0; --p) {
    float acc[kMaxRhs];
#pragma unroll
    for (int q = 0; q < kMaxRhs; ++q) acc[q] = 0.f;
    stage_tiles(D, Wc, P, p, p, p + 1, tid);
    for (int a = p + 1; a < P; a += kSolveTiles) {
      const int b = min(a + kSolveTiles, P);
      stage_tiles(R, Wc, P, p, a, b, tid);
      for (int t = tid; t < (b - a) * s * NB; t += kThreads) {
        const int k = t / (s * NB), q = (t / NB) % s, r = t & 31;
        xseg[(k * kMaxRhs + q) * NB + r] = Bv[q * npad + (a + k) * NB + r];
      }
      cp_async_wait<0>();
      __syncthreads();
      for (int i = a + warp; i < b; i += kWarps) {
        const float* const T = R + (i - a) * TILE + lane * NB;
#pragma unroll
        for (int q = 0; q < kMaxRhs; ++q)
          if (q < s) acc[q] += dot32<true>(T, xseg + ((i - a) * kMaxRhs + q) * NB, lane);
      }
      __syncthreads();
    }
#pragma unroll
    for (int q = 0; q < kMaxRhs; ++q)
      if (q < s) part[(warp * kMaxRhs + q) * NB + lane] = acc[q];
    if (tid < s * NB) yin[tid] = Bv[(tid >> 5) * npad + p * NB + (tid & 31)];
    cp_async_wait<0>();
    __syncthreads();
    if (warp < s) {
      float r = yin[warp * NB + lane];
      for (int w = 0; w < kWarps; ++w) r -= part[(w * kMaxRhs + warp) * NB + lane];
      yout[warp * NB + lane] = r;
      __syncwarp();
      Bv[warp * npad + p * NB + lane] = dot32<true>(D + lane * NB, yout + warp * NB, lane);
    }
    __syncthreads();
  }
}

// The refinement's right-hand side Bv = F - Ks Xv over the full Ks (rows
// i < n; padded rows get zero), one warp per kRows rows, the lanes across
// the columns, Xv read from global memory (written by this block).
__device__ void residual_ws(const float* __restrict__ Kc, const float* __restrict__ F,
                            const float* Xv, float* Bv, int C, int c, int n, int npad, int s,
                            int tid) {
  constexpr int kRows = 4;
  const int lane = tid & 31, warp = tid >> 5;
  for (int i0 = warp * kRows; i0 < npad; i0 += kWarps * kRows) {
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

// One cell per cluster of CS CTAs (grid C * CS).  W: the cells' packed
// lower tiles (C x P(P+1)/2 x TILE floats); V: per cell the right-hand
// sides Bv and the first solution Xv ((npad, s) each, by columns).
__global__ void __launch_bounds__(kThreads, 2)
chol_solve_large_kernel(const float* __restrict__ K, const float* __restrict__ F,
                        float* __restrict__ X, float* __restrict__ W, float* __restrict__ V,
                        int C, int n, int s, int P, int CS, float eps, bool vec) {
  extern __shared__ float4 smem4[];
  float* const D = reinterpret_cast<float*>(smem4);  // Dinv_p
  float* const E = D + TILE;                         // worker 0's diagonal tile
  float* const R = E + TILE;                         // kStage tiles
  const int npad = P * NB;
  const int c = blockIdx.x / CS;
  const int rank = (int)cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NW = CS * kWarps, gw = warp * CS + rank;  // workers of the cell; 0: rank 0, warp 0
  const float* const Kc = K + (size_t)c * n * n;
  float* const Wc = W + (size_t)c * (P * (P + 1) / 2) * TILE;
  K3_MARK_START

  // Dinv_0, in every CTA
  {
    const int lc = tid >> 3, lr = (tid & 7) * 4;
    load_chunk(D + lc * NB + lr, Kc, n, lr, lc, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (warp == 0) factor_diag(D, lane, eps);
    __syncthreads();
    if (rank == 0 && warp == 0) warp_store_tile(Wc, D, lane);
  }
  K3_MARK(0)

  for (int p = 0; p + 1 < P; ++p) {
    const bool from_k = p == 0;  // panel 0 reads Ks
    if (p > 0) {
      stage_tiles(D, Wc, P, p, p, p + 1, tid);
      cp_async_wait<0>();
      __syncthreads();
    }
    K3_MARK(1)
    // panel tiles L_ip = A_ip Dinv_p^T, i > p, one worker each
    for (int i = p + 1 + gw; i < P; i += NW) {
      float* const S = R + warp * TILE;
      float* const Wt = Wc + (size_t)tile_index(i, p, P) * TILE;
      warp_fetch_tile(S, Kc, Wt, n, i, p, from_k, vec, lane);
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
      panel_tile(S, D, lane);
      __syncwarp();
      warp_store_tile(Wt, S, lane);
      __syncwarp();
    }
    cluster_sync();
    K3_MARK(2)
    // trailing update, p < j <= i < P, by windows of staged panel tiles
    const int m = P - 1 - p;
    const int wa = m <= kStage ? m : kStage - kWinB;
    for (int ja = p + 1; ja < P; ja += wa) {
      const int jb = min(ja + wa, P), w = jb - ja;
      stage_tiles(R, Wc, P, p, ja, jb, tid);
      cp_async_wait<0>();
      __syncthreads();
      K3_MARK(7)
      const bool first = ja == p + 1;
      int u0 = gw, du = NW;
      if (first) {
        if (gw == 0) {  // tile (p+1, p+1): update, factor, store Dinv_{p+1}
          update_tile_ws(E, R, R, Kc, Wc + (size_t)tile_index(p + 1, p + 1, P) * TILE, n,
                         p + 1, p + 1, from_k, vec, lane);
          __syncwarp();
          factor_diag(E, lane, eps);
          __syncwarp();
          warp_store_tile(Wc + (size_t)tile_index(p + 1, p + 1, P) * TILE, E, lane);
          u0 = w * (w + 1) / 2;  // no more of this triangle
        } else {
          u0 = gw;
          du = NW - 1;
        }
      }
      for (int u = u0; u < w * (w + 1) / 2; u += du) {
        int jj = 0, ii = u;
        while (ii >= w - jj) {
          ii -= w - jj;
          ++jj;
        }
        const int i = ja + jj + ii, j = ja + jj;
        float* const Wt = Wc + (size_t)tile_index(i, j, P) * TILE;
        update_tile_ws(Wt, R + (i - ja) * TILE, R + (j - ja) * TILE, Kc, Wt, n, i, j, from_k,
                       vec, lane);
      }
      K3_MARK(3)
      float* const RB = R + wa * TILE;
      int b = 0;
      for (int ia = jb; ia < P; ia += kWinB, ++b) {
        if (b % CS != rank) continue;  // uniform in the CTA
        const int ib = min(ia + kWinB, P);
        __syncthreads();  // RB is free
        stage_tiles(RB, Wc, P, p, ia, ib, tid);
        cp_async_wait<0>();
        __syncthreads();
        K3_MARK(7)
        for (int u = warp; u < (ib - ia) * w; u += kWarps) {
          const int i = ia + u / w, j = ja + u % w;
          float* const Wt = Wc + (size_t)tile_index(i, j, P) * TILE;
          update_tile_ws(Wt, RB + (i - ia) * TILE, R + (j - ja) * TILE, Kc, Wt, n, i, j, from_k,
                         vec, lane);
        }
        K3_MARK(3)
      }
      __syncthreads();  // R is free
    }
    cluster_sync();
    K3_MARK(3)
  }
  if (rank != 0) {
    K3_MARK_END
    return;
  }

  // ---- rank 0: solve, keep X, residual against the full Ks, solve again --
  float* const Bv = V + (size_t)c * 2 * npad * s;
  float* const Xv = Bv + (size_t)npad * s;
  for (int t = tid; t < npad * s; t += kThreads) {
    const int q = t / npad, i = t - q * npad;
    Bv[t] = i < n ? F[((size_t)i * s + q) * C + c] : 0.f;
  }
  __syncthreads();
  cho_solve_ws(Wc, Bv, R, D, P, npad, s, tid);
  K3_MARK(4)
  for (int t = tid; t < npad * s; t += kThreads) Xv[t] = Bv[t];
  __syncthreads();
  residual_ws(Kc, F, Xv, Bv, C, c, n, npad, s, tid);
  __syncthreads();
  K3_MARK(5)
  cho_solve_ws(Wc, Bv, R, D, P, npad, s, tid);
  K3_MARK(4)
  for (int t = tid; t < n * s; t += kThreads) {
    const int i = t / s, q = t - i * s;
    X[(size_t)t * C + c] = Xv[q * npad + i] + Bv[q * npad + i];
  }
  K3_MARK(6)
  K3_MARK_END
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

// The large instance's shared memory, the same at every n: the staging
// region, Dinv_p and worker 0's diagonal tile.
long large_smem_bytes() { return 4L * kLargeTiles * TILE; }

cudaError_t set_large_attributes(int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(chol_solve_large_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

void large_launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int C, int CS,
                         int smem, cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(C * CS);
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

// The large instance: the configuration (threads, P, CS CTAs a cell, smem)
// is the wrapper's chol_launch_config(n, s, C); W (C x P(P+1)/2 x 1024
// floats) and V (C x 2 x 32P x s floats) are its workspaces, allocated by
// the wrapper, 16-byte aligned.  A configuration this kernel does not run,
// including a shared-memory count that differs from its own, is refused
// with cudaErrorInvalidValue.
int hommx_chol_solve_large_f32(const float* K, const float* F, float* X, float* W, float* V,
                               int C, int n, int s, float eps, int threads, int P, int CS,
                               int smem, cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (C <= 0 || n <= 0 || s <= 0 || s > kMaxRhs || threads != kThreads ||
      P != (n + NB - 1) / NB || CS < 1 || CS > kMaxCluster || (CS & (CS - 1)) != 0 ||
      large_smem_bytes() != smem || reinterpret_cast<std::uintptr_t>(W) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(V) % 16 != 0)
    return bad;
  const cudaError_t err = set_large_attributes(smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = n % 4 == 0 && reinterpret_cast<std::uintptr_t>(K) % 16 == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  large_launch_config(cfg, attr, C, CS, smem, stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, chol_solve_large_kernel, K, F, X, W, V, C, n,
                                           s, P, CS, eps, vec);
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
  large_launch_config(cfg, attr, 1, CS, smem, 0);
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
#endif

}  // extern "C"
