// Fused lockstep block-PCG for the periodic-stencil micro cell problems.
//
// Replaces the TPU kernel hommx_tpu/micro/stencil_pcg.py::_pcg_kernel
// (called through stencil_pcg_pallas).  One launch solves K X = F for a
// whole chunk of cells; the Krylov loop runs inside the kernel.
//
//   ws   (K, n, Cp)  stencil weights (diagonal scaling already folded in)
//   F    (s, n, Cp)  right-hand sides
//   Minv (n, n)      shared dense preconditioner (K0^-1)
//   nbr  (K, n)      torus neighbour table: roll(P, -D_k)[p] = P[nbr[k, p]]
//   out  (s, n, Cp)  best iterate (unclamped); iters (Cp / CB,) per block
//
// Grid: one block per CB cells.  Each block runs its own while-loop and
// stop test, as each Pallas grid step runs its own while_loop; the wrapper
// returns the max count over blocks.  Semantics per column are those of
// _chunk_pcg_raw: breakdown guard, converged-column freeze (brel < tol),
// best-iterate tracking with a 1-1e-4 shrink, stall cap 60, lockstep stop
// on the block's max relative residual (a NaN residual stops the block).
//
// Bound on this card: the preconditioner product Z = Minv R, 2 n^2 s flops
// per cell and iteration (n = 256: ~260 kFLOP vs ~7 kFLOP for the stencil
// matvec), in full-f32 FMA (no TF32, no library call).  Per block and apply
// it is a GEMM Z[:, cols] = Minv R[:, cols] with cols = s CB columns
// (column j = i CB + c: right-hand side i of cell c):
//
//  - R and the search direction P live in shared memory, laid out [row][j],
//    so a thread reads 4 columns of one row as one float4;
//  - Minv is streamed through shared memory in k-slabs of n rows x BK
//    columns with cp.async into two buffers, so the load of slab k+1
//    overlaps the FMAs on slab k (a third buffer measured no faster); a
//    slab row is padded to BKP floats so the float4 reads of 8 consecutive
//    rows hit distinct banks;
//  - each thread owns a register tile of TM rows (p = rg + RG u) x 4
//    columns; its TM x 4 accumulators take TM + 4 shared loads per 16 TM
//    FMAs.  A warp spans WC column groups (up to 8) and 32 / WC rows, so a
//    quarter-warp's loads of R are 8 distinct float4 and of Minv at most
//    a few distinct rows;
//  - Z never leaves the registers: the owner takes its partial sums of
//    <R, Z> and <R, R> from them and, after the block reduction gives beta,
//    writes P = Z + beta P in place.  X stays in registers too, and best X
//    is written from them where a column improved: no global read in the
//    loop but the stencil weights.  The stencil matvec gathers its K
//    neighbours of P from shared memory through the neighbour table; the
//    weights and the table are read through the read-only cache (the
//    chunk's weights stay L2-resident), all TM rows of a k at once.
//
// Column sums: warp shuffles over the rows of a warp, then one shared slot
// per (row block, column group); warp 0 makes every per-column update and
// the stop decision.  The launch configuration (CB, threads, dynamic
// shared bytes) comes from the wrapper
// (stencil_pcg.py::launch_config); the launcher checks it against its own
// count of the shared memory and refuses a mismatch.
//
// The large instance (stencil_pcg_large_kernel) takes n above the small
// one's reach (1198, 1024, 896 at s = 1, 2, 3) up to 4096: the 64² square,
// the 16³ cube.  There Minv (up to 64 MB) no longer fits beside a block's
// vectors, and a design that streams all of Minv through every block of 16
// columns is bound by the rate at which an SM takes in Minv (PR 17's, in
// PERF.md): each Minv float feeds 16 FMAs.  So the product no longer
// follows the stop blocks:
//
//  - One cooperative launch of co-resident CTAs runs the chunk's whole PCG
//    in phases split by a grid barrier (each CTA releases a flag, the first
//    CTA acquires them all and releases a generation word; a wait past
//    ~2^34 cycles traps): the product Z = Minv R; K P and its dots; the
//    updates of X and R; the stop decisions and the new direction.
//  - The product is one GEMM over the chunk's columns, across blocks: tiles
//    of 128 rows x BN columns (128 at s = 1, 2, 48 at s = 3: whole blocks)
//    with 8 x 8 accumulators a thread (16 FMAs a float4 read from shared
//    memory).  Minv (pre-tiled, [row tile][k tile][k][row]) and R ([column
//    tile][row][BN]) come in 16-k tiles through a ring of stages that one
//    lane fills with cp.async.bulk copies (full barriers count the bytes,
//    used barriers the warps).  Each Minv float a CTA takes in feeds BN
//    FMAs.  The tiles' k tiles are split evenly over the CTAs (stream-K),
//    so no CTA waits on a last tile; the CTA that completes a tile adds its
//    k pieces up in order.  Column tiles whose blocks have all stopped are
//    skipped.
//  - The vector passes split the rows of the running blocks evenly over the
//    CTAs the same way; the stencil gathers P's neighbour rows through L2.
//    R, P, X, K P and the product's pieces live in a per-chunk state in
//    global memory in the column-tile layout; the best X goes to the
//    output directly.
//  - Dots: every tile and segment writes its column sums; the CTA that
//    completes a column tile (a block) adds them up in row order, so every
//    CTA takes the same stop decision for a block and two identical
//    launches are bitwise equal.  The block's first segment owns its
//    per-block state (stall count, iterations, the iteration it stopped
//    at); per-column scalars are kept by parity, so a phase never writes
//    what another CTA may still read.
//  - The product stays in the kernel's own full-f32 FMAs (2 n^2 s flops a
//    cell and iteration): no TF32, no library call.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_S = 3;       // scalar P1: s = d <= 3
constexpr int MAX_NC = 64;     // columns per block: s * CB <= 48
constexpr int BK = 16;         // Minv columns per k-slab
constexpr int BKP = BK + 4;    // padded slab row (80 B)
constexpr int SLABS = 2;       // Minv slab buffers
constexpr int STALL_CAP = 60;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
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
__device__ __forceinline__ float4 mk4(const float (&a)[4]) {
  return make_float4(a[0], a[1], a[2], a[3]);
}

// column groups a warp spans: the largest power of two <= 8 dividing CG
__host__ __device__ __forceinline__ int warp_cols(int CG) {
  return (CG & 7) == 0 ? 8 : (CG & 3) == 0 ? 4 : (CG & 1) == 0 ? 2 : 1;
}

// Minv[:, k0:k0+BK] -> Ms[p * BKP + kk]; columns past n are zero-filled.
__device__ __forceinline__ void load_slab(float* Ms, const float* __restrict__ Minv, int n,
                                          int k0, bool vec) {
  if (vec) {  // n % 4 == 0: rows are 16-byte aligned
    for (int e = threadIdx.x; e < n * (BK / 4); e += blockDim.x) {
      const int p = e / (BK / 4), kk = 4 * (e % (BK / 4));
      const bool ok = k0 + kk < n;
      cp_async16(Ms + p * BKP + kk, Minv + (size_t)p * n + (ok ? k0 + kk : 0), ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * BK; e += blockDim.x) {
      const int p = e / BK, kk = e % BK;
      const bool ok = k0 + kk < n;
      cp_async4(Ms + p * BKP + kk, Minv + (size_t)p * n + (ok ? k0 + kk : 0), ok);
    }
  }
}

// acc[u][:] = (Minv R)[rg + RG u, j0:j0+4].  R is read from Rs (npad rows,
// rows n..npad zero); the caller has synchronised since Rs was written.
template <int TM>
__device__ __forceinline__ void prec_tile(const float* __restrict__ Minv, const float* Rs,
                                          float* Ms, int n, int NC, int rg, int RG, int j0,
                                          float (&acc)[TM][4]) {
  const int nkt = (n + BK - 1) / BK;
  const bool vec = (n & 3) == 0;
  const int slab = n * BKP;
  int prow[TM];
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    prow[u] = min(rg + RG * u, n - 1) * BKP;  // rows past n: computed, never stored
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  }
  load_slab(Ms, Minv, n, 0, vec);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    cp_async_wait<0>();  // this thread's copies of slab kt
    __syncthreads();     // everyone's; and every thread is past slab kt - 1
    if (kt + 1 < nkt) load_slab(Ms + ((kt + 1) % SLABS) * slab, Minv, n, (kt + 1) * BK, vec);
    cp_async_commit();
    const float* M = Ms + (kt % SLABS) * slab;
    const float* R = Rs + (size_t)kt * BK * NC + j0;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int u = 0; u < TM; ++u) a[u] = ld4(M + prow[u] + kk);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float4 r = ld4(R + (kk + d) * NC);
#pragma unroll
        for (int u = 0; u < TM; ++u) {
          const float m = d == 0 ? a[u].x : d == 1 ? a[u].y : d == 2 ? a[u].z : a[u].w;
          acc[u][0] = fmaf(m, r.x, acc[u][0]);
          acc[u][1] = fmaf(m, r.y, acc[u][1]);
          acc[u][2] = fmaf(m, r.z, acc[u][2]);
          acc[u][3] = fmaf(m, r.w, acc[u][3]);
        }
      }
    }
  }
}

// acc[u][:] = (K P)[p, j0:j0+4] = sum_k ws[k, p, cells] * P[nbr[k, p], j0:j0+4]
// for the rows p = rg + RG u (rows past n: row n - 1, never stored); P is
// read from Ps.  The loads of all TM rows of one k are issued together.
template <int TM>
__device__ __forceinline__ void matvec_tile(const float* __restrict__ ws,
                                            const int* __restrict__ nbr, const float* Ps,
                                            int K, int n, int NC, int Cp, size_t col0, int rg,
                                            int RG, int j0, float (&acc)[TM][4]) {
  int prow[TM];
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    prow[u] = min(rg + RG * u, n - 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  }
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float4 w[TM];
    int q[TM];
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const size_t row = (size_t)k * n + prow[u];
      w[u] = __ldg(reinterpret_cast<const float4*>(ws + row * Cp + col0));
      q[u] = __ldg(nbr + row);
    }
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const float4 v = ld4(Ps + q[u] * NC + j0);
      acc[u][0] = fmaf(w[u].x, v.x, acc[u][0]);
      acc[u][1] = fmaf(w[u].y, v.y, acc[u][1]);
      acc[u][2] = fmaf(w[u].z, v.z, acc[u][2]);
      acc[u][3] = fmaf(w[u].w, v.w, acc[u][3]);
    }
  }
}

// Sums of Q x 4 per-thread column partials over the rows of the warp ->
// red[(slot Q + q) 4 + e], slot = (row block, column group).  The lanes of
// one column group are lane % WC.
template <int Q>
__device__ __forceinline__ void stash(float (&part)[Q][4], float* red, int WC, int slot) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = part[q][e];
      for (int off = WC; off < 32; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
      if (lane < WC) red[(slot * Q + q) * 4 + e] = v;
    }
  }
}

// Column j's sum of quantity q over the RB row blocks.
__device__ __forceinline__ float colsum(const float* red, int Q, int q, int j, int RB, int CG) {
  const int e = j & 3, cg = j >> 2;
  float sum = 0.f;
  for (int rb = 0; rb < RB; ++rb) sum += red[((rb * CG + cg) * Q + q) * 4 + e];
  return sum;
}

template <int TM>
__global__ void __launch_bounds__(TM >= 8 ? 384 : 512)
stencil_pcg_kernel(const float* __restrict__ ws, const float* __restrict__ F,
                   const float* __restrict__ Minv, const int* __restrict__ nbr,
                   float* __restrict__ bX, int* __restrict__ iters, int K, int n, int s,
                   int Cp, int CB, float tol, int maxiter) {
  extern __shared__ float4 smem4[];
  __shared__ float fnorm_s[MAX_NC], rel_s[MAX_NC], brel_s[MAX_NC], rz_s[MAX_NC];
  __shared__ float alpha_s[MAX_NC], beta_s[MAX_NC];
  __shared__ int imp_s[MAX_NC];
  __shared__ int cont_s, stall_s, k_s;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int NC = s * CB, CG = NC / 4, RG = blockDim.x / CG;
  const int WC = warp_cols(CG), WR = 32 / WC, RB = RG / WR, CGB = CG / WC;
  const int cg = (warp % CGB) * WC + lane % WC;  // column group: columns j0..j0+3
  const int rg = (warp / CGB) * WR + lane / WC;  // rows rg + RG u
  const int slot = (warp / CGB) * CG + cg;
  const int j0 = 4 * cg, i0 = j0 / CB;
  const size_t col0 = (size_t)blockIdx.x * CB + j0 % CB;
  const int npad = ((n + BK - 1) / BK) * BK;
  const float shrink = 1.0f - 1e-4f;
  float* const Rs = reinterpret_cast<float*>(smem4);  // npad x NC residual
  float* const Ps = Rs + npad * NC;                    // n x NC search direction
  float* const Ms = Ps + n * NC;                       // SLABS x n x BKP Minv slabs
  float* const red = Ms + SLABS * n * BKP;             // RB x CG x 2 x 4 partial sums
  auto gidx = [&](int p) { return ((size_t)i0 * n + p) * Cp + col0; };

  // warp 0: the lockstep stop test on the block's worst column
  auto decide = [&](float m, int nan, int any, bool step) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    nan = __any_sync(FULL, nan);
    any = __any_sync(FULL, any);
    if (lane == 0) {
      if (step) {
        stall_s = any ? 0 : stall_s + 1;
        k_s += 1;
      } else {
        stall_s = 0;
        k_s = 0;
      }
      cont_s = (!nan && m > tol && k_s < maxiter && stall_s < STALL_CAP) ? 1 : 0;
    }
  };

  float acc[TM][4], x[TM][4];

  // R = F
  for (int e = t; e < (npad - n) * NC; e += blockDim.x) Rs[n * NC + e] = 0.f;
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int p = rg + RG * u;
    if (p < n) st4(Rs + p * NC + j0, __ldg(reinterpret_cast<const float4*>(F + gidx(p))));
  }
  __syncthreads();

  // X = prec(F); best X = X; X into Ps for the residual's matvec
  prec_tile<TM>(Minv, Rs, Ms, n, NC, rg, RG, j0, x);
#pragma unroll
  for (int u = 0; u < TM; ++u) {
    const int p = rg + RG * u;
    if (p < n) {
      st4(bX + gidx(p), mk4(x[u]));
      st4(Ps + p * NC + j0, mk4(x[u]));
    }
  }
  __syncthreads();

  // R = F - K X (in Rs); |F|^2, |R|^2
  {
    matvec_tile<TM>(ws, nbr, Ps, K, n, NC, Cp, col0, rg, RG, j0, acc);
    float part[2][4] = {};
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int p = rg + RG * u;
      if (p < n) {
        const float4 f4 = ld4(Rs + p * NC + j0);
        const float f[4] = {f4.x, f4.y, f4.z, f4.w};
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          r[e] = f[e] - acc[u][e];
          part[0][e] += f[e] * f[e];
          part[1][e] += r[e] * r[e];
        }
        st4(Rs + p * NC + j0, mk4(r));
      }
    }
    stash<2>(part, red, WC, slot);
  }
  __syncthreads();
  if (warp == 0) {
    for (int j = lane; j < NC; j += 32) {
      const float fn = sqrtf(colsum(red, 2, 0, j, RB, CG)) + 1e-30f;
      fnorm_s[j] = fn;
      rel_s[j] = brel_s[j] = sqrtf(colsum(red, 2, 1, j, RB, CG)) / fn;
    }
  }
  __syncthreads();

  // Z = prec(R); P = Z; rz = <R, Z>
  prec_tile<TM>(Minv, Rs, Ms, n, NC, rg, RG, j0, acc);
  {
    float part[1][4] = {};
#pragma unroll
    for (int u = 0; u < TM; ++u) {
      const int p = rg + RG * u;
      if (p < n) {
        const float4 r = ld4(Rs + p * NC + j0);
        part[0][0] += r.x * acc[u][0];
        part[0][1] += r.y * acc[u][1];
        part[0][2] += r.z * acc[u][2];
        part[0][3] += r.w * acc[u][3];
        st4(Ps + p * NC + j0, mk4(acc[u]));
      }
    }
    stash<1>(part, red, WC, slot);
  }
  __syncthreads();
  if (warp == 0) {
    float m = -INFINITY;
    int nan = 0;
    for (int j = lane; j < NC; j += 32) {
      rz_s[j] = colsum(red, 1, 0, j, RB, CG);
      const float v = rel_s[j];
      if (isnan(v)) nan = 1; else m = fmaxf(m, v);
    }
    decide(m, nan, 0, false);
  }
  __syncthreads();

  while (cont_s) {
    // KP = K P (kept in acc); pkp = <P, KP>
    matvec_tile<TM>(ws, nbr, Ps, K, n, NC, Cp, col0, rg, RG, j0, acc);
    {
      float part[1][4] = {};
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        const int p = rg + RG * u;
        if (p < n) {
          const float4 v = ld4(Ps + p * NC + j0);
          part[0][0] += v.x * acc[u][0];
          part[0][1] += v.y * acc[u][1];
          part[0][2] += v.z * acc[u][2];
          part[0][3] += v.w * acc[u][3];
        }
      }
      stash<1>(part, red, WC, slot);
    }
    __syncthreads();
    if (warp == 0) {
      for (int j = lane; j < NC; j += 32) {
        const float pkp = colsum(red, 1, 0, j, RB, CG), rz = rz_s[j];
        const bool ok = pkp > 0.f && isfinite(pkp) && isfinite(rz) && brel_s[j] >= tol;
        alpha_s[j] = ok ? rz / pkp : 0.f;
      }
    }
    __syncthreads();
    // X += alpha P; R -= alpha KP
    {
      const float a[4] = {alpha_s[j0], alpha_s[j0 + 1], alpha_s[j0 + 2], alpha_s[j0 + 3]};
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        const int p = rg + RG * u;
        if (p < n) {
          const float4 p4 = ld4(Ps + p * NC + j0), r4 = ld4(Rs + p * NC + j0);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w}, rv[4] = {r4.x, r4.y, r4.z, r4.w};
          float r[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[u][e] = x[u][e] + pv[e] * a[e];
            r[e] = rv[e] - acc[u][e] * a[e];
          }
          st4(Rs + p * NC + j0, mk4(r));
        }
      }
    }
    __syncthreads();
    // Z = prec(R) (kept in acc); rz_new = <R, Z>; |R|^2
    prec_tile<TM>(Minv, Rs, Ms, n, NC, rg, RG, j0, acc);
    {
      float part[2][4] = {};
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        const int p = rg + RG * u;
        if (p < n) {
          const float4 r4 = ld4(Rs + p * NC + j0);
          const float r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            part[0][e] += r[e] * acc[u][e];
            part[1][e] += r[e] * r[e];
          }
        }
      }
      stash<2>(part, red, WC, slot);
    }
    __syncthreads();
    if (warp == 0) {
      float m = -INFINITY;
      int nan = 0, any = 0;
      for (int j = lane; j < NC; j += 32) {
        const float rz_new = colsum(red, 2, 0, j, RB, CG), rz = rz_s[j];
        beta_s[j] = rz > 0.f ? rz_new / rz : 0.f;
        rz_s[j] = rz_new;
        const float rel = sqrtf(colsum(red, 2, 1, j, RB, CG)) / fnorm_s[j];
        const float brel = brel_s[j];
        const bool improved = rel < brel * shrink && isfinite(rel);
        if (improved) brel_s[j] = fminf(rel, brel);
        rel_s[j] = rel;
        imp_s[j] = improved ? 1 : 0;
        any |= improved ? 1 : 0;
        if (isnan(rel)) nan = 1; else m = fmaxf(m, rel);
      }
      decide(m, nan, any, true);
    }
    __syncthreads();
    // P = Z + beta P; best X = X in the columns that improved
    {
      const float b[4] = {beta_s[j0], beta_s[j0 + 1], beta_s[j0 + 2], beta_s[j0 + 3]};
      const bool im[4] = {imp_s[j0] != 0, imp_s[j0 + 1] != 0, imp_s[j0 + 2] != 0,
                          imp_s[j0 + 3] != 0};
      const bool all_im = im[0] && im[1] && im[2] && im[3];
#pragma unroll
      for (int u = 0; u < TM; ++u) {
        const int p = rg + RG * u;
        if (p < n) {
          const float4 p4 = ld4(Ps + p * NC + j0);
          st4(Ps + p * NC + j0,
              make_float4(acc[u][0] + p4.x * b[0], acc[u][1] + p4.y * b[1],
                          acc[u][2] + p4.z * b[2], acc[u][3] + p4.w * b[3]));
          float* const dst = bX + gidx(p);
          if (all_im) {
            st4(dst, mk4(x[u]));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (im[e]) dst[e] = x[u][e];
          }
        }
      }
    }
    __syncthreads();
  }
  if (t == 0) iters[blockIdx.x] = k_s;
}

template <int TM>
int launch(const void* ws, const void* F, const void* Minv, const void* nbr, void* Xout,
           void* iters, int K, int n, int s, int Cp, int CB, int threads, int smem, float tol,
           int maxiter, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stencil_pcg_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  stencil_pcg_kernel<TM><<<Cp / CB, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<const float*>(F),
      static_cast<const float*>(Minv), static_cast<const int*>(nbr), static_cast<float*>(Xout),
      static_cast<int*>(iters), K, n, s, Cp, CB, tol, maxiter);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The large instance (see the header): semantics per column and per block
// are those of the small instance; the product's tiles span blocks, the
// vector passes take one block's slice of rows.

constexpr int LBM = 128;          // rows of a product tile (Minv rows)
constexpr int LBK = 16;           // k of a ring stage
constexpr int LSL = 256;          // rows a group of the vector passes takes at once
constexpr int LMAX_STAGES = 8;    // ring stages
constexpr int LMAX_CT = 1024;     // column tiles a chunk
constexpr int LMAX_NC = 16;       // columns a block: s CB in {12, 16}
constexpr int LIVE = 0x7fffffff;  // stopped[b] of a block that has not stopped
constexpr int LCTL = 16;          // control words before the grid barrier's flags
constexpr int LMAX_GRID = 2048;   // CTAs: one flag each
constexpr int LPIECES = 8;        // k pieces a product tile at most
constexpr int LEPIECES = 32;      // segments a block of the vector passes at most

// CTAs an SM that __launch_bounds__ asks of the registers: one at 256
// threads (two, at 128 registers a thread, spilled ~2 KB and ran 5-13%
// slower on the H100, tools/k1_probe.py), four at 96 (168 registers)
__host__ __device__ constexpr int large_min_blocks(int BN) { return BN == 128 ? 1 : 4; }

// With K1L_PROBE defined (tools/k1_probe.py --large), thread 0 of every CTA
// adds up clock64 cycles: 0 in the products (their ring waits, the
// producer's and the epilogues included), 1 of them waiting for tiles, 2
// waiting at grid barriers, 3 in the stencil passes, 4 in the other vector
// passes, 5 in the dots (the column scalars and the column sums of the
// passes), 6 in all; 7 counts the ring stages it consumed.
#ifdef K1L_PROBE
__device__ long long g_k1l_cycles[8192 * 8];
#define K1L_NOW(v) const long long v = clock64();
#define K1L_ADD(c, v) (c) += clock64() - (v);
#else
#define K1L_NOW(v)
#define K1L_ADD(c, v)
#endif

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}

// Wait for the barrier's phase of this parity.  A wait past ~2^36 cycles
// (tens of seconds; a tile takes microseconds) traps: a broken pipeline
// fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* b, unsigned parity) {
  const unsigned a = smem_addr(b);
  unsigned done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 36)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

// `bytes` from global src into shared dst; the barrier counts them
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// orders this thread's generic global writes before later bulk copies
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// state that other CTAs write is read through L2 (ld.global.cg)
__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float el(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Spin until *p reaches v; a wait past ~2^34 cycles (seconds) traps.
__device__ __forceinline__ void spin_until(const unsigned* p, unsigned v, int sleep_ns) {
  const long long t0 = clock64();
  while (ld_acquire(p) != v) {
    if (clock64() - t0 > (1LL << 34)) __trap();
    if (sleep_ns) __nanosleep(sleep_ns);
  }
}

// Every thread of every CTA of the (cooperative, co-resident) grid.  Each
// CTA but the first releases its flag (ctl[LCTL + CTA]) at generation gen
// + 1; the first CTA's threads acquire all flags, then it releases the
// generation word ctl[0] that the others acquire: no atomic, no CTA
// waits on a contended address but ctl[0].  gen (every thread's) counts
// the barriers passed.
__device__ __forceinline__ void grid_sync(unsigned* ctl, unsigned& gen, long long& waited) {
  fence_async_global();  // this thread's writes before other CTAs' bulk copies
  __syncthreads();
  K1L_NOW(w0)
  const unsigned target = ++gen;
  if (blockIdx.x == 0) {
    for (unsigned i = threadIdx.x + 1; i < gridDim.x; i += blockDim.x)
      spin_until(ctl + LCTL + i, target, 0);
    __syncthreads();
    if (threadIdx.x == 0) st_release(ctl, target);
  } else if (threadIdx.x == 0) {
    __threadfence();
    st_release(ctl + LCTL + blockIdx.x, target);
    spin_until(ctl, target, 32);
  }
  __syncthreads();
  K1L_ADD(waited, w0)
}

struct LargeArgs {
  const float* ws;  // (K, n, Cp) stencil weights
  const float* F;   // (s, n, Cp) right-hand sides
  const float* Mt;  // Minv tiled: [RT][KT][LBK][LBM], zero past n
  const int* nbr;   // (K, n) neighbour table
  float* bX;        // (s, n, Cp) best iterate
  int* iters;       // (Cp / CB,) iterations a block
  float* state;     // the chunk's state (see hommx_stencil_pcg_large_f32)
  int K, n, s, Cp, CB;
  int stages;  // ring stages
  float tol;
  int maxiter;
};

// acc += (the stage's 16 k of Minv)^T-tile x (its 16 rows of R): a thread's
// rows 4 ty + (0..3), 64 + 4 ty + (0..3) and columns 4 tx + (0..3),
// BN / 2 + 4 tx + (0..3).
template <int BN>
__device__ __forceinline__ void mma_stage(const float* As, const float* Bs, int ty, int tx,
                                          float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < LBK; ++kk) {
    const float4 a0 = ld4(As + kk * LBM + 4 * ty), a1 = ld4(As + kk * LBM + 64 + 4 * ty);
    const float4 b0 = ld4(Bs + kk * BN + 4 * tx), b1 = ld4(Bs + kk * BN + BN / 2 + 4 * tx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// What a product phase of the large kernel reads: the chunk's sizes, the
// state's arrays, the CTA's ring and barriers, and the split.
struct LargeProd {
  const float* Mt;
  const float* R;
  float* W;
  float* Pp;
  float* Tp;
  int* done_t;
  int* done_p;
  unsigned long long* full_b;
  unsigned long long* used_b;
  const unsigned short* act;  // the listed column tiles
  int* last_s;                // shared: whether this CTA completed a count
  long long* cyc;             // the probe's counters (K1L_PROBE)
  size_t A;                   // floats an array of the state
  long long U;                // the split's units
  int n, npad, KT, RT, CT, NCt, CTa, Gp, NST;
};

// Whether this CTA, adding `part` to `done` after writing its sums, brings
// it to `whole` (thread 0's atomic after a fence; the last resets the
// count): every thread learns it.
__device__ __forceinline__ bool large_last_in(int* done, int whole, int part, int* last_s) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(done, part) == whole - part;
    if (last) *done = 0;
    *last_s = last;
  }
  __syncthreads();
  const bool last = *last_s != 0;
  if (last) __threadfence();
  return last;
}

// One product phase of the large kernel: Z = Minv R over the listed column
// tiles, split over the CTAs (stream-K): the tiles tau = rt CTa + cti, each
// of KT k tiles, are U units u = tau KT + kt; CTA c < Gp takes units [c U /
// Gp, (c + 1) U / Gp), so every CTA gets the same work to a unit, and with
// Gp <= 6 RT CTa a tile's units fall to at most LPIECES CTAs, its k
// pieces.  Piece pc of a tile writes its part to W[pc]; the CTA that
// completes the tile adds the pieces up in piece order into W[0] (a tile
// of one piece is whole at once).  With the whole Z of a tile, mode 1 adds
// the column sums of <R, Z> to Pp[0], mode 2 also those of |R|^2 to Pp[1];
// the CTA that completes a column tile adds up its sums in row-tile order
// into Tp.  Returns the ring's counts of stages consumed and issued.
template <int BN>
__device__ __forceinline__ uint2 large_product(const LargeProd& g, int mode, unsigned gcons,
                                            unsigned gprod) {
  constexpr int T = 2 * BN, TX = BN / 8;
  constexpr int SA = LBK * LBM, SB = LBK * BN, SST = SA + SB;
  const int t = threadIdx.x, lane = t & 31, ty = t / TX, tx = t % TX, c = blockIdx.x;
  const int n = g.n, KT = g.KT, CTa = g.CTa, Gp = g.Gp, NST = g.NST;
  const long long U = g.U;
  auto owner = [&](long long u) { return (int)(((u + 1) * Gp - 1) / U); };  // unit u's CTA
  extern __shared__ float4 smem4[];  // the kernel's: NST ring stages, then the column sums
  float* const ring = reinterpret_cast<float*>(smem4);
  float* const red = ring + (size_t)NST * SST;
  (void)T;
  K1L_NOW(p0)
  const long long lo = c < Gp ? (long long)c * U / Gp : 0;
  const long long hi = c < Gp ? (long long)(c + 1) * U / Gp : 0;
  long long pu = lo;  // the producer's (thread 0's) next unit
  auto issue = [&]() {
    if (pu >= hi) return;
    const int tau = (int)(pu / KT), kt = (int)(pu % KT);
    const int rt = tau / CTa, ct = g.act[tau % CTa];
    const unsigned h = gprod++;
    const int st = h % NST;
    if (h >= (unsigned)NST) mbar_wait(&g.used_b[st], ((h / NST) - 1) & 1);
    mbar_arrive_tx(&g.full_b[st], SST * 4);
    float* const buf = ring + st * SST;
    bulk_load(buf, g.Mt + ((size_t)rt * KT + kt) * SA, SA * 4, &g.full_b[st]);
    bulk_load(buf + SA, g.R + ((size_t)ct * g.npad + (size_t)kt * LBK) * BN, SB * 4,
              &g.full_b[st]);
    ++pu;
  };
  if (t == 0) {
    fence_async_global();
    for (int i = 0; i < NST - 1; ++i) issue();
  }
  for (long long u = lo; u < hi;) {
    const int tau = (int)(u / KT), k0 = (int)(u % KT);
    const int k1 = (int)min((long long)KT, k0 + (hi - u));
    const int rt = tau / CTa, cti = tau % CTa, ct = g.act[cti];
    const int pc = c - owner((long long)tau * KT);
    u += k1 - k0;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int kt = k0; kt < k1; ++kt) {
      if (t == 0) issue();  // into the stage the previous step freed
      const unsigned gs = gcons++;
      const int st = gs % NST;
      K1L_NOW(w0)
      mbar_wait(&g.full_b[st], (gs / NST) & 1);
      K1L_ADD(g.cyc[1], w0)
      mma_stage<BN>(ring + st * SST, ring + st * SST + SA, ty, tx, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&g.used_b[st]);
#ifdef K1L_PROBE
      g.cyc[7] += 1;
#endif
    }
    // this piece's Z into W[pc]
    const size_t tile = (size_t)ct * g.npad * BN;
    auto rowof = [&](int i) { return rt * LBM + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4); };
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = rowof(i);
      if (p >= n) continue;
      float* const zr = g.W + (size_t)pc * g.A + tile + (size_t)p * BN;
      st4(zr + 4 * tx, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      st4(zr + BN / 2 + 4 * tx, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
    const int np = owner((long long)(tau + 1) * KT - 1) - owner((long long)tau * KT) + 1;
    bool whole = np == 1;
    if (!whole && large_last_in(g.done_t + (size_t)rt * g.CT + ct, KT, k1 - k0, g.last_s)) {
      whole = true;  // every piece is in: Z = their sum in piece order, into W[0] and acc
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = rowof(i);
        if (p >= n) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t o = tile + (size_t)p * BN + h * (BN / 2) + 4 * tx;
          float4 z = ldcg4(g.W + o);
          for (int i2 = 1; i2 < np; ++i2) {
            const float4 v = ldcg4(g.W + (size_t)i2 * g.A + o);
            z = make_float4(z.x + v.x, z.y + v.y, z.z + v.z, z.w + v.w);
          }
          st4(g.W + o, z);
          acc[i][4 * h] = z.x;
          acc[i][4 * h + 1] = z.y;
          acc[i][4 * h + 2] = z.z;
          acc[i][4 * h + 3] = z.w;
        }
      }
    }
    if (whole && mode) {  // the column sums of the tile's rows
      K1L_NOW(s0)
      float d0[8], d1[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) d0[j] = d1[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = rowof(i);
        if (p >= n) continue;
        const float4 r0 = ldcg4(g.R + tile + (size_t)p * BN + 4 * tx);
        const float4 r1 = ldcg4(g.R + tile + (size_t)p * BN + BN / 2 + 4 * tx);
        const float rv[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          d0[j] += rv[j] * acc[i][j];
          d1[j] += rv[j] * rv[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = j < 4 ? 4 * tx + j : BN / 2 + 4 * tx + j - 4;
        red[(ty * 2 + 0) * BN + cc] = d0[j];
        red[(ty * 2 + 1) * BN + cc] = d1[j];
      }
      __syncthreads();
      const int q = t / BN, col = t % BN;  // one (quantity, column) a thread
      float* const pq = g.Pp + (size_t)q * g.RT * g.NCt + (size_t)ct * BN + col;
      if (q == 0 || mode == 2) {
        float v = 0.f;
#pragma unroll
        for (int y = 0; y < 16; ++y) v += red[(y * 2 + q) * BN + col];
        pq[(size_t)rt * g.NCt] = v;
      }
      if (large_last_in(g.done_p + ct, g.RT, 1, g.last_s) && (q == 0 || mode == 2)) {
        float v = 0.f;
        for (int r2 = 0; r2 < g.RT; r2 += 8) {
          float x[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            x[i] = r2 + i < g.RT ? __ldcg(pq + (size_t)(r2 + i) * g.NCt) : 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) v += x[i];
        }
        g.Tp[(size_t)q * g.NCt + (size_t)ct * BN + col] = v;
      }
      __syncthreads();  // red and last_s are the next tile's
      K1L_ADD(g.cyc[5], s0)
    }
  }
  K1L_ADD(g.cyc[0], p0)
  return make_uint2(gcons, gprod);
}

template <int BN, int NC>
__global__ void __launch_bounds__(2 * BN, large_min_blocks(BN))
stencil_pcg_large_kernel(const LargeArgs a) {
  constexpr int T = 2 * BN, TX = BN / 8, NW = T / 32;
  constexpr int QN = NC / 4, RPP = T / QN, NR = LSL / RPP, BPT = BN / NC;
  constexpr int SA = LBK * LBM, SB = LBK * BN, SST = SA + SB;  // floats a ring stage
  static_assert(T % QN == 0 && LSL % RPP == 0 && BN % NC == 0, "tile shape");
  extern __shared__ float4 smem4[];
  __shared__ unsigned short act_s[LMAX_CT];  // the column tiles with a running block
  __shared__ float cola_s[NC];               // alpha or beta of the item's columns
  __shared__ int coli_s[NC];                 // improved
  __shared__ int nact_s, last_s;
  __shared__ __align__(8) unsigned long long full_b[LMAX_STAGES], used_b[LMAX_STAGES];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = a.n, K = a.K, Cp = a.Cp, CB = a.CB, NST = a.stages;
  const int NB = Cp / CB, CT = (NB + BPT - 1) / BPT, NBs = CT * BPT, NCt = CT * BN;
  const int npad = (n + LBK - 1) / LBK * LBK, KT = npad / LBK, RT = (n + LBM - 1) / LBM;
  const int NSLp = (npad + LSL - 1) / LSL;  // I0's slices
  const float shrink = 1.0f - 1e-4f;
  const size_t A = (size_t)CT * npad * BN;  // floats an array of the state
  // the state: control words (the grid barrier's generation; from LCTL its
  // flags), then the arrays
  unsigned* const ctl = reinterpret_cast<unsigned*>(a.state);
  float* const R = a.state + LCTL + LMAX_GRID;
  float* const P = R + A;
  float* const X = P + A;
  float* const W = X + A;                      // Z by k piece, then whole in the first; K P
  float* const Pp = W + (size_t)LPIECES * A;   // [2][RT][NCt] the products' sums
  float* const Pe = Pp + (size_t)2 * RT * NCt;   // [2][LEPIECES][NCt] the passes' sums
  float* const Tp = Pe + (size_t)2 * LEPIECES * NCt;  // [2][NCt] their totals
  float* const Te = Tp + 2 * NCt;                    // [2][NCt]
  float* const fnorm = Te + 2 * NCt;                 // [NCt]
  float* const rzv = fnorm + NCt;                    // [2][NCt] by parity
  float* const brelv = rzv + 2 * NCt;                // [2][NCt] by parity
  int* const stopped = reinterpret_cast<int*>(brelv + 2 * NCt);  // [NBs]
  int* const stall = stopped + NBs;
  int* const kcnt = stall + NBs;
  int* const done_e = kcnt + NBs;  // [NBs] a block's rows whose sums are in
  int* const done_p = done_e + NBs;  // [CT] a column tile's row tiles whose sums are in
  int* const done_t = done_p + CT;   // [RT CT] a product tile's k tiles done
  float* const ring = reinterpret_cast<float*>(smem4);  // NST stages
  float* const red = ring + (size_t)NST * SST;          // 32 BN floats of column sums

  // the product's thread: rows 4 ty + (0..3) and 64 + 4 ty + (0..3) of its
  // tile, columns 4 tx + (0..3) and BN / 2 + 4 tx + (0..3)
  const int ty = t / TX, tx = t % TX;
  // the passes' thread: column quad qd of the block, rows r + RPP u of a group
  const int qd = t % QN, r = t / QN;
  // the state's element (p, quad qd of block b), and F's and bX's
  auto sidx = [&](int b, int p) -> size_t {
    const int gc = b * NC + 4 * qd;
    return ((size_t)(gc / BN) * npad + p) * BN + gc % BN;
  };
  auto fidx = [&](int b, int p) -> size_t {
    const int j = 4 * qd;
    return ((size_t)(j / CB) * n + p) * Cp + (size_t)b * CB + j % CB;
  };

  long long cyc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  K1L_NOW(c_start)
  if (t == 0) {
    for (int i = 0; i < NST; ++i) {
      mbar_init(&full_b[i], 1);   // the producer's arrival with the bytes
      mbar_init(&used_b[i], NW);  // every warp done with the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned gen = 0;               // grid barriers passed
  unsigned gcons = 0, gprod = 0;  // ring stages consumed; issued (thread 0's)

  // the column tiles with a block that runs in iteration it (warp 0; the
  // same list in every CTA)
  auto build_act = [&](int it) {
    if (warp == 0) {
      int cnt = 0;
      for (int c0 = 0; c0 < CT; c0 += 32) {
        const int ct = c0 + lane;
        bool on = false;
        if (ct < CT)
          for (int q = 0; q < BPT; ++q) {
            const int b = ct * BPT + q;
            on = on || (b < NB && __ldcg(stopped + b) >= it);
          }
        const unsigned m = __ballot_sync(FULL, on);
        if (on) act_s[cnt + __popc(m & ((1u << lane) - 1u))] = static_cast<unsigned short>(ct);
        cnt += __popc(m);
      }
      if (lane == 0) nact_s = cnt;
    }
    __syncthreads();
  };

  // The product's split over the CTAs (large_product)
  int CTa = 0, Gp = 0;
  long long U = 1;
  auto split = [&]() {
    CTa = nact_s;
    U = (long long)RT * CTa * KT;
    Gp = min((int)gridDim.x, 6 * RT * CTa);
  };

  // a product phase (large_product)
  auto product = [&](int mode) {
    const LargeProd g = {a.Mt, R, W, Pp, Tp, done_t, done_p, full_b, used_b, act_s, &last_s, cyc,
                         A, U, n, npad, KT, RT, CT, NCt, CTa, Gp, NST};
    const uint2 gc = large_product<BN>(g, mode, gcons, gprod);
    gcons = gc.x;
    gprod = gc.y;
  };

  // The vector passes' split, as the product's: the block slots of the
  // listed column tiles, n rows each, are Ue block-rows; CTA c < Ge takes
  // [c Ue / Ge, (c + 1) Ue / Ge), at most LEPIECES CTAs a block (Ge <= 30
  // slots).  body(b, r0, r1, pc, np): rows r0 .. r1 of block b, the
  // segment's place pc among the np of the block.
  auto segments = [&](auto&& body) {
    const int nbl = CTa * BPT;
    const long long Ue = (long long)nbl * n;
    const int Ge = min((int)gridDim.x, 30 * nbl), c = blockIdx.x;
    auto own = [&](long long u) { return (int)(((u + 1) * Ge - 1) / Ue); };
    if (c >= Ge) return;
    const long long hi = (long long)(c + 1) * Ue / Ge;
    for (long long u = (long long)c * Ue / Ge; u < hi;) {
      const int bi = (int)(u / n), r0 = (int)(u % n);
      const int r1 = (int)min((long long)n, r0 + (hi - u));
      const int first = own((long long)bi * n);
      const int np = own((long long)bi * n + n - 1) - first + 1;
      u += r1 - r0;
      body(act_s[bi / BPT] * BPT + bi % BPT, r0, r1, c - first, np);
    }
  };
  // The column sums s0 (and s1) of the segment's threads -> Pe[q][pc][b's
  // columns]; the CTA that completes the block's rows adds its np pieces up
  // in order into Te.
  auto seg_sums = [&](int b, int rows, int pc, int np, float4 s0, float4 s1, int Q) {
    K1L_NOW(d0)
    float4* const r4 = reinterpret_cast<float4*>(red);
    r4[2 * t] = s0;
    r4[2 * t + 1] = s1;
    __syncthreads();
    const int q = t / NC, j = t % NC;
    float* const pe = Pe + (size_t)q * LEPIECES * NCt + (size_t)b * NC + j;
    if (t < Q * NC) {
      float v = 0.f;
#pragma unroll 8
      for (int rr = 0; rr < RPP; ++rr) v += el(r4[2 * (rr * QN + j / 4) + q], j & 3);
      pe[(size_t)pc * NCt] = v;
    }
    if (large_last_in(done_e + b, n, rows, &last_s) && t < Q * NC) {
      float v = 0.f;
      for (int i0 = 0; i0 < np; i0 += 8) {
        float x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = i0 + i < np ? __ldcg(pe + (size_t)(i0 + i) * NCt) : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) v += x[i];
      }
      Te[(size_t)q * NCt + (size_t)b * NC + j] = v;
    }
    __syncthreads();  // red and last_s are the next segment's
    K1L_ADD(cyc[5], d0)
  };
  auto live = [&](int b, int it) { return b < NB && __ldcg(stopped + b) >= it; };
  // the thread's rows of a group: p0 + r + RPP u, u < NR
  auto grp = [&](int p0, int u) { return p0 + r + RPP * u; };
  // (K V) at the thread's rows of a group of block b (those past pend
  // computed on row pend - 1, never stored): the weights of the block's
  // cells, V's neighbour rows through L2, all rows of one k at once, the
  // next k's neighbours loaded with this k's values
  auto kv = [&](const float* V, int b, int p0, int pend, float4 (&o)[NR]) {
    const size_t wc = (size_t)b * CB + (4 * qd) % CB;
    const float* const Vc = V + sidx(b, 0);
    size_t rw[NR];  // row k n + p of the weights and the table
    int q[NR];
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      rw[u] = min(grp(p0, u), pend - 1);
      q[u] = __ldg(a.nbr + rw[u]);
    }
    for (int k = 0; k < K; ++k) {
      float4 w[NR], v[NR];
      int qn[NR];
#pragma unroll
      for (int u = 0; u < NR; ++u) {
        w[u] = ldg4(a.ws + rw[u] * Cp + wc);
        v[u] = ldcg4(Vc + (size_t)q[u] * BN);
        rw[u] += n;
        qn[u] = k + 1 < K ? __ldg(a.nbr + rw[u]) : 0;
      }
#pragma unroll
      for (int u = 0; u < NR; ++u) {
        o[u].x = fmaf(w[u].x, v[u].x, o[u].x);
        o[u].y = fmaf(w[u].y, v[u].y, o[u].y);
        o[u].z = fmaf(w[u].z, v[u].z, o[u].z);
        o[u].w = fmaf(w[u].w, v[u].w, o[u].w);
        q[u] = qn[u];
      }
    }
  };
  // warp 0 of the block's first segment: the lockstep stop test on the
  // block's worst column (lanes < NC hold rel and improved); step: one more
  // iteration, else the first decision.  Writes the block's state.
  auto decide = [&](int b, float rel, bool improved, bool step, int it) {
    const bool mine = lane < NC;
    float m = mine && !isnan(rel) ? rel : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    const int nan = __any_sync(FULL, mine && isnan(rel));
    const int any = __any_sync(FULL, mine && improved);
    if (lane == 0) {
      const int st = step ? (any ? 0 : __ldcg(stall + b) + 1) : 0;
      const int k = step ? __ldcg(kcnt + b) + 1 : 0;
      stall[b] = st;
      kcnt[b] = k;
      a.iters[b] = k;
      if (!(!nan && m > a.tol && k < a.maxiter && st < STALL_CAP)) stopped[b] = it;
    }
  };

  // I0: R = F (zero in the padded rows and block slots); the blocks' state
  for (int w = blockIdx.x; w < NBs * NSLp; w += gridDim.x) {
    K1L_NOW(u0)
    const int b = w / NSLp, sl = w % NSLp, pend = min(npad, (sl + 1) * LSL);
    if (sl == 0 && t == 0) {
      stopped[b] = b < NB ? LIVE : -1;
      done_e[b] = 0;
      if (b % BPT == 0) done_p[b / BPT] = 0;
    }
    if (sl == 0 && b % BPT == 0)  // the counters of block b's column tile
      for (int r2 = t; r2 < RT; r2 += T) done_t[(size_t)r2 * CT + b / BPT] = 0;
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      const int p = grp(sl * LSL, u);
      if (p >= pend) continue;
      st4(R + sidx(b, p),
          b < NB && p < n ? ldg4(a.F + fidx(b, p)) : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    K1L_ADD(cyc[4], u0)
  }
  grid_sync(ctl, gen, cyc[2]);
  build_act(0);  // every column tile
  split();

  // X = prec(F)
  product(0);
  grid_sync(ctl, gen, cyc[2]);
  // X = best X = Z
  segments([&](int b, int r0, int r1, int, int) {
    if (b >= NB) return;
    K1L_NOW(u0)
    for (int p0 = r0; p0 < r1; p0 += RPP * NR)
#pragma unroll
      for (int u = 0; u < NR; ++u) {
        const int p = grp(p0, u);
        if (p >= r1) continue;
        const float4 z = ldcg4(W + sidx(b, p));
        st4(X + sidx(b, p), z);
        st4(a.bX + fidx(b, p), z);
      }
    K1L_ADD(cyc[4], u0)
  });
  grid_sync(ctl, gen, cyc[2]);
  // R = F - K X; |F|^2, |R|^2
  segments([&](int b, int r0, int r1, int pc, int np) {
    if (b >= NB) return;
    K1L_NOW(m0)
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
    for (int p0 = r0; p0 < r1; p0 += RPP * NR) {
      float4 kx[NR];
      kv(X, b, p0, r1, kx);
#pragma unroll
      for (int u = 0; u < NR; ++u) {
        const int p = grp(p0, u);
        if (p >= r1) continue;
        const size_t o = sidx(b, p);
        const float4 f = ldcg4(R + o);
        const float4 rv =
            make_float4(f.x - kx[u].x, f.y - kx[u].y, f.z - kx[u].z, f.w - kx[u].w);
        st4(R + o, rv);
        s0 = make_float4(s0.x + f.x * f.x, s0.y + f.y * f.y, s0.z + f.z * f.z, s0.w + f.w * f.w);
        s1 = make_float4(s1.x + rv.x * rv.x, s1.y + rv.y * rv.y, s1.z + rv.z * rv.z,
                         s1.w + rv.w * rv.w);
      }
    }
    K1L_ADD(cyc[3], m0)
    seg_sums(b, r1 - r0, pc, np, s0, s1, 2);
  });
  grid_sync(ctl, gen, cyc[2]);
  // Z = prec(R); <R, Z>
  product(1);
  grid_sync(ctl, gen, cyc[2]);
  // P = Z; rz = <R, Z>; |F|, rel = best rel; the first stop decision
  segments([&](int b, int r0, int r1, int, int) {
    if (b >= NB) return;
    if (r0 == 0 && warp == 0) {
      K1L_NOW(d0)
      float rel = 0.f;
      if (lane < NC) {
        const int gc = b * NC + lane;
        const float fn = sqrtf(__ldcg(Te + gc)) + 1e-30f;
        rel = sqrtf(__ldcg(Te + NCt + gc)) / fn;
        fnorm[gc] = fn;
        brelv[gc] = rel;
        rzv[gc] = __ldcg(Tp + gc);
      }
      decide(b, rel, false, false, 0);
      K1L_ADD(cyc[5], d0)
    }
    K1L_NOW(u0)
    for (int p0 = r0; p0 < r1; p0 += RPP * NR)
#pragma unroll
      for (int u = 0; u < NR; ++u) {
        const int p = grp(p0, u);
        if (p < r1) st4(P + sidx(b, p), ldcg4(W + sidx(b, p)));
      }
    K1L_ADD(cyc[4], u0)
  });
  grid_sync(ctl, gen, cyc[2]);

  for (int it = 1;; ++it) {
    build_act(it);
    if (nact_s == 0) break;
    split();
    const int pc = (it - 1) & 1, pn = it & 1;
    // K P (into W); pkp = <P, K P>
    segments([&](int b, int r0, int r1, int sp, int np) {
      if (!live(b, it)) return;
      K1L_NOW(m0)
      float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p0 = r0; p0 < r1; p0 += RPP * NR) {
        float4 kp[NR];
        kv(P, b, p0, r1, kp);
#pragma unroll
        for (int u = 0; u < NR; ++u) {
          const int p = grp(p0, u);
          if (p >= r1) continue;
          const size_t o = sidx(b, p);
          const float4 pv = ldcg4(P + o);
          st4(W + o, kp[u]);
          s0 = make_float4(s0.x + pv.x * kp[u].x, s0.y + pv.y * kp[u].y, s0.z + pv.z * kp[u].z,
                           s0.w + pv.w * kp[u].w);
        }
      }
      K1L_ADD(cyc[3], m0)
      seg_sums(b, r1 - r0, sp, np, s0, s0, 1);
    });
    grid_sync(ctl, gen, cyc[2]);
    // alpha; X += alpha P; R -= alpha K P
    segments([&](int b, int r0, int r1, int, int) {
      if (!live(b, it)) return;
      K1L_NOW(d0)
      if (t < NC) {
        const int gc = b * NC + t;
        const float pkp = __ldcg(Te + gc), rz = __ldcg(rzv + pc * NCt + gc);
        const bool ok = pkp > 0.f && isfinite(pkp) && isfinite(rz) &&
                        __ldcg(brelv + pc * NCt + gc) >= a.tol;
        cola_s[t] = ok ? rz / pkp : 0.f;
      }
      __syncthreads();
      K1L_ADD(cyc[5], d0)
      K1L_NOW(u0)
      const float al[4] = {cola_s[4 * qd], cola_s[4 * qd + 1], cola_s[4 * qd + 2],
                           cola_s[4 * qd + 3]};
      for (int p0 = r0; p0 < r1; p0 += RPP * 4) {  // four rows' loads at once
        float4 p4[4], r4[4], x4[4], k4[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (grp(p0, v) >= r1) continue;
          const size_t o = sidx(b, grp(p0, v));
          p4[v] = ldcg4(P + o);
          r4[v] = ldcg4(R + o);
          x4[v] = ldcg4(X + o);
          k4[v] = ldcg4(W + o);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (grp(p0, v) >= r1) continue;
          const size_t o = sidx(b, grp(p0, v));
          float x[4], rr[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[e] = el(x4[v], e) + el(p4[v], e) * al[e];
            rr[e] = el(r4[v], e) - el(k4[v], e) * al[e];
          }
          st4(X + o, mk4(x));
          st4(R + o, mk4(rr));
        }
      }
      __syncthreads();  // cola_s is the next segment's
      K1L_ADD(cyc[4], u0)
    });
    grid_sync(ctl, gen, cyc[2]);
    // Z = prec(R); <R, Z>, |R|^2
    product(2);
    grid_sync(ctl, gen, cyc[2]);
    // beta, rel, improved; the stop decision; P = Z + beta P; best X
    segments([&](int b, int r0, int r1, int, int) {
      if (!live(b, it)) return;
      K1L_NOW(d0)
      if (warp == 0) {
        float rel = 0.f;
        bool improved = false;
        if (lane < NC) {
          const int gc = b * NC + lane;
          const float rz_new = __ldcg(Tp + gc), rz = __ldcg(rzv + pc * NCt + gc);
          rel = sqrtf(__ldcg(Tp + NCt + gc)) / __ldcg(fnorm + gc);
          const float brel = __ldcg(brelv + pc * NCt + gc);
          improved = rel < brel * shrink && isfinite(rel);
          cola_s[lane] = rz > 0.f ? rz_new / rz : 0.f;
          coli_s[lane] = improved ? 1 : 0;
          if (r0 == 0) {
            rzv[pn * NCt + gc] = rz_new;
            brelv[pn * NCt + gc] = improved ? fminf(rel, brel) : brel;
          }
        }
        if (r0 == 0) decide(b, rel, improved, true, it);
      }
      __syncthreads();
      K1L_ADD(cyc[5], d0)
      K1L_NOW(u0)
      const float be[4] = {cola_s[4 * qd], cola_s[4 * qd + 1], cola_s[4 * qd + 2],
                           cola_s[4 * qd + 3]};
      const bool im[4] = {coli_s[4 * qd] != 0, coli_s[4 * qd + 1] != 0, coli_s[4 * qd + 2] != 0,
                          coli_s[4 * qd + 3] != 0};
      const bool any_im = im[0] || im[1] || im[2] || im[3];
      for (int p0 = r0; p0 < r1; p0 += RPP * 4) {  // four rows' loads at once
        float4 z4[4], p4[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (grp(p0, v) >= r1) continue;
          const size_t o = sidx(b, grp(p0, v));
          z4[v] = ldcg4(W + o);
          p4[v] = ldcg4(P + o);
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int p = grp(p0, v);
          if (p >= r1) continue;
          const size_t o = sidx(b, p);
          st4(P + o, make_float4(z4[v].x + p4[v].x * be[0], z4[v].y + p4[v].y * be[1],
                                 z4[v].z + p4[v].z * be[2], z4[v].w + p4[v].w * be[3]));
          if (any_im) {
            const float4 x4 = ldcg4(X + o);
            const size_t fo = fidx(b, p);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (im[e]) a.bX[fo + e] = el(x4, e);
          }
        }
      }
      __syncthreads();  // cola_s, coli_s are the next segment's
      K1L_ADD(cyc[4], u0)
    });
    grid_sync(ctl, gen, cyc[2]);
  }
#ifdef K1L_PROBE
  K1L_ADD(cyc[6], c_start)
  if (t == 0 && blockIdx.x < 8192)
    for (int q = 0; q < 8; ++q) g_k1l_cycles[blockIdx.x * 8 + q] = cyc[q];
#else
  (void)cyc;
#endif
}

// the state's floats (see hommx_stencil_pcg_large_f32)
long long large_state_floats(int n, int s, int Cp, int CB, int BN) {
  const long long NC = s * CB, BPT = BN / NC, NB = Cp / CB, CT = (NB + BPT - 1) / BPT;
  const long long NBs = CT * BPT, NCt = CT * BN, npad = (n + LBK - 1) / LBK * LBK;
  const long long RT = (n + LBM - 1) / LBM;
  return LCTL + LMAX_GRID + (3 + LPIECES) * CT * npad * BN + 2 * RT * NCt +
         2 * LEPIECES * NCt + 9 * NCt + 4 * NBs + CT + RT * CT;
}

long long large_smem_bytes(int BN, int stages) {
  return 4LL * (stages * LBK * (LBM + BN) + 32 * BN);
}

// the instance of BN columns a tile: 16 columns a block at 128 (s = 1, 2),
// 12 at 48 (s = 3)
template <int BN>
constexpr int large_nc() {
  return BN == 128 ? 16 : 12;
}

template <int BN>
int large_occupancy(int smem, int* per_sm, int* sms) {
  const auto kern = stencil_pcg_large_kernel<BN, large_nc<BN>()>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, 2 * BN, smem);
}

template <int BN>
int launch_large(const LargeArgs& a, int grid, int smem, void* stream) {
  if (a.s * a.CB != large_nc<BN>()) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t e = (cudaError_t)large_occupancy<BN>(smem, &per_sm, &sms);
  if (e != cudaSuccess) return (int)e;
  int g = grid < per_sm * sms ? grid : per_sm * sms;  // every CTA resident
  if (g > LMAX_GRID) g = LMAX_GRID;
  if (g < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the control words and the grid barrier's flags
  if ((e = cudaMemsetAsync(a.state, 0, 4 * (LCTL + LMAX_GRID), st)) != cudaSuccess) return (int)e;
  LargeArgs args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(stencil_pcg_large_kernel<BN, large_nc<BN>()>), dim3(g),
      dim3(2 * BN), params, (size_t)smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The configuration (CB, threads, smem) is the wrapper's
// launch_config(n, s); anything this kernel cannot run is refused with
// cudaErrorInvalidValue, including a shared-memory count that differs from
// the kernel's own.
extern "C" int hommx_stencil_pcg_f32(const void* ws, const void* F, const void* Minv,
                                     const void* nbr, void* Xout, void* iters, int K, int n,
                                     int s, int Cp, int CB, int threads, int smem, float tol,
                                     int maxiter, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (s < 1 || s > MAX_S || K < 1 || n < 1 || (CB != 4 && CB != 8 && CB != 16) || Cp < CB ||
      Cp % CB != 0 || threads < 32 || threads > 512 || threads % 32 != 0)
    return bad;
  const int NC = s * CB, CG = NC / 4;
  if (threads % CG != 0 || (threads / CG) % (32 / warp_cols(CG)) != 0) return bad;
  const int RG = threads / CG, rows = (n + RG - 1) / RG;
  int tm = 1;
  while (tm < rows) tm *= 2;
  if (tm > 8 || (tm == 8 && threads > 384)) return bad;
  const long npad = ((n + BK - 1) / BK) * BK;
  const long need = 4L * (npad * NC + (long)n * NC + (long)SLABS * n * BKP +
                          (threads / 32) * warp_cols(CG) * 2 * 4);
  if (need != smem) return bad;
  switch (tm) {
    case 1:
      return launch<1>(ws, F, Minv, nbr, Xout, iters, K, n, s, Cp, CB, threads, smem, tol,
                       maxiter, stream);
    case 2:
      return launch<2>(ws, F, Minv, nbr, Xout, iters, K, n, s, Cp, CB, threads, smem, tol,
                       maxiter, stream);
    case 4:
      return launch<4>(ws, F, Minv, nbr, Xout, iters, K, n, s, Cp, CB, threads, smem, tol,
                       maxiter, stream);
    default:
      return launch<8>(ws, F, Minv, nbr, Xout, iters, K, n, s, Cp, CB, threads, smem, tol,
                       maxiter, stream);
  }
}

// The large instance's configuration (BN columns a product tile, SK k
// slices, the ring's stages, threads = 2 BN, smem, the grid it asks for) is
// the wrapper's launch_config(n, s, C); the grid is cut to the CTAs that
// this card holds at once (the grid barrier needs every CTA resident).
// Minv comes tiled ([row tile of 128][k tile of 16][k][row], zero past n);
// state holds state_floats floats: LCTL control words and LMAX_GRID flags of
// the grid barrier, R, P, X and SK arrays
// of the product (column tiles x npad x BN each), the column sums and
// their totals, the per-column scalars and the per-block and per-tile
// counters.  Refused as above.
extern "C" int hommx_stencil_pcg_large_f32(const void* ws, const void* F, const void* Mt,
                                           const void* nbr, void* Xout, void* iters,
                                           void* state, int K, int n, int s, int Cp, int CB,
                                           int BN, int stages, int threads, int smem,
                                           int grid, long long state_floats, float tol,
                                           int maxiter, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  const int NC = s * CB;
  if (s < 1 || s > MAX_S || K < 1 || n < 1 || CB < 4 || NC % 4 != 0 || NC > LMAX_NC ||
      BN % NC != 0 || Cp < CB || Cp % CB != 0 || stages < 2 || stages > LMAX_STAGES ||
      threads != 2 * BN || grid < 1)
    return bad;
  const int BPT = BN / NC;
  if ((Cp / CB + BPT - 1) / BPT > LMAX_CT) return bad;
  if (large_smem_bytes(BN, stages) != smem) return bad;
  if (large_state_floats(n, s, Cp, CB, BN) != state_floats) return bad;
  const LargeArgs a = {static_cast<const float*>(ws), static_cast<const float*>(F),
                       static_cast<const float*>(Mt), static_cast<const int*>(nbr),
                       static_cast<float*>(Xout), static_cast<int*>(iters),
                       static_cast<float*>(state), K, n, s, Cp, CB, stages, tol, maxiter};
  switch (BN) {
    case 128:
      return launch_large<128>(a, grid, smem, stream);
    case 48:
      return launch_large<48>(a, grid, smem, stream);
    default:
      return bad;
  }
}

// The CTAs of the large instance at BN columns a tile and smem bytes that
// this card holds at once (the grid a launch is cut to), or minus the
// cudaError_t of the query.
extern "C" int hommx_stencil_pcg_large_grid(int BN, int smem) {
  int per_sm = 0, sms = 0, e;
  switch (BN) {
    case 128:
      e = large_occupancy<128>(smem, &per_sm, &sms);
      break;
    case 48:
      e = large_occupancy<48>(smem, &per_sm, &sms);
      break;
    default:
      return -(int)cudaErrorInvalidValue;
  }
  return e != 0 ? -e : per_sm * sms;
}

#ifdef K1L_PROBE
// The probe's per-CTA cycle counts (8192 x 8 int64) into dst.
extern "C" int hommx_k1l_phases(void* dst, void* stream) {
  return (int)cudaMemcpyFromSymbolAsync(dst, g_k1l_cycles, sizeof(g_k1l_cycles), 0,
                                        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
}
#endif
