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
// the 16³ cube.  There a Minv slab of n rows no longer fits beside R and P,
// and what bounds the product is the rate at which an SM takes in Minv
// (tools/k1_probe.py --large on the H100, PERF.md):
//
//  - Minv streams in 16 KB tiles (BM rows x BK k, BM = 4096 / BK) through
//    a ring of buffers that one producer lane fills with cp.async.bulk
//    copies (full barriers count the bytes, used barriers the consumer
//    warps).  A CTA so fed took in 27-36 GB/s whatever the ring's depth
//    (4 to 13 buffers), and multicasting each tile to a cluster of CTAs
//    that solved their own cells ran no faster: the SM's intake is the
//    bound, not L2 or HBM traffic.  With the product's arithmetic left
//    out an apply still takes ~3/4 of its time (two CTAs an SM take in
//    ~47 GB/s), and a second producer lane gains nothing.  The tile layout [k group][row][4]
//    (the wrapper's _tiled) makes a thread's float4 4 k of one of its 4
//    rows of the panel; with its 4 columns that is 64 FMAs a float4 pair.
//  - So a block of CB cells (16 columns; 12 at s = 3, none of them
//    padding) is a cluster of CS CTAs that split its rows: each streams
//    only its n / CS rows of Minv, with the rows of R each tile multiplies
//    in the same buffer, and the CTAs add their column sums through
//    distributed shared memory in rank order, so every CTA holds the same
//    totals and takes the same stop decision.  CS grows until a chunk
//    puts 1.5 CTAs on every SM (1 at 33², 4 at 64², 8 at 16³): against one
//    CTA a block that made 64² 2.6x and 16³ 5.5x faster.
//  - R, P, X and Z live in a per-block state in global memory (L2): each
//    CTA writes only its rows; the stencil matvec reads P's neighbour rows
//    of any CTA through L2, recomputed in the update pass rather than kept
//    (n K gathers beside the n^2 product); cluster barriers order R's rows
//    before a product (with a proxy fence for the bulk copies) and P's
//    before a matvec.
//  - The product stays in the kernel's own full-f32 FMAs (2 n^2 s flops a
//    cell and iteration).

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
// are those of the small instance; a block is a cluster of CS CTAs, each
// owning a contiguous range of its rows (whole panels of BM rows).

constexpr int LTILE = 4096;      // floats per Minv tile (16 KB): BM rows x BK columns (k)
constexpr int LTM = 4;           // rows of a panel a thread holds
constexpr int LMAX_STAGES = 16;  // ring buffers
constexpr int LMAX_NC = 16;      // columns a block: s CB in {4, 8, 12, 16}
constexpr int LMAX_CS = 8;       // CTAs a cluster

// With K1L_PROBE defined (tools/k1_probe.py --large), thread 0 and the
// producer lane of every CTA add up clock64 cycles: 0 in the products, 1 of
// them waiting for tiles, 2 the producer's, 3 of them waiting for the
// consumers, 4 in the stencil passes, 5 in all; 6 the applies.  K1L_NO_FMA
// leaves the product's arithmetic out (wrong results, the tiles' intake
// alone: only the cycles mean anything).
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

// the float at p's offset in the shared memory of cluster rank `rank`
__device__ __forceinline__ float ld_rank(const float* p, unsigned rank) {
  float v;
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %1, %2;\n"
      "ld.shared::cluster.f32 %0, [ra];\n}\n"
      : "=f"(v)
      : "r"(smem_addr(p)), "r"(rank)
      : "memory");
  return v;
}

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// The producer of one apply: lane 0 of the last warp keeps the ring full.
// Tile g (numbered on from apply to apply) goes to buffer g % S once this
// CTA's consumers are done with tile g - S; a buffer holds the Minv tile
// (this CTA's rows, k tile kt) and the rows kt BK .. kt BK + BK of R.
__device__ __forceinline__ void produce(const float* __restrict__ Mt, const float* Rg,
                                        float* Ms, unsigned long long* full_b,
                                        unsigned long long* used_b, unsigned g0, int T,
                                        int KT, int pt0, int BK, int NC, int S, int sst,
                                        long long& waited) {
  fence_async_global();
  for (int tt = 0; tt < T; ++tt) {
    const unsigned g = g0 + tt, use = g / S;
    const int st = g % S, kt = tt % KT;
    if (use > 0) {
      K1L_NOW(w0)
      mbar_wait(&used_b[st], (use - 1) & 1);
      K1L_ADD(waited, w0)
    }
    mbar_arrive_tx(&full_b[st], (LTILE + BK * NC) * 4);
    float* const buf = Ms + st * sst;
    bulk_load(buf, Mt + ((size_t)(pt0 + tt / KT) * KT + kt) * LTILE, LTILE * 4, &full_b[st]);
    bulk_load(buf + LTILE, Rg + (size_t)kt * BK * NC, BK * NC * 4, &full_b[st]);
  }
}

// acc[u][:] = (Minv R)[p0 + RG u, j0:j0+4] for one panel of BM = LTILE / BK
// rows: its KT tiles g0 .. g0 + KT - 1 from the ring.  The tile layout is
// [k group][row][4]: a thread's float4 holds 4 k of one row.
template <int BK>
__device__ __forceinline__ void prec_panel(const float* Ms, unsigned long long* full_b,
                                           unsigned long long* used_b, unsigned g0, int KT,
                                           int S, int sst, int NC, int rg, int RG, int j0,
                                           int lane, float (&acc)[LTM][4], long long& waited) {
  constexpr int BM = LTILE / BK;
#pragma unroll
  for (int u = 0; u < LTM; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const unsigned g = g0 + kt;
    const int st = g % S;
    K1L_NOW(w0)
    mbar_wait(&full_b[st], (g / S) & 1);
    K1L_ADD(waited, w0)
    const float* M = Ms + st * sst + rg * 4;
    const float* R = Ms + st * sst + LTILE + j0;
#ifndef K1L_NO_FMA
#pragma unroll
    for (int q = 0; q < BK / 4; ++q) {
      float4 a[LTM];
#pragma unroll
      for (int u = 0; u < LTM; ++u) a[u] = ld4(M + (q * BM + RG * u) * 4);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float4 r = ld4(R + (4 * q + d) * NC);
#pragma unroll
        for (int u = 0; u < LTM; ++u) {
          const float m = d == 0 ? a[u].x : d == 1 ? a[u].y : d == 2 ? a[u].z : a[u].w;
          acc[u][0] = fmaf(m, r.x, acc[u][0]);
          acc[u][1] = fmaf(m, r.y, acc[u][1]);
          acc[u][2] = fmaf(m, r.z, acc[u][2]);
          acc[u][3] = fmaf(m, r.w, acc[u][3]);
        }
      }
    }
#endif
    __syncwarp();
    if (lane == 0) mbar_arrive(&used_b[st]);
  }
}

// (K P)[p, j0:j0+4] through the neighbour table; P's rows belong to any CTA
// of the cluster, so they are read from L2.  cell[e] is column j0 + e's
// cell (its weight column).
__device__ __forceinline__ void kp_row(const float* __restrict__ ws,
                                       const int* __restrict__ nbr, const float* Pg, int K,
                                       int n, int NC, int Cp, int j0, const int (&cell)[4],
                                       int p, float (&o)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const size_t row = (size_t)k * n + p;
    const float4 v = ldcg4(Pg + (size_t)__ldg(nbr + row) * NC + j0);
    const float* w = ws + row * Cp;
    o[0] = fmaf(__ldg(w + cell[0]), v.x, o[0]);
    o[1] = fmaf(__ldg(w + cell[1]), v.y, o[1]);
    o[2] = fmaf(__ldg(w + cell[2]), v.z, o[2]);
    o[3] = fmaf(__ldg(w + cell[3]), v.w, o[3]);
  }
}

// what an apply of the preconditioner does with its rows
enum class Epi { kFirst, kDirection, kUpdate };

// two CTAs an SM: 96 registers a thread (a few spills) and two producers;
// 8-11% faster than one CTA at 168 registers (tools/k1_probe.py --large)
#ifndef K1L_MIN_BLOCKS
#define K1L_MIN_BLOCKS 2
#endif

template <int BK>
__global__ void __launch_bounds__(256 + 32, K1L_MIN_BLOCKS)
stencil_pcg_large_kernel(const float* __restrict__ ws, const float* __restrict__ F,
                         const float* __restrict__ Mt, const int* __restrict__ nbr,
                         float* __restrict__ bX, float* __restrict__ state,
                         int* __restrict__ iters, int K, int n, int s, int Cp, int CB, int CS,
                         int S, float tol, int maxiter) {
  constexpr int BM = LTILE / BK;
  extern __shared__ float4 smem4[];
  __shared__ float fnorm_s[LMAX_NC], rel_s[LMAX_NC], brel_s[LMAX_NC], rz_s[LMAX_NC];
  __shared__ float alpha_s[LMAX_NC], beta_s[LMAX_NC];
  __shared__ int imp_s[LMAX_NC];
  __shared__ int cont_s, stall_s, k_s;
  __shared__ float cpart_s[2][2][LMAX_NC];  // this CTA's column sums, by parity
  __shared__ float tot_s[2][LMAX_NC];       // the cluster's
  __shared__ __align__(8) unsigned long long full_b[LMAX_STAGES], used_b[LMAX_STAGES];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int Tc = blockDim.x - 32, NWc = Tc >> 5;
  const bool producer = warp == NWc;  // the last warp streams Minv
  const int NC = s * CB, CG = NC / 4, RG = Tc / CG;
  const int WC = warp_cols(CG), WR = 32 / WC, RB = RG / WR, CGB = CG / WC;
  const int cg = (warp % CGB) * WC + lane % WC;  // column group: columns j0..j0+3
  const int rg = (warp / CGB) * WR + lane / WC;  // rows r0 + rg + RG v
  const int slot = (warp / CGB) * CG + cg;
  const int j0 = 4 * cg;
  const int blk = blockIdx.x / CS;
  const unsigned rank = cluster_rank();
  const int npad = ((n + BK - 1) / BK) * BK, KT = npad / BK;
  // this CTA's rows r0 .. r1: whole panels
  const int nr = ((n + CS - 1) / CS + BM - 1) / BM * BM;
  const int r0 = rank * nr, r1 = min(n, r0 + nr);
  const int pt0 = r0 / BM, PT = (r1 - r0 + BM - 1) / BM, T = PT * KT;
  const int sst = LTILE + BK * NC;  // floats a ring buffer
  const float shrink = 1.0f - 1e-4f;
  float* const Ms = reinterpret_cast<float*>(smem4);  // S ring buffers
  float* const red = Ms + S * sst;                    // RB x CG x 2 x 4 partial sums
  // the block's state in global memory: R (npad rows), P, X, Z (n x NC each)
  float* const Rg = state + (size_t)blk * (npad + 3 * n) * NC;
  float* const Pg = Rg + (size_t)npad * NC;
  float* const Xg = Pg + (size_t)n * NC;
  float* const Zg = Xg + (size_t)n * NC;

  // column j = i CB + c: right-hand side i of the block's cell c; fo[e] + p Cp
  // is column j0 + e's element at row p of F and of bX (s, n, Cp)
  int cell[4];
  size_t fo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = j0 + e;
    cell[e] = blk * CB + j % CB;
    fo[e] = (size_t)(j / CB) * n * Cp + cell[e];
  }

  if (t == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full_b[i], 1);    // the producer's arrival with the bytes
      mbar_init(&used_b[i], NWc);  // every consumer warp done with the buffer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  long long cyc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  K1L_NOW(c_start)

  // Z = Minv R over this CTA's panels, and what `epi` does with their rows;
  // part[q][e] gathers the thread's column partial sums
  unsigned gbase = 0;
  float part[2][4];
  auto apply = [&](Epi epi) {
    K1L_NOW(a0)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[q][e] = 0.f;
    if (producer) {
      if (lane == 0)
        produce(Mt, Rg, Ms, full_b, used_b, gbase, T, KT, pt0, BK, NC, S, sst, cyc[3]);
      __syncwarp();
      K1L_ADD(cyc[2], a0)
    } else {
      for (int pt = 0; pt < PT; ++pt) {
        float acc[LTM][4];
        prec_panel<BK>(Ms, full_b, used_b, gbase + pt * KT, KT, S, sst, NC, rg, RG, j0, lane,
                       acc, cyc[1]);
#pragma unroll
        for (int u = 0; u < LTM; ++u) {
          const int p = r0 + pt * BM + rg + RG * u;
          if (p >= r1) continue;
          float* const prow = Pg + (size_t)p * NC + j0;
          if (epi == Epi::kFirst) {  // X = best X = P = Z
            st4(Xg + (size_t)p * NC + j0, mk4(acc[u]));
            st4(prow, mk4(acc[u]));
#pragma unroll
            for (int e = 0; e < 4; ++e) bX[fo[e] + (size_t)p * Cp] = acc[u][e];
            continue;
          }
          const float4 r4 = ld4(Rg + (size_t)p * NC + j0);
          const float r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) part[0][e] += r[e] * acc[u][e];
          if (epi == Epi::kDirection) {  // P = Z; <R, Z>
            st4(prow, mk4(acc[u]));
          } else {  // Z kept for P's update; <R, Z>, |R|^2
            st4(Zg + (size_t)p * NC + j0, mk4(acc[u]));
#pragma unroll
            for (int e = 0; e < 4; ++e) part[1][e] += r[e] * r[e];
          }
        }
      }
      K1L_ADD(cyc[0], a0)
    }
    gbase += T;
    cyc[6] += 1;
  };

  // the cluster's sums of Q quantities per column: each CTA's warp 0 adds
  // up its row blocks, then every CTA adds the CTAs' sums in rank order, so
  // all of them hold the same totals (tot_s) and take the same decisions
  int par = 0;
  auto cluster_sums = [&](int Q) {
    __syncthreads();
    if (warp == 0)
      for (int j = lane; j < NC; j += 32)
        for (int q = 0; q < Q; ++q) cpart_s[par][q][j] = colsum(red, Q, q, j, RB, CG);
    cluster_sync();
    if (warp == 0)
      for (int j = lane; j < NC; j += 32)
        for (int q = 0; q < Q; ++q) {
          float v = 0.f;
          for (int r = 0; r < CS; ++r) v += ld_rank(&cpart_s[par][q][j], r);
          tot_s[q][j] = v;
        }
    par ^= 1;
  };
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

  // R = F in this CTA's rows (rank 0 zeroes the padded rows)
  if (rank == 0)
    for (int e = t; e < (npad - n) * NC; e += blockDim.x) Rg[(size_t)n * NC + e] = 0.f;
  if (!producer) {
    for (int p = r0 + rg; p < r1; p += RG) {
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = __ldg(F + fo[e] + (size_t)p * Cp);
      st4(Rg + (size_t)p * NC + j0, mk4(f));
    }
  }
  fence_async_global();
  cluster_sync();  // every CTA's barriers and rows of R

  // X = prec(F); best X = X; X into P for the residual's matvec
  apply(Epi::kFirst);
  cluster_sync();

  // R = F - K X; |F|^2, |R|^2
  if (!producer) {
    float sums[2][4] = {};
    for (int p = r0 + rg; p < r1; p += RG) {
      float kx[4];
      kp_row(ws, nbr, Pg, K, n, NC, Cp, j0, cell, p, kx);
      const float4 f4 = ld4(Rg + (size_t)p * NC + j0);
      const float f[4] = {f4.x, f4.y, f4.z, f4.w};
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        r[e] = f[e] - kx[e];
        sums[0][e] += f[e] * f[e];
        sums[1][e] += r[e] * r[e];
      }
      st4(Rg + (size_t)p * NC + j0, mk4(r));
    }
    stash<2>(sums, red, WC, slot);
  }
  fence_async_global();
  cluster_sums(2);
  if (warp == 0) {
    for (int j = lane; j < NC; j += 32) {
      const float fn = sqrtf(tot_s[0][j]) + 1e-30f;
      fnorm_s[j] = fn;
      rel_s[j] = brel_s[j] = sqrtf(tot_s[1][j]) / fn;
    }
  }
  __syncthreads();

  // Z = prec(R); P = Z; rz = <R, Z>
  apply(Epi::kDirection);
  if (!producer) {
    float sums[1][4] = {{part[0][0], part[0][1], part[0][2], part[0][3]}};
    stash<1>(sums, red, WC, slot);
  }
  cluster_sums(1);
  if (warp == 0) {
    float m = -INFINITY;
    int nan = 0;
    for (int j = lane; j < NC; j += 32) {
      rz_s[j] = tot_s[0][j];
      const float v = rel_s[j];
      if (isnan(v)) nan = 1; else m = fmaxf(m, v);
    }
    decide(m, nan, 0, false);
  }
  __syncthreads();

  while (cont_s) {
    // pkp = <P, K P>
    K1L_NOW(m0)
    if (!producer) {
      float sums[1][4] = {};
      for (int p = r0 + rg; p < r1; p += RG) {
        float kp[4];
        kp_row(ws, nbr, Pg, K, n, NC, Cp, j0, cell, p, kp);
        const float4 v = ld4(Pg + (size_t)p * NC + j0);
        sums[0][0] += v.x * kp[0];
        sums[0][1] += v.y * kp[1];
        sums[0][2] += v.z * kp[2];
        sums[0][3] += v.w * kp[3];
      }
      stash<1>(sums, red, WC, slot);
    }
    cluster_sums(1);
    if (warp == 0) {
      for (int j = lane; j < NC; j += 32) {
        const float pkp = tot_s[0][j], rz = rz_s[j];
        const bool ok = pkp > 0.f && isfinite(pkp) && isfinite(rz) && brel_s[j] >= tol;
        alpha_s[j] = ok ? rz / pkp : 0.f;
      }
    }
    __syncthreads();
    // X += alpha P; R -= alpha K P (K P again: n K gathers beside the n^2 product)
    if (!producer) {
      const float a[4] = {alpha_s[j0], alpha_s[j0 + 1], alpha_s[j0 + 2], alpha_s[j0 + 3]};
      for (int p = r0 + rg; p < r1; p += RG) {
        float kp[4];
        kp_row(ws, nbr, Pg, K, n, NC, Cp, j0, cell, p, kp);
        const size_t o = (size_t)p * NC + j0;
        const float4 p4 = ld4(Pg + o), r4 = ld4(Rg + o), x4 = ld4(Xg + o);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w}, rv[4] = {r4.x, r4.y, r4.z, r4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        float x[4], r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = xv[e] + pv[e] * a[e];
          r[e] = rv[e] - kp[e] * a[e];
        }
        st4(Xg + o, mk4(x));
        st4(Rg + o, mk4(r));
      }
    }
    fence_async_global();
    cluster_sync();  // every CTA's rows of R before the product reads them
    K1L_ADD(cyc[4], m0)
    // Z = prec(R); rz_new = <R, Z>; |R|^2
    apply(Epi::kUpdate);
    if (!producer) stash<2>(part, red, WC, slot);
    cluster_sums(2);
    if (warp == 0) {
      float m = -INFINITY;
      int nan = 0, any = 0;
      for (int j = lane; j < NC; j += 32) {
        const float rz_new = tot_s[0][j], rz = rz_s[j];
        beta_s[j] = rz > 0.f ? rz_new / rz : 0.f;
        rz_s[j] = rz_new;
        const float rel = sqrtf(tot_s[1][j]) / fnorm_s[j];
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
    if (!producer) {
      const float b[4] = {beta_s[j0], beta_s[j0 + 1], beta_s[j0 + 2], beta_s[j0 + 3]};
      const bool im[4] = {imp_s[j0] != 0, imp_s[j0 + 1] != 0, imp_s[j0 + 2] != 0,
                          imp_s[j0 + 3] != 0};
      const bool any_im = im[0] || im[1] || im[2] || im[3];
      for (int p = r0 + rg; p < r1; p += RG) {
        const size_t o = (size_t)p * NC + j0;
        const float4 z4 = ld4(Zg + o), p4 = ld4(Pg + o);
        st4(Pg + o, make_float4(z4.x + p4.x * b[0], z4.y + p4.y * b[1], z4.z + p4.z * b[2],
                                z4.w + p4.w * b[3]));
        if (any_im) {
          const float4 x4 = ld4(Xg + o);
          const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (im[e]) bX[fo[e] + (size_t)p * Cp] = x[e];
        }
      }
    }
    cluster_sync();  // every CTA's rows of P before the next matvec
  }
  if (t == 0 && rank == 0) iters[blk] = k_s;
#ifdef K1L_PROBE
  K1L_ADD(cyc[5], c_start)
  if (blockIdx.x < 8192) {
    if (t == 0)
      for (int q : {0, 1, 4, 5, 6}) g_k1l_cycles[blockIdx.x * 8 + q] = cyc[q];
    if (producer && lane == 0)
      for (int q : {2, 3}) g_k1l_cycles[blockIdx.x * 8 + q] = cyc[q];
  }
#endif
  cluster_sync();  // no CTA leaves while a peer may still read its column sums
}

template <int BK>
int launch_large(const void* ws, const void* F, const void* Mt, const void* nbr, void* Xout,
                 void* iters, void* state, int K, int n, int s, int Cp, int CB, int CS, int S,
                 int threads, int smem, float tol, int maxiter, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(stencil_pcg_large_kernel<BK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Cp / CB) * CS);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, stencil_pcg_large_kernel<BK>, static_cast<const float*>(ws),
                         static_cast<const float*>(F), static_cast<const float*>(Mt),
                         static_cast<const int*>(nbr), static_cast<float*>(Xout),
                         static_cast<float*>(state), static_cast<int*>(iters), K, n, s, Cp, CB,
                         CS, S, tol, maxiter);
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

// The large instance's configuration (CB cells a block, CS CTAs a block
// that split its rows, S ring buffers, threads = the consumer warps'
// threads + one producer warp, smem) is the wrapper's launch_config(n, s,
// C); Minv comes
// tiled ([row tile][k tile][k / 4][row][4], BK = 4, 8, 16 at 4, 8, 12 or
// more columns); state holds (npad + 3 n) s CB floats a block.  Refused as
// above.
extern "C" int hommx_stencil_pcg_large_f32(const void* ws, const void* F, const void* Mt,
                                           const void* nbr, void* Xout, void* iters,
                                           void* state, int K, int n, int s, int Cp, int CB,
                                           int CS, int S, int threads, int smem, float tol,
                                           int maxiter, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  const int NC = s * CB;
  if (s < 1 || CB < 1 || K < 1 || n < 1 || NC % 4 != 0 || NC > LMAX_NC || CS < 1 ||
      CS > LMAX_CS || Cp < CB || Cp % CB != 0 || S < 2 || S > LMAX_STAGES)
    return bad;
  const int CG = NC / 4, Tc = CG == 3 ? 192 : 256, RG = Tc / CG;
  const int BK = NC >= 12 ? 16 : NC, BM = LTILE / BK;  // RG rows x LTM = BM
  if (threads != Tc + 32 || RG * LTM != BM) return bad;
  const int nr = ((n + CS - 1) / CS + BM - 1) / BM * BM;
  if ((long)nr * (CS - 1) >= n) return bad;  // every CTA owns rows
  const long need = 4L * ((long)S * (LTILE + BK * NC) + (Tc / 32) * warp_cols(CG) * 2 * 4);
  if (need != smem) return bad;
  switch (BK) {
    case 4:
      return launch_large<4>(ws, F, Mt, nbr, Xout, iters, state, K, n, s, Cp, CB, CS, S,
                             threads, smem, tol, maxiter, stream);
    case 8:
      return launch_large<8>(ws, F, Mt, nbr, Xout, iters, state, K, n, s, Cp, CB, CS, S,
                             threads, smem, tol, maxiter, stream);
    default:
      return launch_large<16>(ws, F, Mt, nbr, Xout, iters, state, K, n, s, Cp, CB, CS, S,
                              threads, smem, tol, maxiter, stream);
  }
}

#ifdef K1L_PROBE
// The probe's per-CTA cycle counts (8192 x 8 int64) into dst.
extern "C" int hommx_k1l_phases(void* dst, void* stream) {
  return (int)cudaMemcpyFromSymbolAsync(dst, g_k1l_cycles, sizeof(g_k1l_cycles), 0,
                                        cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
}
#endif
