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
