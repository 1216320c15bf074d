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
// Bound on this card: the preconditioner product, 2 n^2 s flops per cell
// and iteration (n = 256: ~260 kFLOP vs ~7 kFLOP for the stencil matvec),
// in full-f32 FMA (no TF32, no library call).  The block keeps the residual
// R of its cells in shared memory, where the product reads it; Minv rows
// are warp-uniform loads served by L1/L2.  The other Krylov arrays
// (X, P, Z, KP, best X) live in global scratch laid out (s, n, C) with the
// cell index minor, so a half-warp reads 16 consecutive cells and the whole
// working set of a chunk (~20 MB at n = 256, C = 2048) stays L2-resident.
// Per-column reductions and the block's stop flag live in shared memory.
// Simple first version: no tensor cores, no TMA.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CB = 16;              // cells per block (= CELLS_PER_BLOCK)
constexpr int NRG = 16;             // row groups per block
constexpr int THREADS = CB * NRG;   // 256
constexpr int MAX_S = 3;            // scalar P1: s = d <= 3
constexpr int ROWS = 4;             // rows per pass of the prec product
constexpr int STALL_CAP = 60;

// Z[i, p] = sum_q Minv[p, q] R[i, q] for the rows p owned by this thread
// (p = rg, rg + NRG, ...), R staged in shared memory as Rs[(i n + q) CB + c].
template <typename Emit>
__device__ __forceinline__ void prec_rows(const float* __restrict__ Minv,
                                          const float* Rs, int n, int s,
                                          int rg, int c, Emit emit) {
  for (int pb = rg; pb < n; pb += NRG * ROWS) {
    float acc[ROWS][MAX_S];
    int prow[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      prow[u] = pb + u * NRG;
#pragma unroll
      for (int i = 0; i < MAX_S; ++i) acc[u][i] = 0.f;
    }
    for (int q = 0; q < n; ++q) {
      float r[MAX_S];
#pragma unroll
      for (int i = 0; i < MAX_S; ++i)
        r[i] = (i < s) ? Rs[(i * n + q) * CB + c] : 0.f;
#pragma unroll
      for (int u = 0; u < ROWS; ++u) {
        if (prow[u] < n) {
          const float m = __ldg(Minv + (size_t)prow[u] * n + q);
#pragma unroll
          for (int i = 0; i < MAX_S; ++i) acc[u][i] = fmaf(m, r[i], acc[u][i]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (prow[u] < n) {
#pragma unroll
        for (int i = 0; i < MAX_S; ++i)
          if (i < s) emit(i, prow[u], acc[u][i]);
      }
    }
  }
}

// (K P)[i, p] = sum_k ws[k, p] P[i, nbr[k, p]] for the owned rows p.
template <typename Emit>
__device__ __forceinline__ void matvec_rows(const float* __restrict__ ws,
                                            const float* __restrict__ Psrc,
                                            const int* nbr, int K, int n,
                                            int s, int Cp, size_t col, int rg,
                                            Emit emit) {
  const size_t plane = (size_t)n * Cp;
  for (int p = rg; p < n; p += NRG) {
    float acc[MAX_S];
#pragma unroll
    for (int i = 0; i < MAX_S; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float w = ws[((size_t)k * n + p) * Cp + col];
      const size_t q = (size_t)nbr[k * n + p] * Cp + col;
#pragma unroll
      for (int i = 0; i < MAX_S; ++i)
        if (i < s) acc[i] = fmaf(w, Psrc[i * plane + q], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < MAX_S; ++i)
      if (i < s) emit(i, p, acc[i]);
  }
}

__global__ void __launch_bounds__(THREADS)
stencil_pcg_kernel(const float* __restrict__ ws, const float* __restrict__ F,
                   const float* __restrict__ Minv, const int* __restrict__ nbr_g,
                   float* __restrict__ Xc, float* __restrict__ Pw,
                   float* __restrict__ Zw, float* __restrict__ KPw,
                   float* __restrict__ bX, int* __restrict__ iters, int K,
                   int n, int s, int Cp, float tol, int maxiter) {
  extern __shared__ float smem[];
  float* Rs = smem;                      // s * n * CB   residual of the block
  float* red0 = Rs + s * n * CB;         // NRG * s * CB partial column sums
  float* red1 = red0 + NRG * s * CB;     // NRG * s * CB
  int* nbr = reinterpret_cast<int*>(red1 + NRG * s * CB);  // K * n

  __shared__ float rz_s[MAX_S * CB], fnorm_s[MAX_S * CB], brel_s[MAX_S * CB];
  __shared__ float rel_s[MAX_S * CB], alpha_s[MAX_S * CB], beta_s[MAX_S * CB];
  __shared__ int imp_s[MAX_S * CB];
  __shared__ int cont_s, stall_s, k_s;

  const int t = threadIdx.x;
  const int c = t % CB, rg = t / CB;
  const size_t col = (size_t)blockIdx.x * CB + c;
  const size_t plane = (size_t)n * Cp;
  const int ncol = s * CB;
  const float shrink = 1.0f - 1e-4f;
  auto gidx = [&](int i, int p) { return i * plane + (size_t)p * Cp + col; };
  auto sidx = [&](int i, int p) { return (i * n + p) * CB + c; };

  // column sums of the per-thread partials part[i] -> red[(rg s + i) CB + c]
  auto stash = [&](float* red, const float* part) {
#pragma unroll
    for (int i = 0; i < MAX_S; ++i)
      if (i < s) red[(rg * s + i) * CB + c] = part[i];
  };
  auto colsum = [&](const float* red, int ic) {
    const int i = ic / CB, cc = ic % CB;
    float sum = 0.f;
    for (int r = 0; r < NRG; ++r) sum += red[(r * s + i) * CB + cc];
    return sum;
  };
  // lockstep stop test on the block's worst column (thread 0)
  auto decide = [&]() {
    float m = -INFINITY;
    bool nan = false;
    for (int ic = 0; ic < ncol; ++ic) {
      const float v = rel_s[ic];
      if (isnan(v)) nan = true; else m = fmaxf(m, v);
    }
    cont_s = (!nan && m > tol && k_s < maxiter && stall_s < STALL_CAP) ? 1 : 0;
  };

  for (int j = t; j < K * n; j += THREADS) nbr[j] = nbr_g[j];
  for (int i = 0; i < s; ++i)
    for (int p = rg; p < n; p += NRG) Rs[sidx(i, p)] = F[gidx(i, p)];
  __syncthreads();

  // X = prec(F); best X = X
  prec_rows(Minv, Rs, n, s, rg, c, [&](int i, int p, float v) {
    Xc[gidx(i, p)] = v;
    bX[gidx(i, p)] = v;
  });
  __syncthreads();

  // R = F - K X (kept in Rs); |F|, |R|
  {
    float pff[MAX_S] = {0.f, 0.f, 0.f}, prr[MAX_S] = {0.f, 0.f, 0.f};
    matvec_rows(ws, Xc, nbr, K, n, s, Cp, col, rg, [&](int i, int p, float v) {
      const float f = F[gidx(i, p)];
      const float r = f - v;
      Rs[sidx(i, p)] = r;
      pff[i] += f * f;
      prr[i] += r * r;
    });
    stash(red0, pff);
    stash(red1, prr);
  }
  __syncthreads();
  if (t < ncol) {
    const float fn = sqrtf(colsum(red0, t)) + 1e-30f;
    fnorm_s[t] = fn;
    rel_s[t] = sqrtf(colsum(red1, t)) / fn;
    brel_s[t] = rel_s[t];
  }
  __syncthreads();

  // Z = prec(R); P = Z; rz = <R, Z>
  {
    float prz[MAX_S] = {0.f, 0.f, 0.f};
    prec_rows(Minv, Rs, n, s, rg, c, [&](int i, int p, float v) {
      Zw[gidx(i, p)] = v;
      Pw[gidx(i, p)] = v;
      prz[i] += Rs[sidx(i, p)] * v;
    });
    stash(red0, prz);
  }
  __syncthreads();
  if (t < ncol) rz_s[t] = colsum(red0, t);
  if (t == 0) {
    k_s = 0;
    stall_s = 0;
  }
  __syncthreads();
  if (t == 0) decide();
  __syncthreads();

  while (cont_s) {
    // KP = K P; pkp = <P, KP>
    {
      float ppk[MAX_S] = {0.f, 0.f, 0.f};
      matvec_rows(ws, Pw, nbr, K, n, s, Cp, col, rg, [&](int i, int p, float v) {
        KPw[gidx(i, p)] = v;
        ppk[i] += Pw[gidx(i, p)] * v;
      });
      stash(red0, ppk);
    }
    __syncthreads();
    if (t < ncol) {
      const float pkp = colsum(red0, t);
      const float rz = rz_s[t];
      const bool ok = pkp > 0.f && isfinite(pkp) && isfinite(rz) && brel_s[t] >= tol;
      alpha_s[t] = ok ? rz / pkp : 0.f;
    }
    __syncthreads();
    // X += alpha P; R -= alpha KP
    for (int i = 0; i < s; ++i) {
      const float a = alpha_s[i * CB + c];
      for (int p = rg; p < n; p += NRG) {
        const size_t g = gidx(i, p);
        Xc[g] = Xc[g] + Pw[g] * a;
        Rs[sidx(i, p)] = Rs[sidx(i, p)] - KPw[g] * a;
      }
    }
    __syncthreads();
    // Z = prec(R); rz_new = <R, Z>; |R|
    {
      float prz[MAX_S] = {0.f, 0.f, 0.f}, prr[MAX_S] = {0.f, 0.f, 0.f};
      prec_rows(Minv, Rs, n, s, rg, c, [&](int i, int p, float v) {
        Zw[gidx(i, p)] = v;
        const float r = Rs[sidx(i, p)];
        prz[i] += r * v;
        prr[i] += r * r;
      });
      stash(red0, prz);
      stash(red1, prr);
    }
    __syncthreads();
    if (t < ncol) {
      const float rz_new = colsum(red0, t);
      const float rz = rz_s[t];
      beta_s[t] = rz > 0.f ? rz_new / rz : 0.f;
      rz_s[t] = rz_new;
      const float rel = sqrtf(colsum(red1, t)) / fnorm_s[t];
      const float brel = brel_s[t];
      const bool improved = rel < brel * shrink && isfinite(rel);
      if (improved) brel_s[t] = fminf(rel, brel);
      rel_s[t] = rel;
      imp_s[t] = improved ? 1 : 0;
    }
    __syncthreads();
    if (t == 0) {
      int any = 0;
      for (int ic = 0; ic < ncol; ++ic) any |= imp_s[ic];
      stall_s = any ? 0 : stall_s + 1;
      k_s += 1;
      decide();
    }
    // P = Z + beta P; best X where the column improved
    for (int i = 0; i < s; ++i) {
      const float b = beta_s[i * CB + c];
      const bool imp = imp_s[i * CB + c] != 0;
      for (int p = rg; p < n; p += NRG) {
        const size_t g = gidx(i, p);
        Pw[g] = Zw[g] + Pw[g] * b;
        if (imp) bX[g] = Xc[g];
      }
    }
    __syncthreads();
  }
  if (t == 0) iters[blockIdx.x] = k_s;
}

}  // namespace

extern "C" int hommx_stencil_pcg_f32(const void* ws, const void* F,
                                     const void* Minv, const void* nbr,
                                     void* work, void* Xout, void* iters,
                                     int K, int n, int s, int Cp, float tol,
                                     int maxiter, void* stream) {
  if (s < 1 || s > MAX_S || K < 1 || n < 1 || Cp < CB || Cp % CB != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)s * n * CB + 2 * (size_t)NRG * s * CB) +
                      sizeof(int) * (size_t)K * n;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stencil_pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  float* w = static_cast<float*>(work);
  const size_t sz = (size_t)s * n * Cp;
  stencil_pcg_kernel<<<Cp / CB, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<const float*>(F),
      static_cast<const float*>(Minv), static_cast<const int*>(nbr), w, w + sz,
      w + 2 * sz, w + 3 * sz, static_cast<float*>(Xout), static_cast<int*>(iters),
      K, n, s, Cp, tol, maxiter);
  return (int)cudaGetLastError();
}
