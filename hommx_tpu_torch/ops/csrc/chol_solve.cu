// K3: batched SPD direct solve with one refinement sweep, one cell per block.
//
// Replaces the TPU kernel hommx_tpu/ops/chol_kernel.py::_chol_kernel_rolled
// (and its unrolled twin _chol_kernel), called through fused_chol_solve.
// For every cell c it solves Ks[c] X = Fs[:, :, c] for the s right-hand
// sides: a Cholesky factorization with clamped pivots sqrt(max(p, eps))
// (never raises; a non-SPD cell gives large-but-finite factors), forward
// and backward substitution, then ONE refinement sweep R = F - Ks X against
// the original (equilibrated) operator and X += solve(R).
//
// Layouts: Ks (C, n, n) cell-major, row-major per cell; Fs and X (n, s, C)
// cell-minor, as the JAX package's kernel takes them.
//
// What bounds it.  At the elasticity cell (n = 192, s = 6) one cell is
// n^3/3 = 2.36 MFLOP of factorization, 4 triangular solves of n^2 s =
// 0.88 MFLOP and a refinement matvec of 2 n^2 s = 0.44 MFLOP: 3.69 MFLOP
// against 157 KB of traffic (Ks read once, F read, X written), 23.5 FLOP
// per byte.  TF32 tensor cores are ruled out (they round inputs the way the
// TPU's bf16 passes did, which cost 3.3e-3 on A*), so the ceiling is the
// float32 CUDA-core rate, 67 TFLOP/s, and the kernel is compute-bound:
// ~59 us per 1080-cell chunk against ~50 us of memory time.
//
// What the design does about it (a simple first version, no wgmma or TMA):
// - one block of 256 threads per cell; the whole operator sits in dynamic
//   shared memory (n*n floats), so the factorization reads no global
//   memory.  Ks[c] is symmetric, so its row-major image is taken as the
//   column-major matrix: column k is contiguous, and every inner loop walks
//   a column with consecutive lanes on consecutive words (no bank
//   conflicts).  The factor thus reads the upper triangle where the plain
//   version reads the lower one; the two agree up to the assembly's
//   rounding, and the refinement runs against the full row-major Ks.
// - the factorization is right-looking by columns: all threads scale
//   column k, then each warp updates whole trailing columns j (lanes over
//   rows i >= j), with a __syncthreads between the two phases.  The
//   diagonal of L (p / sqrt(max(p, eps)), as the reference keeps it) goes
//   to a separate array so that no thread overwrites A[k][k] while the
//   others read it.
// - substitution: one warp per right-hand side, no block-wide barrier;
//   forward right-looking (column axpys), backward left-looking (column dot
//   products reduced with shuffles).
// - the refinement re-reads Ks[c] from global memory row by row (the
//   factor overwrote the shared copy), one warp per row, coalesced.
// Shared memory is (n*n + n + 2*n*s) floats: the largest n is 234 at s = 6
// (232,448 bytes a block may opt into); the wrapper checks the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRhs = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// L y = b in place (b overwritten by y); L column-major in A, diagonal in dg.
__device__ void forward_solve(const float* A, const float* dg, float* b, int n,
                              int lane) {
  for (int k = 0; k < n; ++k) {
    const float yk = b[k] / dg[k];
    const float* col = A + (size_t)k * n;
    for (int i = k + 1 + lane; i < n; i += 32) b[i] -= col[i] * yk;
    __syncwarp();
  }
  for (int i = lane; i < n; i += 32) b[i] /= dg[i];
  __syncwarp();
}

// L^T x = y in place: x_k = (y_k - sum_{j>k} L[j][k] x_j) / L[k][k].
__device__ void backward_solve(const float* A, const float* dg, float* b, int n,
                               int lane) {
  for (int k = n - 1; k >= 0; --k) {
    const float* col = A + (size_t)k * n;
    float acc = 0.f;
    for (int j = k + 1 + lane; j < n; j += 32) acc += col[j] * b[j];
    acc = warp_sum(acc);
    if (lane == 0) b[k] = (b[k] - acc) / dg[k];
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
chol_solve_f32_kernel(const float* __restrict__ K, const float* __restrict__ F,
                      float* __restrict__ X, int C, int n, int s, float eps) {
  extern __shared__ float smem[];
  float* A = smem;           // n*n: the operator, then L (lower, column-major)
  float* dg = A + n * n;     // n: diagonal of L
  float* B = dg + n;         // s*n: right-hand side / solution, column q at q*n
  float* Xs = B + s * n;     // s*n: first solution
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Kc = K + (size_t)c * n * n;

  for (int t = tid; t < n * n; t += kThreads) A[t] = Kc[t];
  for (int t = tid; t < n * s; t += kThreads) {
    const int i = t / s, q = t - i * s;
    B[q * n + i] = F[(size_t)t * C + c];
  }
  __syncthreads();

  // ---- factorization: right-looking, one column per step ----------------
  for (int k = 0; k < n; ++k) {
    const float p = A[k * n + k];
    const float piv = sqrtf(p < eps ? eps : p);  // a NaN pivot stays NaN
    float* colk = A + (size_t)k * n;
    for (int i = k + 1 + tid; i < n; i += kThreads) colk[i] = colk[i] / piv;
    if (tid == 0) dg[k] = p / piv;
    __syncthreads();
    for (int j = k + 1 + warp; j < n; j += kWarps) {
      const float ljk = colk[j];
      float* colj = A + (size_t)j * n;
      for (int i = j + lane; i < n; i += 32) colj[i] -= colk[i] * ljk;
    }
    __syncthreads();
  }

  // ---- solve, keep X, residual against the original Ks, solve again ------
  for (int q = warp; q < s; q += kWarps) {
    forward_solve(A, dg, B + q * n, n, lane);
    backward_solve(A, dg, B + q * n, n, lane);
  }
  __syncthreads();
  for (int t = tid; t < n * s; t += kThreads) Xs[t] = B[t];
  __syncthreads();
  for (int i = warp; i < n; i += kWarps) {
    const float* Ki = Kc + (size_t)i * n;
    float acc[kMaxRhs];
#pragma unroll
    for (int q = 0; q < kMaxRhs; ++q) acc[q] = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float kij = Ki[j];
#pragma unroll
      for (int q = 0; q < kMaxRhs; ++q)
        if (q < s) acc[q] += kij * Xs[q * n + j];
    }
#pragma unroll
    for (int q = 0; q < kMaxRhs; ++q) {
      if (q < s) {
        const float kx = warp_sum(acc[q]);
        if (lane == 0) B[q * n + i] = F[((size_t)i * s + q) * C + c] - kx;
      }
    }
  }
  __syncthreads();
  for (int q = warp; q < s; q += kWarps) {
    forward_solve(A, dg, B + q * n, n, lane);
    backward_solve(A, dg, B + q * n, n, lane);
  }
  __syncthreads();
  for (int t = tid; t < n * s; t += kThreads) {
    const int i = t / s, q = t - i * s;
    X[(size_t)t * C + c] = Xs[q * n + i] + B[q * n + i];
  }
}

}  // namespace

extern "C" {

// The launch; the wrapper (ops/chol_kernel.py) has checked device, type,
// shapes and the shared-memory bound.
int hommx_chol_solve_f32(const float* K, const float* F, float* X, int C, int n,
                         int s, float eps, cudaStream_t stream) {
  if (C <= 0 || n <= 0 || s <= 0 || s > kMaxRhs) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)n * n + n + 2 * (size_t)n * s);
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chol_solve_f32_kernel<<<C, kThreads, smem, stream>>>(K, F, X, C, n, s, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
