// DIA sparse matrix-vector product: y[i] = sum_d vals[d, i] * x[i + off_d],
// with x taken as zero outside [0, N).
//
// Replaces the TPU kernel hommx_tpu/ops/dia.py::dia_spmv_pallas, the macro
// CG matvec.  The TPU version decomposes every offset into aligned row
// windows plus sublane/lane rolls; none of that is needed here: one thread
// per row, the static offsets passed by value in the kernel parameters
// (constant bank), bounds-masked reads of x.
//
// Bound on this card: bytes.  Per row it reads nd values and nd entries
// of x (neighbouring threads read neighbouring addresses for every
// diagonal, and the x reads of one block overlap in L1/L2), and writes one
// value: ~(nd + 2) * 4 bytes of DRAM traffic per row in float32 against
// 2 flops per diagonal, far below the card's operations-per-byte line.  At
// the 512² macro system (N = 263,169, nd = 7) that is 9.47 MB, 2.83 us at
// 3.35 TB/s: a product is a few microseconds of device time, so the host
// path around the launch decides what a CG iteration pays for it.  The
// design keeps that path short: the macro CG prepares the operator once per
// solve (ops/dia.py::DIAOperator: contiguous values, offsets packed for
// this launcher, a reused output buffer), and a product is a few checks and
// one ctypes call into hommx_dia_spmv_f32, which neither allocates nor
// synchronises, so it can also be captured in a CUDA graph.
//
// The grid is about one wave (~1,000 blocks of 256 threads), so each
// thread keeps all of its row's loads in flight at once: the diagonal loop
// is unrolled at compile time for nd = 7 (2D P1) and nd = 15 (3D P1), with
// a generic path for nd <= 96; and a block whose rows i +- max|offset| all
// lie inside [0, N) skips the per-diagonal bounds test (the test is
// uniform over the block, so no warp diverges on it).  On an H100 this
// cut the L2-warm time by 13% and the time after an L2 flush by 3-8%
// (PERF.md, section 6); the flushed time stays near 3.5x the bound.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIAGONALS = 96;  // = ops/dia.py _MAX_DIAGONALS
constexpr int THREADS = 256;

struct Offsets {
  int v[MAX_DIAGONALS];
};

// ND > 0: nd fixed at compile time; ND == 0: nd at run time.
template <int ND>
__device__ __forceinline__ float row_sum(const float* __restrict__ vals,
                                         const Offsets& offs, int nd,
                                         const float* __restrict__ x, int i,
                                         int N, bool interior) {
  constexpr int UNROLL = ND > 0 ? ND : 8;
  const int n = ND > 0 ? ND : nd;
  float acc = 0.f;
  if (interior) {
#pragma unroll (UNROLL)
    for (int d = 0; d < n; ++d)
      acc = fmaf(__ldg(vals + (size_t)d * N + i), __ldg(x + i + offs.v[d]), acc);
  } else {
#pragma unroll (UNROLL)
    for (int d = 0; d < n; ++d) {
      const int j = i + offs.v[d];
      const float xv = (j >= 0 && j < N) ? __ldg(x + j) : 0.f;
      acc = fmaf(__ldg(vals + (size_t)d * N + i), xv, acc);
    }
  }
  return acc;
}

template <int ND>
__global__ void __launch_bounds__(THREADS)
dia_spmv_kernel(const float* __restrict__ vals, Offsets offs, int nd, int pmax,
                const float* __restrict__ x, float* __restrict__ y, int N) {
  const int b0 = blockIdx.x * THREADS;
  const int i = b0 + threadIdx.x;
  const bool interior = b0 >= pmax && b0 + THREADS + pmax <= N;
  if (i >= N) return;
  y[i] = row_sum<ND>(vals, offs, nd, x, i, N, interior);
}

}  // namespace

extern "C" int hommx_dia_spmv_f32(const void* vals, const int* offsets, int nd,
                                  const void* x, void* y, int N, void* stream) {
  if (nd < 1 || nd > MAX_DIAGONALS || N < 1) return (int)cudaErrorInvalidValue;
  Offsets offs;
  int pmax = 0;
  for (int d = 0; d < nd; ++d) {
    offs.v[d] = offsets[d];
    const int a = offsets[d] < 0 ? -offsets[d] : offsets[d];
    pmax = a > pmax ? a : pmax;
  }
  const int blocks = (N + THREADS - 1) / THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  if (nd == 7)
    dia_spmv_kernel<7><<<blocks, THREADS, 0, s>>>(v, offs, nd, pmax, xp, yp, N);
  else if (nd == 15)
    dia_spmv_kernel<15><<<blocks, THREADS, 0, s>>>(v, offs, nd, pmax, xp, yp, N);
  else
    dia_spmv_kernel<0><<<blocks, THREADS, 0, s>>>(v, offs, nd, pmax, xp, yp, N);
  return (int)cudaGetLastError();
}
