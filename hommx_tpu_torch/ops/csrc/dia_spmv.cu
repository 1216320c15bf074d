// DIA sparse matrix-vector product: y[i] = sum_d vals[d, i] * x[i + off_d],
// with x taken as zero outside [0, N).
//
// Replaces the TPU kernel hommx_tpu/ops/dia.py::dia_spmv_pallas, the macro
// CG matvec.  The TPU version decomposes every offset into aligned row
// windows plus sublane/lane rolls; none of that is needed here: one thread
// per row, the static offsets passed by value in the kernel parameters
// (constant bank), bounds-masked reads of x.
//
// Bound on this card: memory.  Per row it reads nd values and nd entries
// of x (neighbouring threads read neighbouring addresses for every
// diagonal, and the x reads of one block overlap in L1/L2), and writes one
// value: ~(nd + 1) * 4 bytes of DRAM traffic per row in float32, 2 flops
// per diagonal.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_DIAGONALS = 96;  // = ops/dia.py _MAX_DIAGONALS
constexpr int THREADS = 256;

struct Offsets {
  int v[MAX_DIAGONALS];
};

__global__ void __launch_bounds__(THREADS)
dia_spmv_kernel(const float* __restrict__ vals, Offsets offs, int nd,
                const float* __restrict__ x, float* __restrict__ y, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  float acc = 0.f;
  for (int d = 0; d < nd; ++d) {
    const int j = i + offs.v[d];
    const float xv = (j >= 0 && j < N) ? __ldg(x + j) : 0.f;
    acc = fmaf(__ldg(vals + (size_t)d * N + i), xv, acc);
  }
  y[i] = acc;
}

}  // namespace

extern "C" int hommx_dia_spmv_f32(const void* vals, const int* offsets, int nd,
                                  const void* x, void* y, int N, void* stream) {
  if (nd < 1 || nd > MAX_DIAGONALS || N < 1) return (int)cudaErrorInvalidValue;
  Offsets offs;
  for (int d = 0; d < nd; ++d) offs.v[d] = offsets[d];
  const int blocks = (N + THREADS - 1) / THREADS;
  dia_spmv_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), offs, nd, static_cast<const float*>(x),
      static_cast<float*>(y), N);
  return (int)cudaGetLastError();
}
