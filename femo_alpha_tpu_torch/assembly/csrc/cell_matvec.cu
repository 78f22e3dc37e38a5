// K1: lane-major per-cell matvec  y[i,c] = sum_j A[i,j,c] * x[j,c].
//
// Replaces the Pallas TPU kernel femo_alpha_tpu/assembly/pallas_kernels.py
// ::cell_matvec_T_pallas (body _matvec_kernel). It is the contraction of
// every matrix-free operator application on the shell solve path: each CG
// matvec of the fine operator and every Chebyshev step and residual of the
// multigrid V-cycle.
//
// Bound: device-memory bandwidth. A (nd*nd*nc values) is read exactly once
// and each value takes one multiply-add, so the kernel does 2 flops per
// 8 bytes in f64 — far below the card's compute roofline.
//
// Design: one thread per (row i, cell c). blockIdx.y picks the row, the
// threads of a block walk consecutive cells, so every load of A[i,j,:]
// and x[j,:] is coalesced along the cell axis (the lane-major layout puts
// cells innermost). x is re-read by the nd row-blocks of a cell column and
// is served from L1/L2. nd and nc are runtime values; a bounds check masks
// the ragged last block, so nc needs no padding.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void cell_matvec_T_kernel(const T* __restrict__ A,
                                     const T* __restrict__ x,
                                     T* __restrict__ y,
                                     int64_t nd, int64_t nc) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (c >= nc) return;
  const int64_t i = blockIdx.y;
  const T* a = A + i * nd * nc + c;
  const T* xc = x + c;
  T acc = T(0);
  for (int64_t j = 0; j < nd; ++j) {
    acc += a[j * nc] * xc[j * nc];
  }
  y[i * nc + c] = acc;
}

template <typename T>
int launch(const T* A, const T* x, T* y, int64_t nd, int64_t nc,
           void* stream) {
  if (nd <= 0 || nc <= 0) return 0;
  if (nd > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>((nc + kThreads - 1) / kThreads),
            static_cast<unsigned>(nd));
  cell_matvec_T_kernel<T><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      A, x, y, nd, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int femo_cell_matvec_T_f64(const double* A, const double* x,
                                      double* y, int64_t nd, int64_t nc,
                                      void* stream) {
  return launch<double>(A, x, y, nd, nc, stream);
}

extern "C" int femo_cell_matvec_T_f32(const float* A, const float* x,
                                      float* y, int64_t nd, int64_t nc,
                                      void* stream) {
  return launch<float>(A, x, y, nd, nc, stream);
}

extern "C" const char* femo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
