// K2: affine design combine  Ae[e,c] = sum_k theta[c]^p_k * B[k,e,c]
// over the lane-major element-matrix layout (e = i*nd + j, cells innermost).
//
// Replaces the Pallas TPU kernel femo_alpha_tpu/assembly/pallas_kernels.py
// ::combine_df_pallas (body _make_combine_df_kernel). The TPU kernel works
// on a float-float (hi, lo) pair of f32 words only because Mosaic has no
// f64; Hopper has native f64, so this kernel computes, in one rounding per
// term, the value the TPU pair encodes after df_to_f64
// (femo_alpha_tpu/assembly/affine.py::_affine_combine). It re-assembles the
// fine operator and every multigrid level for each new design.
//
// Bound: device-memory bandwidth. It reads K basis values and writes one
// output value per entry (K = 2 on the shell: (K+1)*8 bytes per 2K flops).
//
// Design: a grid-stride loop over the flattened (e, c) index, so threads of
// a warp touch consecutive addresses of every basis slab and of the output.
// The per-cell coefficients theta^p_k are recomputed in registers from
// theta[c] by repeated multiplication (integer powers, at most 4 terms),
// which costs nothing next to the memory traffic.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTerms = 4;

struct Powers {
  int p[kMaxTerms];
};

template <typename T>
__device__ __forceinline__ T ipow(T t, int p) {
  T r = T(1);
  for (int q = 0; q < p; ++q) r *= t;
  return r;
}

template <typename T>
__global__ void affine_combine_kernel(const T* __restrict__ B,
                                      const T* __restrict__ theta,
                                      T* __restrict__ out, int K,
                                      Powers powers, int64_t ndnd,
                                      int64_t nc) {
  const int64_t total = ndnd * nc;  // one basis slab; B[k] starts at k*total
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const T t = theta[idx % nc];
    T acc = ipow(t, powers.p[0]) * B[idx];
    for (int k = 1; k < K; ++k) {
      acc += ipow(t, powers.p[k]) * B[k * total + idx];
    }
    out[idx] = acc;
  }
}

template <typename T>
int launch(const T* B, const T* theta, T* out, int K, const int* p,
           int64_t ndnd, int64_t nc, void* stream) {
  if (K < 1 || K > kMaxTerms) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = ndnd * nc;
  if (total <= 0) return 0;
  Powers powers{};
  for (int k = 0; k < K; ++k) powers.p[k] = p[k];
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // 32 blocks per SM, then stride
  affine_combine_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      B, theta, out, K, powers, ndnd, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p: host array of K integer powers (K <= 4).
extern "C" int femo_affine_combine_f64(const double* B, const double* theta,
                                       double* out, int K, const int* p,
                                       int64_t ndnd, int64_t nc,
                                       void* stream) {
  return launch<double>(B, theta, out, K, p, ndnd, nc, stream);
}

extern "C" int femo_affine_combine_f32(const float* B, const float* theta,
                                       float* out, int K, const int* p,
                                       int64_t ndnd, int64_t nc,
                                       void* stream) {
  return launch<float>(B, theta, out, K, p, ndnd, nc, stream);
}
