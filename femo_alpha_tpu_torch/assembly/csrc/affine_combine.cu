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
// Bound: device-memory bytes. It reads K basis values and writes one
// output value per entry, (K+1)*nd^2*nc*sizeof(T) + nc*sizeof(T) bytes in
// all, for at most 2K-1 flops per entry.
//
// Design, against what held the first version (a grid-stride loop over
// the flat index, one 8-byte element per thread and step) back:
// - No division: a 2-D grid, blockIdx.x over chunks of cells and
//   blockIdx.y over tiles of the nd^2 rows, so no thread computes
//   `index % nc` (a 64-bit remainder by a runtime divisor is a software
//   routine of dozens of instructions on sm_90, most of the instruction
//   stream at K = 1).
// - Coefficients once per cell: each thread owns VEC consecutive cells
//   (16 bytes) and R = max(1, kLoads/K) rows; it loads theta for its cells
//   once and forms theta^p_k in registers, reused across its rows.
// - Bytes in flight: all R*K 16-byte read-only loads of a thread are
//   issued before its multiply-adds, then its 16-byte stores. Loads and
//   stores keep the default cache policy: evict-first loads of the basis
//   (__ldcs) cost warm time at nc 800, where the basis stays in the 50 MB
//   L2, and gained nothing cold (tools/k2_bench.py, PERF.md).
// - K is a template parameter (1..4), so the term loop unrolls; K = 1 is
//   one load, one multiply and one store per entry.
// - The arithmetic per entry is the first version's, so every path keeps
//   its digits: theta^p by repeated multiplication from 1, the first term
//   a product, each later term one fused multiply-add in k order.
// - A scalar (VEC = 1) instance takes odd nc or pointers that are not
//   16-byte aligned.
// - The grid covers the whole slab, one tile per block (no grid-stride
//   loop).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxTerms = 4;
constexpr int kThreadsX = 32;  // along cells: a warp covers 512 bytes of a row
constexpr int kThreadsY = 4;   // along rows
constexpr int kLoads = 4;      // basis loads per thread: R = kLoads / K rows

template <int K>
constexpr int rows_per_thread() {
  return kLoads / K > 1 ? kLoads / K : 1;
}

struct Powers {
  int p[kMaxTerms];
};

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// 16-byte (or scalar) read-only loads and stores of VEC consecutive cells
__device__ __forceinline__ void load(const double* p, double (&v)[2]) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
template <typename T>
__device__ __forceinline__ void load(const T* p, T (&v)[1]) {
  v[0] = __ldg(p);
}

__device__ __forceinline__ void store(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T>
__device__ __forceinline__ void store(T* p, const T (&v)[1]) {
  *p = v[0];
}

// blockDim = (kThreadsX, kThreadsY); a block covers kThreadsX*VEC cells
// and kThreadsY*R rows. Requires nc % VEC == 0 and 16-byte aligned B,
// theta and out when VEC > 1.
template <typename T, int VEC, int K, int R>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
    affine_combine_kernel(const T* __restrict__ B, const T* __restrict__ theta,
                          T* __restrict__ out, Powers powers, int64_t ndnd,
                          int64_t nc) {
  const int64_t c =
      (static_cast<int64_t>(blockIdx.x) * kThreadsX + threadIdx.x) * VEC;
  if (c >= nc) return;
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.y) * (kThreadsY * R) + threadIdx.y;
  const int64_t slab = ndnd * nc;  // one basis term

  T th[VEC];
  load(theta + c, th);
  T coef[K][VEC];
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      T r = T(1);
      for (int q = 0; q < powers.p[k]; ++q) r *= th[v];
      coef[k][v] = r;
    }
  }

  T b[R][K][VEC];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t row = row0 + j * kThreadsY;
    if (row < ndnd) {
#pragma unroll
      for (int k = 0; k < K; ++k) load(B + k * slab + row * nc + c, b[j][k]);
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t row = row0 + j * kThreadsY;
    if (row < ndnd) {
      T acc[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = coef[0][v] * b[j][0][v];
#pragma unroll
      for (int k = 1; k < K; ++k) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          acc[v] = fma_rn(coef[k][v], b[j][k][v], acc[v]);
        }
      }
      store(out + row * nc + c, acc);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int VEC, int K>
cudaError_t launch_terms(const T* B, const T* theta, T* out,
                         const Powers& powers, int64_t ndnd, int64_t nc,
                         cudaStream_t stream) {
  constexpr int R = rows_per_thread<K>();
  const int64_t bx = (nc / VEC + kThreadsX - 1) / kThreadsX;
  const int64_t by = (ndnd + kThreadsY * R - 1) / (kThreadsY * R);
  if (bx > INT32_MAX || by > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  const dim3 block(kThreadsX, kThreadsY);
  affine_combine_kernel<T, VEC, K, R>
      <<<grid, block, 0, stream>>>(B, theta, out, powers, ndnd, nc);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* B, const T* theta, T* out, int K,
                       const Powers& powers, int64_t ndnd, int64_t nc,
                       cudaStream_t s) {
  switch (K) {
    case 1: return launch_terms<T, VEC, 1>(B, theta, out, powers, ndnd, nc, s);
    case 2: return launch_terms<T, VEC, 2>(B, theta, out, powers, ndnd, nc, s);
    case 3: return launch_terms<T, VEC, 3>(B, theta, out, powers, ndnd, nc, s);
    case 4: return launch_terms<T, VEC, 4>(B, theta, out, powers, ndnd, nc, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const T* B, const T* theta, T* out, int K, const int* p,
           int64_t ndnd, int64_t nc, void* stream) {
  if (K < 1 || K > kMaxTerms) return static_cast<int>(cudaErrorInvalidValue);
  if (ndnd <= 0 || nc <= 0) return 0;
  Powers powers{};
  for (int k = 0; k < K; ++k) powers.p[k] = p[k];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kVec = 16 / sizeof(T);
  cudaError_t err;
  if (nc % kVec == 0 && aligned16(B) && aligned16(theta) && aligned16(out)) {
    err = launch_vec<T, kVec>(B, theta, out, K, powers, ndnd, nc, s);
  } else {
    err = launch_vec<T, 1>(B, theta, out, K, powers, ndnd, nc, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// p: host array of K integer powers (K <= 4). Launches on `stream` and
// returns the CUDA error of the launch (0 when none).
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
