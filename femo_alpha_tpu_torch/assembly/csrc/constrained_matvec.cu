// The fused constrained operator
//
//     y = free * A(free * x) + (1 - free) * x,
//     A(v) = sum over cells c of P_c^T Ae[:, :, c] P_c v,
//
// for lane-major element matrices Ae (nd, nd, nc) and a 0/1 mask `free` of
// the dofs that carry no Dirichlet condition: one whole application of the
// strong-BC operator of the shell solve (every CG matvec, and every
// Chebyshev step, residual and Lanczos matvec of the multigrid levels).
//
// Replaces the Pallas TPU kernel femo_alpha_tpu/assembly/pallas_kernels.py
// ::cell_matvec_T_pallas TOGETHER WITH the structured gather, the adjoint
// scatter and the masks (femo_alpha_tpu/assembly/bc.py::constrain_matvec
// around assembly/assemble.py::make_matvec_T) that XLA fused around it in
// the JAX solve, a compiled lax.while_loop. The eager port paid one device
// op for each of those pieces (about 31 per application); here they are
// two kernel launches behind one C call.
//
// Tables (made once per space, femo_alpha_tpu_torch/spaces/space.py):
//   dofmap_T (nd, nc) int32  global dof of local row j of cell c
//   inv      (n, w)   int32  for each dof, its entries i*nc + c of the cell
//                            values, in increasing order, padded with -1
// Both work for any dofmap; w is 4 on the quad meshes of the shell.
//
// Bound: device-memory bytes. Each value of Ae takes one multiply-add.
// At 128x32 f64 (nd 39, nc 4,096, 62,886 dofs) the call must move Ae
// 49.84 MB, x, free and y 3 x 0.50 MB and the tables 1.65 MB: 52.99 MB,
// 15.8 us at 3.35 TB/s. At the first multigrid level (64x16, nc 1,024,
// 16,086 dofs) it is 13.26 MB, 3.96 us from HBM; that level's 12.5 MB of Ae
// stays in the 50 MB L2 across the 13 applications of one V-cycle, so the
// L2 can beat the HBM bound there.
//
// Builds: f64, f32, and f32 element matrices with f64 vectors and f64
// arithmetic (femo_constrained_matvec_T_f32f64: the fine operator under
// storage="f32"; each thread then streams 8 bytes of f32 Ae for its two
// f64 cells, the tiling of the f64 build, so its values are the f64
// build's on the upcast matrices bit for bit). At 128x32 it moves 24.92 MB
// of Ae and the same 3 x 0.50 MB + 1.65 MB: 28.07 MB, 8.4 us.
//
// Design, against what held the standalone K1 (cell_matvec.cu) back:
// - Pass 1 (cell pass): a block takes a tile of cells and ALL nd rows of
//   them. It stages free[d] * x[d] for the tile's dofs in shared memory
//   once (x was re-read by every row-block of K1). Each thread owns one
//   row and 16 bytes of cells (2 f64 or 4 f32), and streams Ae with 16-byte
//   read-only loads in batches of kBatch independent loads issued before
//   their multiply-adds (K1 issued one dependent load-add pair at a time).
//   The tile width is halved until the grid holds two blocks per SM, but
//   not below one 32-byte sector per row: nc 1,024 gives 256 blocks, where
//   K1 at nc 256 gave 39 blocks on 132 SMs. It writes the cell values
//   yc (nd, nc) to a scratch buffer that stays in L2.
// - Pass 2 (dof pass): one thread per dof sums its inv entries of yc in
//   table order, then applies the mask and the identity on constrained
//   dofs and writes y.
// - No atomics: every sum runs in a fixed order, so two applications on the
//   same input give identical bits and CG iteration counts cannot wobble
//   through the operator.
// - The wrapper (cuda_kernels.py::constrained_matvec_T) checks and uploads
//   everything once, when the operator is made; an application is one
//   torch.empty and one call of the C function below, which launches both
//   passes on the given stream.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kBatch = 8;          // Ae loads in flight per thread
constexpr int kDofThreads = 256;
constexpr int kMaxThreads = 1024;
constexpr int kMaxStaticSmem = 48 * 1024;

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
__device__ __forceinline__ void load(const float* p, float (&v)[2]) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
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

// blockDim = (threads along cells, rows); a block's tile is
// blockDim.x * VEC cells. Requires nc % VEC == 0 and 16-byte aligned Ae and
// yc when VEC > 1.
// TA: the element matrices' type; T: the vectors' and the arithmetic's
// (TA = T, or f32 matrices with f64 vectors: the f32-stored operator
// applied in f64, each product of an f32 entry exact in f64)
template <typename TA, typename T, int VEC>
__global__ void cmv_cell_pass_kernel(const TA* __restrict__ A,
                                     const T* __restrict__ x,
                                     const T* __restrict__ free_mask,
                                     const int32_t* __restrict__ dofmap_T,
                                     T* __restrict__ yc, int nd, int nc) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // (nd, tile): free*x of the tile
  const int tile = blockDim.x * VEC;
  const int c0 = blockIdx.x * tile;
  const int nthreads = blockDim.x * blockDim.y;
  for (int k = threadIdx.y * blockDim.x + threadIdx.x; k < nd * tile;
       k += nthreads) {
    const int j = k / tile;
    const int c = c0 + (k - j * tile);
    T v = T(0);
    if (c < nc) {
      const int d = dofmap_T[static_cast<int64_t>(j) * nc + c];
      v = free_mask[d] * x[d];
    }
    xs[k] = v;
  }
  __syncthreads();

  const int cl = threadIdx.x * VEC;
  const int c = c0 + cl;
  if (c >= nc) return;
  const int64_t slab = static_cast<int64_t>(nd) * nc;  // one row i of Ae
  for (int i = threadIdx.y; i < nd; i += blockDim.y) {
    const TA* a = A + i * slab + c;
    T acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = T(0);
    for (int j0 = 0; j0 < nd; j0 += kBatch) {
      TA av[kBatch][VEC];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (j0 + k < nd) load(a + static_cast<int64_t>(j0 + k) * nc, av[k]);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (j0 + k < nd) {
          const T* xr = xs + (j0 + k) * tile + cl;
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            acc[v] = fma_rn(static_cast<T>(av[k][v]), xr[v], acc[v]);
          }
        }
      }
    }
    store(yc + static_cast<int64_t>(i) * nc + c, acc);
  }
}

template <typename T>
__global__ void cmv_dof_pass_kernel(const T* __restrict__ yc,
                                    const int32_t* __restrict__ inv,
                                    const T* __restrict__ x,
                                    const T* __restrict__ free_mask,
                                    T* __restrict__ y, int n, int w) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n) return;
  const int32_t* e = inv + static_cast<int64_t>(d) * w;
  T acc = T(0);
  for (int k = 0; k < w; ++k) {
    const int32_t t = __ldg(e + k);
    if (t >= 0) acc += __ldg(yc + t);
  }
  const T f = free_mask[d];
  y[d] = f * acc + (T(1) - f) * x[d];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TA, typename T, int VEC>
cudaError_t launch_cell_pass(const TA* A, const T* x, const T* free_mask,
                             const int32_t* dofmap_T, T* yc, int nd, int nc,
                             int sms, cudaStream_t stream) {
  // threads along cells: 128 bytes of a row of Ae per block, halved while
  // the grid has fewer than two blocks per SM, never below one 32-byte
  // sector
  constexpr int kThreadBytes = static_cast<int>(VEC * sizeof(T));
  constexpr int min_tx = 32 / kThreadBytes;
  int tx = 128 / kThreadBytes;
  auto blocks = [&](int t) { return (nc + t * VEC - 1) / (t * VEC); };
  while (tx > min_tx && blocks(tx) < 2 * sms) tx /= 2;
  while (tx > 1 && static_cast<size_t>(nd) * tx * VEC * sizeof(T) >
                       static_cast<size_t>(kMaxStaticSmem)) {
    tx /= 2;
  }
  const size_t smem = static_cast<size_t>(nd) * tx * VEC * sizeof(T);
  if (smem > static_cast<size_t>(kMaxStaticSmem)) return cudaErrorInvalidValue;
  const int ty = nd < kMaxThreads / tx ? nd : kMaxThreads / tx;
  cmv_cell_pass_kernel<TA, T, VEC>
      <<<static_cast<unsigned>(blocks(tx)), dim3(tx, ty), smem, stream>>>(
          A, x, free_mask, dofmap_T, yc, nd, nc);
  return cudaGetLastError();
}

int sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *sms = cached;
  return 0;
}

template <typename TA, typename T>
int launch(const TA* A, const T* x, const T* free_mask,
           const int32_t* dofmap_T, const int32_t* inv, T* yc, T* y,
           int64_t nd, int64_t nc, int64_t n, int64_t w, void* stream) {
  if (nd <= 0 || nc <= 0 || n <= 0) return 0;
  if (w <= 0 || nd * nc > INT32_MAX || n > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  if (int rc = sm_count(&sms)) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kVec = 16 / sizeof(T);
  const int ind = static_cast<int>(nd), inc = static_cast<int>(nc);
  cudaError_t err;
  if (nc % kVec == 0 && aligned16(A) && aligned16(yc)) {
    err = launch_cell_pass<TA, T, kVec>(A, x, free_mask, dofmap_T, yc, ind,
                                        inc, sms, s);
  } else {
    err = launch_cell_pass<TA, T, 1>(A, x, free_mask, dofmap_T, yc, ind, inc,
                                     sms, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int in = static_cast<int>(n);
  cmv_dof_pass_kernel<T><<<(in + kDofThreads - 1) / kDofThreads, kDofThreads,
                           0, s>>>(yc, inv, x, free_mask, y, in,
                                   static_cast<int>(w));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// yc: (nd, nc) scratch for the cell values; y: (n,) output. Launches both
// passes on `stream` and returns the first CUDA error (0 when none).
extern "C" int femo_constrained_matvec_T_f64(
    const double* A, const double* x, const double* free_mask,
    const int32_t* dofmap_T, const int32_t* inv, double* yc, double* y,
    int64_t nd, int64_t nc, int64_t n, int64_t w, void* stream) {
  return launch<double, double>(A, x, free_mask, dofmap_T, inv, yc, y, nd, nc,
                                n, w, stream);
}

extern "C" int femo_constrained_matvec_T_f32(
    const float* A, const float* x, const float* free_mask,
    const int32_t* dofmap_T, const int32_t* inv, float* yc, float* y,
    int64_t nd, int64_t nc, int64_t n, int64_t w, void* stream) {
  return launch<float, float>(A, x, free_mask, dofmap_T, inv, yc, y, nd, nc,
                              n, w, stream);
}

// f32 element matrices (storage="f32"), f64 vectors, f64 arithmetic: the
// same operator, bit for bit, as the f64 build on the matrices upcast, with
// half of Ae's bytes
extern "C" int femo_constrained_matvec_T_f32f64(
    const float* A, const double* x, const double* free_mask,
    const int32_t* dofmap_T, const int32_t* inv, double* yc, double* y,
    int64_t nd, int64_t nc, int64_t n, int64_t w, void* stream) {
  return launch<float, double>(A, x, free_mask, dofmap_T, inv, yc, y, nd, nc,
                               n, w, stream);
}
