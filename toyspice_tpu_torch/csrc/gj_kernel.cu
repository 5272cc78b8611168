// Batched dense Gauss-Jordan with partial pivoting: x = a^-1 b for every
// system of a (B, n, n) and b (B, n) f64 pair, one thread block of 128
// threads per system.
//
// Replaces the TPU kernel toyspice_tpu/ops/pallas_solve.py::_gj_kernel
// (launched at pallas_solve.py:297 by pallas_solve_batched, the batching
// rule of ops/solve.py::linear_solve): the general engine's dense solves,
// the OP's linear-devices-only initial estimate (engine/op.py:48-59) and
// the general AC's (2np1, 2np1) system per (instance, frequency)
// (engine/ac.py:127-141).  Per system the block copies [a | b] into shared
// memory and runs gj_block.cuh's elimination: the largest |pivot| among
// the unused rows, the lowest row on a tie, a zero pivot's poison row and
// a NaN pivot column's all-NaN x, with the operations of newton.cuh's
// per-thread gauss_jordan and of ops/solve.py::gj_plain in the same order.
//
// The TPU kernel's double-float (hi, lo) f32 pairs, its batch-last (n, n,
// 8, W) folding and its one-hot pivot contractions exist because the TPU
// has no f64; none of that carries over.
//
// Bound: bytes.  Each system reads n^2 + n values and writes n: 6.0 f64
// operations per byte at n = 72 (chip_smoke.py lu_flops), below the
// card's 10 (34 TFLOP/s of f64 over 3.35 TB/s).  The
// design is the simple one: one block per system, the matrix in shared
// memory (41 KB at n = 72, 132 KB at n = 128, so 1-5 blocks per SM) and
// three block barriers per column; several systems per block, register
// tiles and cp.async loads are later work.

#include "gj_block.cuh"

namespace {

using namespace tsr;

__global__ void __launch_bounds__(GJ_THREADS)
gj_kernel(int n, const double* __restrict__ a, const double* __restrict__ b,
          double* __restrict__ x) {
  extern __shared__ double m[];
  const size_t sys = blockIdx.x;
  const int ld = n + 1;
  const double* as = a + sys * n * n;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    m[i * ld + (e - i * n)] = as[e];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    m[i * ld + n] = b[sys * n + i];
  __syncthreads();
  gj_block(m, n, x + sys * n);
}

}  // namespace

// Solve nsys systems of size n (1 <= n <= NBIG) on `stream`; returns the
// cudaError_t of the launch (0 on success).
extern "C" int tsr_gj(int n, const double* a, const double* b, double* x,
                      long long nsys, void* stream) {
  if (nsys <= 0) return 0;
  if (n < 1 || n > NBIG || nsys > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shmem = gj_shared_bytes(n);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gj_kernel<<<static_cast<unsigned>(nsys), GJ_THREADS, shmem,
              static_cast<cudaStream_t>(stream)>>>(n, a, b, x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
