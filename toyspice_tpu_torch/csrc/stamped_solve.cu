// Build and solve one MNA system per lane from flat stamp values, one
// thread per lane, in f64.
//
// Replaces the TPU kernel toyspice_tpu/ops/pallas_solve.py::
// _build_solve_kernel (launched at pallas_solve.py:469 through
// solve_stamped_for): the general engine's solve of each Newton iteration,
// and the whole of a linear deck's Newton (engine/newton.py nr_linear): the
// linear OP with its rescue rungs, every point of a linear DC sweep, the
// bias of a linear AC.  Per lane:
//
//   m = 0; for each stamp term t, in the pattern's entry order:
//     m[row[t]][col[t]] += value[src[t]]   (vals, then the RHS values
//     rvals; column n is the right-hand side)
//   row 0 := the ground identity row, x[0] = 0;
//   m[r][r] += gmin for r = 1 .. n-1 (matrix/circuit.go:107-114);
//   Gauss-Jordan with partial pivoting (newton.cuh: the largest |pivot|
//   among unused rows, the lowest row on a tie; a zero pivot poisons its
//   row, pallas_solve.py:17-20).
//
// The (row, col) pattern is static per deck (ops/solve_stamped.py turns it
// into the int32 term table, entries into row 0 dropped): each cell sums
// its entries in the order _cell_groups lists them, from 0.  The TPU kernel
// unrolls that pattern at trace time over double-float (hi, lo) f32 pairs
// folded to (8, W) tiles; here the table is data in shared memory, so one
// build serves every deck, and the values are native f64.
// ops/solve_stamped.py::solve_plain is the same arithmetic as torch
// operations, and the build uses -fmad=false.
//
// Bound: bytes for small systems (each lane reads its nnz + nrhs values and
// gmin and writes n), the elimination's operations for larger ones
// (chip_smoke.py gj_flops); both are far below what one thread per lane
// through a local-memory matrix reaches, as in the other kernels.
//
// Past n = 32 (the general engine's Newton, np1 up to NBIG) a lane's
// system no longer fits a thread: stamped_block_kernel gives each lane a
// block of GJ_THREADS threads and builds the system in shared memory, each
// cell summed by one thread in the table's entry order from 0 (the same
// sums as the per-thread build), then runs gj_block.cuh's elimination,
// whose element operations are gauss_jordan's.  The term table stays in
// device memory there (the matrix takes the shared memory).

#include "gj_block.cuh"
#include "newton.cuh"

namespace {

using namespace tsr;

template <int NMAX>
__global__ void __launch_bounds__(THREADS)
stamped_kernel(const int* __restrict__ tab_g, int tab_len, int n, int nnz,
               int nrhs, const double* __restrict__ vals,
               const double* __restrict__ rvals,
               const double* __restrict__ gmin, double* __restrict__ x_out,
               int nlanes) {
  extern __shared__ int tab[];
  for (int i = threadIdx.x; i < tab_len; i += blockDim.x) tab[i] = tab_g[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nlanes) return;

  const int nterm = tab[0];
  const int* row = tab + 1;
  const int* col = row + nterm;
  const int* src = col + nterm;
  const double* v = vals + (size_t)lane * nnz;
  const double* rv = rvals + (size_t)lane * nrhs;

  double m[NMAX][NMAX + 1];
  double x[NMAX];
  for (int i = 0; i < n; ++i)
    for (int j = 0; j <= n; ++j) m[i][j] = 0.0;
  for (int t = 0; t < nterm; ++t) {
    const int s = src[t];
    m[row[t]][col[t]] += s < nnz ? v[s] : rv[s - nnz];
  }
  m[0][0] = 1.0;
  const double g = gmin[lane];
  for (int r = 1; r < n; ++r) m[r][r] = m[r][r] + g;
  gauss_jordan<NMAX>(m, n, x);
  for (int i = 0; i < n; ++i) x_out[(size_t)lane * n + i] = x[i];
}

template <int NMAX>
cudaError_t launch(const int* tab, int tab_len, int n, int nnz, int nrhs,
                   const double* vals, const double* rvals,
                   const double* gmin, double* x, int nlanes,
                   cudaStream_t stream) {
  const int blocks = (nlanes + THREADS - 1) / THREADS;
  const size_t shmem = (size_t)tab_len * sizeof(int);
  stamped_kernel<NMAX><<<blocks, THREADS, shmem, stream>>>(
      tab, tab_len, n, nnz, nrhs, vals, rvals, gmin, x, nlanes);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(GJ_THREADS)
stamped_block_kernel(const int* __restrict__ tab, int n, int nnz, int nrhs,
                     const double* __restrict__ vals,
                     const double* __restrict__ rvals,
                     const double* __restrict__ gmin,
                     double* __restrict__ x_out) {
  extern __shared__ double m[];
  const size_t lane = blockIdx.x;
  const int ld = n + 1;
  const int nterm = tab[0];
  const int* row = tab + 1;
  const int* col = row + nterm;
  const int* src = col + nterm;
  const double* v = vals + lane * nnz;
  const double* rv = rvals + lane * nrhs;
  for (int e = threadIdx.x; e < n * ld; e += blockDim.x) m[e] = 0.0;
  __syncthreads();
  // a cell's terms are consecutive in the table: the thread of its first
  // term sums them all
  for (int t = threadIdx.x; t < nterm; t += blockDim.x) {
    const int r = row[t], c = col[t];
    if (t > 0 && row[t - 1] == r && col[t - 1] == c) continue;
    double acc = 0.0;
    for (int u = t; u < nterm && row[u] == r && col[u] == c; ++u) {
      const int s = src[u];
      acc += s < nnz ? v[s] : rv[s - nnz];
    }
    m[r * ld + c] = acc;
  }
  __syncthreads();
  const double g = gmin[lane];
  if (threadIdx.x == 0) m[0] = 1.0;
  for (int r = 1 + threadIdx.x; r < n; r += blockDim.x)
    m[r * ld + r] = m[r * ld + r] + g;
  __syncthreads();
  gj_block(m, n, x_out + lane * n);
}

cudaError_t launch_block(const int* tab, int n, int nnz, int nrhs,
                         const double* vals, const double* rvals,
                         const double* gmin, double* x, int nlanes,
                         cudaStream_t stream) {
  const size_t shmem = gj_shared_bytes(n);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stamped_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  stamped_block_kernel<<<nlanes, GJ_THREADS, shmem, stream>>>(
      tab, n, nnz, nrhs, vals, rvals, gmin, x);
  return cudaGetLastError();
}

}  // namespace

// Solve nlanes stamped systems of size n on `stream`; returns the
// cudaError_t of the launch (0 on success).  n picks the matrix size:
// one thread per lane up to 32, one block per lane up to NBIG.
extern "C" int tsr_stamped(int n, const int* tab, int tab_len, int nnz,
                           int nrhs, const double* vals, const double* rvals,
                           const double* gmin, double* x, int nlanes,
                           void* stream) {
  if (nlanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 8)
    return launch<8>(tab, tab_len, n, nnz, nrhs, vals, rvals, gmin, x,
                     nlanes, s);
  if (n <= 16)
    return launch<16>(tab, tab_len, n, nnz, nrhs, vals, rvals, gmin, x,
                      nlanes, s);
  if (n <= 32)
    return launch<32>(tab, tab_len, n, nnz, nrhs, vals, rvals, gmin, x,
                      nlanes, s);
  if (n <= NBIG)
    return launch_block(tab, n, nnz, nrhs, vals, rvals, gmin, x, nlanes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
