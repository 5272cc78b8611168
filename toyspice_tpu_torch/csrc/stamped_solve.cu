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
// (chip_smoke.py gj_flops); one thread per lane through a local-memory
// matrix (n <= 32) is far from both, as in the other kernels.
//
// Past n = 32 (the general engine's Newton, np1 up to NBIG) a lane's
// system no longer fits a thread.  Up to n = 64, stamped_warp_kernel gives
// each lane's system one warp, with no block barrier past the table's
// copy: the warp copies its lane's values to shared memory, sums each cell
// of the term table (in shared memory, once per block; both when they
// fit, else read through the cache) in the table's
// entry order from 0 (the same sums as the per-thread build) into its
// slice of shared memory, applies the ground row and the gmin diagonal,
// and runs gj_warp.cuh's elimination: the rows in registers, two a lane,
// for n <= 48 (four systems a block); in the warp's slice of shared
// memory (odd stride) for n <= 64 (two a block).  Past 64,
// stamped_block_kernel gives each lane a block: it builds the system in
// shared memory as above, a block's threads over the cells, then runs
// gj_kernel.cu's elimination (gj_block.cuh): to n = 96 (GJ_NREG) row i
// goes to thread i's registers (gj_rows, three warps), past it the
// shared-memory body (gj_block, GJ_THREADS threads).
//
// At n = 35 (cw16, 8192 systems; ab_run_kernel.py --stamped on an H100
// 80GB HBM3 at 700 W) the block kernel took 0.73 ms a launch through the
// C entry (0.83-0.91 with its wrapper in chip_smoke), 108 block barriers
// and a shared load and store per element update a system; the warp port
// takes 0.39: the build ~0.06 ms of it, the divisions ~0.07, the rows
// past 32 (a second register slot that three of 32 lanes use) ~0.12.  Its
// bound is operations, ~0.0074 ms: each column is a chain of dependent
// steps at 2 warps a scheduler (234 registers a lane).

#include "gj_block.cuh"
#include "gj_warp.cuh"
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

constexpr int SW_NREG = 48;  // the largest n with the rows in registers
// systems (warps) a block of the warp path: 4 with the rows in registers,
// 2 with them in shared memory (33 KB a warp at n = 64)
__host__ __device__ constexpr int sw_warps(bool reg) { return reg ? 4 : 2; }

// a lane's stamp values are copied to shared memory when they take at most
// this many doubles (8 KB a warp), the term table when it takes at most
// this many ints (64 KB a block); past them the build reads device memory
constexpr int SW_VSTAGE = 1024;
constexpr int SW_TSTAGE = 16384;

// The exchange buffer of the elimination, in doubles: n + 1 with the rows
// in shared memory, SW_NREG + 1 with them in registers (slot indices)
__host__ __device__ inline int warp_buf(int n) {
  return even_up(n > SW_NREG ? n + 1 : SW_NREG + 1);
}

// The shared memory of one warp of the warp path, in doubles (each part
// 16-byte aligned): the system (n rows of stride warp_ld(n)), the
// exchange buffer, and the lane's stamp values (nnz + nrhs) if they are
// staged.
__host__ __device__ inline int warp_slice(int n, int nnz, int nrhs) {
  return even_up(n * warp_ld(n)) + warp_buf(n)
         + (nnz + nrhs <= SW_VSTAGE ? even_up(nnz + nrhs) : 0);
}

// The system of lane `sys` in the warp's slice t of shared memory (stride
// ld, the right-hand side at column n), from the term table in shared
// memory: the lane's values first copied to v (coalesced) if v is given,
// then each cell's terms summed from 0 in table order by the lane of its
// first term, then the ground identity row and gmin on the diagonals
// 1..n-1.
__device__ __forceinline__ void warp_build(const int* tab, int n, int nnz,
                                           int nrhs,
                                           const double* __restrict__ vals,
                                           const double* __restrict__ rvals,
                                           const double* __restrict__ gmin,
                                           size_t sys, double* t, int ld,
                                           double* v, int lane) {
  const int nterm = tab[0];
  const int* row = tab + 1;
  const int* col = row + nterm;
  const int* src = col + nterm;
  const double* vs = vals + sys * nnz;
  const double* rs = rvals + sys * nrhs;
  if (v != nullptr) {
    for (int e = lane; e < nnz; e += 32) v[e] = vs[e];
    for (int e = lane; e < nrhs; e += 32) v[nnz + e] = rs[e];
  }
  for (int e = lane; e < n * ld; e += 32) t[e] = 0.0;
  __syncwarp();
  // a cell's terms are consecutive in the table: the lane of its first
  // term sums them all
  for (int u = lane; u < nterm; u += 32) {
    const int r = row[u], c = col[u];
    if (u > 0 && row[u - 1] == r && col[u - 1] == c) continue;
    double acc = 0.0;
    for (int w = u; w < nterm && row[w] == r && col[w] == c; ++w) {
      const int sidx = src[w];
      acc += v != nullptr ? v[sidx] : sidx < nnz ? vs[sidx] : rs[sidx - nnz];
    }
    t[r * ld + c] = acc;
  }
  __syncwarp();
  const double g = gmin[sys];
  if (lane == 0) t[0] = 1.0;
  for (int r = 1 + lane; r < n; r += 32) t[r * ld + r] = t[r * ld + r] + g;
  __syncwarp();
}

template <bool REG>
__global__ void __launch_bounds__(sw_warps(REG) * 32)
stamped_warp_kernel(const int* __restrict__ tab_g, int tab_len, int n,
                    int nnz, int nrhs, const double* __restrict__ vals,
                    const double* __restrict__ rvals,
                    const double* __restrict__ gmin,
                    double* __restrict__ x_out, int nlanes) {
  extern __shared__ double smem[];
  // the term table, once per block, after the warps' slices
  const int* tab = tab_g;
  if (tab_len <= SW_TSTAGE) {
    int* t_s = reinterpret_cast<int*>(
        smem + (size_t)sw_warps(REG) * warp_slice(n, nnz, nrhs));
    for (int i = threadIdx.x; i < tab_len; i += blockDim.x) t_s[i] = tab_g[i];
    __syncthreads();
    tab = t_s;
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sys = blockIdx.x * sw_warps(REG) + warp;
  if (sys >= nlanes) return;
  const int ld = warp_ld(n);
  double* t = smem + (size_t)warp * warp_slice(n, nnz, nrhs);
  double* q = t + even_up(n * ld);
  double* v = nnz + nrhs <= SW_VSTAGE ? q + warp_buf(n) : nullptr;
  warp_build(tab, n, nnz, nrhs, vals, rvals, gmin, sys, t, ld, v, lane);
  double* x = x_out + (size_t)sys * n;
  if constexpr (REG) {
    double m[2][SW_NREG + 1];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int i = lane + 32 * s;
#pragma unroll
      for (int j = 0; j < SW_NREG; ++j)
        m[s][j] = i < n && j < n ? t[i * ld + j] : 0.0;
      m[s][SW_NREG] = i < n ? t[i * ld + n] : 0.0;
    }
    __syncwarp();
    gj_warp_reg<SW_NREG, 32, 2>(m, n, q, lane, 0xffffffffu, x);
  } else {
    gj_warp_smem<32, 2>(t, ld, n, q, lane, 0xffffffffu, x);
  }
}

template <bool REG>
cudaError_t launch_warp(const int* tab, int tab_len, int n, int nnz,
                        int nrhs, const double* vals, const double* rvals,
                        const double* gmin, double* x, int nlanes,
                        cudaStream_t stream) {
  const size_t shmem =
      (size_t)sw_warps(REG) * warp_slice(n, nnz, nrhs) * sizeof(double)
      + (tab_len <= SW_TSTAGE ? (size_t)tab_len * sizeof(int) : 0);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stamped_warp_kernel<REG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (nlanes + sw_warps(REG) - 1) / sw_warps(REG);
  stamped_warp_kernel<REG><<<blocks, sw_warps(REG) * 32, shmem, stream>>>(
      tab, tab_len, n, nnz, nrhs, vals, rvals, gmin, x, nlanes);
  return cudaGetLastError();
}

// NMAX slots a row in registers (gj_block.cuh's gj_rows), or 0: the
// shared-memory body (gj_block)
template <int NMAX>
__global__ void __launch_bounds__(NMAX ? gj_reg_threads(NMAX) : GJ_THREADS,
                                  gj_min_blocks(NMAX))
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
  if constexpr (NMAX == 0) {
    gj_block(m, n, x_out + lane * n);
  } else {  // thread i takes row i
    const int i = threadIdx.x;
    const bool mine = i < n;
    const double* mr = m + (mine ? i : 0) * ld;
    double r[NMAX + 1];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) r[j] = mine && j < n ? mr[j] : 0.0;
    r[NMAX] = mine ? mr[n] : 0.0;
    gj_rows<NMAX>(r, n, x_out + lane * n);
  }
}

template <int NMAX>
cudaError_t launch_block(const int* tab, int n, int nnz, int nrhs,
                         const double* vals, const double* rvals,
                         const double* gmin, double* x, int nlanes,
                         cudaStream_t stream) {
  const size_t shmem = NMAX ? (size_t)n * (n + 1) * sizeof(double)
                            : gj_shared_bytes(n);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stamped_block_kernel<NMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  stamped_block_kernel<NMAX>
      <<<nlanes, NMAX ? gj_reg_threads(NMAX) : GJ_THREADS, shmem, stream>>>(
          tab, n, nnz, nrhs, vals, rvals, gmin, x);
  return cudaGetLastError();
}

}  // namespace

// Solve nlanes stamped systems of size n on `stream`; returns the
// cudaError_t of the launch (0 on success).  n picks the matrix size:
// one thread per lane up to 32, one warp per lane up to 64, one block per
// lane up to NBIG.
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
  if (n <= SW_NREG)
    return launch_warp<true>(tab, tab_len, n, nnz, nrhs, vals, rvals, gmin,
                             x, nlanes, s);
  if (n <= 64)
    return launch_warp<false>(tab, tab_len, n, nnz, nrhs, vals, rvals,
                              gmin, x, nlanes, s);
  if (n > NBIG) return static_cast<int>(cudaErrorInvalidValue);
  switch (gj_bucket(n)) {  // past 64 the GJ kernel's buckets: 72, 96, 0
    case 72:
      return launch_block<72>(tab, n, nnz, nrhs, vals, rvals, gmin, x,
                              nlanes, s);
    case 96:
      return launch_block<96>(tab, n, nnz, nrhs, vals, rvals, gmin, x,
                              nlanes, s);
    default:
      return launch_block<0>(tab, n, nnz, nrhs, vals, rvals, gmin, x,
                             nlanes, s);
  }
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
