// Batched dense Gauss-Jordan with partial pivoting: x = a^-1 b for every
// system of a (B, n, n) and b (B, n) f64 pair, one thread block per
// system: to n = 96 a row a thread in registers, to GJ_NWIDE = 144 the
// system in the registers of a 512-thread block, to NBIG = 168 the matrix
// in shared memory, past it in device memory (a bounded grid whose blocks
// loop over the systems, each in its slice of a workspace the wrapper
// allocates).
//
// Replaces the TPU kernel toyspice_tpu/ops/pallas_solve.py::_gj_kernel
// (launched at pallas_solve.py:297 by pallas_solve_batched, the batching
// rule of ops/solve.py::linear_solve): the general engine's dense solves,
// the OP's linear-devices-only initial estimate (engine/op.py:48-59) and
// the general AC's (2np1, 2np1) system per (instance, frequency)
// (engine/ac.py:127-141).  Per system the block runs gj_block.cuh's
// elimination: the largest |pivot| among the unused rows, the lowest row
// on a tie, a zero pivot's poison row and a NaN pivot column's all-NaN x,
// with the operations of ops/solve.py::gj_plain (ops/newton.py's
// gauss_jordan) in the same order.
//
// The TPU kernel's double-float (hi, lo) f32 pairs, its batch-last (n, n,
// 8, W) folding and its one-hot pivot contractions exist because the TPU
// has no f64; none of that carries over.
//
// Bound: bytes.  Each system reads n^2 + n values and writes n: 6.0 f64
// operations per byte at n = 72 (chip_smoke.py lu_flops), below the
// card's 10 (34 TFLOP/s of f64 over 3.35 TB/s).  The first port (one
// block of 128 threads, the matrix in shared memory, three block barriers
// a column, every element of every row updated, dead columns included)
// took 86 ms on lc16_ac_8192's 172,032 systems of 72, 39x that bound.
// gj_kernel<NMAX> keeps row i on thread i in registers (gj_block.cuh
// gj_rows: the dead columns fall away, the pivot row alone goes through
// shared memory, a division a thread) and takes ~30 ms there
// (ab_run_kernel.py --gj, an NVIDIA H100 80GB HBM3 at 700 W): what bounds
// it is each column's chain of dependent steps (warp reductions, three
// block barriers, a division of ~130 cycles by probe_latency.py, the
// update) at 4 systems an SM, not bytes or f64 operations.  Each thread
// reads its own row from device memory: staging a system through shared
// memory with coalesced loads first took 20% longer in an earlier form
// of the kernel (82 ms against 68).  Past 96 a row no longer fits a
// thread's registers: gj_wide_kernel spreads the system over the
// registers of 16 warps (gj_block.cuh gj_wide, three block barriers a
// column, every thread on every live column), each thread loading its
// elements straight from a and b (a warp reads 32 consecutive columns of
// a row): on 8192 random systems of 128 it takes 11.9-12.0 ms against
// 59.3 for the pointer body in shared memory at 128 threads and 24.6 at
// 512 (ab_run_kernel.py --gj --floor, an H100 at 700 W).  gj_kernel<0>,
// that pointer body at 512 threads, takes GJ_NWIDE + 1 to NBIG;
// gj_work_kernel the systems past NBIG, whose matrix would not fit a
// block's 227 KB of shared memory.

#include "gj_block.cuh"

namespace {

using namespace tsr;

// System sys of (a, b) into t (stride n + 1, the right-hand side at
// column n) by the whole block, then a block barrier
__device__ inline void load_system(int n, const double* __restrict__ a,
                                   const double* __restrict__ b, size_t sys,
                                   double* t) {
  const size_t ld = n + 1, nn = (size_t)n * n;
  const double* as = a + sys * nn;
  for (size_t e = threadIdx.x; e < nn; e += blockDim.x) {
    const size_t i = e / n;
    t[i * ld + (e - i * n)] = as[e];
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    t[i * ld + n] = b[sys * n + i];
  __syncthreads();
}

// NMAX slots a row in registers (gj_rows), or 0: the shared-memory body
template <int NMAX>
__global__ void __launch_bounds__(NMAX ? gj_reg_threads(NMAX)
                                       : GJ_WORK_THREADS,
                                  gj_min_blocks(NMAX))
gj_kernel(int n, const double* __restrict__ a, const double* __restrict__ b,
          double* __restrict__ x) {
  const size_t sys = blockIdx.x;
  if constexpr (NMAX == 0) {
    extern __shared__ double t[];
    load_system(n, a, b, sys, t);
    gj_block(t, n, x + sys * n);
  } else {
    const int i = threadIdx.x;
    const bool row = i < n;
    const double* ar = a + (sys * n + (row ? i : 0)) * n;
    double m[NMAX + 1];
#pragma unroll
    for (int j = 0; j < NMAX; ++j) m[j] = row && j < n ? ar[j] : 0.0;
    m[NMAX] = row ? b[sys * n + i] : 0.0;
    gj_rows<NMAX>(m, n, x + sys * n);
  }
}

// GJ_NREG < n <= GJ_NWIDE, a bucket of NB: the system in the registers of
// the block's 16 warps (gj_wide), each thread loading its elements
template <int NB>
__global__ void __launch_bounds__(GJ_WIDE_THREADS, 1)
gj_wide_kernel(int n, const double* __restrict__ a,
               const double* __restrict__ b, double* __restrict__ x) {
  constexpr int R = gj_wide_rows(NB), S = gj_wide_cols(NB);
  const size_t sys = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double m[R][S];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = GJ_WIDE_WARPS * r + warp;
    const double* ar = a + (sys * n + (i < n ? i : 0)) * n;
#pragma unroll
    for (int c = 0; c < S; ++c) {
      const int j = 32 * c + lane;
      m[r][c] = i >= n ? 0.0 : j < n ? ar[j] : j == n ? b[sys * n + i] : 0.0;
    }
  }
  gj_wide<R, S>(m, n, x + sys * n);
}

// Past NBIG: block k eliminates systems k, k + gridDim.x, ... in slice k
// of the workspace (gj_slice_doubles(n) each), so that the workspace is
// bounded by the grid, not by nsys
__global__ void __launch_bounds__(GJ_WORK_THREADS)
gj_work_kernel(int n, const double* __restrict__ a,
               const double* __restrict__ b, double* __restrict__ x,
               long long nsys, double* __restrict__ work) {
  double* t = work + blockIdx.x * gj_slice_doubles(n);
  for (long long sys = blockIdx.x; sys < nsys; sys += gridDim.x) {
    __syncthreads();  // the last system's x is read out of t
    load_system(n, a, b, sys, t);
    gj_block(t, n, x + sys * n);
  }
}

template <int NMAX>
cudaError_t launch(int n, const double* a, const double* b, double* x,
                   long long nsys, cudaStream_t stream) {
  size_t shmem = 0;
  int threads = gj_reg_threads(NMAX);
  if constexpr (NMAX == 0) {
    shmem = gj_shared_bytes(n);
    threads = GJ_WORK_THREADS;
    if (shmem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          gj_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shmem));
      if (err != cudaSuccess) return err;
    }
  }
  gj_kernel<NMAX><<<static_cast<unsigned>(nsys), threads, shmem, stream>>>(
      n, a, b, x);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_wide(int n, const double* a, const double* b, double* x,
                        long long nsys, cudaStream_t stream) {
  gj_wide_kernel<NB><<<static_cast<unsigned>(nsys), GJ_WIDE_THREADS, 0,
                       stream>>>(n, a, b, x);
  return cudaGetLastError();
}

}  // namespace

// Solve nsys systems of size n on `stream`; returns the cudaError_t of the
// launch (0 on success).  Past NBIG, work holds work_len doubles, room for
// the slices of the grid's blocks (at least one gj_slice_doubles(n) slice;
// one block per slice, up to nsys): ops/solve.py work_for sizes it at one
// block an SM, ~70 MB at n = 256 on 132 SMs.  Up to NBIG work is not
// read.
extern "C" int tsr_gj(int n, const double* a, const double* b, double* x,
                      long long nsys, double* work, long long work_len,
                      void* stream) {
  if (nsys <= 0) return 0;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > NBIG) {
    const long long slices = work_len / (long long)gj_slice_doubles(n);
    if (work == nullptr || slices < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>(
        slices < nsys ? (slices < 0x7fffffffLL ? slices : 0x7fffffffLL)
                      : nsys);
    gj_work_kernel<<<blocks, GJ_WORK_THREADS, 0, s>>>(n, a, b, x, nsys, work);
    return static_cast<int>(cudaGetLastError());
  }
  if (nsys > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const int wide = gj_wide_bucket(n);
  if (wide == GJ_WIDE_MID)
    return static_cast<int>(launch_wide<GJ_WIDE_MID>(n, a, b, x, nsys, s));
  if (wide == GJ_NWIDE)
    return static_cast<int>(launch_wide<GJ_NWIDE>(n, a, b, x, nsys, s));
  switch (gj_bucket(n)) {
    case 16: err = launch<16>(n, a, b, x, nsys, s); break;
    case 32: err = launch<32>(n, a, b, x, nsys, s); break;
    case 48: err = launch<48>(n, a, b, x, nsys, s); break;
    case 64: err = launch<64>(n, a, b, x, nsys, s); break;
    case 72: err = launch<72>(n, a, b, x, nsys, s); break;
    case 96: err = launch<96>(n, a, b, x, nsys, s); break;
    default: err = launch<0>(n, a, b, x, nsys, s); break;
  }
  return static_cast<int>(err);
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
