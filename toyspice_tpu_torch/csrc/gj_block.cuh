// Block-cooperative Gauss-Jordan of one augmented (n, n+1) f64 system in
// shared memory: the elimination of csrc/gj_kernel.cu (one dense system
// per block) and of csrc/stamped_solve.cu's systems past n = 64 (one
// lane's stamped system per block).  The stamped solve's systems of 33 to
// 64 and the AC kernel's run on gj_warp.cuh (a warp a system).
//
// The counterpart of toyspice_tpu/ops/pallas_solve.py::_gj_eliminate and
// ops/solve.py::_gj_batch_last, which carry double-float (hi, lo) f32
// pairs folded to (8, W) tiles and pick pivot rows by one-hot sums because
// the TPU has no f64; here the values are native f64 and the pivot row is
// indexed.  For each column k:
//
//   1. warp 0 finds the pivot: the largest |m[i][k]| over the unused rows,
//      the lowest row on a tie; a NaN there makes every x NaN;
//   2. the pivot row is divided by the pivot (a division per element, as
//      newton.cuh's gauss_jordan does), or, for a zero pivot, becomes the
//      poison row (1 at column k, inf elsewhere: x goes non-finite,
//      pallas_solve.py:17-20); the factors m[i][k] of the other rows go to
//      a shared vector before any of those rows changes;
//   3. every other element is updated as m[i][j] - f[i] * p[j], a warp per
//      row, its lanes over the columns.
//
// Each element sees the operations of newton.cuh's per-thread
// gauss_jordan in the same order (built with -fmad=false), so the kernels
// and ops/newton.py::gauss_jordan give the same bits; a system with a
// non-finite x gets NaN in every x, as there.
//
// Shared memory: the matrix (n rows of stride n + 1) and, after it, the n
// factors (doubles), the n pivot rows and the n used flags (ints):
// gj_shared_bytes(n).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tsr {

constexpr int GJ_THREADS = 128;  // threads per system
constexpr int NBIG = 128;        // ops/solve.py NBIG: the largest system

__host__ __device__ inline size_t gj_shared_bytes(int n) {
  return ((size_t)n * (n + 1) + n) * sizeof(double) + 2 * (size_t)n * sizeof(int);
}

// Eliminate the system in m (shared memory laid out as above) with the
// whole block and write x[0..n) to x_out.  Every thread of the block must
// call it.
__device__ inline void gj_block(double* m, int n, double* x_out) {
  const int ld = n + 1;
  double* fac = m + (size_t)n * ld;
  int* perm = reinterpret_cast<int*>(fac + n);
  int* used = perm + n;
  __shared__ int s_p, s_nan;
  __shared__ double s_piv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int i = tid; i < n; i += blockDim.x) used[i] = 0;
  __syncthreads();
  int nan_col = 0;
  for (int k = 0; k < n; ++k) {
    if (warp == 0) {
      double best = -1.0;
      int p = -1;
      bool nan = false;
      for (int i = lane; i < n; i += 32) {  // ascending: a lane's first max
        if (used[i]) continue;
        const double a = fabs(m[i * ld + k]);
        if (isnan(a)) nan = true;
        if (a > best) {
          best = a;
          p = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const double ob = __shfl_down_sync(0xffffffffu, best, off);
        const int op = __shfl_down_sync(0xffffffffu, p, off);
        if (op >= 0 && (ob > best || (ob == best && (p < 0 || op < p)))) {
          best = ob;
          p = op;
        }
      }
      nan = __any_sync(0xffffffffu, nan);
      if (lane == 0) {
        s_nan = (nan || p < 0) ? 1 : 0;
        s_p = p;
        if (!s_nan) s_piv = m[p * ld + k];
      }
    }
    __syncthreads();
    if (s_nan) {
      nan_col = 1;
      break;
    }
    const int p = s_p;
    const double piv = s_piv;
    double* prow = m + p * ld;
    for (int j = tid; j <= n; j += blockDim.x)
      prow[j] = piv == 0.0 ? (j == k ? 1.0 : INFINITY) : prow[j] / piv;
    for (int i = tid; i < n; i += blockDim.x)
      if (i != p) fac[i] = m[i * ld + k];
    if (tid == 0) {
      used[p] = 1;
      perm[k] = p;
    }
    __syncthreads();
    for (int i = warp; i < n; i += nwarps) {
      if (i == p) continue;
      const double f = fac[i];
      double* row = m + i * ld;
      for (int j = lane; j <= n; j += 32) row[j] = row[j] - f * prow[j];
    }
    __syncthreads();
  }
  // one non-finite x makes every x NaN, as the JAX package's one-hot
  // gather does
  if (tid == 0) s_nan = nan_col;
  __syncthreads();
  for (int k = tid; k < n && !nan_col; k += blockDim.x)
    if (!isfinite(m[perm[k] * ld + n])) s_nan = 1;
  __syncthreads();
  for (int k = tid; k < n; k += blockDim.x)
    x_out[k] = s_nan ? NAN : m[perm[k] * ld + n];
}

}  // namespace tsr
