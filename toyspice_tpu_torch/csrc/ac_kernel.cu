// The AC small-signal solve of every (instance, frequency) pair in one
// launch, one thread per pair, in f64.
//
// Replaces the TPU kernel toyspice_tpu/ops/pallas_ac.py::_ac_kernel (body
// _ac_core, launched at pallas_ac.py:164 through ac_solve_batch).  The AC
// system is exactly linear in omega: one assemble per instance at
// omega = 1 (engine/ac.py, ops/assemble.py assemble_system_ac) gives the
// conductances G and the susceptance base B^ (N x N, ground rows baked in)
// and the phasor RHS r (2N).  Lane = b*F + f, omega = 2*pi*freq[f]:
//
//   M = [[G, -(omega B^)], [omega B^, G]] | r,
//   Gauss-Jordan with partial pivoting (newton.cuh: the largest |pivot|
//   among unused rows, the lowest row on a tie; a zero pivot poisons its
//   row), x (2N) = [Re x; Im x].
//
// G, B^ and r are read once per instance (index lane / F) from (B, ...)
// rows, not repeated per frequency as the TPU wrapper's lanes() does
// (pallas_ac.py:129-136): it had to lay every lane's values out in VMEM
// tiles, while threads here read their instance's rows from memory (the F
// threads of one instance are neighbours and share the cache lines).  The
// TPU kernel carries double-float (hi, lo) f32 pairs; here omega*B^ is one
// f64 product, as in ops/ac.py::ac_plain, and the build uses -fmad=false.
//
// The matrix is 2N x (2N+1) in a per-thread array: N2MAX 16, 32 or 64 for
// np1 <= 8, 16, 32 (64 x 65 f64 is 33 KB of local memory per thread).
//
// Bound: bytes for small systems (each instance's 2N^2 + 2N values, each
// lane's 2N outputs), the 2N elimination's operations for larger ones
// (chip_smoke.py gj_flops).  One thread per lane through local memory is
// latency-bound, as in the other kernels.

#include "newton.cuh"

namespace {

using namespace tsr;

template <int N2MAX>
__global__ void __launch_bounds__(THREADS)
ac_kernel(int np1, int nf, const double* __restrict__ gm,
          const double* __restrict__ bm, const double* __restrict__ rhs,
          const double* __restrict__ omega, double* __restrict__ x_out,
          int nlanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nlanes) return;
  const int b = lane / nf;
  const int n = np1, n2 = 2 * np1;
  const double w = omega[lane - b * nf];
  const double* g = gm + (size_t)b * n * n;
  const double* bh = bm + (size_t)b * n * n;
  const double* r = rhs + (size_t)b * n2;

  double m[N2MAX][N2MAX + 1];
  double x[N2MAX];
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      const double gij = g[i * n + j];
      const double wb = w * bh[i * n + j];
      m[i][j] = gij;
      m[i][n + j] = -wb;
      m[n + i][j] = wb;
      m[n + i][n + j] = gij;
    }
  }
  for (int i = 0; i < n2; ++i) m[i][n2] = r[i];
  gauss_jordan<N2MAX>(m, n2, x);
  for (int i = 0; i < n2; ++i) x_out[(size_t)lane * n2 + i] = x[i];
}

template <int N2MAX>
cudaError_t launch(int np1, int nf, const double* g, const double* bh,
                   const double* r, const double* omega, double* x,
                   int nlanes, cudaStream_t stream) {
  const int blocks = (nlanes + THREADS - 1) / THREADS;
  ac_kernel<N2MAX><<<blocks, THREADS, 0, stream>>>(np1, nf, g, bh, r, omega,
                                                   x, nlanes);
  return cudaGetLastError();
}

}  // namespace

// Launch the AC kernel for nb instances of nf frequencies on `stream`;
// returns the cudaError_t of the launch (0 on success).  np1 picks the
// matrix size.
extern "C" int tsr_ac(int np1, int nb, int nf, const double* g,
                      const double* bh, const double* r, const double* omega,
                      double* x, void* stream) {
  const long long lanes = (long long)nb * nf;
  if (lanes <= 0) return 0;
  if (lanes > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nl = static_cast<int>(lanes);
  if (np1 <= 8) return launch<16>(np1, nf, g, bh, r, omega, x, nl, s);
  if (np1 <= 16) return launch<32>(np1, nf, g, bh, r, omega, x, nl, s);
  if (np1 <= 32) return launch<64>(np1, nf, g, bh, r, omega, x, nl, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
