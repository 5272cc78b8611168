// The AC small-signal solve of every (instance, frequency) pair in one
// launch, in f64: to 2N = 64 a segment of 16 or 32 lanes of one warp per
// pair, past it a block per pair.
//
// Replaces the TPU kernel toyspice_tpu/ops/pallas_ac.py::_ac_kernel (body
// _ac_core, launched at pallas_ac.py:164 through ac_solve_batch).  The AC
// system is exactly linear in omega: one assemble per instance at
// omega = 1 (engine/ac.py, ops/assemble.py assemble_system_ac) gives the
// conductances G and the susceptance base B^ (N x N, ground rows baked in)
// and the phasor RHS r (2N).  Lane = b*F + f, omega = 2*pi*freq[f]:
//
//   M = [[G, -(omega B^)], [omega B^, G]] | r,
//   Gauss-Jordan with partial pivoting (the largest |pivot| among unused
//   rows, the lowest row on a tie; a zero pivot poisons its row), x (2N) =
//   [Re x; Im x].
//
// G, B^ and r are read once per instance (index lane / F) from (B, ...)
// rows, not repeated per frequency as the TPU wrapper's lanes() does
// (pallas_ac.py:129-136): it had to lay every lane's values out in VMEM
// tiles, while the F systems of one instance are neighbouring segments
// (or blocks) here and read the same rows through the cache.  The TPU
// kernel carries double-float (hi, lo) f32 pairs; here omega*B^ is one f64
// product (ac_entry), as in ops/ac.py::ac_plain, and the build uses
// -fmad=false.  Like the TPU kernel, it takes every N: no (B, F, 2N, 2N)
// tensor is written to device memory at any size.
//
// Design, by 2N: a system per segment, its row i in lane i of the
// segment, and gj_warp.cuh's elimination: a shuffle butterfly for the
// pivot, the pivot row's quotients through the segment's slice of shared
// memory, no block barrier.  2N <= 16 (np1 <= 8): 16 lanes and the rows in
// registers, two systems a warp; 2N <= 32: 32 lanes, registers; 2N <= 64
// (np1 <= 32): 32 lanes, two rows each in the warp's slice of shared
// memory (65 doubles a row would not fit the register file).  The first
// port kept the 2N x (2N+1) matrix in a per-thread array in local memory
// (2.2 KB a thread at 2N = 16) and was 3.4x slower than one
// torch.linalg.solve.  Past 64 a block builds the system with ac_entry
// and eliminates it with csrc/gj_block.cuh's bodies, those of the GJ
// kernel (csrc/gj_kernel.cu), whose bits are gj_plain's, ops/newton.py's
// gauss_jordan, the elimination ac_plain runs: to 2N = GJ_NREG = 96 row i
// in thread i's registers (gj_rows, buckets 72 and 96), to GJ_NWIDE = 144
// the system in the registers of a 512-thread block (gj_wide, buckets 127
// and 144), to NBIG = 168 the pointer body in shared memory (gj_block),
// past it the same body on a block's slice of a workspace in device
// memory, a bounded grid whose blocks loop over the systems (ops/solve.py
// work_for sizes it).  Only the loaders are the AC kernel's own.
//
// Bound: bytes for small systems (each instance's 2N^2 + 2N values, each
// lane's 2N outputs), the 2N elimination's operations for larger ones
// (chip_smoke.py ac_flops).

#include "gj_block.cuh"
#include "gj_warp.cuh"

namespace {

using namespace tsr;

constexpr int AC_THREADS = 128;  // a block: 4 warps
constexpr int AC_SMEM_WARPS = 2;  // a block of the shared-memory bucket

// the element (i, j) of lane `sys`'s real 2N system: [[G, -wB], [wB, G]]
__device__ __forceinline__ double ac_entry(const double* g, const double* bh,
                                           double w, int n, int i, int j) {
  const int gi = i < n ? i : i - n;
  const int gj = j < n ? j : j - n;
  if ((i < n) == (j < n)) return g[gi * n + gj];
  const double wb = w * bh[gi * n + gj];
  return i < n ? -wb : wb;
}

template <int NMAX, int W>
__global__ void __launch_bounds__(AC_THREADS)
ac_kernel(int np1, int nf, const double* __restrict__ gm,
          const double* __restrict__ bm, const double* __restrict__ rhs,
          const double* __restrict__ omega, double* __restrict__ x_out,
          int nsys) {
  // a segment's exchange buffer, 16-byte aligned (NMAX + 1 used)
  __shared__ __align__(16) double sbuf[AC_THREADS / W][NMAX + 2];
  const int seg = threadIdx.x / W;
  const int lane = threadIdx.x & (W - 1);
  const int sys = blockIdx.x * (AC_THREADS / W) + seg;
  if (sys >= nsys) return;  // the whole segment leaves together
  const unsigned mask = segment_mask<W>(threadIdx.x & 31);
  const int b = sys / nf;
  const int n = np1, n2 = 2 * np1;
  const double w = omega[sys - b * nf];
  const double* g = gm + (size_t)b * n * n;
  const double* bh = bm + (size_t)b * n * n;

  double m[1][NMAX + 1];
#pragma unroll
  for (int j = 0; j <= NMAX; ++j) m[0][j] = 0.0;
  if (lane < n2) {
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n2) m[0][j] = ac_entry(g, bh, w, n, lane, j);
    m[0][NMAX] = rhs[(size_t)b * n2 + lane];
  }
  gj_warp_reg<NMAX, W, 1>(m, n2, sbuf[seg], lane, mask,
                          x_out + (size_t)sys * n2);
}

__global__ void __launch_bounds__(AC_SMEM_WARPS * 32)
ac_smem_kernel(int np1, int nf, const double* __restrict__ gm,
               const double* __restrict__ bm, const double* __restrict__ rhs,
               const double* __restrict__ omega, double* __restrict__ x_out,
               int nsys) {
  extern __shared__ double smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sys = blockIdx.x * AC_SMEM_WARPS + warp;
  if (sys >= nsys) return;
  const int b = sys / nf;
  const int n = np1, n2 = 2 * np1, ld = warp_ld(n2);
  double* t = smem + (size_t)warp * (n2 * ld + n2 + 1);
  double* q = t + n2 * ld;
  const double w = omega[sys - b * nf];
  const double* g = gm + (size_t)b * n * n;
  const double* bh = bm + (size_t)b * n * n;
  for (int e = lane; e < n2 * n2; e += 32) {
    const int i = e / n2, j = e - i * n2;
    t[i * ld + j] = ac_entry(g, bh, w, n, i, j);
  }
  for (int i = lane; i < n2; i += 32) t[i * ld + n2] = rhs[(size_t)b * n2 + i];
  __syncwarp();
  gj_warp_smem<32, 2>(t, ld, n2, q, lane, 0xffffffffu,
                      x_out + (size_t)sys * n2);
}

// 2N in (64, GJ_NREG]: row i of system blockIdx.x on thread i, in
// registers (gj_rows), NMAX slots a row
template <int NMAX>
__global__ void __launch_bounds__(gj_reg_threads(NMAX), gj_min_blocks(NMAX))
ac_rows_kernel(int np1, int nf, const double* __restrict__ gm,
               const double* __restrict__ bm, const double* __restrict__ rhs,
               const double* __restrict__ omega, double* __restrict__ x_out) {
  const size_t sys = blockIdx.x;
  const int b = static_cast<int>(sys / nf);
  const int n = np1, n2 = 2 * np1;
  const double w = omega[sys - (size_t)b * nf];
  const double* g = gm + (size_t)b * n * n;
  const double* bh = bm + (size_t)b * n * n;
  const int i = threadIdx.x;
  const bool row = i < n2;
  double m[NMAX + 1];
#pragma unroll
  for (int j = 0; j < NMAX; ++j)
    m[j] = row && j < n2 ? ac_entry(g, bh, w, n, i, j) : 0.0;
  m[NMAX] = row ? rhs[(size_t)b * n2 + i] : 0.0;
  gj_rows<NMAX>(m, n2, x_out + sys * n2);
}

// 2N in (GJ_NREG, GJ_NWIDE], a bucket of NB: the system in the registers
// of a 512-thread block (gj_wide), row i on warp i mod 16, column j on
// lane j mod 32, each thread building its own elements
template <int NB>
__global__ void __launch_bounds__(GJ_WIDE_THREADS, 1)
ac_wide_kernel(int np1, int nf, const double* __restrict__ gm,
               const double* __restrict__ bm, const double* __restrict__ rhs,
               const double* __restrict__ omega, double* __restrict__ x_out) {
  constexpr int R = gj_wide_rows(NB), S = gj_wide_cols(NB);
  const size_t sys = blockIdx.x;
  const int b = static_cast<int>(sys / nf);
  const int n = np1, n2 = 2 * np1;
  const double w = omega[sys - (size_t)b * nf];
  const double* g = gm + (size_t)b * n * n;
  const double* bh = bm + (size_t)b * n * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double m[R][S];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = GJ_WIDE_WARPS * r + warp;
#pragma unroll
    for (int c = 0; c < S; ++c) {
      const int j = 32 * c + lane;
      m[r][c] = i >= n2 ? 0.0
              : j < n2 ? ac_entry(g, bh, w, n, i, j)
              : j == n2 ? rhs[(size_t)b * n2 + i] : 0.0;
    }
  }
  gj_wide<R, S>(m, n2, x_out + sys * n2);
}

// 2N past GJ_NWIDE: the pointer body (gj_block) on the system built in t
// (stride 2N + 1, the right-hand side at column 2N): in dynamic shared
// memory to NBIG (work null, a block a system), past it in block k's
// slice of work, block k eliminating systems k, k + gridDim.x, ...
__global__ void __launch_bounds__(GJ_WORK_THREADS)
ac_block_kernel(int np1, int nf, const double* __restrict__ gm,
                const double* __restrict__ bm,
                const double* __restrict__ rhs,
                const double* __restrict__ omega, double* __restrict__ x_out,
                long long nsys, double* __restrict__ work) {
  extern __shared__ double ac_smem[];
  const int n = np1, n2 = 2 * np1;
  const size_t ld = n2 + 1;
  double* t = work ? work + blockIdx.x * gj_slice_doubles(n2) : ac_smem;
  for (long long sys = blockIdx.x; sys < nsys; sys += gridDim.x) {
    __syncthreads();  // the last system's x is read out of t
    const int b = static_cast<int>(sys / nf);
    const double w = omega[sys - (long long)b * nf];
    const double* g = gm + (size_t)b * n * n;
    const double* bh = bm + (size_t)b * n * n;
    for (int e = threadIdx.x; e < n2 * n2; e += blockDim.x) {
      const int i = e / n2, j = e - i * n2;
      t[i * ld + j] = ac_entry(g, bh, w, n, i, j);
    }
    for (int i = threadIdx.x; i < n2; i += blockDim.x)
      t[i * ld + n2] = rhs[(size_t)b * n2 + i];
    __syncthreads();
    gj_block(t, n2, x_out + (size_t)sys * n2);
  }
}

template <int NMAX, int W>
cudaError_t launch(int np1, int nf, const double* g, const double* bh,
                   const double* r, const double* omega, double* x,
                   int nsys, cudaStream_t stream) {
  constexpr int per_block = AC_THREADS / W;
  const int blocks = (nsys + per_block - 1) / per_block;
  ac_kernel<NMAX, W><<<blocks, AC_THREADS, 0, stream>>>(np1, nf, g, bh, r,
                                                         omega, x, nsys);
  return cudaGetLastError();
}

cudaError_t launch_smem(int np1, int nf, const double* g, const double* bh,
                        const double* r, const double* omega, double* x,
                        int nsys, cudaStream_t stream) {
  const int n2 = 2 * np1;
  const size_t shmem = (size_t)AC_SMEM_WARPS * (n2 * warp_ld(n2) + n2 + 1)
                       * sizeof(double);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ac_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (nsys + AC_SMEM_WARPS - 1) / AC_SMEM_WARPS;
  ac_smem_kernel<<<blocks, AC_SMEM_WARPS * 32, shmem, stream>>>(
      np1, nf, g, bh, r, omega, x, nsys);
  return cudaGetLastError();
}

template <int NMAX>
cudaError_t launch_rows(int np1, int nf, const double* g, const double* bh,
                        const double* r, const double* omega, double* x,
                        int nsys, cudaStream_t stream) {
  ac_rows_kernel<NMAX><<<nsys, gj_reg_threads(NMAX), 0, stream>>>(
      np1, nf, g, bh, r, omega, x);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_wide(int np1, int nf, const double* g, const double* bh,
                        const double* r, const double* omega, double* x,
                        int nsys, cudaStream_t stream) {
  ac_wide_kernel<NB><<<nsys, GJ_WIDE_THREADS, 0, stream>>>(np1, nf, g, bh,
                                                           r, omega, x);
  return cudaGetLastError();
}

cudaError_t launch_block(int np1, int nf, const double* g, const double* bh,
                         const double* r, const double* omega, double* x,
                         int nsys, double* work, long long work_len,
                         cudaStream_t stream) {
  const int n2 = 2 * np1;
  unsigned blocks = static_cast<unsigned>(nsys);
  size_t shmem = 0;
  if (n2 > NBIG) {
    const long long slices = work_len / (long long)gj_slice_doubles(n2);
    if (work == nullptr || slices < 1) return cudaErrorInvalidValue;
    if (slices < nsys) blocks = static_cast<unsigned>(slices);
  } else {
    work = nullptr;
    shmem = gj_shared_bytes(n2);
    if (shmem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          ac_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shmem));
      if (err != cudaSuccess) return err;
    }
  }
  ac_block_kernel<<<blocks, GJ_WORK_THREADS, shmem, stream>>>(
      np1, nf, g, bh, r, omega, x, nsys, work);
  return cudaGetLastError();
}

}  // namespace

// Launch the AC kernel for nb instances of nf frequencies on `stream`;
// returns the cudaError_t of the launch (0 on success).  np1 picks the
// body.  Past 2np1 = NBIG, work holds work_len doubles, room for at least
// one gj_slice_doubles(2np1) slice (ops/solve.py work_for: a block an SM);
// up to NBIG work is not read.  Every np1 runs; a lane count past int32
// is refused.
extern "C" int tsr_ac(int np1, int nb, int nf, const double* g,
                      const double* bh, const double* r, const double* omega,
                      double* x, double* work, long long work_len,
                      void* stream) {
  const long long lanes = (long long)nb * nf;
  if (lanes <= 0) return 0;
  if (lanes > 0x7fffffffLL || np1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nl = static_cast<int>(lanes);
  const int n2 = 2 * np1;
  if (np1 <= 8) return launch<16, 16>(np1, nf, g, bh, r, omega, x, nl, s);
  if (np1 <= 16) return launch<32, 32>(np1, nf, g, bh, r, omega, x, nl, s);
  if (np1 <= 32) return launch_smem(np1, nf, g, bh, r, omega, x, nl, s);
  if (n2 <= GJ_NREG)
    return gj_bucket(n2) == 72
               ? launch_rows<72>(np1, nf, g, bh, r, omega, x, nl, s)
               : launch_rows<96>(np1, nf, g, bh, r, omega, x, nl, s);
  if (gj_wide_bucket(n2) == GJ_WIDE_MID)
    return launch_wide<GJ_WIDE_MID>(np1, nf, g, bh, r, omega, x, nl, s);
  if (gj_wide_bucket(n2) == GJ_NWIDE)
    return launch_wide<GJ_NWIDE>(np1, nf, g, bh, r, omega, x, nl, s);
  return launch_block(np1, nf, g, bh, r, omega, x, nl, work, work_len, s);
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
