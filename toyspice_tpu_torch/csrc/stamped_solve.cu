// Build and solve one MNA system per lane from flat stamp values, in f64.
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
//   Gauss-Jordan with partial pivoting (the largest |pivot| among unused
//   rows, the lowest row on a tie; a zero pivot poisons its row,
//   pallas_solve.py:17-20).
//
// The (row, col) pattern is static per deck (ops/solve_stamped.py turns it
// into the int32 term table, entries into row 0 dropped, and its row
// view): each cell sums its entries in the order _cell_groups lists them,
// from 0.  The TPU kernel unrolls that pattern at trace time over
// double-float (hi, lo) f32 pairs folded to (8, W) tiles; here the table
// is data, so one build serves every deck, and the values are native f64.
// ops/solve_stamped.py::solve_plain is the same arithmetic as torch
// operations, and the build uses -fmad=false.
//
// Bound: bytes for small systems (each lane reads its nnz + nrhs values and
// gmin and writes n), the elimination's operations for larger ones
// (chip_smoke.py gj_flops).  Four bodies by n:
//
// to n = 32, stamped_seg_kernel: a lane's system on a segment of W = 4, 8,
// 16 or 32 lanes of a warp (newton.cuh seg_bucket), THREADS / W lanes a
// block, as the OP kernel's Newton iterations: thread i sums row i's terms
// from the row view (each term (col, 0, src, +1), in table order, so that
// each cell sums its own from 0 as above) into its row of the segment's
// slice of shared memory, adds gmin to its diagonal after the sum, and
// gj_warp.cuh's gj_warp_reg eliminates from registers (newton.cuh
// seg_solve).  The view is copied to shared memory once per block when it
// fits SEG_VSTAGE, else read through the cache.  Through the C entry
// (ab_run_kernel.py --stamped, an H100 80GB HBM3 at 700 W) divider_op's
// OP and its sweep (8192 and 172,032 systems of 4) take 0.0065-0.0083
// and 0.0353-0.0357 ms, random systems of 32 (8192) 0.209-0.211, against
// 0.0128-0.0134, 0.0676-0.0687 and 16.95 for one thread a lane over a
// local-memory matrix;
//
// to n = 64, stamped_warp_kernel gives each lane's system one warp, with
// no block barrier past the table's copy: the warp copies its lane's
// values to shared memory, sums each cell of the term table (in shared
// memory, once per block; both when they fit, else read through the
// cache) in the table's entry order from 0 into its slice of shared
// memory, applies the ground row and the gmin diagonal, and runs
// gj_warp.cuh's elimination: the rows in registers, two a lane, for n <=
// 48 (four systems a block); in the warp's slice of shared memory (odd
// stride) for n <= 64 (two a block);
//
// to NBIG = 168, a block per lane: it builds the system in shared memory
// as above, a block's threads over the cells, then runs gj_kernel.cu's
// elimination (gj_block.cuh): to n = 96 (GJ_NREG, stamped_block_kernel)
// row i goes to thread i's registers (gj_rows, three warps); to GJ_NWIDE
// = 144 (stamped_wide_kernel) the system goes to the registers of a
// 512-thread block (gj_wide, each thread its elements from shared
// memory); past it the pointer body on the system in shared memory
// (gj_block, GJ_WORK_THREADS threads).  At n = 130 (a 127-stage RC
// ladder's Newton iteration, 1024 lanes; ab_run_kernel.py --stamped
// --floor, an H100 at 700 W) the wide body takes 1.62 ms a launch against
// 3.21 for that pointer body and 4.22 for the device-memory one;
//
// past NBIG, stamped_work_kernel: the same build and the pointer body in
// each block's slice of a workspace in device memory (the wrapper's), a
// bounded grid whose blocks loop over the lanes.
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

// A term's value in the segment build (newton.cuh seg_solve): the lane's
// vals[src], or past nnz its RHS value rvals[src - nnz]
struct FlatStamp {
  const double* v;
  const double* rv;
  int nnz;
  __device__ __forceinline__ double operator()(int, int src) const {
    return src < nnz ? v[src] : rv[src - nnz];
  }
};

// the row view is copied to shared memory when it takes at most this many
// ints (64 KB a block); past it the build reads it through the cache
constexpr int SEG_VSTAGE = 16384;

// Doubles of one segment's slice: the elimination's exchange buffer and
// the W = NMAX build rows (stride NMAX + 2, so that every row starts
// 16-byte aligned), then NMAX for the x of a segment past the last lane
// (an even count)
template <int NMAX>
__host__ __device__ constexpr int seg_slice() {
  return (NMAX + 2) * (NMAX + 1) + NMAX;
}

// The lanes on segments of W = NMAX threads, THREADS / W lanes a block:
// the row view (view_len ints: each term's int4 (col, 0, src, +1), row by
// row in table order, then the n + 1 row offsets), staged or not, then
// each segment's slice.  The segments of a warp run under one full-warp
// mask; one past the last lane builds the last lane's system and writes
// its x to its slice.
template <int NMAX>
__global__ void __launch_bounds__(THREADS, SEG_BLOCKS)
stamped_seg_kernel(const int* __restrict__ view_g, int view_len, int n,
                   int nnz, int nrhs, const double* __restrict__ vals,
                   const double* __restrict__ rvals,
                   const double* __restrict__ gmin,
                   double* __restrict__ x_out, int nlanes) {
  constexpr int W = NMAX;
  extern __shared__ __align__(16) double seg_smem[];
  const bool staged = view_len <= SEG_VSTAGE;
  const int* view = view_g;
  if (staged) {
    int* v_s = reinterpret_cast<int*>(seg_smem);
    for (int i = threadIdx.x; i < view_len; i += blockDim.x)
      v_s[i] = view_g[i];
    __syncthreads();
    view = v_s;
  }
  const int seg = threadIdx.x / W;
  const int me = threadIdx.x & (W - 1);  // the row this thread owns
  const int lane0 = blockIdx.x * (THREADS / W);
  if (lane0 + (int)(threadIdx.x & ~31) / W >= nlanes) return;  // the warp
  const int lane = lane0 + seg;
  const bool real = lane < nlanes;
  const int row_lane = real ? lane : nlanes - 1;  // rows read, never written
  const int nterm = (view_len - (n + 1)) / 4;
  const int4* ent = reinterpret_cast<const int4*>(view);
  const int* roff = view + 4 * nterm;
  double* sl = seg_smem + (staged ? (view_len + 3) / 4 * 2 : 0)
               + seg * seg_slice<NMAX>();
  double* xs = real ? x_out + (size_t)lane * n : sl + (NMAX + 2) * (NMAX + 1);
  int e0[1], e1[1];
  seg_ranges<NMAX>(roff, nullptr, n, me, e0, e1);
  seg_solve<NMAX, false, true>(
      ent, e0, e1,
      FlatStamp{vals + (size_t)row_lane * nnz,
                rvals + (size_t)row_lane * nrhs, nnz},
      nullptr, gmin[row_lane], n, sl, sl + (NMAX + 2), me, xs);
}

template <int NMAX>
cudaError_t launch_seg(const int* view, int view_len, int n, int nnz,
                       int nrhs, const double* vals, const double* rvals,
                       const double* gmin, double* x, int nlanes,
                       cudaStream_t stream) {
  return seg_launch(
      stamped_seg_kernel<NMAX>,
      seg_shape_of<NMAX>(nlanes, view_len <= SEG_VSTAGE ? view_len : 0,
                         seg_slice<NMAX>()),
      stream, view, view_len, n, nnz, nrhs, vals, rvals, gmin, x, nlanes);
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

// The system of lane `lane` into m (stride n + 1, the right-hand side at
// column n) by the whole block, from the term table: each cell's terms
// summed from 0 in table order by the thread of its cell's first term,
// then the ground identity row and gmin on the diagonals 1..n-1; a block
// barrier after each part
__device__ inline void block_build(const int* __restrict__ tab, int n,
                                   int nnz, int nrhs,
                                   const double* __restrict__ vals,
                                   const double* __restrict__ rvals,
                                   const double* __restrict__ gmin,
                                   size_t lane, double* m) {
  const size_t ld = n + 1;
  const int nterm = tab[0];
  const int* row = tab + 1;
  const int* col = row + nterm;
  const int* src = col + nterm;
  const double* v = vals + lane * nnz;
  const double* rv = rvals + lane * nrhs;
  for (size_t e = threadIdx.x; e < n * ld; e += blockDim.x) m[e] = 0.0;
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
}

// NMAX slots a row in registers (gj_block.cuh's gj_rows), or 0: the
// pointer body (gj_block) on the system in shared memory
template <int NMAX>
__global__ void __launch_bounds__(NMAX ? gj_reg_threads(NMAX)
                                       : GJ_WORK_THREADS,
                                  gj_min_blocks(NMAX))
stamped_block_kernel(const int* __restrict__ tab, int n, int nnz, int nrhs,
                     const double* __restrict__ vals,
                     const double* __restrict__ rvals,
                     const double* __restrict__ gmin,
                     double* __restrict__ x_out) {
  extern __shared__ double m[];
  const size_t lane = blockIdx.x;
  block_build(tab, n, nnz, nrhs, vals, rvals, gmin, lane, m);
  if constexpr (NMAX == 0) {
    gj_block(m, n, x_out + lane * n);
  } else {  // thread i takes row i
    const int ld = n + 1;
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

// GJ_NREG < n <= GJ_NWIDE, a bucket of NB: the system built in shared
// memory, then eliminated in the registers of the block's 16 warps
// (gj_block.cuh's gj_wide)
template <int NB>
__global__ void __launch_bounds__(GJ_WIDE_THREADS, 1)
stamped_wide_kernel(const int* __restrict__ tab, int n, int nnz, int nrhs,
                    const double* __restrict__ vals,
                    const double* __restrict__ rvals,
                    const double* __restrict__ gmin,
                    double* __restrict__ x_out) {
  constexpr int R = gj_wide_rows(NB), S = gj_wide_cols(NB);
  extern __shared__ double t[];
  const size_t lane = blockIdx.x;
  block_build(tab, n, nnz, nrhs, vals, rvals, gmin, lane, t);
  const int ld = n + 1;
  const int me = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  double m[R][S];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = GJ_WIDE_WARPS * r + warp;
    const double* tr = t + (i < n ? i : 0) * ld;
#pragma unroll
    for (int c = 0; c < S; ++c) {
      const int j = 32 * c + me;
      m[r][c] = i < n && j <= n ? tr[j] : 0.0;
    }
  }
  gj_wide<R, S>(m, n, x_out + lane * n);
}

// Past NBIG: block k builds and eliminates lanes k, k + gridDim.x, ... in
// slice k of the workspace (gj_slice_doubles(n) each)
__global__ void __launch_bounds__(GJ_WORK_THREADS)
stamped_work_kernel(const int* __restrict__ tab, int n, int nnz, int nrhs,
                    const double* __restrict__ vals,
                    const double* __restrict__ rvals,
                    const double* __restrict__ gmin,
                    double* __restrict__ x_out, int nlanes,
                    double* __restrict__ work) {
  double* m = work + blockIdx.x * gj_slice_doubles(n);
  for (int lane = blockIdx.x; lane < nlanes; lane += gridDim.x) {
    __syncthreads();  // the last lane's x is read out of m
    block_build(tab, n, nnz, nrhs, vals, rvals, gmin, lane, m);
    gj_block(m, n, x_out + (size_t)lane * n);
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
      <<<nlanes, NMAX ? gj_reg_threads(NMAX) : GJ_WORK_THREADS, shmem,
         stream>>>(tab, n, nnz, nrhs, vals, rvals, gmin, x);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_wide(const int* tab, int n, int nnz, int nrhs,
                        const double* vals, const double* rvals,
                        const double* gmin, double* x, int nlanes,
                        cudaStream_t stream) {
  const size_t shmem = (size_t)n * (n + 1) * sizeof(double);
  if (shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stamped_wide_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return err;
  }
  stamped_wide_kernel<NB><<<nlanes, GJ_WIDE_THREADS, shmem, stream>>>(
      tab, n, nnz, nrhs, vals, rvals, gmin, x);
  return cudaGetLastError();
}

}  // namespace

// Solve nlanes stamped systems of size n on `stream`; returns the
// cudaError_t of the launch (0 on success).  n picks the body: a warp
// segment per lane up to 32 (from the row view), a warp per lane up to 64
// and a block per lane up to NBIG (from the term table: a row a thread to
// 96, the registers of 16 warps to GJ_NWIDE, shared memory above), past it
// a block per lane in device memory: work then holds work_len doubles,
// room for the slices of the grid's blocks (as tsr_gj's; not read up to
// NBIG).
extern "C" int tsr_stamped(int n, const int* tab, int tab_len,
                           const int* view, int view_len, int nnz, int nrhs,
                           const double* vals, const double* rvals,
                           const double* gmin, double* x, int nlanes,
                           double* work, long long work_len, void* stream) {
  if (nlanes <= 0) return 0;
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seg_bucket(n)) {
    case 4:
      return launch_seg<4>(view, view_len, n, nnz, nrhs, vals, rvals, gmin,
                           x, nlanes, s);
    case 8:
      return launch_seg<8>(view, view_len, n, nnz, nrhs, vals, rvals, gmin,
                           x, nlanes, s);
    case 16:
      return launch_seg<16>(view, view_len, n, nnz, nrhs, vals, rvals, gmin,
                            x, nlanes, s);
    case 32:
      return launch_seg<32>(view, view_len, n, nnz, nrhs, vals, rvals, gmin,
                            x, nlanes, s);
    default:
      break;
  }
  if (n <= SW_NREG)
    return launch_warp<true>(tab, tab_len, n, nnz, nrhs, vals, rvals, gmin,
                             x, nlanes, s);
  if (n <= 64)
    return launch_warp<false>(tab, tab_len, n, nnz, nrhs, vals, rvals,
                              gmin, x, nlanes, s);
  if (n > NBIG) {
    const long long slices = work_len / (long long)gj_slice_doubles(n);
    if (work == nullptr || slices < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = static_cast<int>(slices < nlanes ? slices : nlanes);
    stamped_work_kernel<<<blocks, GJ_WORK_THREADS, 0, s>>>(
        tab, n, nnz, nrhs, vals, rvals, gmin, x, nlanes, work);
    return static_cast<int>(cudaGetLastError());
  }
  const int wide = gj_wide_bucket(n);
  if (wide == GJ_WIDE_MID)
    return launch_wide<GJ_WIDE_MID>(tab, n, nnz, nrhs, vals, rvals, gmin, x,
                                    nlanes, s);
  if (wide == GJ_NWIDE)
    return launch_wide<GJ_NWIDE>(tab, n, nnz, nrhs, vals, rvals, gmin, x,
                                 nlanes, s);
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
