// Block-cooperative Gauss-Jordan of one augmented (n, n+1) f64 system: the
// elimination of csrc/gj_kernel.cu (one dense system per block) and of
// csrc/stamped_solve.cu's systems past n = 64 (one lane's stamped system
// per block).  The stamped solve's systems of 33 to 64 and the AC kernel's
// run on gj_warp.cuh (a warp a system).
//
// The counterpart of toyspice_tpu/ops/pallas_solve.py::_gj_eliminate and
// ops/solve.py::_gj_batch_last, which carry double-float (hi, lo) f32
// pairs folded to (8, W) tiles and pick pivot rows by one-hot sums because
// the TPU has no f64; here the values are native f64 and the pivot row is
// indexed.  Three bodies, one arithmetic:
//
// gj_rows (n <= GJ_NREG = 96): the rows in registers across a block of
// ceil(NMAX / 32) warps, row i on thread i, in a size bucket of NMAX
// slots (gj_bucket).  As in gj_warp.cuh's gj_warp_reg, slot c holds
// column k + c at column k (each update writes its result one slot to the
// left), so column k is always slot 0, the column loop stays rolled and
// the dead columns before k fall away.  For each column k:
//
//   1. each warp has its candidate (warp_candidate: the largest |m[i][k]|
//      over its unused rows, the lowest row on a tie, and a vote on a NaN
//      there); one block barrier; every thread keeps the largest
//      candidate, the lowest warp (so the lowest row) on a tie: the
//      kernels' pivot rule.  A NaN there, or no candidate, makes every
//      x NaN (the whole block leaves the loop);
//   2. the pivot row's thread puts it in shared memory; a block barrier;
//      thread t - 1 divides relative column t by the pivot (a division
//      per element, as ops/newton.py's gauss_jordan does; a zero pivot
//      leaves the poison row, inf past column k); a block barrier;
//   3. every thread updates its row as m[i][j] - f * p[j] over the live
//      columns from the quotients, f = m[i][k] read before; the pivot row
//      takes the quotients.  After the first eight slots each warp takes
//      its candidate for column k + 1, whose reductions overlap the rest.
//
// Three block barriers a column, and no work done twice: in a design with
// one barrier every warp stored and divided its own candidate row before
// it, and lc16_ac_8192's 172,032 systems of 72 took 37.0 ms against 30.7
// (ab_run_kernel.py --gj on an NVIDIA H100 80GB HBM3 at 700 W).  A zero
// numerator's quotient skips the division (gj_quot): the general AC's
// systems are ~95% zeros.
//
// gj_wide (GJ_NREG < n <= GJ_NWIDE = 144): the system in registers across
// a block of GJ_WIDE_THREADS = 512 threads (16 warps) in a 2-D cyclic
// layout: row i on warp i mod 16, row slot i / 16; column j (the
// right-hand side as column n) on lane j mod 32, column slot j / 32.  A
// thread holds R x S elements (R = 9, S = 5 at n = 144: 90 of its 128
// registers), and every row and every live column stay spread over all
// the threads as k grows.  The column loop runs slot by slot (unrolled:
// column k = 32 s + kl sits in the static slot s, and the slots before s
// are dead) over kl (rolled).  For each column k:
//
//   1. lane kl of each warp holds column k of its rows: it puts them in
//      shared memory (the rows' factors for step 3) and takes the warp's
//      candidate over its unused rows in ascending order; one block
//      barrier; every warp reduces the 16 candidates (three
//      warp reductions over |a|'s two words and the row), the largest
//      |a|, on a tie the lowest ROW (rows interleave across warps: row 17
//      is on warp 1, row 2 on warp 2; the rule picks row 2).  A NaN among
//      the unused rows' column-k entries, or no candidate, makes every x
//      NaN;
//   2. the pivot row's warp puts its live columns in shared memory; one
//      block barrier; thread t divides column k + 1 + t by the pivot
//      (gj_quot; inf past column k on a zero pivot), in place; one block
//      barrier;
//   3. every thread updates its live column slots, a slot at a time: the
//      slot's quotient, then each row's m[i][j] - f * q[j], with no branch
//      inside a slot; the pivot row then takes the quotients.  Column
//      slots past the right-hand side are skipped (a branch the same on
//      every thread); the rows past n compute values nothing reads.
//
// Three block barriers a column.  The rows are never swapped: a row
// slot's used bit and the column it was the pivot of (in shared memory)
// give x.  What bounds it is each column's chain of dependent steps
// across the block (barriers, warp reductions, a division), at one block
// an SM: ~1.5 us a column at n = 130, about 33 times the bound of
// chip_smoke.py (lu_flops at 34 TFLOP/s).  Variants timed in one call on an H100 at 700 W (8192
// random systems of 130, this body 12.07 ms): a branch-free candidate
// (keys compared with selects) 12.31; with that candidate, the pivot's
// warp dividing its slots itself (two barriers) 14.19, a branch per row in
// the update (rows past n skipped, the pivot row selected per element)
// 17.38, and the next column's candidate taken inside the update 13.56.
//
// gj_block (n past GJ_NWIDE): the matrix behind a pointer, a block of
// GJ_WORK_THREADS = 512; warp 0 finds the pivot, the pivot row is divided
// and the factors saved, then the live columns past k of every other row
// are updated, a warp a row; three block barriers a column.  To n = NBIG =
// 168, the largest n whose gj_shared_bytes(n) fits a block's 227 KB, the
// matrix is in shared memory; past it in the block's slice of a workspace
// in device memory (gj_slice_doubles(n)), which the block barriers order
// as they order shared memory: the same elimination, with no cap on n but
// the card's memory.
//
// Each element that reaches x sees the operations of ops/newton.py::
// gauss_jordan, the plain versions' elimination, in the same order (built
// with -fmad=false), so every body gives its bits; a system with a
// non-finite x gets NaN in every x, as there.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tsr {

// threads of gj_wide's blocks and of the pointer body's, in shared
// memory and in device memory (one block an SM there, ops/solve.py
// WORK_BLOCKS_PER_SM): on an H100 (ab_run_kernel.py --stamped --gj) the
// device-memory body took 4.20 ms on the 127-stage ladder's 1024 systems
// of 130 and 32.5 ms on lc31-sized random systems (8192 of 132), against
// 11.44 and 89.7 at 4 blocks an SM of 128 threads, 7.75 and 64.9 at 1 of
// 128, 4.46 and 39.2 at 2 of 256, 4.11 and 30.6 at 1 of 1024: 16 warps
// share each column's rows
constexpr int GJ_WORK_THREADS = 512;
constexpr int GJ_NREG = 96;      // the largest n with a row a thread
constexpr int GJ_NWIDE = 144;    // ops/solve.py NWIDE: the largest n of
                                 // gj_wide (the system in registers)
constexpr int NBIG = 168;        // ops/solve.py NBIG: the largest system in
                                 // shared memory

// the slots a row of the register body takes for a system of n (a
// multiple of 8; 0 past GJ_NREG: the shared-memory body)
__host__ __device__ constexpr int gj_bucket(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 48 ? 48 : n <= 64 ? 64
       : n <= 72 ? 72 : n <= GJ_NREG ? 96 : 0;
}

// x / piv as the division rounds it (piv neither 0 nor NaN), a zero x's
// signed zero without the division: the f64 division's instruction
// sequence takes its slow path for a zero quotient (327 cycles a
// dependent step against 126, probe_latency.py on an H100), and most of a
// sparse system's pivot row is zeros
__device__ __forceinline__ double gj_quot(double x, double piv) {
  if (x == 0.0)
    return __longlong_as_double(
        (__double_as_longlong(x) ^ __double_as_longlong(piv))
        & static_cast<long long>(0x8000000000000000ull));
  return x / piv;
}

// the threads of the register body's block: a row a thread
__host__ __device__ constexpr int gj_reg_threads(int nmax) {
  return (nmax + 31) / 32 * 32;
}

// the blocks an SM should hold (__launch_bounds__): the bucket of 72 at
// 4 (at most 168 registers), not 3 (206 registers unbounded): each column
// is a chain of dependent steps, which more systems an SM overlap; the
// bucket of 96 keeps its 254 registers (2 blocks), since at 3 blocks it
// spills 764 bytes a thread and takes 40% longer
__host__ __device__ constexpr int gj_min_blocks(int nmax) {
  return nmax == 72 ? 4 : 1;
}

// A warp's pivot candidate: the largest |a| over the lanes with `cand`,
// the lowest row on a tie (three warp reductions over the two words of
// |a|, which order a non-negative double as its value does), as {its
// bits' low and high word, its row or -1, whether a candidate |a| is NaN}
__device__ __forceinline__ int4 warp_candidate(double a, bool cand, int i) {
  const bool ok = cand && a >= 0.0;  // a NaN is no candidate
  const unsigned long long bits =
      ok ? static_cast<unsigned long long>(__double_as_longlong(a)) : 0ull;
  const unsigned hi = static_cast<unsigned>(bits >> 32);
  const unsigned lo = static_cast<unsigned>(bits);
  const unsigned mh = __reduce_max_sync(0xffffffffu, hi);
  const unsigned ml = __reduce_max_sync(0xffffffffu, hi == mh ? lo : 0u);
  const int mine = ok && hi == mh && lo == ml ? i : 0x7fffffff;
  const int pw = static_cast<int>(__reduce_min_sync(0xffffffffu, mine));
  const int nan = __any_sync(0xffffffffu, cand && isnan(a)) != 0;
  return make_int4(static_cast<int>(ml), static_cast<int>(mh),
                   pw == 0x7fffffff ? -1 : pw, nan);
}

// Eliminate the system whose row threadIdx.x is m (slots as above, the
// right-hand side in slot NMAX; zeros on the threads past n) with the
// whole block of gj_reg_threads(NMAX) threads, and write x[0..n) to x_out.
template <int NMAX>
__device__ __forceinline__ void gj_rows(double (&m)[NMAX + 1], int n,
                                        double* __restrict__ x_out) {
  static_assert(NMAX % 8 == 0, "the update goes in groups of eight slots");
  constexpr int NW = gj_reg_threads(NMAX) / 32;
  // per column parity: the pivot row (its quotient of relative column c
  // in [c - 1], of the right-hand side in [NMAX], its pivot in
  // [NMAX + 1]) and each warp's candidate (warp_candidate).  The barriers
  // would allow one of each, but with one the kernel took 20% longer on
  // lc16_ac_8192 (more spills in the column loop)
  __shared__ __align__(16) double s_q[2][NMAX + 2];
  __shared__ int4 s_cand[2][NW];
  const int i = threadIdx.x;
  const int lane = i & 31;
  const int warp = i >> 5;
  const bool row = i < n;
  int stage = -1;  // the column this row was the pivot of
  bool nan_col = false;
  int4 wc = warp_candidate(fabs(m[0]), row, i);  // column 0's
  for (int k = 0; k < n; ++k) {
    const int live = n - k;  // columns k..n-1 in slots 0..live-1
    double* q = s_q[k & 1];
    const double2* q2 = reinterpret_cast<const double2*>(q);
    int4* cand = s_cand[k & 1];
    // 1. the block's pivot: the largest warp candidate, the lowest warp
    // (so the lowest row) on a tie
    if (lane == 0) cand[warp] = wc;
    __syncthreads();
    int4 c[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) c[w] = cand[w];
    unsigned long long best = 0ull;
    int p = -1;
    bool nan = false;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const unsigned long long bk =
          (static_cast<unsigned long long>(static_cast<unsigned>(c[w].y))
           << 32) | static_cast<unsigned>(c[w].x);
      nan = nan || c[w].w != 0;
      if (c[w].z >= 0 && (p < 0 || bk > best)) {
        best = bk;
        p = c[w].z;
      }
    }
    if (nan || p < 0) {  // the same on every thread
      nan_col = true;
      break;
    }
    // 2. the pivot row to shared memory (columns c, c + 1 to [c - 1], [c];
    // slot NMAX - 1's partner, the right-hand side, into the unused
    // [NMAX - 1]), then its quotients, thread t - 1 dividing relative
    // column t (a zero pivot leaves the poison row, inf past column k)
    if (i == p) {
      double2* out2 = reinterpret_cast<double2*>(q);
#pragma unroll
      for (int c0 = 1; c0 < NMAX; c0 += 4) {
        if (c0 >= live) break;
#pragma unroll
        for (int c = c0; c < c0 + 4; c += 2)
          out2[(c - 1) / 2] = make_double2(m[c], m[c + 1]);
      }
      q[NMAX] = m[NMAX];
      q[NMAX + 1] = m[0];
    }
    __syncthreads();
    if (i + 1 <= live) {
      const int e = i + 1 < live ? i : NMAX;
      const double piv = q[NMAX + 1];
      q[e] = piv == 0.0 ? INFINITY : gj_quot(q[e], piv);
    }
    __syncthreads();
    // 3. the update: slot c takes column c + 1 (quotient q[c]), in groups
    // of eight slots, the slots past the live ones computing values
    // nothing reads; column k + 1's warp candidates are taken after the
    // first group, so that their reductions overlap the rest
    const double f = m[0];
    if (i == p) stage = k;
#pragma unroll
    for (int c0 = 0; c0 < NMAX; c0 += 8) {
      if (c0 + 1 < live) {  // a group's quotients loaded first
        double2 v[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) v[h] = q2[c0 / 2 + h];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int c = c0 + 2 * h;
          if (c + 1 < NMAX) m[c] = m[c + 1] - f * v[h].x;
          if (c + 2 < NMAX) m[c + 1] = m[c + 2] - f * v[h].y;
        }
      }
      if (c0 == 0) wc = warp_candidate(fabs(m[0]), row && stage < 0, i);
    }
    const double qr = q[NMAX];
    m[NMAX] = m[NMAX] - f * qr;
    if (i == p) {  // the pivot row takes the quotients
#pragma unroll
      for (int c0 = 0; c0 < NMAX; c0 += 4) {
        if (c0 + 1 < live) {
#pragma unroll
          for (int c = c0; c < c0 + 4; c += 2) {
            const double2 v = q2[c / 2];
            if (c + 1 < NMAX) m[c] = v.x;
            if (c + 2 < NMAX) m[c + 1] = v.y;
          }
        }
      }
      m[NMAX] = qr;
    }
  }
  // x: each row's right-hand side at the column it was the pivot of; one
  // non-finite x makes every x NaN, as the JAX package's one-hot gather
  // does
  const bool bad = __syncthreads_or(nan_col || (row && !isfinite(m[NMAX])));
  if (row) x_out[nan_col ? i : stage] = bad ? NAN : m[NMAX];
}

// gj_wide's buckets: GJ_WIDE_MID (R = 8 row slots, S = 4 column slots:
// the largest n whose columns and right-hand side fit four slots) and
// GJ_NWIDE (R = 9, S = 5); 0 outside (GJ_NREG, GJ_NWIDE]: the other
// bodies.  With 17 or 18 warps (R = 8 to 136 or 144) a thread may take
// only 96 registers (a block's warps spread over the SM's four quarters)
// and both buckets spilled
constexpr int GJ_WIDE_MID = 127;
constexpr int GJ_WIDE_WARPS = 16;
constexpr int GJ_WIDE_THREADS = 32 * GJ_WIDE_WARPS;
__host__ __device__ constexpr int gj_wide_bucket(int n) {
  return n <= GJ_NREG || n > GJ_NWIDE ? 0
       : n <= GJ_WIDE_MID ? GJ_WIDE_MID : GJ_NWIDE;
}
// the rows a warp holds (R) and the columns a lane holds, the right-hand
// side included (S), in a bucket of nb
__host__ __device__ constexpr int gj_wide_rows(int nb) {
  return (nb + GJ_WIDE_WARPS - 1) / GJ_WIDE_WARPS;
}
__host__ __device__ constexpr int gj_wide_cols(int nb) {
  return (nb + 32) / 32;
}

// Eliminate the system that the block's threads hold as m[r][c] = row
// 16 r + warp, column 32 c + lane (the right-hand side at column n, zeros
// past n) with the whole block of GJ_WIDE_THREADS threads, and write
// x[0..n) to x_out.
template <int R, int S>
__device__ __forceinline__ void gj_wide(double (&m)[R][S], int n,
                                        double* __restrict__ x_out) {
  constexpr int NW = GJ_WIDE_WARPS;
  constexpr unsigned FULL = 0xffffffffu;
  static_assert(R <= 32, "a used bit per row slot");
  __shared__ __align__(16) double s_q[32 * S];  // the pivot row's quotients
  __shared__ double s_f[NW][R];                 // each row's factor m[i][k]
  __shared__ int4 s_cand[NW];                   // each warp's candidate
  __shared__ int s_stage[NW * R];               // the column row i pivoted
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned used = 0u;  // bit r: row NW r + warp was a pivot (or is past n)
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (NW * r + warp >= n) used |= 1u << r;
  bool nan_col = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (nan_col || 32 * s >= n) break;
    const int kend = min(32, n - 32 * s);
    for (int kl = 0; kl < kend; ++kl) {
      const int k = 32 * s + kl;
      // 1. each warp's candidate from lane kl, which holds column k of the
      // warp's rows: the largest |a| over its unused rows, ascending (the
      // lowest row on a tie; |a|'s bits order as |a| does), and whether
      // one of them is NaN; and the rows' factors m[i][k] for step 3
      if (lane == kl) {
        unsigned long long best = 0ull;
        int p = -1;
        bool nan = false;
#pragma unroll
        for (int r = 0; r < R; ++r) s_f[warp][r] = m[r][s];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (used >> r & 1u) continue;
          const double a = fabs(m[r][s]);
          const unsigned long long bits =
              static_cast<unsigned long long>(__double_as_longlong(a));
          if (isnan(a)) {
            nan = true;
          } else if (p < 0 || bits > best) {
            best = bits;
            p = NW * r + warp;
          }
        }
        s_cand[warp] = make_int4(static_cast<int>(static_cast<unsigned>(best)),
                                 static_cast<int>(best >> 32), p, nan);
      }
      __syncthreads();
      // the block's pivot, on every warp: the largest candidate, the
      // lowest row on a tie
      const int4 c = s_cand[lane % NW];
      const bool ok = c.z >= 0;
      const unsigned hi = ok ? static_cast<unsigned>(c.y) : 0u;
      const unsigned lo = ok ? static_cast<unsigned>(c.x) : 0u;
      const unsigned mh = __reduce_max_sync(FULL, hi);
      const unsigned ml = __reduce_max_sync(FULL, hi == mh ? lo : 0u);
      const unsigned pu = __reduce_min_sync(
          FULL, ok && hi == mh && lo == ml ? static_cast<unsigned>(c.z)
                                           : 0xffffffffu);
      if (__any_sync(FULL, c.w != 0) || pu == 0xffffffffu) {
        nan_col = true;  // the same on every thread
        break;
      }
      const int p = static_cast<int>(pu);
      const int wp = p % NW, rp = p / NW;
      // 2. the pivot row's warp puts its live columns in shared memory; a
      // block barrier; thread t divides column k + 1 + t by the pivot (a
      // division per element, as ops/newton.py's gauss_jordan does; a zero
      // pivot leaves the poison row, inf past column k), in place; a block
      // barrier
      if (warp == wp) {
#pragma unroll
        for (int cc = s; cc < S; ++cc) {
          double v = m[0][cc];
#pragma unroll
          for (int r = 1; r < R; ++r)
            if (r == rp) v = m[r][cc];
          const int j = 32 * cc + lane;
          if (j >= k && j <= n) s_q[j] = v;
        }
        used |= 1u << rp;
      }
      if (threadIdx.x == 0) s_stage[p] = k;
      __syncthreads();
      if (k + 1 + static_cast<int>(threadIdx.x) <= n) {
        const int j = k + 1 + threadIdx.x;
        const double piv = s_q[k];
        s_q[j] = piv == 0.0 ? INFINITY : gj_quot(s_q[j], piv);
      }
      __syncthreads();
      // 3. the update of the live column slots, a slot at a time: its
      // quotient, then each row's m[i][j] - f * q[j], f = m[i][k] (stored
      // by lane kl in step 1); the pivot row then takes the quotients (the
      // columns at or before k, and the rows past n, compute values nothing
      // reads).  No branch inside a slot, so that the slot's products and
      // differences overlap.  The factors are read from shared memory
      // where they are used (a broadcast load): loaded into 2 R registers
      // once a column instead, the bucket of 144 took 3% longer
      const volatile double* fw = s_f[warp];
#pragma unroll
      for (int cc = s; cc < S; ++cc) {
        if (32 * cc > n) break;  // the same on every thread
        const double q = s_q[32 * cc + lane];
#pragma unroll
        for (int r = 0; r < R; ++r) m[r][cc] = m[r][cc] - fw[r] * q;
      }
      if (warp == wp) {
#pragma unroll
        for (int cc = s; cc < S; ++cc) {
          if (32 * cc > n) break;
          const double q = s_q[32 * cc + lane];
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (r == rp) m[r][cc] = q;
        }
      }
      __syncwarp();  // the factors are read before lane kl + 1 writes them
    }
  }
  // x: each row's right-hand side (lane n mod 32, slot n / 32) at the
  // column it was the pivot of; one non-finite x makes every x NaN, as the
  // JAX package's one-hot gather does
  const int ln = n & 31, cn = n >> 5;
  double rhs[R];
  bool bad = nan_col;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    double v = m[r][0];
#pragma unroll
    for (int cc = 1; cc < S; ++cc)
      if (cc == cn) v = m[r][cc];
    rhs[r] = v;
    if (lane == ln && NW * r + warp < n && !isfinite(v)) bad = true;
  }
  bad = __syncthreads_or(bad) != 0;
  if (lane == ln) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = NW * r + warp;
      if (i < n) x_out[nan_col ? i : s_stage[i]] = bad ? NAN : rhs[r];
    }
  }
}

__host__ __device__ inline size_t gj_shared_bytes(int n) {
  return ((size_t)n * (n + 1) + n) * sizeof(double) + 2 * (size_t)n * sizeof(int);
}

// gj_shared_bytes(n) in doubles: one system's slice of the device-memory
// body's workspace (ops/solve.py work_for)
__host__ __device__ inline size_t gj_slice_doubles(int n) {
  return (size_t)n * (n + 3);
}

// The pointer body: eliminate the system in m (n rows of stride n + 1,
// then the n factors (doubles), the n pivot rows and the n used flags
// (ints): gj_shared_bytes(n), in shared or device memory) with the whole
// block and write x[0..n) to x_out.  Every thread of the block must call
// it.  Only the live columns past k are divided and updated at column k:
// the others are never read again.
__device__ inline void gj_block(double* m, int n, double* x_out) {
  const size_t ld = n + 1;
  double* fac = m + n * ld;
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
    for (int j = k + 1 + tid; j <= n; j += blockDim.x)
      prow[j] = piv == 0.0 ? INFINITY : gj_quot(prow[j], piv);
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
      for (int j = k + 1 + lane; j <= n; j += 32)
        row[j] = row[j] - f * prow[j];
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
