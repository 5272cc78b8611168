// Gauss-Jordan of one augmented (n, n+1) f64 system by a segment of W
// lanes of one warp (W = 4, 8, 16 or 32), with no block barrier: the
// elimination of csrc/ac_kernel.cu (every (instance, frequency) system),
// of csrc/stamped_solve.cu's systems of 33 to 64 and of each attempt, or
// each Newton iteration, of the run, OP and DC sweep kernels
// (csrc/newton.cuh seg_solve: from registers to np1 = 32, from the build
// rows in shared memory, a whole warp and two rows a lane, for np1 33 to
// 64).
//
// Row i belongs to lane i % W, slot i / W (R slots a lane).  For each
// column k:
//
//   1. each lane takes the largest |m[i][k]| over its unused rows (its
//      lower row first); then three warp reductions over the segment
//      (__reduce_max_sync of the high and the low word of |a|, which order
//      a non-negative double as its value does, and __reduce_min_sync of
//      the row index among the lanes that hold the maximum) keep the
//      largest, the lowest row on a tie: the kernels' pivot rule (a
//      segment of 4, 8 or 16 lanes takes a butterfly of shuffles instead).
//      A NaN there (one warp vote), or no candidate, makes every x NaN;
//      the segment still runs every column, with row 0 as its pivot from
//      there on, so that the segments of a warp stay converged under one
//      full-warp mask (a failed system's x is all NaN whatever it runs);
//   2. the owner of the pivot row puts it in the segment's exchange
//      buffer in shared memory; the lane of each live column divides its
//      element by the pivot (a division per element, as the plain version
//      does), or writes the poison row of a zero pivot (inf past column
//      k);
//   3. each lane updates its rows as m[i][j] - f * p[j] over the live
//      columns from the buffer's quotients, f = m[i][k] read before; the
//      pivot row takes the quotients.
//
// Only columns k+1..n-1 and the right-hand side are live after column k:
// the earlier ones are never read again (x is the right-hand side of each
// pivot row), so they are not updated, and every element that reaches x
// sees the operations of ops/newton.py's gauss_jordan, the plain
// versions' elimination, in its order (built with -fmad=false).  A system
// whose x has a non-finite entry gets NaN in every entry, as the JAX
// package's one-hot gather gives (and as ops/newton.py's gauss_jordan
// does).
//
// gj_warp_reg keeps the rows in registers, in a size bucket of NMAX slots:
// at column k, slot c holds column k + c (each update writes its result
// one slot to the left, so column k is always slot 0 and the loop over the
// columns stays rolled, its body unrolled over the slots: a kernel the
// instruction cache holds).  Per live element a lane spends a product, a
// difference, a select (the pivot row keeps the quotient) and half a
// 16-byte shared load, the slots in groups of four behind one uniform
// test; a whole warp's pivot is three warp reductions and a vote.  What
// bounds it is each column's chain of dependent steps (the reductions,
// two warp barriers, a division, the update) with only 2-4 warps a
// scheduler at ~128-234 registers a lane, not the issue rate.
// gj_warp_smem keeps the rows in the warp's slice of shared memory
// (stride ld, the right-hand side at column n) for buckets whose rows do
// not fit the register file.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tsr {

// the lanes of the segment of W lanes that holds warp lane `wl`
template <int W>
__device__ __forceinline__ unsigned segment_mask(int wl) {
  if constexpr (W == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << W) - 1u) << (wl & ~(W - 1));
  }
}

// The pivot row of the segment from each lane's candidate (best = |a|,
// p its row, p < 0 none): the largest best, the lowest row on a tie; -1 if
// no lane has one.  A whole warp (W = 32) takes three warp reductions
// (best is a non-negative double, so its high and low words order it as
// its value does); a segment of 4, 8 or 16 lanes, which shares its warp
// with others, a butterfly of shuffles of width W.
template <int W>
__device__ __forceinline__ int segment_pivot(double best, int p,
                                             unsigned mask) {
  if constexpr (W == 32) {
    const unsigned long long bits =
        p >= 0 ? static_cast<unsigned long long>(__double_as_longlong(best))
               : 0ull;
    const unsigned hi = static_cast<unsigned>(bits >> 32);
    const unsigned lo = static_cast<unsigned>(bits);
    const unsigned mh = __reduce_max_sync(mask, hi);
    const unsigned ml = __reduce_max_sync(mask, hi == mh ? lo : 0u);
    const int mine = p >= 0 && hi == mh && lo == ml ? p : 0x7fffffff;
    const int win = __reduce_min_sync(mask, mine);
    return win == 0x7fffffff ? -1 : win;
  } else {
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1) {
      const double ob = __shfl_xor_sync(mask, best, off, W);
      const int op = __shfl_xor_sync(mask, p, off, W);
      if (op >= 0 && (p < 0 || ob > best || (ob == best && op < p))) {
        best = ob;
        p = op;
      }
    }
    return p;
  }
}

template <int W>
__device__ __forceinline__ bool segment_any(bool v, unsigned mask) {
  if constexpr (W == 32) {
    return __any_sync(mask, v) != 0;
  } else {
    int a = v ? 1 : 0;
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1)
      a |= __shfl_xor_sync(mask, a, off, W);
    return a != 0;
  }
}

// x of the segment's system: each row's right-hand side at the column
// where it was the pivot, all NaN if a pivot column held a NaN or if any x
// is not finite; returns whether x is finite (the same on every lane)
template <int W, int R>
__device__ __forceinline__ bool segment_store_x(const double (&rhs)[R],
                                                const int (&stage)[R],
                                                int n, bool nan_col,
                                                int lane, unsigned mask,
                                                double* x_out) {
  bool bad = nan_col;
#pragma unroll
  for (int s = 0; s < R; ++s)
    if (lane + s * W < n && !isfinite(rhs[s])) bad = true;
  bad = segment_any<W>(bad, mask);
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = lane + s * W;
    if (i < n) x_out[nan_col ? i : stage[s]] = bad ? NAN : rhs[s];
  }
  return !bad;
}

// The elimination with the rows in registers: m[s] is row lane + s * W
// (see above for the slots; the right-hand side in slot NMAX).  buf is
// the segment's NMAX + 1 doubles of shared memory, 16-byte aligned: the
// quotient of relative column c in buf[c - 1], the right-hand side's in
// buf[NMAX].  NMAX is a multiple of 4.
template <int NMAX, int W, int R>
__device__ __forceinline__ bool gj_warp_reg(double (&m)[R][NMAX + 1], int n,
                                            double* buf, int lane,
                                            unsigned mask, double* x_out) {
  static_assert(NMAX % 4 == 0, "slots go in groups of four");
  const double2* buf2 = reinterpret_cast<const double2*>(buf);
  int stage[R];
#pragma unroll
  for (int s = 0; s < R; ++s) stage[s] = -1;
  bool nan_col = false;
  for (int k = 0; k < n; ++k) {
    const int live = n - k;  // columns k..n-1 in slots 0..live-1
    double best = -1.0;
    int p = -1;
    bool nan = false;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      if (lane + s * W < n && stage[s] < 0) {
        const double a = fabs(m[s][0]);
        if (isnan(a)) nan = true;
        if (a > best) {
          best = a;
          p = lane + s * W;
        }
      }
    }
    p = segment_pivot<W>(best, p, mask);
    if (segment_any<W>(nan, mask) || p < 0) nan_col = true;
    p = nan_col ? 0 : p;
    const int owner = p % W;
    const int oslot = p / W;
    double mk = m[0][0];
#pragma unroll
    for (int s = 1; s < R; ++s)
      if (s == oslot) mk = m[s][0];
    const double piv = __shfl_sync(mask, mk, owner, W);
    if (lane == owner) {
      double2* out2 = reinterpret_cast<double2*>(buf);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        if (s == oslot) {
          // columns c, c + 1 to buf[c - 1], buf[c]; past the live ones
          // (and slot NMAX - 1's partner, the right-hand side, into the
          // unused buf[NMAX - 1]) nothing reads them
#pragma unroll
          for (int c0 = 1; c0 < NMAX; c0 += 4) {
            if (c0 < live) {
#pragma unroll
              for (int c = c0; c < c0 + 4; c += 2)
                out2[(c - 1) / 2] = make_double2(m[s][c], m[s][c + 1]);
            }
          }
          buf[NMAX] = m[s][NMAX];
        }
      }
    }
    __syncwarp(mask);
    // the quotients of the live columns past k and of the right-hand side
    // (a zero pivot's poison row is inf there)
    for (int t = lane + 1; t <= live; t += W) {
      const int i = t < live ? t - 1 : NMAX;
      buf[i] = piv == 0.0 ? INFINITY : buf[i] / piv;
    }
    __syncwarp(mask);
    double f[R];
#pragma unroll
    for (int s = 0; s < R; ++s) f[s] = m[s][0];
    // slot c takes column c + 1 (quotient buf[c]), the pivot row the
    // quotient itself; the slots past the live ones compute values nothing
    // reads
#pragma unroll
    for (int c0 = 0; c0 < NMAX; c0 += 4) {
      if (c0 + 1 < live) {
#pragma unroll
        for (int c = c0; c < c0 + 4; c += 2) {
          const double2 q = buf2[c / 2];
#pragma unroll
          for (int s = 0; s < R; ++s) {
            const bool ip = lane == owner && s == oslot;
            if (c + 1 < NMAX) m[s][c] = ip ? q.x : m[s][c + 1] - f[s] * q.x;
            if (c + 2 < NMAX) m[s][c + 1] = ip ? q.y : m[s][c + 2] - f[s] * q.y;
          }
        }
      }
    }
    const double qr = buf[NMAX];
#pragma unroll
    for (int s = 0; s < R; ++s) m[s][NMAX] = m[s][NMAX] - f[s] * qr;
    if (lane == owner) {  // the pivot row's right-hand side and stage
#pragma unroll
      for (int s = 0; s < R; ++s) {
        if (s == oslot) {
          m[s][NMAX] = qr;
          stage[s] = k;
        }
      }
    }
    __syncwarp(mask);
  }
  double rhs[R];
#pragma unroll
  for (int s = 0; s < R; ++s) rhs[s] = m[s][NMAX];
  return segment_store_x<W, R>(rhs, stage, n, nan_col, lane, mask, x_out);
}

// The elimination with the rows in shared memory: row i at t + i * ld
// (the right-hand side at column n), R * W >= n; q is the segment's n + 1
// doubles of exchange buffer.  Returns whether x is finite (the same on
// every lane).
template <int W, int R>
__device__ __forceinline__ bool gj_warp_smem(double* t, int ld, int n,
                                             double* q, int lane,
                                             unsigned mask, double* x_out) {
  int stage[R];
#pragma unroll
  for (int s = 0; s < R; ++s) stage[s] = -1;
  bool nan_col = false;
  for (int k = 0; k < n; ++k) {
    double best = -1.0;
    int p = -1;
    bool nan = false;
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int i = lane + s * W;
      if (i < n && stage[s] < 0) {
        const double a = fabs(t[i * ld + k]);
        if (isnan(a)) nan = true;
        if (a > best) {
          best = a;
          p = i;
        }
      }
    }
    p = segment_pivot<W>(best, p, mask);
    if (segment_any<W>(nan, mask) || p < 0) nan_col = true;
    p = nan_col ? 0 : p;
    const double* prow = t + p * ld;
    const double piv = prow[k];
    for (int j = k + lane; j <= n; j += W)
      q[j] = piv == 0.0 ? (j == k ? 1.0 : INFINITY) : prow[j] / piv;
    __syncwarp(mask);
    double* row[R];
    double f[R];
    bool upd[R], is_p[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int i = lane + s * W;
      upd[s] = i < n;
      is_p[s] = i == p;
      row[s] = t + (upd[s] ? i : 0) * ld;
      f[s] = row[s][k];
    }
#pragma unroll 4
    for (int j = k; j <= n; ++j) {
      const double qj = q[j];
#pragma unroll
      for (int s = 0; s < R; ++s)
        if (upd[s]) row[s][j] = is_p[s] ? qj : row[s][j] - f[s] * qj;
    }
#pragma unroll
    for (int s = 0; s < R; ++s)
      if (is_p[s]) stage[s] = k;
    __syncwarp(mask);
  }
  double rhs[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int i = lane + s * W;
    rhs[s] = i < n ? t[i * ld + n] : 0.0;
  }
  return segment_store_x<W, R>(rhs, stage, n, nan_col, lane, mask, x_out);
}

// the stride of a row of n + 1 values in shared memory: odd, so that the
// rows of a warp's lanes fall in different banks
__host__ __device__ inline int warp_ld(int n) { return (n + 1) | 1; }

// a warp's slice of shared memory in doubles, rounded up to an even count
// so that every slice starts 16-byte aligned
__host__ __device__ inline int even_up(int doubles) {
  return (doubles + 1) & ~1;
}

}  // namespace tsr
