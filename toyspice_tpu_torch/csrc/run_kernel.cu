// Whole-run adaptive transient for linear compat decks (R, C, L, V, I with
// DC/SIN/PULSE/PWL sources), one thread per Monte-Carlo lane, in f64.
//
// Replaces the TPU kernel toyspice_tpu/ops/pallas_run.py::_run_kernel
// (body _run_core, launched at pallas_run.py:811) for its linear compat
// subset.  The TPU kernel carries double-float (hi, lo) f32 pairs folded to
// (8, W) sublane tiles and steps whole blocks of lanes in lockstep; Hopper
// has native f64, so each thread here runs its own lane's loop
// (tran.go:96-152, as engine/tran.py:145-200 of the JAX package):
//
//   while (!done && attempts < max_attempts):
//     clamp dt at tstop; sources at the OLD time t (PLAN.md 2);
//     build the (np1) x (np1+1) augmented system from the stamp plan, row 0
//     the ground identity row; Gauss-Jordan with partial pivoting (largest
//     |pivot| among unused rows, lowest row on a tie; a zero pivot poisons
//     the row, so x goes non-finite); LTE from the COMMITTED C/L state;
//     accept (commit compat C/L state, grow dt x2 or x1.1 up to tmax) or
//     reject (halve dt while dt > minstep, else a hard fail).
//
// A lane also stops, failed, when its t or dt is non-finite, so a NaN never
// keeps the loop alive.  ops/run.py::run_plain is the same arithmetic as
// torch operations; the build uses -fmad=false so that every product and
// sum here is rounded on its own, as in the torch version.
//
// The deck is data, not code: an int32 table (ops/run_plan.py, copied to
// shared memory) lists the stamps as (row, col, tag, index, sign) in the
// general engine's scatter order, the sources and the C/L nodes; the lane's
// device values, source records and committed state are f64 rows with the
// batch axis first.  One build serves every eligible deck; the matrix lives
// in a per-thread array sized by the template NMAX (8, 16 or 32).
//
// Bound: operations.  An attempt on bench.py's RLC deck (np1 = 6) needs 299
// f64 operations (chip_smoke.py attempt_flops: 231 for the 6 x 7
// elimination, counting only the columns right of each pivot, plus the
// build, the source's sin, the LTE and the commit); memory traffic is a few
// rows per lane.  8192 lanes fill only a small share of the card's thread
// slots, and each thread's attempts are a serial dependency chain through
// local memory, so the kernel is latency-bound; this version is the
// simple, exact one.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// stamp tags and table header slots: ops/run_plan.py TAG_* and H_*
enum Tag { TAG_G = 0, TAG_GEQ, TAG_LTERM, TAG_ONE, TAG_CEQ, TAG_LRHS,
           TAG_VSRC, TAG_ISRC };
enum Hdr { H_NP1 = 0, H_NE, H_NR, H_NC, H_NL, H_NV, H_NI, H_ENT, H_SRC, H_CN,
           H_LN, H_KS, H_ND, H_NRC };
// source type codes: compiler.py SRC_*
enum Src { SRC_DC = 0, SRC_SIN = 1, SRC_PULSE = 2, SRC_PWL = 3 };
// source record: dc amplitude freq phase v1 v2 delay rise fall width period,
// then P knot times and P knot values (ops/run_plan.py SRC_KEYS)
enum Rec { R_DC = 0, R_AMPL, R_FREQ, R_PHASE, R_V1, R_V2, R_DELAY, R_RISE,
           R_FALL, R_WIDTH, R_PERIOD, R_KNOTS };

constexpr int MAX_SRC = 32;  // ops/run.py MAX_SOURCES
constexpr int THREADS = 128;
constexpr double PI = 3.141592653589793;
constexpr double TWO_PI = 2.0 * PI;

// maximum that propagates NaN (jnp.maximum / torch.maximum)
__device__ __forceinline__ double max_nan(double a, double b) {
  if (isnan(a) || isnan(b)) return NAN;
  return a > b ? a : b;
}

// One source's value at time t: models/sources.py, operation for operation.
__device__ double source_value(int stype, const double* p, int P, double t) {
  const double dc = p[R_DC];
  if (stype == SRC_SIN) {
    return dc +
           p[R_AMPL] * sin(TWO_PI * p[R_FREQ] * t + p[R_PHASE] * PI / 180.0);
  }
  if (stype == SRC_PULSE) {
    const double v1 = p[R_V1], v2 = p[R_V2], delay = p[R_DELAY];
    const double rise = p[R_RISE], fall = p[R_FALL], width = p[R_WIDTH];
    const double period = p[R_PERIOD];
    double tp = t - delay;
    if (period > 0) {  // floor mod: exact fmod, shifted to the divisor's sign
      double r = fmod(tp, period);
      if (r != 0 && ((r < 0) != (period < 0))) r = r + period;
      tp = r;
    }
    const double rise_safe = rise == 0 ? 1.0 : rise;
    const double fall_safe = fall == 0 ? 1.0 : fall;
    const double fall_start = rise + width;
    const double in_rise = rise == 0 ? v2 : v1 + (v2 - v1) * tp / rise_safe;
    const double in_fall =
        fall == 0 ? v1 : v2 - (v2 - v1) * (tp - fall_start) / fall_safe;
    const double val =
        tp < rise ? in_rise
                  : (tp < fall_start ? v2
                                     : (tp < fall_start + fall ? in_fall : v1));
    return t < delay ? v1 : val;
  }
  if (stype == SRC_PWL) {
    const double* kt = p + R_KNOTS;
    const double* kv = kt + P;
    int cnt = 0;
    for (int q = 0; q < P; ++q) cnt += kt[q] < t ? 1 : 0;
    const int idx = cnt < 1 ? 1 : (cnt > P - 1 ? P - 1 : cnt);
    const double t1 = kt[idx - 1], t2 = kt[idx];
    const double w1 = kv[idx - 1], w2 = kv[idx];
    const double slope = (w2 - w1) / (t2 == t1 ? 1.0 : t2 - t1);
    const double val = w1 + slope * (t - t1);
    return t <= kt[0] ? kv[0] : val;
  }
  return dc;
}

template <int NMAX>
__global__ void __launch_bounds__(THREADS)
run_kernel(const int* __restrict__ topo_g, int topo_len,
           const double* __restrict__ dev, const double* __restrict__ rc,
           double* __restrict__ state, double* __restrict__ t_out,
           double* __restrict__ dt_out, int* __restrict__ acc_out,
           int* __restrict__ att_out, int* __restrict__ fail_out, int nlanes,
           double tstop, double minstep, double tmax, double trtol,
           int max_attempts) {
  extern __shared__ int topo[];
  for (int i = threadIdx.x; i < topo_len; i += blockDim.x) topo[i] = topo_g[i];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= nlanes) return;

  const int n = topo[H_NP1], ne = topo[H_NE];
  const int nr = topo[H_NR], nc = topo[H_NC], nl = topo[H_NL];
  const int nsrc = topo[H_NV] + topo[H_NI];
  const int* ent = topo + topo[H_ENT];
  const int* src = topo + topo[H_SRC];
  const int* cnodes = topo + topo[H_CN];
  const int* lnodes = topo + topo[H_LN];
  // device rows: g[nr] C_t[nc] C[nc] L[nl]
  const double* dv = dev + (size_t)lane * topo[H_ND];
  const double* g = dv;
  const double* cadj = dv + nr;
  const double* craw = dv + nr + nc;
  const double* lval = dv + nr + 2 * nc;
  const double* rv = rc + (size_t)lane * topo[H_NRC];
  // committed state rows: q0 q1 v0 v1 [nc], i0 i1 v0 v1 flux0 [nl]
  double* st = state + (size_t)lane * topo[H_KS];
  double* c_q0 = st;
  double* c_q1 = st + nc;
  double* c_v0 = st + 2 * nc;
  double* c_v1 = st + 3 * nc;
  double* l_i0 = st + 4 * nc;
  double* l_i1 = l_i0 + nl;
  double* l_v0 = l_i0 + 2 * nl;
  double* l_v1 = l_i0 + 3 * nl;
  double* l_flux0 = l_i0 + 4 * nl;

  double m[NMAX][NMAX + 1];
  double x[NMAX];
  double sv[MAX_SRC];
  int perm[NMAX];
  bool used[NMAX];

  double t = 0.0, dt = minstep;
  bool done = tstop <= 0.0, fail = false;
  int acc = 0, att = 0;
  const double trtol100 = trtol / 100.0;

  while (!done && att < max_attempts) {
    if (!isfinite(t) || !isfinite(dt)) {
      done = true;
      fail = true;
      break;
    }
    const double tpdt = t + dt;
    const bool over = tpdt > tstop;
    const double next_t = over ? tstop : tpdt;
    const double dte = over ? tstop - t : dt;
    const double dtl = dte > 0 ? dte : 1e-9;

    for (int s = 0; s < nsrc; ++s)
      sv[s] = source_value(src[3 * s], rv + src[3 * s + 1], src[3 * s + 2], t);

    // ---- build: zero, scatter the stamps in plan order, ground row
    for (int i = 0; i < n; ++i)
      for (int j = 0; j <= n; ++j) m[i][j] = 0.0;
    for (int e = 0; e < ne; ++e) {
      const int* en = ent + 5 * e;
      const int k = en[3];
      double v;
      switch (en[2]) {
        case TAG_G: v = g[k]; break;
        case TAG_GEQ: v = cadj[k] / dte; break;
        case TAG_LTERM: v = lval[k] / dtl; break;
        case TAG_CEQ: v = c_q1[k] / dte; break;
        case TAG_LRHS: v = (lval[k] / dtl) * l_i1[k]; break;
        case TAG_VSRC: v = sv[k]; break;
        case TAG_ISRC: v = sv[topo[H_NV] + k]; break;
        default: v = 1.0; break;  // TAG_ONE
      }
      m[en[0]][en[1]] += (double)en[4] * v;
    }
    m[0][0] = 1.0;

    // ---- Gauss-Jordan with partial pivoting
    bool nan_col = false;
    for (int i = 0; i < n; ++i) used[i] = false;
    for (int k = 0; k < n && !nan_col; ++k) {
      int p = -1;
      double best = -1.0;
      for (int i = 0; i < n; ++i) {
        if (used[i]) continue;
        const double a = fabs(m[i][k]);
        if (isnan(a)) nan_col = true;
        if (a > best) {
          best = a;
          p = i;
        }
      }
      if (nan_col || p < 0) {
        nan_col = true;
        break;
      }
      const double piv = m[p][k];
      if (piv == 0.0) {
        for (int j = 0; j <= n; ++j) m[p][j] = j == k ? 1.0 : INFINITY;
      } else {
        for (int j = 0; j <= n; ++j) m[p][j] = m[p][j] / piv;
      }
      for (int i = 0; i < n; ++i) {
        if (i == p) continue;
        const double f = m[i][k];
        for (int j = 0; j <= n; ++j) m[i][j] = m[i][j] - f * m[p][j];
      }
      used[p] = true;
      perm[k] = p;
    }
    bool nr_ok = !nan_col;
    for (int k = 0; k < n; ++k) {
      x[k] = nan_col ? NAN : m[perm[k]][n];
      nr_ok = nr_ok && isfinite(x[k]);
    }

    // ---- LTE from the committed state
    double lte = 0.0;
    for (int k = 0; k < nc; ++k)
      lte = max_nan(lte,
                    fabs(craw[k] * c_v0[k] - craw[k] * c_v1[k]) / (2.0 * dte));
    for (int k = 0; k < nl; ++k) {
      const double cur = fabs(l_i0[k] - l_i1[k]) / (2.0 * dte);
      const double vol = fabs(l_v0[k] - l_v1[k]) / (2.0 * dte);
      lte = max_nan(lte, max_nan(cur, vol));
    }

    // ---- accept / reject
    const bool can_halve = dte > minstep;
    const bool hard_fail = !nr_ok && !can_halve;
    const bool reject =
        (!nr_ok && can_halve) || (nr_ok && lte > trtol && can_halve);
    const bool accept = nr_ok && !reject;
    if (accept) {
      for (int k = 0; k < nc; ++k) {  // capacitor.go:155-171
        const double vd = x[cnodes[2 * k]] - x[cnodes[2 * k + 1]];
        const double q0 = c_q0[k], v0 = c_v0[k];
        c_q0[k] = craw[k] * vd;
        c_q1[k] = q0;
        c_v0[k] = vd;
        c_v1[k] = v0;
      }
      for (int k = 0; k < nl; ++k) {  // inductor.go:81-114
        const double vd = x[lnodes[2 * k]] - x[lnodes[2 * k + 1]];
        const double v0 = l_v0[k];
        l_i0[k] = vd * 1e-9 / lval[k];
        l_i1[k] = l_i1[k] + vd * dte / lval[k];
        l_v0[k] = vd;
        l_v1[k] = v0;
        l_flux0[k] = vd * dte;
      }
      t = next_t;
      const double grown = dte * (lte < trtol100 ? 2.0 : 1.1);
      const double dt_g = isnan(grown) ? grown : (grown > tmax ? tmax : grown);
      dt = (next_t < tstop && dte < tmax) ? dt_g : dte;
      ++acc;
      if (next_t >= tstop) done = true;
    } else {
      dt = dte / 2.0;
    }
    if (hard_fail) {
      done = true;
      fail = true;
    }
    ++att;
  }

  t_out[lane] = t;
  dt_out[lane] = dt;
  acc_out[lane] = acc;
  att_out[lane] = att;
  fail_out[lane] = fail ? 1 : 0;
}

template <int NMAX>
cudaError_t launch(const int* topo, int topo_len, const double* dev,
                   const double* rc, double* state, double* t_out,
                   double* dt_out, int* acc, int* att, int* fail, int nlanes,
                   double tstop, double minstep, double tmax, double trtol,
                   int max_attempts, cudaStream_t stream) {
  const int blocks = (nlanes + THREADS - 1) / THREADS;
  const size_t shmem = (size_t)topo_len * sizeof(int);
  run_kernel<NMAX><<<blocks, THREADS, shmem, stream>>>(
      topo, topo_len, dev, rc, state, t_out, dt_out, acc, att, fail, nlanes,
      tstop, minstep, tmax, trtol, max_attempts);
  return cudaGetLastError();
}

}  // namespace

// Launch the whole-run kernel for nlanes lanes on `stream`; returns the
// cudaError_t of the launch (0 on success).  np1 picks the matrix size.
extern "C" int tsr_run(int np1, const int* topo, int topo_len,
                       const double* dev, const double* rc, double* state,
                       double* t_out, double* dt_out, int* acc, int* att,
                       int* fail, int nlanes, double tstop, double minstep,
                       double tmax, double trtol, int max_attempts,
                       void* stream) {
  if (nlanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (np1 <= 8)
    return launch<8>(topo, topo_len, dev, rc, state, t_out, dt_out, acc, att,
                     fail, nlanes, tstop, minstep, tmax, trtol, max_attempts,
                     s);
  if (np1 <= 16)
    return launch<16>(topo, topo_len, dev, rc, state, t_out, dt_out, acc, att,
                      fail, nlanes, tstop, minstep, tmax, trtol, max_attempts,
                      s);
  if (np1 <= 32)
    return launch<32>(topo, topo_len, dev, rc, state, t_out, dt_out, acc, att,
                      fail, nlanes, tstop, minstep, tmax, trtol, max_attempts,
                      s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* tsr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
