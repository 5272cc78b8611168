// The whole-run kernel of csrc/run_kernel.cu, csrc/run_kernel_phys.cu and
// csrc/run_kernel_mag.cu.
//
// Whole-run adaptive transient (R, C, L, V, I with DC/SIN/PULSE/PWL
// sources, and under compat semantics magnetic inductors and mutual
// couplings, or diodes, BJTs and MOSFETs under compat or physics
// semantics), in f64, every deck on a segment of 4, 8, 16 or 32 lanes of
// a warp per Monte-Carlo lane (run_seg_kernel).
//
// Replaces the TPU kernel toyspice_tpu/ops/pallas_run.py::_run_kernel
// (body _run_core, launched at pallas_run.py:811) for its compat subset:
// the linear decks, the magnetic ones (LM and K with the frozen-core run
// constants of _run_const64, stamped as _run_core stamps them), and the
// nonlinear ones whose attempt runs the in-kernel Newton
// (pallas_tran.py::_newton_in_kernel, here csrc/newton.cuh).  The TPU
// kernel carries double-float (hi, lo) f32 pairs folded to (8, W) sublane
// tiles and steps whole blocks of lanes in lockstep; Hopper has native
// f64, so each lane runs its own loop (tran.go:96-152, as
// engine/tran.py:145-200 of the JAX package), spread over its segment:
//
//   while (!done && attempts < max_attempts):
//     clamp dt at tstop; sources at the OLD time t (PLAN.md 2);
//     linear deck: build the (np1) x (np1+1) augmented system from the
//     stamp plan, row 0 the ground identity row, and solve it by
//     Gauss-Jordan (gj_warp.cuh); nonlinear deck: the Newton of newton.cuh
//     from x = 0 with the carried junction voltages, which carry on to the
//     next attempt whether it accepts or not;
//     LTE from the COMMITTED C/L state; accept (commit compat C/L state,
//     grow dt x2 or x1.1 up to tmax) or reject (halve dt while dt >
//     minstep, else a hard fail).
//
// The PHYS instantiations replace the physics subset of both TPU kernels
// (modes phys_be and phys_trap of _attempt_core, pallas_tran.py:1140-1427,
// and _run_core's trap source time, pallas_run.py:377-381): the state
// stack carries the physics rows after the compat ones (ops/run_plan.py
// PHYS_ROWS: C i0 and hist, L hist, the diode's prev_vd prev_id
// prev_charge ic0 hist, the MOSFET's five charges, five companion
// currents and hist).  The capacitor stamps C_t/dt with
// the previous step's charge q0 (BE) or, with trap after its first
// committed step, 2C_t/dt with Ieq = geq v0 + i0; the inductor's branch
// row -L/dt (BE) or -2L/dt with RHS (2L/dt) i1 + v0; the diode (Bv, Rs)
// and MOSFET companions read the committed charges (newton.cuh); trap
// takes the sources at next_t.  An accepted step commits the physics
// forms of engine/state.py make_commit: the capacitor current (BE with the
// raw C, trap with C_t), the inductor current i0 = i1 = -x_b, and the
// diode and MOSFET charges and companion currents re-evaluated at the raw
// solution (no limiting, no cold start); every hist becomes 1.  Trap is a
// run-time argument, uniform across the lanes.  With MAG (physics
// magnetics, pallas_run.py:390-583) the state stack also carries each LM
// winding's ten live rows (i0 i1 v0 v1 flux0 and its copy of the J-A core,
// H Hold M Mirr dMdH) after the MOSFETs', and the dev rows its J-A
// leaves (MagPhys): each attempt stamps the incremental L = max(1e-12,
// L0 (1 + clip(dMdH, +-1e3))) of the committed core (backward Euler
// under trap too) and M = k sqrt(La Lb) of the live inductances; an
// accepted step sums each core's mmf over its windings, clips H = mmf/len
// to +-1e6 and runs one J-A step (ja_step) of every winding's core copy.
//
// The STORE instantiation also replaces pallas_tran.py::_fused_kernel
// (:1429, launched at :2252) with the waveform store of make_tran_fused
// (:1958) around it: an accepted attempt with next_t >= tstart writes the
// lane's whole solution (ground row included) and next_t straight into
// row n_kept of the lane's (max_store, np1) block.  The TPU needed one
// launch per attempt, a uniform-slot attempt buffer and a compaction after
// the run because Mosaic could neither hold that block in VMEM nor scatter
// per lane; here the lane's segment owns its rows.  With
// the stream flag a full block pauses the lane (the caller drains it and
// re-enters); without it a row past max_store is dropped and the lane's
// overflow flag set (max_store = 0 keeps nothing: a resumed run without
// waveforms).  The STORE instantiation starts each lane from its own t, dt
// and attempt count (a fresh run: 0, minstep, 0; a resume or a stream's
// re-entry: the checkpoint's), so max_attempts binds the whole run.
//
// A non-finite t or dt does not end a lane early: as in the general
// engine's loop, done and the hard fail decide, and max_attempts bounds
// every lane.  ops/run.py::run_plain is the same arithmetic as torch
// operations; the build uses -fmad=false so that every product and sum
// here is rounded on its own, as in the torch version.
//
// The deck is data, not code: an int32 table (ops/run_plan.py, copied to
// shared memory) lists the stamps as (row, col, tag, index, sign) in the
// general engine's scatter order, the sources and the device nodes; the
// lane's device values, source records, committed state and junction
// voltages are f64 rows with the batch axis first.  One build serves every
// eligible deck.  The system's rows, one a lane of the lane's segment of
// W = NMAX lanes (the size bucket: 4, 8, 16 or 32), live in registers
// (gj_warp_reg), each built from the table's row view (ops/run_plan.py
// row_view); a Newton deck's junction voltages and value slots live in the
// segment's slice of shared memory.  NL (the Newton), MAG (the LM and K
// stamps), STORE and PHYS are template parameters: the instantiations
// without them compile to the code they had before.
// run_kernel.cu instantiates the compat kernels, run_kernel_phys.cu the
// PHYS ones without MAG, run_kernel_mag.cu the PHYS MAG ones and compat
// MAG with NL: three sources, so that their nvcc calls run side by side.
//
// Bound: operations.  An attempt on bench.py's RLC deck (np1 = 6) needs 299
// f64 operations (chip_smoke.py attempt_flops: 231 for the 6 x 7
// elimination, counting only the columns right of each pivot, plus the
// build, the source's sin, the LTE and the commit); a Newton iteration adds
// the device evaluations and a build and solve (chip_smoke.py
// newton_flops).  Memory traffic is a few rows per lane.  The kernel is
// latency-bound: each lane's attempts are one dependency chain.  A lane's
// segment (8 threads at np1 <= 8: 65,536 threads for 8192 lanes) spreads
// each attempt's build, divisions and updates over its rows and its
// devices' evaluations over its threads, keeps the matrix in registers
// and the lane's rows in shared memory, and leaves the card warps to hide
// one another's shuffles and divisions.

#pragma once

#include "gj_warp.cuh"
#include "newton.cuh"

namespace {

using namespace tsr;

// source type codes: compiler.py SRC_*
enum Src { SRC_DC = 0, SRC_SIN = 1, SRC_PULSE = 2, SRC_PWL = 3 };
// source record: dc amplitude freq phase v1 v2 delay rise fall width period,
// then P knot times and P knot values (ops/run_plan.py SRC_KEYS)
enum Rec { R_DC = 0, R_AMPL, R_FREQ, R_PHASE, R_V1, R_V2, R_DELAY, R_RISE,
           R_FALL, R_WIDTH, R_PERIOD, R_KNOTS };

constexpr int MAX_SRC = 32;  // ops/run.py MAX_SOURCES
constexpr double PI = 3.141592653589793;
constexpr double TWO_PI = 2.0 * PI;

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

// The compat magnetic run constants of one lane (ops/run_plan.py
// magnetic_rows) and the K partners' table.
struct Mag {
  const double* l0;    // [nlm] L0 = mu0 N^2 A / len
  const double* leff;  // [nlm] L_eff at the frozen core
  const double* i0;    // [nlm] the frozen i0
  const double* i1;    // [nlm] the frozen i1
  const double* mij;   // [nk] M = k sqrt(La Lb)
  const int* kp;       // [nk][4] kind_a, idx_a, kind_b, idx_b
  const double* l_i0;  // the linear inductors' committed i0 (live)

  // the LM branch value (assemble.py LM tran, compat): L0 on the first
  // step or while |i0| < 1e-9, else L_eff
  __device__ __forceinline__ double l_used(int k, double t, double dtl) const {
    return (t < dtl || fabs(i0[k]) < 1e-9) ? l0[k] : leff[k];
  }
  // a winding's current as the mutual stamp reads it (mutual.go:114-115):
  // a linear L's live junk i0, an LM's frozen i0
  __device__ __forceinline__ double partner_i0(int kind, int idx) const {
    return kind == 0 ? l_i0[idx] : i0[idx];
  }
  // a magnetic stamp's value; every other tag left here is TAG_ONE
  __device__ __forceinline__ double term(int tag, int k, double t, double dte,
                                         double dtl) const {
    switch (tag) {
      case TAG_LMTERM: return l_used(k, t, dtl) / dtl;
      case TAG_LMRHS: return (l_used(k, t, dtl) / dtl) * i1[k];
      case TAG_KTERM: return mij[k] / dte;
      case TAG_KRHSA:
        return (mij[k] * partner_i0(kp[4 * k + 2], kp[4 * k + 3])) / dte;
      case TAG_KRHSB:
        return (mij[k] * partner_i0(kp[4 * k], kp[4 * k + 1])) / dte;
      default: return 1.0;
    }
  }
};

// a physics LM's run constants and live state rows (ops/run_plan.py
// LM_PHYS_ROWS and LM_STATE; row r of winding k at r * nlm + k)
enum LmRow { LM_L0 = 0, LM_MST, LM_A, LM_K, LM_C, LM_ALPHA, LM_TURNS, LM_LEN,
             LM_ROWS };
enum LmState { LS_I0 = 0, LS_I1, LS_V0, LS_V1, LS_FLUX0, LS_H, LS_HOLD, LS_M,
               LS_MIRR, LS_DMDH, LS_ROWS };

// One Jiles-Atherton step of a winding's core copy to field h, with Ms at
// the commit's temperature given as mst (models/magnetic.py ja_step,
// magnetic.go:88-132): every guard of the reference (|dH| < 1e-12 keeps
// the core, the linear anhysteretic at |He| < 1e-6, the denominator
// clamped at +-1e-12) and the JAX package's Bernoulli series of the
// Langevin function below |x| = 0.25.  c points at the winding's H row;
// the other core rows follow at the stride nlm.
__device__ __forceinline__ void ja_step(double mst, double a, double kk,
                                        double cc, double alpha, double h,
                                        double* c, int nlm) {
  double& H = c[0];
  double& Hold = c[(LS_HOLD - LS_H) * nlm];
  double& M = c[(LS_M - LS_H) * nlm];
  double& Mirr = c[(LS_MIRR - LS_H) * nlm];
  double& dMdH = c[(LS_DMDH - LS_H) * nlm];
  const double dH = h - Hold;
  const bool small = fabs(dH) < 1e-12;
  const double delta = dH < 0 ? -1.0 : 1.0;
  const double he = h + alpha * M;
  const double he_safe = fabs(he) < 1e-6 ? 1.0 : he;
  const double man_lin = mst * he / (3.0 * a);
  const double x = he_safe / a;
  const double x2 = x * x;
  const double series =
      x * (1.0 / 3.0 +
           x2 * (-1.0 / 45.0 +
                 x2 * (2.0 / 945.0 +
                       x2 * (-1.0 / 4725.0 +
                             x2 * (2.0 / 93555.0 +
                                   x2 * (-1382.0 / 638512875.0))))));
  const double x_safe = fabs(x) < 1e-30 ? 1.0 : x;
  const double direct = 1.0 / tanh(x_safe) - 1.0 / x_safe;
  const double langevin = fabs(x) < 0.25 ? series : direct;
  const double man = fabs(he) < 1e-6 ? man_lin : mst * langevin;
  double denom = kk * delta - alpha * (man - Mirr);
  if (fabs(denom) < 1e-12) denom = 1e-12 * sgn(denom + 1e-300);
  const double d_mirr_dh = (man - Mirr) / denom;
  const double mirr_new = Mirr + d_mirr_dh * dH;
  const double m_new = mirr_new + cc * (man - mirr_new);
  const double dmdh_new = (m_new - M) / (small ? 1.0 : dH);
  if (!small) {
    H = h;
    Hold = h;
    M = m_new;
    Mirr = mirr_new;
    dMdH = dmdh_new;
  }
}

// The physics magnetic stamps of one lane (assemble.py's physics LM and K
// blocks): each LM's incremental L = max(1e-12, L0 (1 + clip(dMdH,
// +-1e3))) from its committed core, backward Euler under trap too; each
// K's M = k sqrt(La Lb) from the live inductances with the +M/dt memory
// of the partner's committed current, trap's 2M/dt on a both-linear pair
// once both windings have history.  The plan's K RHS entries carry
// compat's sign -1, so those values carry the minus.
struct MagPhys {
  const double* lm;      // [LM_ROWS][nlm] run constants
  const double* kc;      // [nk] coefficients
  double* ls;            // [LS_ROWS][nlm] the live state rows
  const double* lval;    // [nl] the linear inductors
  const double* l_i1;    // [nl] their committed current
  const double* l_hist;  // [nl] their first-step flags
  const int* kp;         // [nk][4] kind_a, idx_a, kind_b, idx_b
  int nlm;
  bool trap;

  __device__ __forceinline__ double l_used(int k) const {
    const double d = clamp_max(clamp_min(ls[LS_DMDH * nlm + k], -1e3), 1e3);
    return max_nan(1e-12, lm[LM_L0 * nlm + k] * (1.0 + d));
  }
  __device__ __forceinline__ double l_of(int kind, int idx) const {
    return kind == 0 ? lval[idx] : l_used(idx);
  }
  __device__ __forceinline__ double i1_of(int kind, int idx) const {
    return kind == 0 ? l_i1[idx] : ls[LS_I1 * nlm + idx];
  }
  // M/dt, or 2M/dt on a started both-linear pair under trap
  __device__ __forceinline__ double mcoef(int k, double dte) const {
    const int* p = kp + 4 * k;
    const double m = kc[k] * sqrt(l_of(p[0], p[1]) * l_of(p[2], p[3]));
    const bool tr = trap && p[0] == 0 && p[2] == 0 && l_hist[p[1]] > 0 &&
                    l_hist[p[3]] > 0;
    return tr ? 2.0 * m / dte : m / dte;
  }
  // the partner's memory term, BE: (M i1)/dt; trap: mcoef i1
  __device__ __forceinline__ double krhs(int k, int kind, int idx,
                                         double dte) const {
    if (trap) return -(mcoef(k, dte) * i1_of(kind, idx));
    const int* p = kp + 4 * k;
    const double m = kc[k] * sqrt(l_of(p[0], p[1]) * l_of(p[2], p[3]));
    return -((m * i1_of(kind, idx)) / dte);
  }
  __device__ __forceinline__ double term(int tag, int k, double dte,
                                         double dtl) const {
    switch (tag) {
      case TAG_LMTERM: return l_used(k) / dtl;
      case TAG_LMRHS: return (l_used(k) / dtl) * ls[LS_I1 * nlm + k];
      case TAG_KTERM: return mcoef(k, dte);
      case TAG_KRHSA: return krhs(k, kp[4 * k + 2], kp[4 * k + 3], dte);
      case TAG_KRHSB: return krhs(k, kp[4 * k], kp[4 * k + 1], dte);
      default: return 1.0;
    }
  }
};

// ------------------------------------------------ the segment kernel

// A lane's rows (committed state, device rows, source records) held in its
// segment's slice of shared memory when together they fit this many
// doubles; a deck past it reads them in device memory.
constexpr int SEG_ROWS = 192;

// Doubles of one segment's slice of shared memory: the elimination's
// exchange buffer and the W = NMAX build rows (stride NMAX + 2, so every
// row starts 16-byte aligned), x, the source values and the lane's rows;
// a Newton deck adds nl_doubles (its junction voltages and value slots,
// newton_doubles), rounded up to an even count.
template <int NMAX>
__host__ __device__ constexpr int seg_slice(int nl_doubles = 0) {
  return (NMAX + 2) * (NMAX + 1) + NMAX + MAX_SRC + SEG_ROWS +
         ((nl_doubles + 1) & ~1);
}

// A deck's whole run on a segment of W = NMAX lanes of one warp per
// Monte-Carlo lane (THREADS / W lanes a block), thread i of the segment
// owning row i of the system.  Per attempt: the sources, thread i taking
// those s = i (mod W); then the solve; the LTE, thread i taking the C's
// and L's k = i (mod W), then a max over the segment (every term is +0 or
// more, or NaN, so the order does not move it); the step control, which
// every thread computes from the same values; the commit, each device by
// the thread k = i (mod W); the store, thread i writing x[i].
//
// The solve of a linear deck (NL false) is one build and elimination:
// thread i sums its row's stamps in plan order from the row view of the
// table (ops/run_plan.py row_view) into its row of the slice, then into
// registers; gj_warp_reg's elimination (x to the slice, all NaN when one
// x is not finite: the per-thread elimination left a poisoned row's inf
// there, but either way the attempt fails and its x is never committed or
// stored, so counters, state and waveforms keep their bits).
//
// The solve of a Newton deck (NL) is newton.cuh's transient Newton spread
// over the segment, from x = 0 with the carried junction voltages: per
// iteration, device j on thread j (mod W) limits its junctions from the
// last iterate (from iteration 1 on) and evaluates its value slots into
// the slice (limit_device, device_value; both read and write only that
// device's rows); then the build, a TAG_NL entry reading its slot; the
// elimination; the convergence test of row i on thread i (rows past n
// count as converged), ANDed over the segment with the elimination's
// finite flag.  The junction voltages stay in the slice across attempts.
//
// The warp's segments (8 of 4 lanes, 4 of 8, 2 of 16, or one of 32) run in
// lockstep under one full-warp mask: the warp attempts while any of its
// lanes is live, and iterates while any of its segments still iterates;
// a lane past its end (done, its attempts spent, paused, or past nlanes)
// runs the attempt with the others, and a segment whose Newton has ended
// (converged, or at max_iter) runs the later builds and eliminations, and
// both keep nothing of them: their junction voltages, value slots and
// counts do not move, and x is put back from the registers of each row's
// thread.  Per-segment masks let the segments drift apart, and the warp
// then issues each instruction once per segment.
template <int NMAX, bool NL, bool MAG, bool STORE, bool PHYS>
__global__ void __launch_bounds__(THREADS, SEG_BLOCKS)
run_seg_kernel(const int* __restrict__ topo_g, int topo_len, int nl_doubles,
               const double* __restrict__ dev, const double* __restrict__ rc,
               double* __restrict__ state, double* __restrict__ jv_g,
               double* __restrict__ t_io, double* __restrict__ dt_io,
               int* __restrict__ acc_out, int* __restrict__ att_io,
               int* __restrict__ fail_out, int* __restrict__ nri_out,
               int nlanes, double tstop, double minstep, double tmax,
               double trtol, int max_attempts, double reltol, double abstol,
               int max_iter, double tstart, int max_store, int stream,
               double* __restrict__ out_x, double* __restrict__ out_t,
               int* __restrict__ out_n, int* __restrict__ overflow,
               int trap) {
  constexpr int W = NMAX;
  extern __shared__ __align__(16) double seg_smem[];
  int* topo = reinterpret_cast<int*>(seg_smem);
  for (int i = threadIdx.x; i < topo_len; i += blockDim.x) topo[i] = topo_g[i];
  __syncthreads();
  const int seg = threadIdx.x / W;
  const int me = threadIdx.x & (W - 1);  // the row this thread owns
  const int lane0 = blockIdx.x * (THREADS / W);
  if (lane0 + (int)(threadIdx.x & ~31) / W >= nlanes) return;  // the warp
  const int lane = lane0 + seg;
  const bool real = lane < nlanes;
  const int row_lane = real ? lane : nlanes - 1;  // rows read, never written
  constexpr unsigned mask = 0xffffffffu;

  double* sl = seg_smem + (topo_len + 3) / 4 * 2 +
               seg * seg_slice<NMAX>(NL ? nl_doubles : 0);
  double* buf = sl;
  double* row = sl + (NMAX + 2) * (1 + me);
  double* xs = sl + (NMAX + 2) * (NMAX + 1);
  double* sv = xs + NMAX;
  double* own = sv + MAX_SRC;

  const int n = topo[H_NP1];
  const int nc = topo[H_NC], nl = topo[H_NL];
  const int nv_src = topo[H_NV];
  const int nsrc = nv_src + topo[H_NI];
  const int ks = topo[H_KS], nd = topo[H_ND], nrc = topo[H_NRC];
  const int* src = topo + topo[H_SRC];
  const int* cnodes = topo + topo[H_CN];
  const int* lnodes = topo + topo[H_LN];
  const int* lbranch = topo + topo[H_LB];
  const int4* ent = reinterpret_cast<const int4*>(topo + topo[H_ROWS]);
  const int* roff = topo + topo[H_ROWS] + 4 * topo[H_NE];

  // the lane's rows, read once into the slice and the state written back
  // once at the end, when they fit it (the same for every lane of a deck)
  const bool in_sh = ks + nd + nrc <= SEG_ROWS;
  double* const st_g = state + (size_t)row_lane * ks;
  double* st = st_g;
  const double* dv = dev + (size_t)row_lane * nd;
  const double* rv = rc + (size_t)row_lane * nrc;
  if (in_sh) {
    for (int i = me; i < ks; i += W) own[i] = st_g[i];
    for (int i = me; i < nd; i += W) own[ks + i] = dv[i];
    for (int i = me; i < nrc; i += W) own[ks + nd + i] = rv[i];
    st = own;
    dv = own + ks;
    rv = own + ks + nd;
  }
  // device rows: g[nr] C_t[nc] C[nc] L[nl], then the magnetic constants,
  // then a Newton deck's device blocks
  const double* g = dv;
  const double* cadj = dv + topo[H_NR];
  const double* craw = cadj + nc;
  const double* lval = craw + nc;
  // committed state rows: q0 q1 v0 v1 [nc], i0 i1 v0 v1 flux0 [nl], then
  // under physics C i0 hist [nc], L hist [nl], the diode and MOSFET blocks
  // (DS_ROWS x nD, MS_ROWS x nM), the live LM rows
  double* c_q0 = st;
  double* c_q1 = st + nc;
  double* c_v0 = st + 2 * nc;
  double* c_v1 = st + 3 * nc;
  double* l_i0 = st + 4 * nc;
  double* l_i1 = l_i0 + nl;
  double* l_v0 = l_i0 + 2 * nl;
  double* l_v1 = l_i0 + 3 * nl;
  double* l_flux0 = l_i0 + 4 * nl;
  double* c_i0 = l_i0 + 5 * nl;
  double* c_hist = c_i0 + nc;
  double* l_hist = c_hist + nc;
  double* d_st = l_hist + nl;
  double* m_st = d_st + DS_ROWS * topo[H_NDD];
  Mag mag{};
  MagPhys mp{};
  const int nlm = topo[H_NLM];
  if constexpr (MAG && PHYS) {
    mp.lm = lval + nl;
    mp.kc = mp.lm + LM_ROWS * nlm;
    mp.ls = m_st + MS_ROWS * topo[H_NM];
    mp.lval = lval;
    mp.l_i1 = l_i1;
    mp.l_hist = l_hist;
    mp.kp = topo + topo[H_KP];
    mp.nlm = nlm;
    mp.trap = trap != 0;
  } else if constexpr (MAG) {
    mag.l0 = lval + nl;
    mag.leff = mag.l0 + nlm;
    mag.i0 = mag.l0 + 2 * nlm;
    mag.i1 = mag.l0 + 3 * nlm;
    mag.mij = mag.l0 + 4 * nlm;
    mag.kp = topo + topo[H_KP];
    mag.l_i0 = l_i0;
  }
  const bool tr = PHYS && trap != 0;

  // a Newton deck's device blocks, its junction voltages (carried across
  // attempts, in the slice) and its value slots (the slice, after them)
  const Deck deck(topo, dv);
  const int ndev = deck.n_d + deck.n_q + deck.n_m;
  Phys ph;
  ph.d = d_st;
  ph.m = m_st;
  ph.trap = tr;
  double* jv = own + SEG_ROWS;
  double* nv = jv + deck.kj;
  // a slice shorter than the deck's junction voltages and value slots
  // (nl_doubles is not ops/run.py newton_doubles): every lane fails
  // before its first attempt, and the slice is neither read nor written
  const bool short_slice =
      NL && nl_doubles < deck.kj + D_SLOTS * deck.n_d + Q_SLOTS * deck.n_q +
                             M_SLOTS * deck.n_m;
  if constexpr (NL)
    if (!short_slice)
      for (int i = me; i < deck.kj; i += W)
        jv[i] = jv_g[(size_t)row_lane * deck.kj + i];
  __syncwarp(mask);

  double t = STORE ? t_io[row_lane] : 0.0;
  double dt = STORE ? dt_io[row_lane] : minstep;
  int att = STORE ? att_io[row_lane] : 0;
  const int att0 = att;
  bool done = !real || tstop <= 0.0 || t >= tstop || short_slice,
       fail = short_slice;
  int acc = 0, nri = 0, n_kept = 0;
  bool dropped = false;
  const double trtol100 = trtol / 100.0;
  auto live = [&] {
    return !done && att < max_attempts &&
           (!STORE || !stream || n_kept < max_store);
  };

  for (bool active = live(); __any_sync(mask, active); active = live()) {
    const double tpdt = t + dt;
    const bool over = tpdt > tstop;
    const double next_t = over ? tstop : tpdt;
    const double dte = over ? tstop - t : dt;
    const double dtl = dte > 0 ? dte : 1e-9;

    // ---- sources: trapezoidal physics at the end of the step
    // (engine/tran.py), the rest at the old time (PLAN.md 2)
    const double t_src = tr ? next_t : t;
    for (int s = me; s < nsrc; s += W)
      sv[s] = source_value(src[3 * s], rv + src[3 * s + 1], src[3 * s + 2],
                           t_src);
    __syncwarp(mask);

    // a stamp's value in this attempt: compat (the reference's companions,
    // the frozen-core LM and K), or physics (BE with the previous step's
    // charge, or the trapezoidal companions after the device's first
    // committed step; the live LM and K), as assemble.py stamps them
    auto stamp = [=](int tag, int k) -> double {
      if constexpr (PHYS) {
        switch (tag) {
          case TAG_G: return g[k];
          case TAG_GEQ:
            return (tr && c_hist[k] > 0) ? 2.0 * cadj[k] / dte
                                         : cadj[k] / dte;
          case TAG_CEQ:
            return (tr && c_hist[k] > 0)
                       ? 2.0 * cadj[k] / dte * c_v0[k] + c_i0[k]
                       : c_q0[k] / dte;
          case TAG_LTERM:
            return (tr && l_hist[k] > 0) ? 2.0 * lval[k] / dtl
                                         : lval[k] / dtl;
          case TAG_LRHS: {
            const bool on = tr && l_hist[k] > 0;
            const double lc = on ? 2.0 * lval[k] / dtl : lval[k] / dtl;
            return tr ? lc * l_i1[k] + (on ? l_v0[k] : 0.0) : lc * l_i1[k];
          }
          case TAG_VSRC: return sv[k];
          case TAG_ISRC: return sv[nv_src + k];
          default:  // TAG_ONE, or a magnetic stamp
            if constexpr (MAG) return mp.term(tag, k, dte, dtl);
            return 1.0;
        }
      } else {
        switch (tag) {
          case TAG_G: return g[k];
          case TAG_GEQ: return cadj[k] / dte;
          case TAG_LTERM: return lval[k] / dtl;
          case TAG_CEQ: return c_q1[k] / dte;
          case TAG_LRHS: return (lval[k] / dtl) * l_i1[k];
          case TAG_VSRC: return sv[k];
          case TAG_ISRC: return sv[nv_src + k];
          default:  // TAG_ONE, or a magnetic stamp
            if constexpr (MAG) return mag.term(tag, k, t, dte, dtl);
            return 1.0;
        }
      }
    };
    // ---- build (this thread's row, its stamps in plan order) and
    // eliminate: x to the slice; returns whether x is finite
    auto solve = [&]() -> bool {
      for (int c = 0; c <= n; ++c) row[c] = 0.0;
      if (me < n) {
        for (int e = roff[me]; e < roff[me + 1]; ++e) {
          const int4 q = ent[e];  // col, tag, index, sign
          const double v =
              (NL && q.y == TAG_NL) ? nv[q.z] : stamp(q.y, q.z);
          row[q.x] += (double)q.w * v;
        }
      }
      if (me == 0) row[0] = 1.0;  // the ground row is the identity
      // slot c holds column c, the right-hand side slot NMAX
      double m[1][NMAX + 1];
#pragma unroll
      for (int c = 0; c < NMAX; ++c) m[0][c] = c < n ? row[c] : 0.0;
      m[0][NMAX] = row[n];
      return gj_warp_reg<NMAX, W, 1>(m, n, buf, me, mask, xs);
    };

    bool nr_ok;
    if constexpr (NL) {
      // ---- Newton from x = 0 with the carried junction voltages
      double xo = 0.0;  // row me of the last iterate
      xs[me] = 0.0;
      int it = 0;
      bool ok = false;
      bool iter = active && max_iter > 0;
      __syncwarp(mask);
      while (__any_sync(mask, iter)) {
        if (iter) {
          for (int j = me; j < ndev; j += W) {
            if (it > 0) limit_device<PHYS>(deck, j, xs, jv);
            device_value<true, PHYS>(deck, j, jv, dte, 0.0, nv, ph);
          }
        }
        __syncwarp(mask);
        const bool finite = solve();
        __syncwarp(mask);
        // every |new - old| <= reltol*max(|new|, |old|) + abstol
        const double xn = xs[me];
        const double tol = reltol * max_nan(fabs(xn), fabs(xo)) + abstol;
        bool conv = me >= n || fabs(xn - xo) <= tol;
#pragma unroll
        for (int off = W / 2; off > 0; off >>= 1)
          conv = __shfl_xor_sync(mask, conv ? 1 : 0, off, W) && conv;
        if (iter) {
          xo = xn;
          ok = it > 0 && conv && finite;
          ++it;
          iter = !ok && it < max_iter;
        }
      }
      if (me < n) xs[me] = xo;  // what a segment that ran along kept
      __syncwarp(mask);
      nri += it;
      nr_ok = ok;
    } else {  // ---- one solve, converged when x is finite
      nr_ok = solve();
      __syncwarp(mask);
    }

    // ---- LTE from the committed state
    double lte = 0.0;
    for (int k = me; k < nc; k += W)
      lte = max_nan(lte,
                    fabs(craw[k] * c_v0[k] - craw[k] * c_v1[k]) / (2.0 * dte));
    for (int k = me; k < nl; k += W) {
      const double cur = fabs(l_i0[k] - l_i1[k]) / (2.0 * dte);
      const double vol = fabs(l_v0[k] - l_v1[k]) / (2.0 * dte);
      lte = max_nan(lte, max_nan(cur, vol));
    }
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1)
      lte = max_nan(lte, __shfl_xor_sync(mask, lte, off, W));

    // ---- accept / reject
    const bool can_halve = dte > minstep;
    const bool hard_fail = !nr_ok && !can_halve;
    const bool reject =
        (!nr_ok && can_halve) || (nr_ok && lte > trtol && can_halve);
    const bool accept = active && nr_ok && !reject;
    if (accept) {
      if constexpr (PHYS) {  // engine/state.py make_commit, physics
        for (int k = me; k < nc; k += W) {
          const double vd = xs[cnodes[2 * k]] - xs[cnodes[2 * k + 1]];
          const double q0 = c_q0[k], v0 = c_v0[k];
          const double dv_ = vd - v0;
          // trap with the stamp's C_t (the TR recursion must match it)
          c_i0[k] = tr ? (c_hist[k] > 0 ? 2.0 * cadj[k] / dte * dv_ - c_i0[k]
                                        : cadj[k] * dv_ / dte)
                       : craw[k] * dv_ / dte;
          c_q0[k] = craw[k] * vd;
          c_q1[k] = q0;
          c_v0[k] = vd;
          c_v1[k] = v0;
          c_hist[k] = 1.0;
        }
        for (int k = me; k < nl; k += W) {  // the branch unknown is -I
          const double vd = xs[lnodes[2 * k]] - xs[lnodes[2 * k + 1]];
          const double i = -xs[lbranch[k]];
          const double v0 = l_v0[k];
          l_i0[k] = i;
          l_i1[k] = i;
          l_v0[k] = vd;
          l_v1[k] = v0;
          l_flux0[k] = vd * dte;
          l_hist[k] = 1.0;
        }
        if constexpr (NL) {
          const int n_d = deck.n_d, n_m = deck.n_m;
          for (int k = me; k < n_d; k += W) {  // the diode's charge memory
            const double vd = xs[deck.dn[2 * k]] - xs[deck.dn[2 * k + 1]];
            double id, gd;
            d_phys(vd, deck.d(D_NVT, k), deck.d(D_IST, k), deck.d(D_GMIN, k),
                   deck.d(D_RS, k), deck.d(D_BV, k), &id, &gd);
            double* sd = d_st + k;
            const double q = deck.d(D_TT, k) * id;
            const double dq = q - sd[DS_Q * n_d];
            const double ic = (tr && sd[DS_HIST * n_d] > 0)
                                  ? 2.0 * dq / dte - sd[DS_IC * n_d]
                                  : dq / dte;
            sd[DS_VD * n_d] = vd;
            sd[DS_ID * n_d] = id;
            sd[DS_Q * n_d] = q;
            sd[DS_IC * n_d] = ic;
            sd[DS_HIST * n_d] = 1.0;
          }
          for (int k = me; k < n_m; k += W) {  // the MOSFET's charges
            const int* nd_ = deck.mn + 5 * k;  // drain gate source bulk level
            const Mos p{deck.pm + k, n_m};
            const double sg = p[M_SIGN];
            const double xsrc = xs[nd_[2]];
            double q[5];
            mos_charges(p, nd_[4], sg * (xs[nd_[1]] - xsrc),
                        sg * (xs[nd_[0]] - xsrc), sg * (xs[nd_[3]] - xsrc),
                        q);
            double* sm = m_st + k;
            const bool on = tr && sm[MS_HIST * n_m] > 0;
            for (int r = 0; r < 5; ++r) {
              const double dq = (q[r] - sm[(MS_QGS + r) * n_m]) / dte;
              sm[(MS_ICGS + r) * n_m] =
                  on ? 2.0 * dq - sm[(MS_ICGS + r) * n_m] : dq;
              sm[(MS_QGS + r) * n_m] = q[r];
            }
            sm[MS_HIST * n_m] = 1.0;
          }
        }
        if constexpr (MAG) {  // the live J-A commit (engine/state.py)
          const int* lmt = topo + topo[H_LMN];  // n1 n2 branch per winding
          const int* core = topo + topo[H_CORE];
          const double* lm = mp.lm;
          double* ls = mp.ls;
          for (int k = me; k < nlm; k += W) {
            // the core's summed mmf, in winding order (segment_sum)
            double mmf = 0.0;
            for (int w = 0; w < nlm; ++w)
              mmf = mmf + (core[w] == core[k]
                               ? lm[LM_TURNS * nlm + w] * -xs[lmt[3 * w + 2]]
                               : 0.0);
            const double h = clamp_max(
                clamp_min(mmf / lm[LM_LEN * nlm + k], -1e6), 1e6);
            ja_step(lm[LM_MST * nlm + k], lm[LM_A * nlm + k],
                    lm[LM_K * nlm + k], lm[LM_C * nlm + k],
                    lm[LM_ALPHA * nlm + k], h, ls + LS_H * nlm + k, nlm);
            const double vd = xs[lmt[3 * k]] - xs[lmt[3 * k + 1]];
            double* sk = ls + k;
            sk[LS_I1 * nlm] = sk[LS_I0 * nlm];
            sk[LS_I0 * nlm] = -xs[lmt[3 * k + 2]];
            sk[LS_V1 * nlm] = sk[LS_V0 * nlm];
            sk[LS_V0 * nlm] = vd;
            sk[LS_FLUX0 * nlm] = sk[LS_FLUX0 * nlm] + vd * dte;
          }
        }
      } else {
        for (int k = me; k < nc; k += W) {  // capacitor.go:155-171
          const double vd = xs[cnodes[2 * k]] - xs[cnodes[2 * k + 1]];
          const double q0 = c_q0[k], v0 = c_v0[k];
          c_q0[k] = craw[k] * vd;
          c_q1[k] = q0;
          c_v0[k] = vd;
          c_v1[k] = v0;
        }
        for (int k = me; k < nl; k += W) {  // inductor.go:81-114
          const double vd = xs[lnodes[2 * k]] - xs[lnodes[2 * k + 1]];
          const double v0 = l_v0[k];
          l_i0[k] = vd * 1e-9 / lval[k];
          l_i1[k] = l_i1[k] + vd * dte / lval[k];
          l_v0[k] = vd;
          l_v1[k] = v0;
          l_flux0[k] = vd * dte;
        }
      }
      t = next_t;
      if constexpr (STORE) {  // tran.go:141-143
        if (next_t >= tstart) {
          if (n_kept < max_store) {
            const size_t orow = (size_t)lane * max_store + n_kept;
            if (me < n) out_x[orow * n + me] = xs[me];
            if (me == 0) out_t[orow] = next_t;
            ++n_kept;
          } else {
            dropped = true;
          }
        }
      }
      const double grown = dte * (lte < trtol100 ? 2.0 : 1.1);
      const double dt_g = isnan(grown) ? grown : (grown > tmax ? tmax : grown);
      dt = (next_t < tstop && dte < tmax) ? dt_g : dte;
      ++acc;
      if (next_t >= tstop) done = true;
    } else if (active) {
      dt = dte / 2.0;
    }
    if (active) {
      if (hard_fail) {
        done = true;
        fail = true;
      }
      ++att;
    }
    __syncwarp(mask);  // the commit before the next attempt's reads
  }

  if (!real) return;
  if (in_sh)
    for (int i = me; i < ks; i += W) st_g[i] = st[i];
  if constexpr (NL)
    if (!short_slice)
      for (int i = me; i < deck.kj; i += W)
        jv_g[(size_t)lane * deck.kj + i] = jv[i];
  if (me == 0) {
    // a Newton deck's iterations, or a linear deck's attempts (one solve
    // each), in this run
    nri_out[lane] = NL ? nri : att - att0;
    t_io[lane] = t;
    dt_io[lane] = dt;
    acc_out[lane] = acc;
    att_io[lane] = att;
    if constexpr (STORE) {
      out_n[lane] = n_kept;
      overflow[lane] = dropped ? 1 : 0;
    }
    fail_out[lane] = fail ? 1 : 0;
  }
}

struct RunArgs {
  const int* topo;
  int topo_len;
  int nl_doubles;
  const double* dev;
  const double* rc;
  double* state;
  double* jv;
  double* t_io;
  double* dt_io;
  int* acc;
  int* att_io;
  int* fail;
  int* nri;
  int nlanes;
  double tstop, minstep, tmax, trtol;
  int max_attempts;
  double reltol, abstol;
  int max_iter;
  double tstart;
  int max_store, stream;
  double* out_x;
  double* out_t;
  int* out_n;
  int* overflow;
  int trap;
};

// A deck's launch shape (newton.cuh seg_shape_of): nl_doubles is a
// Newton deck's (0 for a linear one).
template <int NMAX>
SegShape seg_shape(int nlanes, int topo_len, int nl_doubles) {
  return seg_shape_of<NMAX>(nlanes, topo_len, seg_slice<NMAX>(nl_doubles));
}

// the shape of np1's size bucket (newton.cuh seg_bucket); false past
// the caps
inline bool seg_shape_np1(int np1, int nlanes, int topo_len, int nl_doubles,
                          SegShape* s) {
  switch (seg_bucket(np1)) {
    case 4: *s = seg_shape<4>(nlanes, topo_len, nl_doubles); return true;
    case 8: *s = seg_shape<8>(nlanes, topo_len, nl_doubles); return true;
    case 16: *s = seg_shape<16>(nlanes, topo_len, nl_doubles); return true;
    case 32: *s = seg_shape<32>(nlanes, topo_len, nl_doubles); return true;
    default: return false;
  }
}

// The launch of one instantiation: a segment of a warp per lane; NL the
// Newton (a.nl_doubles sizes its slots), else a linear deck.
template <int NMAX, bool NL, bool MAG, bool STORE, bool PHYS>
cudaError_t launch(const RunArgs& a, cudaStream_t stream) {
  return seg_launch(
      run_seg_kernel<NMAX, NL, MAG, STORE, PHYS>,
      seg_shape<NMAX>(a.nlanes, a.topo_len, NL ? a.nl_doubles : 0), stream,
      a.topo, a.topo_len, a.nl_doubles, a.dev, a.rc, a.state, a.jv, a.t_io,
      a.dt_io, a.acc, a.att_io, a.fail, a.nri, a.nlanes, a.tstop, a.minstep,
      a.tmax, a.trtol, a.max_attempts, a.reltol, a.abstol, a.max_iter,
      a.tstart, a.max_store, a.stream, a.out_x, a.out_t, a.out_n,
      a.overflow, a.trap);
}

}  // namespace
