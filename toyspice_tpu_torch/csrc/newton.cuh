// The Newton of the port's nonlinear kernels, f64: the per-device bodies
// (limit_diode .. limit_mos, value_diode .. value_mos), which every kernel
// calls device by device, a device a thread of a lane's warp segment; the
// segment Newton of csrc/op_kernel.cu (each OP solve) and
// csrc/dc_sweep_kernel.cu (each sweep point), seg_newton; and its build
// and solve, seg_solve, which also solves csrc/stamped_solve.cu's systems
// to np1 = 32.
// The run kernel (csrc/run_kernel.cuh) runs the transient's Newton on the
// same bodies.
//
// The CUDA counterpart of toyspice_tpu/ops/pallas_tran.py's
// _newton_in_kernel and _device_eval_lib (compat, and with PHYS the
// physics branches), and of the general engine's engine/newton.py.
// ops/newton.py is the same arithmetic as torch operations: each value
// below is computed with the operations of that file in the same order,
// and the build uses -fmad=false, so that kernel and plain version agree
// bit for bit.
//
// One Newton iteration of a lane:
//   1. junction voltages: the carried ones at iteration 0 of a transient
//      attempt or a DC sweep point (warm start, tran.go:174, dc.go:155),
//      else UpdateVoltages of the last solution with pnjlim on the diode
//      and BJT junctions (engine/nlstate.py; PHYS adds the diode's
//      breakdown-frame limit);
//   2. device evaluation into value slots (ops/run_plan.py NL_SLOTS per
//      device): the diode (compat, or PHYS: Bv and Rs) with its
//      transit-time companion, the Ebers-Moll BJT with its exact Jacobian
//      after the cold-start guess, the level 1-3 MOSFET after its
//      cold-start guess, with the Meyer charge stamps of a transient
//      (compat: previous charges frozen, PLAN.md 1; PHYS: the committed
//      charge memory, trapezoidal after a device's first committed step);
//   3. the build from the stamp plan in shared memory, row i from its
//      entries in plan order, the ground row and, in an OP, the status
//      gmin on every non-ground diagonal;
//   4. Gauss-Jordan with partial pivoting (largest |pivot| among unused
//      rows, lowest row on a tie; a zero pivot poisons the row);
//   5. convergence from iteration 1 on: every |new - old| <=
//      reltol*max(|new|, |old|) + abstol (a DC sweep point: every |new -
//      old| <= abstol or <= reltol*|new|), and the solution finite.
// The loop ends on convergence or at max_iter, the lane's own count.
//
// Not a copy of the TPU code: that one carries double-float (hi, lo) f32
// pairs folded to (8, W) tiles and extracts pivot rows by one-hot sums;
// Hopper has native f64, and here a lane's system lives on a segment of
// W = 4, 8, 16 or 32 lanes of a warp (np1's size bucket), row i in the
// registers of thread i (gj_warp.cuh), its junction voltages and value
// slots in the segment's slice of shared memory.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "gj_warp.cuh"

namespace tsr {

// stamp tags and table header slots: ops/run_plan.py TAG_* and H_*
enum Tag { TAG_G = 0, TAG_GEQ, TAG_LTERM, TAG_ONE, TAG_CEQ, TAG_LRHS,
           TAG_VSRC, TAG_ISRC, TAG_NL, TAG_LMTERM, TAG_LMRHS, TAG_KTERM,
           TAG_KRHSA, TAG_KRHSB };
enum Hdr { H_NP1 = 0, H_NE, H_NR, H_NC, H_NL, H_NV, H_NI, H_ENT, H_SRC, H_CN,
           H_LN, H_KS, H_ND, H_NRC, H_NDD, H_NQ, H_NM, H_DN, H_QN, H_MN,
           H_NLIN, H_KJ, H_DOFF, H_QOFF, H_MOFF, H_NLM, H_NK, H_KP, H_LB,
           H_LMN, H_CORE, H_ROWS };
// per-device dev rows: ops/run_plan.py D_ROWS, Q_ROWS, M_ROWS
enum DRow { D_N = 0, D_IS, D_GMIN, D_TT, D_PQ, D_NVT, D_IST, D_VTE,
            D_VCRIT, D_RS, D_BV };
enum QRow { Q_SIGN = 0, Q_IES, Q_ICS, Q_NF, Q_NR, Q_AF, Q_INVNFVT,
            Q_INVNRVT, Q_INVVAF, Q_INVVAR, Q_INVIKF, Q_INVIKR, Q_VBE0,
            Q_VBC0, Q_VTEF, Q_VCRITF, Q_VTER, Q_VCRITR };
enum MRow { M_SIGN = 0, M_VTO, M_GAMMA, M_PHI, M_KP, M_W, M_L, M_LAM,
            M_TOX, M_UO, M_UCRIT, M_UEXP, M_VMAX, M_THETA, M_KAPPA, M_DELTA,
            M_CGSO, M_CGDO, M_CGBO, M_CBS, M_CBD, M_CJ, M_CJSW, M_AS, M_AD,
            M_PS, M_PD, M_PB, M_MJ, M_QGS, M_QGD, M_QGB, M_QBS, M_QBD };
// value slots per device: ops/run_plan.py NL_SLOTS
constexpr int D_SLOTS = 2, Q_SLOTS = 12, M_SLOTS = 21;
// the physics state rows of a diode and a MOSFET: ops/run_plan.py
// PHYS_ROWS (row r of device k at r*nk + k)
enum DState { DS_VD = 0, DS_ID, DS_Q, DS_IC, DS_HIST, DS_ROWS };
enum MState { MS_QGS = 0, MS_QGD, MS_QGB, MS_QBS, MS_QBD, MS_ICGS, MS_ICGD,
              MS_ICGB, MS_ICBS, MS_ICBD, MS_HIST, MS_ROWS };

constexpr int THREADS = 128;

constexpr double EXP_CLAMP = 40.0;  // models/bjt.py, models/diode.py
constexpr double MOS_GMIN = 1e-12;  // models/mosfet.py GMIN
constexpr double MOS_DELTA = 1e-6;  // models/mosfet.py DELTA
constexpr double MOS_INV_DELTA = 1e6;  // models/mosfet.py INV_DELTA
constexpr double COX_NUM = 3.9 * 8.85e-14;  // 3.9 * EPS0 (mosfet.go:382)
// XLA folds 2·c/3 and c/3 into products with these (models/mosfet.py)
constexpr double TWO_THIRDS = 2.0 / 3.0, ONE_THIRD = 1.0 / 3.0;
enum Region { CUTOFF = 0, LINEAR = 1, SATURATION = 2 };

// torch.maximum / torch.minimum: NaN if either is NaN
__device__ __forceinline__ double max_nan(double a, double b) {
  if (isnan(a) || isnan(b)) return NAN;
  return a > b ? a : b;
}
__device__ __forceinline__ double min_nan(double a, double b) {
  if (isnan(a) || isnan(b)) return NAN;
  return a < b ? a : b;
}
// torch.clamp_min / clamp_max: a NaN passes through
__device__ __forceinline__ double clamp_min(double x, double lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ double clamp_max(double x, double hi) {
  return x > hi ? hi : x;
}
// torch.sign: 0 for zero and NaN
__device__ __forceinline__ double sgn(double x) {
  return (double)((0.0 < x) - (x < 0.0));
}

// a ** b for a > 0 as exp(b*log a): models/mosfet.py pow_pos (pow built
// with -fmad=false does not round as torch.pow on every input; exp and log
// do)
__device__ __forceinline__ double pow_pos(double a, double b) {
  return exp(b * log(a));
}

// SPICE3F5 DEVpnjlim: models/limiter.py
__device__ __forceinline__ double pnjlim(double vnew, double vold, double vte,
                                         double vc) {
  const bool limit = (vnew > vc) && (fabs(vnew - vold) > 2.0 * vte);
  if (!limit) return vnew;
  if (vold > 0) {
    const double arg = 1.0 + (vnew - vold) / vte;
    return arg > 0 ? vold + vte * log(clamp_min(arg, 1e-300)) : vc;
  }
  return vte * log(clamp_min(vnew, 1e-300) / vte);
}

// ------------------------------------------------ the physics diode

// The junction's (i, g) at vj with the Bv breakdown exponential
// (models/diode.py _raw_physics).
__device__ __forceinline__ void d_raw_phys(double vj, double nvt, double is_t,
                                           double gmin, double bv, double* i,
                                           double* g) {
  const bool fwd = vj > -3.0 * nvt;
  const bool bkd = vj <= -bv;
  const double arg = clamp_max(vj / nvt, EXP_CLAMP);
  const double barg = clamp_max(-(bv + vj) / nvt, EXP_CLAMP);
  const double eb = exp(barg);
  const double i_fwd = is_t * (exp(arg) - 1.0);
  const double i_bkd = -is_t * eb;
  *i = fwd ? i_fwd : (bkd ? i_bkd : -is_t);
  const double g_fwd = (fabs(i_fwd) + is_t) / nvt;
  const double g_bkd = is_t * eb / nvt;
  *g = (fwd ? g_fwd : (bkd ? g_bkd : 0.0)) + gmin;
}

// Terminal (id, gd) of the physics diode (models/diode.py
// dc_eval_physics): Rs folded in by the 8-step inner Newton from the
// current-limited seed.  The branch is per lane and at run time: at
// Rs = 0 the seed is vd and every step subtracts 0, so skipping them is
// exact.
__device__ __forceinline__ void d_phys(double vd, double nvt, double is_t,
                                       double gmin, double rs, double bv,
                                       double* id, double* gd) {
  double vj = vd, ij, gj;
  if (rs != 0.0) {
    const bool rs_pos = rs > 0;
    const double rs_is = (rs_pos ? rs : 1.0) * is_t;
    const double fwd_cap = nvt * log1p(clamp_min(vd, 0.0) / rs_is);
    const double bkd_cap =
        -bv - nvt * log1p(clamp_min(-vd - bv, 0.0) / rs_is);
    vj = (rs_pos && vd > 0)
             ? min_nan(vd, fwd_cap)
             : ((rs_pos && vd < -bv) ? max_nan(vd, bkd_cap) : vd);
    for (int s = 0; s < 8; ++s) {
      d_raw_phys(vj, nvt, is_t, gmin, bv, &ij, &gj);
      const double f = vj + rs * ij - vd;
      vj = vj - f / (1.0 + rs * gj);
    }
  }
  d_raw_phys(vj, nvt, is_t, gmin, bv, &ij, &gj);
  *id = ij;
  *gd = gj / (1.0 + rs * gj);
}

// What a physics transient's companions read besides the dev rows: the
// lane's committed diode and MOSFET rows and the integration rule.
struct Phys {
  const double* d = nullptr;  // DS_ROWS x n_d
  const double* m = nullptr;  // MS_ROWS x n_m
  bool trap = false;
};

// ------------------------------------------------------------ the MOSFET

struct Mos {  // one device's rows: models/mosfet.py reads them as p[...]
  const double* p;
  int stride;
  __device__ __forceinline__ double operator[](int r) const {
    return p[r * stride];
  }
};

// threshold with body effect, type-positive frame (mosfet.go:296-318)
__device__ __forceinline__ double mos_vth(const Mos& p, double vbs) {
  if (!(p[M_GAMMA] > 0)) return p[M_VTO];
  return p[M_VTO] + p[M_GAMMA] * (sqrt(clamp_min(p[M_PHI] - vbs, 0.0)) -
                                  sqrt(p[M_PHI]));
}

// drain current in the type-positive frame (mosfet.go:321-459): the branch
// of the device's level only, as the torch version selects it
__device__ double mos_ids(const Mos& p, int level, double vgs, double vds,
                          double vbs, int* region) {
  const double vth = mos_vth(p, vbs);
  const double vgst = vgs - vth;
  const double beta1 = p[M_KP] * p[M_W] / p[M_L];
  const double lamf = 1.0 + p[M_LAM] * vds;
  double id, vdsat;
  if (level == 2) {
    const double cox = COX_NUM / p[M_TOX];
    const double tox100 = p[M_TOX] * 100.0;
    const double eeff = vgst / tox100;
    // eeff / ucrit as XLA computes it (models/mosfet.py)
    const double den =
        (p[M_UCRIT] > 0 && eeff > 0)
            ? 1.0 + pow_pos(clamp_min(vgst / (tox100 * p[M_UCRIT]), 1e-300),
                            p[M_UEXP])
            : 1.0;
    const double ueff = p[M_UO] / den;
    const double ecrit = p[M_VMAX] / (ueff == 0 ? 1.0 : ueff) * 100.0;
    vdsat = p[M_VMAX] > 0 ? min_nan(vgst, ecrit * p[M_L]) : vgst;
    const double beta2 = ueff * cox * p[M_W] / (p[M_L] * 100.0);
    id = vds < vdsat
             ? beta2 * (vgst * vds - 0.5 * vds * vds) * lamf
             : 0.5 * beta2 * vdsat * vdsat * lamf;
  } else if (level == 3) {
    const double vgst_eff =
        p[M_THETA] > 0 ? vgst / (1.0 + p[M_THETA] * vgst) : vgst;
    // a / sqrt(b) and beta1 / c as XLA computes them (models/mosfet.py)
    vdsat = p[M_KAPPA] > 0
                ? vgst_eff * (1.0 / sqrt(clamp_min(1.0 + p[M_KAPPA] * vgst_eff,
                                                   1e-30)))
                : vgst_eff;
    const double beta3 =
        (p[M_KP] * p[M_W]) /
        (p[M_L] * (p[M_DELTA] > 0 ? 1.0 + p[M_DELTA] / p[M_W] : 1.0));
    id = vds < vdsat
             ? beta3 *
                   (vgst_eff * vds -
                    0.5 * vds * vds / (1.0 + p[M_KAPPA] * vgst_eff)) *
                   lamf
             : 0.5 * beta3 * vdsat * vdsat * lamf;
  } else {
    vdsat = vgst;
    id = vds < vgst ? beta1 * (vgst * vds - 0.5 * vds * vds) * lamf
                    : 0.5 * beta1 * vgst * vgst * lamf;
  }
  if (vgst <= 0) {
    *region = CUTOFF;
    return 0.0;
  }
  *region = vds < vdsat ? LINEAR : SATURATION;
  return id;
}

// one bulk junction's charge (mosfet.go:597-637)
__device__ __forceinline__ double mos_qj(const Mos& p, double c, double v) {
  const double cv =
      v < 0 ? c / pow_pos(clamp_min(1.0 - v / p[M_PB], 1e-30), p[M_MJ])
            : c * (1.0 + p[M_MJ] * v / p[M_PB]);
  return cv * v;
}

// The five charges qgs qgd qgb qbs qbd at the terminal voltages, no cold
// start (models/mosfet.py dc_eval and charges, as the physics commit of
// engine/state.py takes them): the Meyer capacitances of device_values.
__device__ void mos_charges(const Mos& p, int level, double vgs, double vds,
                            double vbs, double* q) {
  int region;
  mos_ids(p, level, vgs, vds, vbs, &region);
  const bool lin = region == LINEAR;
  const bool cut = region == CUTOFF;
  const double cox = COX_NUM / p[M_TOX];
  const double cgate = cox * p[M_W] * p[M_L];
  const double cgso = p[M_CGSO] * p[M_W];
  const double cgdo = p[M_CGDO] * p[M_W];
  const double cgbo = p[M_CGBO] * p[M_L];
  const double cbs = (p[M_CBS] == 0 && p[M_CJ] > 0)
                         ? p[M_CJ] * p[M_AS] + p[M_CJSW] * p[M_PS]
                         : p[M_CBS];
  const double cbd = (p[M_CBD] == 0 && p[M_CJ] > 0)
                         ? p[M_CJ] * p[M_AD] + p[M_CJSW] * p[M_PD]
                         : p[M_CBD];
  const double cgs =
      cut ? cgso : (lin ? cgate / 2.0 + cgso : cgate * TWO_THIRDS + cgso);
  const double cgd = cut ? cgdo : (lin ? cgate / 2.0 + cgdo : cgdo);
  const double cgb =
      cut ? cgate * TWO_THIRDS : (lin ? cgbo : cgbo + cgate * ONE_THIRD);
  q[0] = cut ? 0.0 : cgs * vgs;
  q[1] = cut ? 0.0 : cgd * (vgs - vds);
  q[2] = cgb * (vgs - vbs);
  q[3] = mos_qj(p, cbs, vbs);
  q[4] = mos_qj(p, cbd, vbs - vds);
}

// ------------------------------------------------------- the lane's deck

// What a lane's Newton reads: the plan in shared memory, its dev row, and
// where its nonlinear device blocks start.
struct Deck {
  const int* topo;
  const double* dv;
  int n, n_d, n_q, n_m, kj;
  const int* dn;
  const int* qn;
  const int* mn;
  const double* pd;
  const double* pq;
  const double* pm;

  __device__ Deck(const int* topo_, const double* dv_) : topo(topo_),
                                                         dv(dv_) {
    n = topo[H_NP1];
    n_d = topo[H_NDD];
    n_q = topo[H_NQ];
    n_m = topo[H_NM];
    kj = topo[H_KJ];
    dn = topo + topo[H_DN];
    qn = topo + topo[H_QN];
    mn = topo + topo[H_MN];
    pd = dv + topo[H_DOFF];
    pq = dv + topo[H_QOFF];
    pm = dv + topo[H_MOFF];
  }
  __device__ __forceinline__ double d(int r, int k) const {
    return pd[r * n_d + k];
  }
  __device__ __forceinline__ double q(int r, int k) const {
    return pq[r * n_q + k];
  }
};

// UpdateVoltages + pnjlim (engine/nlstate.py), in place on the rows
// D vd | Q vbe | Q vbc | M vgs | M vds | M vbs, one device at a time: each
// body reads x and writes only its own device's rows of jv.  PHYS limits a
// diode voltage below min(0, -Bv + 10 vte) as -(Bv + vd), gated on the new
// voltage only.
template <bool PHYS>
__device__ __forceinline__ void limit_diode(const Deck& c, int k,
                                            const double* x, double* jv) {
  const double vd = x[c.dn[2 * k]] - x[c.dn[2 * k + 1]];
  if constexpr (PHYS) {
    const double vte = c.d(D_VTE, k), vcrit = c.d(D_VCRIT, k);
    const double bv = c.d(D_BV, k);
    const double vold = jv[k];
    double v = pnjlim(vd, vold, vte, vcrit);
    if (vd < min_nan(0.0, -bv + 10.0 * vte))
      v = -bv - pnjlim(-(bv + vd), -(bv + vold), vte, vcrit);
    jv[k] = v;
  } else {
    jv[k] = pnjlim(vd, jv[k], c.d(D_VTE, k), c.d(D_VCRIT, k));
  }
}

__device__ __forceinline__ void limit_bjt(const Deck& c, int k,
                                          const double* x, double* jv) {
  double* vbe = jv + c.n_d;
  double* vbc = vbe + c.n_q;
  const double vc = x[c.qn[3 * k]], vb = x[c.qn[3 * k + 1]],
               ve = x[c.qn[3 * k + 2]];
  const bool pnp = c.q(Q_SIGN, k) < 0;
  const double be = pnp ? ve - vb : vb - ve;
  const double bc = pnp ? vc - vb : vb - vc;
  vbe[k] = pnjlim(be, vbe[k], c.q(Q_VTEF, k), c.q(Q_VCRITF, k));
  vbc[k] = pnjlim(bc, vbc[k], c.q(Q_VTER, k), c.q(Q_VCRITR, k));
}

__device__ __forceinline__ void limit_mos(const Deck& c, int k,
                                          const double* x, double* jv) {
  double* vgs = jv + c.n_d + 2 * c.n_q;
  double* vds = vgs + c.n_m;
  double* vbs = vds + c.n_m;
  const int* nd = c.mn + 5 * k;  // drain gate source bulk level
  const double s = c.pm[M_SIGN * c.n_m + k];
  const double xs = x[nd[2]];
  vgs[k] = s * (x[nd[1]] - xs);
  vds[k] = s * (x[nd[0]] - xs);
  vbs[k] = s * (x[nd[3]] - xs);
}

// The limit of device j of the deck's order (its diodes, then its BJTs,
// then its MOSFETs).
template <bool PHYS = false>
__device__ __forceinline__ void limit_device(const Deck& c, int j,
                                             const double* x, double* jv) {
  if (j < c.n_d)
    limit_diode<PHYS>(c, j, x, jv);
  else if (j < c.n_d + c.n_q)
    limit_bjt(c, j - c.n_d, x, jv);
  else
    limit_mos(c, j - c.n_d - c.n_q, x, jv);
}

// Device evaluation into the value slots at junction voltages jv, one
// device at a time: each body reads its own device's rows of jv (and under
// PHYS its committed rows in ph) and writes only its own slots.  TRAN adds
// the companions of a transient step dte; gmin is the OP's status gmin on
// the MOSFET drain/source diagonals (0 in a transient).  PHYS evaluates
// the physics diode, and its companions read ph.
template <bool TRAN, bool PHYS>
__device__ __forceinline__ void value_diode(const Deck& c, int k,
                                            const double* jv, double dte,
                                            double* nv, const Phys& ph) {
  // ---- diodes (diode.go:119-148, 184-227)
  const double vd = jv[k];
  const double nvt = c.d(D_NVT, k), is_t = c.d(D_IST, k);
  const double gmin_d = c.d(D_GMIN, k);
  double id, gd;
  if constexpr (PHYS) {
    d_phys(vd, nvt, is_t, gmin_d, c.d(D_RS, k), c.d(D_BV, k), &id, &gd);
  } else {
    const bool fwd = vd > -3.0 * nvt;
    const double arg = clamp_max(vd / nvt, EXP_CLAMP);
    const double i_fwd = is_t * (exp(arg) - 1.0);
    id = fwd ? i_fwd : -is_t;
    gd = fwd ? (fabs(id) + is_t) / nvt + gmin_d : gmin_d;
  }
  if (TRAN && PHYS) {  // the committed charge memory (assemble.py)
    const double tt = c.d(D_TT, k);
    const double* sd = ph.d + k;
    const bool on = ph.trap && sd[DS_HIST * c.n_d] > 0;
    const double dq = tt * id - sd[DS_Q * c.n_d];
    const bool pos = dte > 0;
    const double cap =
        pos ? (on ? 2.0 * dq / dte - sd[DS_IC * c.n_d] : dq / dte) : 0.0;
    const double geq = pos ? (on ? 2.0 * tt : tt) * gd / dte : 0.0;
    gd = gd + geq;
    id = id + cap;
  } else if (TRAN) {  // compat: the previous charge is frozen (PLAN.md 1)
    const double tt = c.d(D_TT, k);
    const double charge = tt * id;
    const bool pos = dte > 0;
    const double cap = pos ? (charge - c.d(D_PQ, k)) / dte : 0.0;
    const double geq = pos ? tt * gd / dte : 0.0;
    gd = gd + geq;
    id = id + cap;
  }
  nv[k] = gd;
  nv[c.n_d + k] = id - gd * vd;
}

__device__ __forceinline__ void value_bjt(const Deck& c, int k,
                                          const double* jv, double* nv) {
  // ---- BJTs: models/bjt.py jacobian after the cold start
  double* qv = nv + D_SLOTS * c.n_d;
  const double* jbe = jv + c.n_d;
  const double* jbc = jbe + c.n_q;
  double vbe = jbe[k], vbc = jbc[k];
  const bool cold = (vbe == 0.0) && (vbe - vbc == 0.0);
  vbe = cold ? c.q(Q_VBE0, k) : vbe;
  vbc = cold ? c.q(Q_VBC0, k) : vbc;
  const double sign = c.q(Q_SIGN, k), ies = c.q(Q_IES, k),
               ics = c.q(Q_ICS, k);
  const double invnfvt = c.q(Q_INVNFVT, k), invnrvt = c.q(Q_INVNRVT, k);
  const double invvaf = c.q(Q_INVVAF, k), invvar = c.q(Q_INVVAR, k);
  const double invikf = c.q(Q_INVIKF, k), invikr = c.q(Q_INVIKR, k);
  const double a1 = vbe * invnfvt;
  const double a2 = vbc * invnrvt;
  const double e1 = exp(clamp_max(a1, EXP_CLAMP));
  const double e2 = exp(clamp_max(a2, EXP_CLAMP));
  const double f0 = sign * ies * (e1 - 1.0);
  const double r0 = sign * ics * (e2 - 1.0);
  const double df0 = a1 <= EXP_CLAMP ? sign * ies * e1 * invnfvt : 0.0;
  const double dr0 = a2 <= EXP_CLAMP ? sign * ics * e2 * invnrvt : 0.0;
  const double u = 1.0 - vbc * invvaf;
  const double wv = 1.0 + vbe * invvar;
  const double f1 = f0 * u;
  const double r1 = r0 * wv;
  const double df1_be = df0 * u;
  const double df1_bc = -f0 * invvaf;
  const double dr1_be = r0 * invvar;
  const double dr1_bc = dr0 * wv;
  const double sf = sgn(f1), sr = sgn(r1);
  const double den_f = 1.0 + fabs(f1) * invikf * u;
  const double den_r = 1.0 + fabs(r1) * invikr * u;
  const double f2 = f1 / den_f;
  const double r2 = r1 / den_r;
  const double ddenf_be = sf * df1_be * invikf * u;
  const double ddenf_bc =
      sf * df1_bc * invikf * u - fabs(f1) * invikf * invvaf;
  const double ddenr_be = sr * dr1_be * invikr * u;
  const double ddenr_bc =
      sr * dr1_bc * invikr * u - fabs(r1) * invikr * invvaf;
  const double df2_be = (df1_be - f2 * ddenf_be) / den_f;
  const double df2_bc = (df1_bc - f2 * ddenf_bc) / den_f;
  const double dr2_be = (dr1_be - r2 * ddenr_be) / den_r;
  const double dr2_bc = (dr1_bc - r2 * ddenr_bc) / den_r;
  const double af = c.q(Q_AF, k);
  const double ic0 = sign * (af * f2 - r2) * u;
  const double ie0 = sign * (f2 - r2);
  const double ib0 = ie0 - ic0;
  const double g11 = sign * (af * df2_be - dr2_be) * u;
  const double g12 = sign * ((af * df2_bc - dr2_bc) * u - (af * f2 - r2) *
                                                            invvaf);
  const double g21 = sign * (df2_be - dr2_be) - g11;
  const double g22 = sign * (df2_bc - dr2_bc) - g12;
  const int nq = c.n_q;
  // the stamp of ops/assemble.py's BJT block, base node sign sb
  qv[0 * nq + k] = (g11 + g12) * sign;
  qv[1 * nq + k] = -g11 * sign;
  qv[2 * nq + k] = -g12 * sign;
  qv[3 * nq + k] = (g21 + g22) * sign;
  qv[4 * nq + k] = -g21 * sign;
  qv[5 * nq + k] = -g22 * sign;
  qv[6 * nq + k] = -(g11 + g12 + g21 + g22) * sign;
  qv[7 * nq + k] = (g11 + g21) * sign;
  qv[8 * nq + k] = (g12 + g22) * sign;
  qv[9 * nq + k] = -ic0 + g11 * vbe + g12 * vbc;
  qv[10 * nq + k] = -ib0 + g21 * vbe + g22 * vbc;
  qv[11 * nq + k] = (ic0 + ib0) - (g11 + g21) * vbe - (g12 + g22) * vbc;
}

template <bool TRAN, bool PHYS>
__device__ __forceinline__ void value_mos(const Deck& c, int k,
                                          const double* jv, double dte,
                                          double gmin, double* nv,
                                          const Phys& ph) {
  // ---- MOSFETs: models/mosfet.py dc_eval and charges after the cold
  // start
  double* mv = nv + D_SLOTS * c.n_d + Q_SLOTS * c.n_q;
  const int nm = c.n_m;
  const double* jgs = jv + c.n_d + 2 * c.n_q;
  const double* jds = jgs + nm;
  const double* jbs = jds + nm;
  const Mos p{c.pm + k, nm};
  const int level = c.mn[5 * k + 4];
  double vgs = jgs[k], vds = jds[k], vbs = jbs[k];
  const bool cold = (vgs == 0.0) && (vds == 0.0) && (vbs == 0.0);
  vgs = cold ? 0.7 : vgs;
  vds = cold ? 0.1 : vds;
  vbs = cold ? 0.0 : vbs;
  const double sign = p[M_SIGN];
  int region;
  const double id = sign * mos_ids(p, level, vgs, vds, vbs, &region);
  const double vth = mos_vth(p, vbs);
  const double vgst = vgs - vth;
  const double beta1 = p[M_KP] * p[M_W] / p[M_L];
  const bool lin = region == LINEAR;
  const bool cut = region == CUTOFF;
  double gm, gds, gmbs;
  if (level == 2 || level == 3) {  // numeric differencing (mosfet.go:517)
    const double d = MOS_DELTA * sign;
    int r_;
    const double idg = mos_ids(p, level, vgs + d, vds, vbs, &r_);
    const double idd = mos_ids(p, level, vgs, vds + d, vbs, &r_);
    const double idb = mos_ids(p, level, vgs, vds, vbs + d, &r_);
    gm = clamp_min((sign * idg - id) * MOS_INV_DELTA, MOS_GMIN);
    gds = clamp_min((sign * idd - id) * MOS_INV_DELTA, MOS_GMIN);
    gmbs = clamp_min((sign * idb - id) * MOS_INV_DELTA, MOS_GMIN);
  } else {  // level 1 analytic (mosfet.go:505-515)
    const double lamf = 1.0 + p[M_LAM] * vds;
    gm = lin ? beta1 * vds * lamf : beta1 * vgst * lamf;
    gds = lin ? beta1 * (vgst - vds) * lamf +
                    beta1 * p[M_LAM] * (vgst * vds - 0.5 * vds * vds)
              : 0.5 * beta1 * vgst * vgst * p[M_LAM];
    gmbs = (p[M_GAMMA] > 0 && p[M_PHI] > 0 && vbs < 0)
               ? gm * p[M_GAMMA] /
                     (2.0 * sqrt(clamp_min(p[M_PHI] - vbs, 1e-30)))
               : MOS_GMIN;
  }
  gm = cut ? MOS_GMIN : gm;
  gds = cut ? MOS_GMIN : gds;
  gmbs = cut ? MOS_GMIN : gmbs;
  gm = gm * sign;  // mosfet.go:534-537: gm and gmbs flip, gds does not
  gmbs = gmbs * sign;
  mv[0 * nm + k] = gds + gmin;
  mv[1 * nm + k] = gm;
  mv[2 * nm + k] = -gds - gm - gmbs;
  mv[3 * nm + k] = gmbs;
  mv[4 * nm + k] = gds + gm + gmbs + gmin;
  mv[5 * nm + k] = -gds;
  mv[6 * nm + k] = -gm;
  mv[7 * nm + k] = -gmbs;
  mv[8 * nm + k] = -id + gds * vds + gm * vgs + gmbs * vbs;
  if (TRAN) {  // Meyer capacitances (mosfet.go:540-594) and charges
    const double cox = COX_NUM / p[M_TOX];
    const double cgate = cox * p[M_W] * p[M_L];
    const double cgso = p[M_CGSO] * p[M_W];
    const double cgdo = p[M_CGDO] * p[M_W];
    const double cgbo = p[M_CGBO] * p[M_L];
    const double cbs = (p[M_CBS] == 0 && p[M_CJ] > 0)
                           ? p[M_CJ] * p[M_AS] + p[M_CJSW] * p[M_PS]
                           : p[M_CBS];
    const double cbd = (p[M_CBD] == 0 && p[M_CJ] > 0)
                           ? p[M_CJ] * p[M_AD] + p[M_CJSW] * p[M_PD]
                           : p[M_CBD];
    const double cgs = cut ? cgso
                           : (lin ? cgate / 2.0 + cgso
                                  : cgate * TWO_THIRDS + cgso);
    const double cgd = cut ? cgdo : (lin ? cgate / 2.0 + cgdo : cgdo);
    const double cgb =
        cut ? cgate * TWO_THIRDS : (lin ? cgbo : cgbo + cgate * ONE_THIRD);
    const double qgs = cut ? 0.0 : cgs * vgs;
    const double qgd = cut ? 0.0 : cgd * (vgs - vds);
    const double qgb = cgb * (vgs - vbs);
    const double qbs = mos_qj(p, cbs, vbs);
    const double qbd = mos_qj(p, cbd, vbs - vds);
    if constexpr (PHYS) {
      // the committed charges; trapezoidal 2C/dt and 2dq/dt - ic after
      // the device's first committed step (assemble.py's physics block)
      const double* sm = ph.m + k;
      const bool on = ph.trap && sm[MS_HIST * nm] > 0;
      const double cs[7] = {cgd, cgs, cgb, cgd + cgs + cgb, cbs, cbd,
                            cbd + cbs};
      for (int r = 0; r < 7; ++r)
        mv[(9 + r) * nm + k] = (on ? 2.0 * cs[r] : cs[r]) / dte;
      const double qs[5] = {qgs, qgd, qgb, qbs, qbd};
      double ic[5];
      for (int r = 0; r < 5; ++r) {
        const double dq = (qs[r] - sm[(MS_QGS + r) * nm]) / dte;
        ic[r] = on ? 2.0 * dq - sm[(MS_ICGS + r) * nm] : dq;
      }
      mv[16 * nm + k] = ic[1];
      mv[17 * nm + k] = ic[0];
      mv[18 * nm + k] = ic[2];
      mv[19 * nm + k] = ic[3];
      mv[20 * nm + k] = ic[4];
    } else {
      mv[9 * nm + k] = cgd / dte;
      mv[10 * nm + k] = cgs / dte;
      mv[11 * nm + k] = cgb / dte;
      mv[12 * nm + k] = (cgd + cgs + cgb) / dte;
      mv[13 * nm + k] = cbs / dte;
      mv[14 * nm + k] = cbd / dte;
      mv[15 * nm + k] = (cbd + cbs) / dte;
      mv[16 * nm + k] = (qgd - p[M_QGD]) / dte;
      mv[17 * nm + k] = (qgs - p[M_QGS]) / dte;
      mv[18 * nm + k] = (qgb - p[M_QGB]) / dte;
      mv[19 * nm + k] = (qbs - p[M_QBS]) / dte;
      mv[20 * nm + k] = (qbd - p[M_QBD]) / dte;
    }
  }
}

// The evaluation of device j of the deck's order.
template <bool TRAN, bool PHYS = false>
__device__ __forceinline__ void device_value(const Deck& c, int j,
                                             const double* jv, double dte,
                                             double gmin, double* nv,
                                             const Phys& ph) {
  if (j < c.n_d)
    value_diode<TRAN, PHYS>(c, j, jv, dte, nv, ph);
  else if (j < c.n_d + c.n_q)
    value_bjt(c, j - c.n_d, jv, nv);
  else
    value_mos<TRAN, PHYS>(c, j - c.n_d - c.n_q, jv, dte, gmin, nv, ph);
}

// ------------------------------------------------- the segment Newton

// blocks an SM holds at once under the segment kernels' launch bounds: at
// most 128 registers a thread (8192 lanes of np1 <= 8 in one wave on 132
// SMs)
constexpr int SEG_BLOCKS = 4;

// np1's size bucket, the segment width W = NMAX of a lane's system (0 past
// the caps): np1 <= 4 on segments of 4, which halve the instructions a
// lane issues in the 8-row bucket (on an H100, ab_run_kernel.py: 3.0 ms
// against 3.7 for the 8192-lane rectifier's run, 1.2 against 1.4 for an
// 8192-lane RC low-pass)
__host__ __device__ constexpr int seg_bucket(int np1) {
  return np1 <= 4 ? 4 : np1 <= 8 ? 8 : np1 <= 16 ? 16 : np1 <= 32 ? 32 : 0;
}

// The Newton flavours of engine/newton.py: the OP (jv from x at every
// iteration, status gmin on the MOSFET and the non-ground diagonals) and
// the DC sweep (iteration 0 stamps the carried jv, a warm start,
// dc.go:155; status gmin 0, no gmin diagonal, and CheckConvergence: every
// |new - old| <= abstol or <= reltol*|new|, dc.go:142-187).
enum Flavour { FL_OP = 0, FL_DC };

// An OP or DC sweep stamp's value (ops/assemble.py mode "op"): the
// capacitor leaks gc, the inductor stamps its dt = 1e-9 companion, the
// sources their values of this solve, an LM its +1e-3 branch diagonal
// against the plan's sign -1 (magnetic.go:216-217); the OP plan has no
// K, no LM RHS and no TAG_CEQ.
struct OpStamp {
  const double* g;     // [nR] 1/R
  const double* lval;  // [nL] L
  const double* lrhs;  // [nL] the inductor companion RHS
  const double* vsrc;  // [nV]
  const double* isrc;  // [nI]
  double gc;
  __device__ __forceinline__ double operator()(int tag, int k) const {
    switch (tag) {
      case TAG_G: return g[k];
      case TAG_GEQ: return gc;
      case TAG_LTERM: return lval[k] / 1e-9;
      case TAG_LRHS: return lrhs[k];
      case TAG_VSRC: return vsrc[k];
      case TAG_ISRC: return isrc[k];
      case TAG_LMTERM: return -1e-3;
      default: return 1.0;  // TAG_ONE
    }
  }
};

// A launch on warp segments: segments of W = NMAX threads, THREADS / W
// lanes a block, the table and each segment's slice in dynamic shared
// memory (bytes).
struct SegShape {
  int w, per_block, blocks, threads, shmem;
};

// The shape of nlanes lanes whose segments each take `slice` doubles
template <int NMAX>
SegShape seg_shape_of(int nlanes, int topo_len, int slice) {
  constexpr int per_block = THREADS / NMAX;
  const int doubles = (topo_len + 3) / 4 * 2 + per_block * slice;
  return {NMAX, per_block, (nlanes + per_block - 1) / per_block, THREADS,
          doubles * static_cast<int>(sizeof(double))};
}

// Launch a segment kernel in shape sh on `stream` (past 48 KB of shared
// memory once the kernel's limit is raised); returns the launch's error.
template <class... P, class... A>
cudaError_t seg_launch(void (*kernel)(P...), const SegShape& sh,
                       cudaStream_t stream, A... args) {
  if (sh.shmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, sh.shmem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<sh.blocks, sh.threads, sh.shmem, stream>>>(args...);
  return cudaGetLastError();
}

// Doubles of one segment's slice of the OP and DC sweep kernels' shared
// memory: the elimination's exchange buffer and the W = NMAX build rows
// (stride NMAX + 2, so that every row starts 16-byte aligned), x, then
// lane_doubles of the lane's own (its inputs, junction voltages and value
// slots, sized from the deck's counts by the wrapper), an even count.
template <int NMAX>
__host__ __device__ constexpr int opdc_slice(int lane_doubles) {
  return (NMAX + 2) * (NMAX + 1) + NMAX + ((lane_doubles + 1) & ~1);
}

template <int NMAX>
SegShape opdc_shape(int nlanes, int topo_len, int lane_doubles) {
  return seg_shape_of<NMAX>(nlanes, topo_len,
                            opdc_slice<NMAX>(lane_doubles));
}

// The OP or DC sweep kernel's shape for np1; false past the caps
inline bool opdc_shape_np1(int np1, int nlanes, int topo_len,
                           int lane_doubles, SegShape* s) {
  switch (seg_bucket(np1)) {
    case 4: *s = opdc_shape<4>(nlanes, topo_len, lane_doubles); return true;
    case 8: *s = opdc_shape<8>(nlanes, topo_len, lane_doubles); return true;
    case 16: *s = opdc_shape<16>(nlanes, topo_len, lane_doubles); return true;
    case 32: *s = opdc_shape<32>(nlanes, topo_len, lane_doubles); return true;
    default: return false;
  }
}

// The build and elimination of one system on a segment of W = NMAX lanes:
// thread me sums the entries [e0, e1) of the table's row view (its row's,
// in plan order; a TAG_NL entry reads its value slot when NLV) into its
// row of the slice, adds diag to its diagonal past row 0 when DIAG (after
// the row's sum, as the plain build does), row 0 being the ground
// identity row; then gj_warp_reg eliminates from registers and writes x to
// xs.  Returns whether x is finite (the same on every lane of the
// segment; x all NaN when not).
template <int NMAX, bool NLV, bool DIAG, class Stamp>
__device__ __forceinline__ bool seg_solve(const int4* ent, int e0, int e1,
                                          const Stamp& stamp,
                                          const double* nv, double diag,
                                          int n, double* buf, double* row,
                                          int me, double* xs) {
  constexpr unsigned mask = 0xffffffffu;
  for (int c = 0; c <= n; ++c) row[c] = 0.0;
  if (me < n) {
    for (int e = e0; e < e1; ++e) {
      const int4 q = ent[e];  // col, tag, index, sign
      const double v = (NLV && q.y == TAG_NL) ? nv[q.z] : stamp(q.y, q.z);
      row[q.x] += (double)q.w * v;
    }
    if (DIAG && me > 0) row[me] = row[me] + diag;
  }
  if (me == 0) row[0] = 1.0;
  // slot c holds column c, the right-hand side slot NMAX
  double m[1][NMAX + 1];
#pragma unroll
  for (int c = 0; c < NMAX; ++c) m[0][c] = c < n ? row[c] : 0.0;
  m[0][NMAX] = row[n];
  return gj_warp_reg<NMAX, NMAX, 1>(m, n, buf, me, mask, xs);
}

// The Newton loop of one lane (engine/newton.py) in flavour FL on its
// segment of W = NMAX lanes, thread me owning row me: per iteration,
// device j on thread j (mod W) limits its junctions from the last iterate
// (the OP from iteration 0 on, the DC sweep from iteration 1 on) and
// evaluates its value slots into the slice (limit_device, device_value:
// each reads and writes only that device's rows); then seg_solve from
// the row view ent/roff with the status gmin on the diagonals of an OP;
// then the convergence test of row i on thread i (rows past n count as
// converged), ANDed over the segment with the solve's finite flag.
//
// xs holds x0 on entry and the last solution on exit, jv the carried
// junction voltages on entry and those of the last iteration on exit;
// go is whether the lane iterates at all.  Returns the iteration count;
// *conv is whether it converged.  The warp's segments run in lockstep
// under one full-warp mask: the warp iterates while any of its segments
// does, and a segment whose Newton has ended runs the later builds and
// eliminations with the others and keeps nothing of them (its junction
// voltages, value slots and counts do not move, and x is put back from
// the registers of each row's thread).  PHYS: the physics diode and limit.
template <int NMAX, int FL, bool PHYS, class Stamp>
__device__ int seg_newton(const Deck& c, const int4* ent, const int* roff,
                          const Stamp& stamp, double gmin, bool go,
                          int max_iter, double reltol, double abstol,
                          double* buf, double* row, double* xs, double* jv,
                          double* nv, int me, bool* conv) {
  constexpr bool OP = FL == FL_OP;
  constexpr int W = NMAX;
  constexpr unsigned mask = 0xffffffffu;
  const int n = c.n;
  const int ndev = c.n_d + c.n_q + c.n_m;
  const int e0 = me < n ? roff[me] : 0, e1 = me < n ? roff[me + 1] : 0;
  double xo = me < n ? xs[me] : 0.0;  // row me of the last iterate
  int it = 0;
  bool ok = false;
  bool iter = go && max_iter > 0;
  __syncwarp(mask);
  while (__any_sync(mask, iter)) {
    if (iter) {
      for (int j = me; j < ndev; j += W) {
        if (OP || it > 0) limit_device<PHYS>(c, j, xs, jv);
        device_value<false, PHYS>(c, j, jv, 0.0, OP ? gmin : 0.0, nv,
                                  Phys{});
      }
    }
    __syncwarp(mask);
    const bool finite = seg_solve<NMAX, true, OP>(ent, e0, e1, stamp, nv,
                                                  gmin, n, buf, row, me, xs);
    __syncwarp(mask);
    const double xn = xs[me];
    const double d = fabs(xn - xo);
    bool cv;
    if constexpr (OP)  // every |new - old| <= reltol*max(|new|, |old|) + abstol
      cv = me >= n || d <= reltol * max_nan(fabs(xn), fabs(xo)) + abstol;
    else  // every |new - old| <= abstol or <= reltol*|new|
      cv = me >= n || d <= abstol || d <= reltol * fabs(xn);
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1)
      cv = __shfl_xor_sync(mask, cv ? 1 : 0, off, W) && cv;
    if (iter) {
      xo = xn;
      ok = it > 0 && cv && finite;
      ++it;
      iter = !ok && it < max_iter;
    }
  }
  if (me < n) xs[me] = xo;  // what a segment that ran along kept
  __syncwarp(mask);
  *conv = ok;
  return it;
}

}  // namespace tsr
