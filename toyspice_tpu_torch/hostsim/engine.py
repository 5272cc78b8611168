"""Sequential NumPy oracle: an independent re-implementation of the reference
algorithm (edp1096/toy-spice) used to validate the vectorized engine.

A copy of the JAX package's ``hostsim/engine.py`` (it needs neither JAX nor
torch), pointed at the port's own compiler and native library, so that the
port runs without the JAX package.

Written in the reference's sequential object-by-object style — per-device
stamping into a 1-based dense matrix with explicit ground checks, a plain
Python Newton loop, plain Python adaptive timestepping — so that it shares no
code (and no vectorization decisions) with the batched engine.  The Go reference
itself cannot be built offline (its sparse dependency needs the network), so
this oracle carries the reference semantics, including the quirks catalogued
in PLAN.md, with the same two documented deviations as the engine (clamped
BJT exponential; non-finite solutions treated as non-convergence).

Solver: Gaussian elimination with partial pivoting (the engine uses the same
algorithm as batched torch operations; keeping the algorithm identical makes
waveforms comparable to ~1e-12 instead of diverging at adaptive-step
threshold decisions).
"""

import math

import numpy as np

from ..compiler import (
    CompiledCircuit,
    SRC_DC,
    SRC_SIN,
    SRC_PULSE,
    SRC_PWL,
)

BOLTZMANN = 1.3806226e-23
CHARGE = 1.6021918e-19
TEMP = 300.15
MU0 = 4 * math.pi * 1e-7

ABSTOL = 1e-12
RELTOL = 1e-6
MAX_ITER = 100
TRTOL = 7.0


_SOLVER = "numpy"


def set_solver(name: str):
    """Pick the host solver: 'numpy' (dense partial-pivot GE) or 'native'
    (the C++ sparse LU, native/sparse_lu.cc — the Berkeley-Sparse-lineage
    counterpart of the reference's solver, pkg/matrix/circuit.go)."""
    global _SOLVER
    if name not in ("numpy", "native"):
        raise ValueError(f"unknown host solver {name!r}")
    if name == "native":
        from .. import native

        if not native.available():
            raise RuntimeError("native C++ solver unavailable (g++/make)")
    _SOLVER = name


def _native_solve(a, b):
    from .. import native

    n = a.shape[0]
    s = native.SparseSolver(n)
    s.add_matrix(np.asarray(a, dtype=np.float64))
    if not s.factor():
        return np.full(n, np.inf)  # singular: same non-finite signal as GE
    return s.solve(np.asarray(b, dtype=np.float64))


def solve(a, b):
    if _SOLVER == "native":
        return _native_solve(a, b)
    return ge_solve(a, b)


def ge_solve(a, b):
    """Partial-pivot Gaussian elimination, same algorithm as ops/solve.py."""
    n = a.shape[0]
    m = np.concatenate([a.astype(np.float64), b.reshape(-1, 1)], axis=1)
    for k in range(n):
        col = np.abs(m[:, k]).copy()
        col[:k] = -1.0
        p = int(np.argmax(col))
        if p != k:
            m[[k, p]] = m[[p, k]]
        piv = m[k, k]
        piv_safe = piv if piv != 0 else 1.0
        factors = m[:, k] / piv_safe
        factors[: k + 1] = 0.0
        m -= factors[:, None] * m[k][None, :]
    x = np.zeros(n)
    for k in range(n - 1, -1, -1):
        s = float(m[k, k + 1 : n] @ x[k + 1 : n])
        piv = m[k, k]
        if piv == 0:
            x[k] = np.inf
        else:
            x[k] = (m[k, n] - s) / piv
    return x


def vt_of(temp):
    if temp <= 0:
        temp = TEMP
    return BOLTZMANN * temp / CHARGE


def pnjlim(vnew, vold, vte, vcrit):
    """SPICE3F5 junction limiter — same deviation as the engine
    (models/limiter.py): the reference stubbed its limiter out and its
    unclamped BJT exp diverges on bjt1.cir."""
    if vnew > vcrit and abs(vnew - vold) > 2.0 * vte:
        if vold > 0:
            arg = 1.0 + (vnew - vold) / vte
            return vold + vte * math.log(arg) if arg > 0 else vcrit
        return vte * math.log(vnew / vte)
    return vnew


class Dev:
    nonlinear = False
    time_dependent = False  # only C and L in the reference (PLAN.md 1)

    def stamp(self, A, b, st):
        raise NotImplementedError

    def stamp_ac(self, G, B, br, bi, st):
        pass

    def load_state(self, x, st):
        pass

    def update_state(self, x, st):
        pass

    def lte(self, st):
        return 0.0


class Status:
    def __init__(self, **kw):
        self.time = kw.get("time", 0.0)
        self.dt = kw.get("dt", 0.0)
        self.gmin = kw.get("gmin", 0.0)
        self.mode = kw.get("mode", "op")
        self.freq = kw.get("freq", 0.0)
        self.temp = kw.get("temp", TEMP)


class Resistor(Dev):
    def __init__(self, name, n1, n2, value, tc1=0.0, tc2=0.0):
        self.name, self.n1, self.n2, self.value = name, n1, n2, value
        self.tc1, self.tc2 = tc1, tc2

    def stamp(self, A, b, st):
        # quadratic temperature adjustment (resistor.go:77-81), Tnom 300.15 K
        dt_ = st.temp - TEMP
        g = 1.0 / (self.value * (1.0 + self.tc1 * dt_ + self.tc2 * dt_ * dt_))
        n1, n2 = self.n1, self.n2
        if n1:
            A[n1, n1] += g
            if n2:
                A[n1, n2] -= g
        if n2:
            if n1:
                A[n2, n1] -= g
            A[n2, n2] += g

    def stamp_ac(self, G, B, br, bi, st):
        self.stamp(G, br, st)


class Capacitor(Dev):
    time_dependent = True

    def __init__(self, name, n1, n2, value, tc1=0.0, tc2=0.0):
        self.name, self.n1, self.n2, self.value = name, n1, n2, value
        self.tc1, self.tc2 = tc1, tc2
        self.v0 = self.v1 = self.q0 = self.q1 = 0.0

    def _adjusted(self, temp):
        # capacitor.go:180-184; UpdateState/LTE use the raw value like the
        # reference (capacitor.go:155-178)
        dt_ = temp - TEMP
        return self.value * (1.0 + self.tc1 * dt_ + self.tc2 * dt_ * dt_)

    def stamp(self, A, b, st):
        n1, n2 = self.n1, self.n2
        if st.mode == "tran":
            geq = self._adjusted(st.temp) / st.dt
            ceq = self.q1 / st.dt
            if n1:
                A[n1, n1] += geq
                if n2:
                    A[n1, n2] -= geq
                b[n1] += ceq
            if n2:
                A[n2, n2] += geq
                if n1:
                    A[n2, n1] -= geq
                b[n2] -= ceq
        else:
            gmin = max(st.gmin, 1e-12)
            if n1:
                A[n1, n1] += gmin
                if n2:
                    A[n1, n2] -= gmin
            if n2:
                A[n2, n2] += gmin
                if n1:
                    A[n2, n1] -= gmin

    def stamp_ac(self, G, B, br, bi, st):
        w = 2 * math.pi * st.freq
        wc = w * self._adjusted(st.temp)
        n1, n2 = self.n1, self.n2
        if n1:
            B[n1, n1] += wc
            if n2:
                B[n1, n2] -= wc
        if n2:
            B[n2, n2] += wc
            if n1:
                B[n2, n1] -= wc

    def update_state(self, x, st):
        vd = (x[self.n1] if self.n1 else 0.0) - (x[self.n2] if self.n2 else 0.0)
        self.q1 = self.q0
        self.q0 = self.value * vd
        self.v1 = self.v0
        self.v0 = vd

    def lte(self, st):
        return abs(self.value * self.v0 - self.value * self.v1) / (2.0 * st.dt)


class Inductor(Dev):
    time_dependent = True

    def __init__(self, name, n1, n2, value, branch):
        self.name, self.n1, self.n2 = name, n1, n2
        self.value, self.branch = value, branch
        self.i0 = self.i1 = self.v0 = self.v1 = 0.0

    def stamp(self, A, b, st):
        n1, n2, bi = self.n1, self.n2, self.branch
        if n1:
            A[n1, bi] += -1
            A[bi, n1] += -1
        if n2:
            A[n2, bi] += 1
            A[bi, n2] += 1
        dt = st.dt if st.dt > 0 else 1e-9
        A[bi, bi] += -self.value / dt
        b[bi] += self.value / dt * self.i1

    def stamp_ac(self, G, B, br, bi_v, st):
        # engine's corrected branch-row AC stamp (deviation, PLAN.md 13)
        w = 2 * math.pi * st.freq
        n1, n2, bi = self.n1, self.n2, self.branch
        if n1:
            G[n1, bi] += -1
            G[bi, n1] += -1
        if n2:
            G[n2, bi] += 1
            G[bi, n2] += 1
        B[bi, bi] += -w * self.value

    def load_state(self, x, st):
        vd = (x[self.n1] if self.n1 else 0.0) - (x[self.n2] if self.n2 else 0.0)
        self._i_load = self.i1 + vd * st.dt / self.value

    def update_state(self, x, st):
        vd = (x[self.n1] if self.n1 else 0.0) - (x[self.n2] if self.n2 else 0.0)
        self.v1 = self.v0
        self.v0 = vd
        self.i1 = self._i_load
        self.i0 = self.v0 * 1e-9 / self.value  # the junk current (inductor.go:112-113)

    def lte(self, st):
        c = abs(self.i0 - self.i1) / (2.0 * st.dt)
        v = abs(self.v0 - self.v1) / (2.0 * st.dt)
        return max(c, v)

    def get_value(self, temp):
        return self.value

    def get_current(self):
        return self.i0


class MagneticInductor(Dev):
    # NOT time_dependent (PLAN.md 1): state frozen in compat
    def __init__(self, name, n1, n2, branch, turns, core):
        self.name, self.n1, self.n2, self.branch = name, n1, n2, branch
        self.turns = turns
        self.core = dict(core)  # ms alpha a c k area len tc beta
        self.i0 = self.i1 = 0.0
        self.H = self.Hold = self.M = self.Mirr = self.dMdH = 0.0

    def _ja(self, h, temp):
        dH = h - self.Hold
        if abs(dH) < 1e-12:
            return self.M, self.dMdH
        delta = -1.0 if dH < 0 else 1.0
        mst = self.core["ms"]
        if self.core["tc"] > 0:
            mst *= ((self.core["tc"] - temp) / self.core["tc"]) ** self.core["beta"]
        he = h + self.core["alpha"] * self.M
        if abs(he) < 1e-6:
            man = mst * he / (3.0 * self.core["a"])
        else:
            man = mst * (1.0 / math.tanh(he / self.core["a"]) - self.core["a"] / he)
        denom = self.core["k"] * delta - self.core["alpha"] * (man - self.Mirr)
        if abs(denom) < 1e-12:
            denom = math.copysign(1e-12, denom)
        dmirr = (man - self.Mirr) / denom
        self.Mirr += dmirr * dH
        mold = self.M
        self.M = self.Mirr + self.core["c"] * (man - self.Mirr)
        self.dMdH = (self.M - mold) / dH
        self.H = h
        self.Hold = h
        return self.M, self.dMdH

    def stamp(self, A, b, st):
        n1, n2, bi = self.n1, self.n2, self.branch
        if st.mode == "op":
            if n1:
                A[n1, bi] += -1
                A[bi, n1] += -1
            if n2:
                A[n2, bi] += 1
                A[bi, n2] += 1
            A[bi, bi] += 1e-3
            self.i0 = self.i1 = 0.0
            return
        # transient
        if n1:
            A[n1, bi] += -1
            A[bi, n1] += -1
        if n2:
            A[n2, bi] += 1
            A[bi, n2] += 1
        dt = st.dt if st.dt > 0 else 1e-9
        if st.time < dt or abs(self.i0) < 1e-9:
            L0 = MU0 * self.turns * self.turns * self.core["area"] / self.core["len"]
            A[bi, bi] += -L0 / dt
            b[bi] += L0 / dt * self.i1
            return
        h = self.turns * self.i0 / self.core["len"]
        h = max(-1e6, min(1e6, h))
        _, dmdh = self._ja(h, st.temp)
        dmdh = max(-1e3, min(1e3, dmdh))
        leff = max(1e-12, MU0 * (1 + dmdh) * self.turns ** 2
                   * self.core["area"] / self.core["len"])
        A[bi, bi] += -leff / dt
        b[bi] += leff / dt * self.i1

    def stamp_ac(self, G, B, br, bi_v, st):
        w = 2 * math.pi * st.freq
        n1, n2, bi = self.n1, self.n2, self.branch
        if n1:
            G[n1, bi] += -1
            G[bi, n1] += -1
        if n2:
            G[n2, bi] += 1
            G[bi, n2] += 1
        B[bi, bi] += -w * self.get_value(st.temp)

    def get_value(self, temp):
        h = self.turns * self.i0 / self.core["len"]
        _, dmdh = self._ja(h, temp)
        return MU0 * self.turns ** 2 * self.core["area"] * (1 + dmdh) / self.core["len"]

    def get_current(self):
        return self.i0


class VSource(Dev):
    def __init__(self, name, n1, n2, branch, spec):
        self.name, self.n1, self.n2, self.branch = name, n1, n2, branch
        self.s = spec
        self.scale = 1.0

    def value_at(self, t):
        s = self.s
        dc = s.dc * self.scale
        if s.stype == SRC_DC:
            return dc
        if s.stype == SRC_SIN:
            return dc + s.amplitude * math.sin(
                2 * math.pi * s.freq * t + s.phase * math.pi / 180.0
            )
        if s.stype == SRC_PULSE:
            return self._pulse(t)
        return self._pwl(t)

    def _pulse(self, t):
        s = self.s
        if t < s.delay:
            return s.v1
        t = t - s.delay
        if s.period > 0:
            t = math.fmod(t, s.period)
        if t < s.rise:
            if s.rise == 0:
                return s.v2
            return s.v1 + (s.v2 - s.v1) * t / s.rise
        if t < s.rise + s.width:
            return s.v2
        fs = s.rise + s.width
        if t < fs + s.fall:
            if s.fall == 0:
                return s.v1
            return s.v2 - (s.v2 - s.v1) * (t - fs) / s.fall
        return s.v1

    def _pwl(self, t):
        s = self.s
        ts, vs = s.pwl_t, s.pwl_v
        if t <= ts[0]:
            return vs[0]
        if t >= ts[-1]:
            return vs[-1]
        for i in range(1, len(ts)):
            if t <= ts[i]:
                slope = (vs[i] - vs[i - 1]) / (ts[i] - ts[i - 1])
                return vs[i - 1] + slope * (t - ts[i - 1])
        return vs[-1]

    def stamp(self, A, b, st):
        n1, n2, bi = self.n1, self.n2, self.branch
        if n1:
            A[bi, n1] += 1
            A[n1, bi] += 1
        if n2:
            A[bi, n2] += -1
            A[n2, bi] += -1
        b[bi] += self.value_at(st.time)

    def stamp_ac(self, G, B, br, bi_v, st):
        n1, n2, bi = self.n1, self.n2, self.branch
        if n1:
            G[bi, n1] += 1
            G[n1, bi] += 1
        if n2:
            G[bi, n2] += -1
            G[n2, bi] += -1
        ph = self.s.ac_phase * math.pi / 180.0
        br[bi] += self.s.ac_mag * math.cos(ph)
        bi_v[bi] += self.s.ac_mag * math.sin(ph)


class ISource(Dev):
    def __init__(self, name, n1, n2, spec):
        self.name, self.n1, self.n2 = name, n1, n2
        self.s = spec
        self._v = VSource(name, n1, n2, 0, spec)  # reuse waveform eval

    def stamp(self, A, b, st):
        cur = self._v.value_at(st.time)
        if self.n1:
            b[self.n1] += cur
        if self.n2:
            b[self.n2] -= cur

    def stamp_ac(self, G, B, br, bi_v, st):
        ph = self.s.ac_phase * math.pi / 180.0
        re = self.s.ac_mag * math.cos(ph)
        im = self.s.ac_mag * math.sin(ph)
        if self.n1:
            br[self.n1] += re
            bi_v[self.n1] += im
        if self.n2:
            br[self.n2] -= re
            bi_v[self.n2] -= im


class Diode(Dev):
    nonlinear = True

    def __init__(self, name, n1, n2, p):
        self.name, self.n1, self.n2 = name, n1, n2
        self.p = p
        self.vd = 0.0
        self.prev_charge = 0.0  # frozen at 0 in compat

    def update_voltages(self, x):
        raw = (x[self.n1] if self.n1 else 0.0) - (x[self.n2] if self.n2 else 0.0)
        vte = self.p["n"] * vt_of(TEMP)
        vcrit = vte * math.log(vte / (math.sqrt(2.0) * self.p["is_"]))
        self.vd = pnjlim(raw, self.vd, vte, vcrit)

    def _eval(self, temp):
        p = self.p
        vt = vt_of(temp)
        nvt = p["n"] * vt
        ratio = temp / TEMP
        egfact = -p["eg"] / (2 * vt) * (temp / TEMP - 1.0)
        is_t = p["is_"] * ratio ** (p["xti"] / p["n"]) * math.exp(egfact)
        if self.vd > -3 * nvt:
            arg = min(self.vd / nvt, 40.0)
            id_ = is_t * (math.exp(arg) - 1.0)
            gd = (abs(id_) + is_t) / nvt + p["gmin"]
        else:
            id_ = -is_t
            gd = p["gmin"]
        return id_, gd

    def stamp(self, A, b, st):
        id_, gd = self._eval(st.temp)
        if st.mode == "tran" and st.dt > 0:
            charge = self.p["tt"] * id_
            cap_cur = (charge - self.prev_charge) / st.dt
            gd = gd + self.p["tt"] * gd / st.dt
            id_ = id_ + cap_cur
        n1, n2 = self.n1, self.n2
        rhs = id_ - gd * self.vd
        if n1:
            A[n1, n1] += gd
            if n2:
                A[n1, n2] -= gd
            b[n1] -= rhs
        if n2:
            if n1:
                A[n2, n1] -= gd
            A[n2, n2] += gd
            b[n2] += rhs

    def stamp_ac(self, G, B, br, bi_v, st):
        p = self.p
        _, gd = self._eval(st.temp)
        w = 2 * math.pi * st.freq
        vd = self.vd
        if p["cj0"] == 0:
            cj = 0.0
        elif vd < 0:
            arg = max(1 - vd / p["vj"], 0.1)
            cj = p["cj0"] / arg ** p["m"]
        else:
            cj = p["cj0"] * (1 + p["m"] * vd / p["vj"])
        n1, n2 = self.n1, self.n2
        if n1:
            G[n1, n1] += gd
            B[n1, n1] += w * cj
            if n2:
                G[n1, n2] -= gd
                B[n1, n2] -= w * cj
        if n2:
            if n1:
                G[n2, n1] -= gd
                B[n2, n1] -= w * cj
            G[n2, n2] += gd
            B[n2, n2] += w * cj


class BJT(Dev):
    nonlinear = True

    def __init__(self, name, nc, nb, ne, p):
        self.name, self.nc, self.nb, self.ne = name, nc, nb, ne
        self.p = p
        self.vbe = self.vbc = self.vce = 0.0

    def update_voltages(self, x):
        vc = x[self.nc] if self.nc else 0.0
        vb = x[self.nb] if self.nb else 0.0
        ve = x[self.ne] if self.ne else 0.0
        if self.p["sign"] < 0:
            vbe, vbc = ve - vb, vc - vb
        else:
            vbe, vbc = vb - ve, vb - vc
        vt = vt_of(TEMP)
        vte_f = self.p["nf"] * vt
        vte_r = self.p["nr"] * vt
        vcrit_f = vte_f * math.log(vte_f / (math.sqrt(2.0) * self.p["ies"]))
        vcrit_r = vte_r * math.log(vte_r / (math.sqrt(2.0) * self.p["ics"]))
        self.vbe = pnjlim(vbe, self.vbe, vte_f, vcrit_f)
        self.vbc = pnjlim(vbc, self.vbc, vte_r, vcrit_r)
        self.vce = self.vbe - self.vbc

    def _jacobian(self, temp):
        """Consistent analytic Jacobian — the identical derivative chain
        (same operation order, so bit-comparable in f64) as the engine
        (models/bjt.py jacobian)."""
        p = self.p
        vt = vt_of(temp)
        if self.vbe == 0 and self.vce == 0:
            self.vbe = p["nf"] * vt * math.log(1e-3 / p["ies"])
            self.vce = max(2.0, self.vbe + 1.0)
            self.vbc = self.vbe - self.vce
        vbe, vbc = self.vbe, self.vbc
        sign = p["sign"]
        invnfvt = 1.0 / (p["nf"] * vt)
        invnrvt = 1.0 / (p["nr"] * vt)
        a1 = vbe * invnfvt
        a2 = vbc * invnrvt
        e1 = math.exp(min(a1, 40.0))
        e2 = math.exp(min(a2, 40.0))
        invvaf = 1.0 / p["vaf"] if p["vaf"] > 0 else 0.0
        invvar = 1.0 / p["var"] if p["var"] > 0 else 0.0
        invikf = 1.0 / p["ikf"] if p["ikf"] > 0 else 0.0
        invikr = 1.0 / p["ikr"] if p["ikr"] > 0 else 0.0
        f0 = sign * p["ies"] * (e1 - 1.0)
        r0 = sign * p["ics"] * (e2 - 1.0)
        df0 = sign * p["ies"] * e1 * invnfvt if a1 <= 40.0 else 0.0
        dr0 = sign * p["ics"] * e2 * invnrvt if a2 <= 40.0 else 0.0
        u = 1.0 - vbc * invvaf
        wv = 1.0 + vbe * invvar
        f1 = f0 * u
        r1 = r0 * wv
        df1_be = df0 * u
        df1_bc = -f0 * invvaf
        dr1_be = r0 * invvar
        dr1_bc = dr0 * wv
        sf = 1.0 if f1 > 0.0 else (-1.0 if f1 < 0.0 else 0.0)
        sr = 1.0 if r1 > 0.0 else (-1.0 if r1 < 0.0 else 0.0)
        den_f = 1.0 + abs(f1) * invikf * u
        den_r = 1.0 + abs(r1) * invikr * u
        f2 = f1 / den_f
        r2 = r1 / den_r
        ddenf_be = sf * df1_be * invikf * u
        ddenf_bc = sf * df1_bc * invikf * u - abs(f1) * invikf * invvaf
        ddenr_be = sr * dr1_be * invikr * u
        ddenr_bc = sr * dr1_bc * invikr * u - abs(r1) * invikr * invvaf
        df2_be = (df1_be - f2 * ddenf_be) / den_f
        df2_bc = (df1_bc - f2 * ddenf_bc) / den_f
        dr2_be = (dr1_be - r2 * ddenr_be) / den_r
        dr2_bc = (dr1_bc - r2 * ddenr_bc) / den_r
        af = p["alphaf"]
        ic0 = sign * (af * f2 - r2) * u
        ie0 = sign * (f2 - r2)
        ib0 = ie0 - ic0
        g11 = sign * (af * df2_be - dr2_be) * u
        g12 = sign * ((af * df2_bc - dr2_bc) * u - (af * f2 - r2) * invvaf)
        g21 = sign * (df2_be - dr2_be) - g11
        g22 = sign * (df2_bc - dr2_bc) - g12
        return ic0, ib0, g11, g12, g21, g22

    def _caps(self, gm, temp):
        p = self.p
        if self.vbe < p["vje"]:
            cbe = p["cje"] / (1 - self.vbe / p["vje"]) ** p["mje"]
        else:
            cbe = p["cje"] * (1 + p["mje"] * (self.vbe - p["vje"]) / p["vje"])
        cbe += p["tf"] * abs(gm)
        if self.vbc < p["vjc"]:
            cbc = p["cjc"] / (1 - self.vbc / p["vjc"]) ** p["mjc"]
        else:
            cbc = p["cjc"] * (1 + p["mjc"] * (self.vbc - p["vjc"]) / p["vjc"])
        return cbe, cbc

    def stamp(self, A, b, st):
        ic0, ib0, g11, g12, g21, g22 = self._jacobian(st.temp)
        sb = self.p["sign"]
        nc, nb, ne = self.nc, self.nb, self.ne
        vbe, vbc = self.vbe, self.vbc
        A[nc, nb] += (g11 + g12) * sb
        A[nc, ne] += -g11 * sb
        A[nc, nc] += -g12 * sb
        A[nb, nb] += (g21 + g22) * sb
        A[nb, ne] += -g21 * sb
        A[nb, nc] += -g22 * sb
        A[ne, nb] += -(g11 + g12 + g21 + g22) * sb
        A[ne, ne] += (g11 + g21) * sb
        A[ne, nc] += (g12 + g22) * sb
        b[nc] += -ic0 + g11 * vbe + g12 * vbc
        b[nb] += -ib0 + g21 * vbe + g22 * vbc
        b[ne] += (ic0 + ib0) - (g11 + g21) * vbe - (g12 + g22) * vbc
        # row/col 0 contributions are inert (ground row overwritten), same
        # as the engine

    def stamp_ac(self, G, B, br, bi_v, st):
        ic0, ib0, g11, g12, g21, g22 = self._jacobian(st.temp)
        cbe, cbc = self._caps(g11, st.temp)
        w = 2 * math.pi * st.freq
        sb = self.p["sign"]
        nc, nb, ne = self.nc, self.nb, self.ne
        G[nc, nb] += (g11 + g12) * sb
        G[nc, ne] += -g11 * sb
        G[nc, nc] += -g12 * sb
        G[nb, nb] += (g21 + g22) * sb
        G[nb, ne] += -g21 * sb
        G[nb, nc] += -g22 * sb
        G[ne, nb] += -(g11 + g12 + g21 + g22) * sb
        G[ne, ne] += (g11 + g21) * sb
        G[ne, nc] += (g12 + g22) * sb
        wbe, wbc = w * cbe, w * cbc
        B[nb, nb] += wbe + wbc
        B[nb, ne] += -wbe
        B[ne, nb] += -wbe
        B[ne, ne] += wbe
        B[nb, nc] += -wbc
        B[nc, nb] += -wbc
        B[nc, nc] += wbc


class Mosfet(Dev):
    nonlinear = True
    GMIN = 1e-12
    DELTA = 1e-6

    def __init__(self, name, nd, ng, ns, nb, p, level):
        self.name = name
        self.nd, self.ng, self.ns, self.nb = nd, ng, ns, nb
        self.p = p
        self.level = level
        self.vgs = self.vds = self.vbs = 0.0
        # prevQ* frozen at 0 in compat
        self.pq = (0.0, 0.0, 0.0, 0.0, 0.0)

    def update_voltages(self, x):
        vd = x[self.nd] if self.nd else 0.0
        vg = x[self.ng] if self.ng else 0.0
        vs = x[self.ns] if self.ns else 0.0
        vb = x[self.nb] if self.nb else 0.0
        s = self.p["sign"]
        self.vgs = s * (vg - vs)
        self.vds = s * (vd - vs)
        self.vbs = s * (vb - vs)

    def _vth(self, vbs):
        p = self.p
        if p["gamma"] > 0:
            return p["vto"] + p["gamma"] * (
                math.sqrt(max(0.0, p["phi"] - vbs)) - math.sqrt(p["phi"])
            )
        return p["vto"]

    def _ids(self, vgs, vds, vbs):
        """type-positive frame drain current, (id, region)"""
        p = self.p
        vth = self._vth(vbs)
        vgst = vgs - vth
        if vgst <= 0:
            return 0.0, 0
        if self.level == 2:
            eps0 = 8.85e-14
            cox = 3.9 * eps0 / p["tox"]
            eeff = vgst / (p["tox"] * 100.0)
            ueff = p["uo"]
            if p["ucrit"] > 0 and eeff > 0:
                ueff /= 1.0 + (eeff / p["ucrit"]) ** p["uexp"]
            vdsat = vgst
            if p["vmax"] > 0:
                ecrit = p["vmax"] / ueff * 100.0
                vdsat = min(vgst, ecrit * p["l"])
            beta = ueff * cox * p["w"] / (p["l"] * 100.0)
            if vds < vdsat:
                return beta * (vgst * vds - 0.5 * vds * vds) * (1 + p["lam"] * vds), 1
            return 0.5 * beta * vdsat * vdsat * (1 + p["lam"] * vds), 2
        if self.level == 3:
            vgst_eff = vgst / (1 + p["theta"] * vgst) if p["theta"] > 0 else vgst
            vdsat = (
                vgst_eff / math.sqrt(1 + p["kappa"] * vgst_eff)
                if p["kappa"] > 0
                else vgst_eff
            )
            beta = p["kp"] * p["w"] / p["l"]
            if p["delta"] > 0:
                beta /= 1 + p["delta"] / p["w"]
            if vds < vdsat:
                return (
                    beta
                    * (vgst_eff * vds - 0.5 * vds * vds / (1 + p["kappa"] * vgst_eff))
                    * (1 + p["lam"] * vds)
                ), 1
            return 0.5 * beta * vdsat * vdsat * (1 + p["lam"] * vds), 2
        # level 1
        beta = p["kp"] * p["w"] / p["l"]
        if vds < vgst:
            return beta * (vgst * vds - 0.5 * vds * vds) * (1 + p["lam"] * vds), 1
        return 0.5 * beta * vgst * vgst * (1 + p["lam"] * vds), 2

    def _eval(self):
        p = self.p
        sign = p["sign"]
        if self.vgs == 0 and self.vds == 0 and self.vbs == 0:
            self.vgs, self.vds, self.vbs = 0.7, 0.1, 0.0
        id_pos, region = self._ids(self.vgs, self.vds, self.vbs)
        id_ = sign * id_pos

        gmin = self.GMIN
        if region == 0:
            gm = gds = gmbs = gmin
        elif self.level in (2, 3):
            d = self.DELTA * sign
            idg, _ = self._ids(self.vgs + d, self.vds, self.vbs)
            idd, _ = self._ids(self.vgs, self.vds + d, self.vbs)
            idb, _ = self._ids(self.vgs, self.vds, self.vbs + d)
            gm = max((sign * idg - id_) / self.DELTA, gmin)
            gds = max((sign * idd - id_) / self.DELTA, gmin)
            gmbs = max((sign * idb - id_) / self.DELTA, gmin)
        else:
            vth = self._vth(self.vbs)
            vgst = self.vgs - vth
            beta = p["kp"] * p["w"] / p["l"]
            vds = self.vds
            if region == 1:
                gm = beta * vds * (1 + p["lam"] * vds)
                gds = beta * (vgst - vds) * (1 + p["lam"] * vds) + beta * p["lam"] * (
                    vgst * vds - 0.5 * vds * vds
                )
            else:
                gm = beta * vgst * (1 + p["lam"] * vds)
                gds = 0.5 * beta * vgst * vgst * p["lam"]
            if p["gamma"] > 0 and p["phi"] > 0 and self.vbs < 0:
                gmbs = gm * p["gamma"] / (2 * math.sqrt(p["phi"] - self.vbs))
            else:
                gmbs = gmin
        gm *= sign
        gmbs *= sign

        # Meyer caps
        cox = 3.9 * 8.85e-14 / p["tox"]
        cgate = cox * p["w"] * p["l"]
        cgso = p["cgso"] * p["w"]
        cgdo = p["cgdo"] * p["w"]
        cgbo = p["cgbo"] * p["l"]
        cbs = p["cbs"]
        if cbs == 0 and p["cj"] > 0:
            cbs = p["cj"] * p["as"] + p["cjsw"] * p["ps"]
        cbd = p["cbd"]
        if cbd == 0 and p["cj"] > 0:
            cbd = p["cj"] * p["ad"] + p["cjsw"] * p["pd"]
        if region == 0:
            cgb, cgs, cgd = 2 * cgate / 3, cgso, cgdo
        elif region == 1:
            cgs, cgd, cgb = cgate / 2 + cgso, cgate / 2 + cgdo, cgbo
        else:
            cgs, cgd, cgb = 2 * cgate / 3 + cgso, cgdo, cgbo + cgate / 3
        return id_, region, gm, gds, gmbs, cgs, cgd, cgb, cbs, cbd

    def _charges(self, ev):
        id_, region, gm, gds, gmbs, cgs, cgd, cgb, cbs, cbd = ev
        p = self.p
        vgd = self.vgs - self.vds
        vbd = self.vbs - self.vds
        if region == 0:
            qgs, qgd = 0.0, 0.0
        else:
            qgs, qgd = cgs * self.vgs, cgd * vgd
        qgb = cgb * (self.vgs - self.vbs)
        if self.vbs < 0:
            cbs_v = cbs / (1 - self.vbs / p["pb"]) ** p["mj"]
        else:
            cbs_v = cbs * (1 + p["mj"] * self.vbs / p["pb"])
        if vbd < 0:
            cbd_v = cbd / (1 - vbd / p["pb"]) ** p["mj"]
        else:
            cbd_v = cbd * (1 + p["mj"] * vbd / p["pb"])
        return qgs, qgd, qgb, cbs_v * self.vbs, cbd_v * vbd

    def stamp(self, A, b, st):
        ev = self._eval()
        id_, region, gm, gds, gmbs, cgs, cgd, cgb, cbs, cbd = ev
        nd, ng, ns, nb = self.nd, self.ng, self.ns, self.nb
        gmin = st.gmin
        vgs, vds, vbs = self.vgs, self.vds, self.vbs
        if nd:
            A[nd, nd] += gds + gmin
            if ng:
                A[nd, ng] += gm
            if ns:
                A[nd, ns] += -gds - gm - gmbs
            if nb:
                A[nd, nb] += gmbs
            b[nd] += -id_ + gds * vds + gm * vgs + gmbs * vbs
        if ns:
            A[ns, ns] += gds + gm + gmbs + gmin
            if nd:
                A[ns, nd] += -gds
            if ng:
                A[ns, ng] += -gm
            if nb:
                A[ns, nb] += -gmbs
            b[ns] += id_ - gds * vds - gm * vgs - gmbs * vbs
        if st.mode == "tran" and st.dt > 0:
            dt = st.dt
            qgs, qgd, qgb, qbs, qbd = self._charges(ev)
            pq = self.pq
            icgs = (qgs - pq[0]) / dt
            icgd = (qgd - pq[1]) / dt
            icgb = (qgb - pq[2]) / dt
            icbs = (qbs - pq[3]) / dt
            icbd = (qbd - pq[4]) / dt
            if ng:
                if nd:
                    A[ng, nd] += cgd / dt
                    A[nd, ng] += cgd / dt
                    b[ng] += icgd
                    b[nd] -= icgd
                if ns:
                    A[ng, ns] += cgs / dt
                    A[ns, ng] += cgs / dt
                    b[ng] += icgs
                    b[ns] -= icgs
                if nb:
                    A[ng, nb] += cgb / dt
                    A[nb, ng] += cgb / dt
                    b[ng] += icgb
                    b[nb] -= icgb
                A[ng, ng] += (cgd + cgs + cgb) / dt
            if nb:
                if ns:
                    A[nb, ns] += cbs / dt
                    A[ns, nb] += cbs / dt
                    b[nb] += icbs
                    b[ns] -= icbs
                if nd:
                    A[nb, nd] += cbd / dt
                    A[nd, nb] += cbd / dt
                    b[nb] += icbd
                    b[nd] -= icbd
                A[nb, nb] += (cbd + cbs) / dt

    def stamp_ac(self, G, B, br, bi_v, st):
        ev = self._eval()
        id_, region, gm, gds, gmbs, cgs, cgd, cgb, cbs, cbd = ev
        w = 2 * math.pi * st.freq
        cgsi, cgdi, cgbi = w * cgs, w * cgd, w * cgb
        cbsi, cbdi = w * cbs, w * cbd
        nd, ng, ns, nb = self.nd, self.ng, self.ns, self.nb
        if nd:
            G[nd, nd] += gds
            if ng:
                G[nd, ng] += gm
                B[nd, ng] += cgdi
            if ns:
                G[nd, ns] += -gds - gm - gmbs
            if nb:
                G[nd, nb] += gmbs
                B[nd, nb] += cbdi
        if ns:
            G[ns, ns] += gds + gm + gmbs
            if nd:
                G[ns, nd] += -gds
            if ng:
                G[ns, ng] += -gm
                B[ns, ng] += cgsi
            if nb:
                G[ns, nb] += -gmbs
                B[ns, nb] += cbsi
        if ng:
            B[ng, ng] += cgsi + cgdi + cgbi
            if nd:
                B[ng, nd] += cgdi
            if ns:
                B[ng, ns] += cgsi
            if nb:
                B[ng, nb] += cgbi
        if nb:
            B[nb, nb] += cbsi + cbdi + cgbi
            if nd:
                B[nb, nd] += cbdi
            if ns:
                B[nb, ns] += cbsi
            if ng:
                B[nb, ng] += cgbi


class Mutual(Dev):
    def __init__(self, name, inductors, coeff):
        self.name = name
        self.inductors = inductors
        self.coeff = coeff

    def stamp(self, A, b, st):
        if st.mode != "tran" or st.dt <= 0:
            return
        dt = st.dt
        info = [
            (ind.branch, ind.get_value(st.temp), ind.get_current())
            for ind in self.inductors
        ]
        n = len(info)
        for i in range(n):
            for j in range(i + 1, n):
                mij = self.coeff * math.sqrt(info[i][1] * info[j][1])
                A[info[i][0], info[j][0]] += -mij / dt
                A[info[j][0], info[i][0]] += -mij / dt
                b[info[i][0]] += -mij * info[j][2] / dt
                b[info[j][0]] += -mij * info[i][2] / dt

    def stamp_ac(self, G, B, br, bi_v, st):
        # engine's corrected branch-row stamp (deviation, PLAN.md 13)
        w = 2 * math.pi * st.freq
        info = [(ind.branch, ind.get_value(st.temp)) for ind in self.inductors]
        n = len(info)
        for i in range(n):
            for j in range(i + 1, n):
                mij = self.coeff * math.sqrt(info[i][1] * info[j][1])
                B[info[i][0], info[j][0]] += -w * mij
                B[info[j][0], info[i][0]] += -w * mij


class OracleCircuit:
    """Builds oracle devices from a CompiledCircuit (shares only the parsed
    tables, not any engine compute code)."""

    def __init__(self, cc: CompiledCircuit, temp: float = TEMP):
        self.cc = cc
        self.temp = temp
        self.np1 = cc.np1
        self.devices = []
        self.vsources = []
        self.nonlinear = []

        def nodes(kind, i):
            return [int(x) for x in cc.idx[kind]["nodes"][i]]

        ind_by_name = {}

        order = {name: k for k, name in enumerate(
            [e.name for e in cc.netlist.elements])}

        made = {}
        if "R" in cc.idx:
            pr = cc.params["R"]
            for i, name in enumerate(cc.names["R"]):
                n1, n2 = nodes("R", i)
                made[name] = Resistor(name, n1, n2, float(pr["value"][i]),
                                      float(pr["tc1"][i]), float(pr["tc2"][i]))
        if "C" in cc.idx:
            pc = cc.params["C"]
            for i, name in enumerate(cc.names["C"]):
                n1, n2 = nodes("C", i)
                made[name] = Capacitor(name, n1, n2, float(pc["value"][i]),
                                       float(pc["tc1"][i]), float(pc["tc2"][i]))
        if "L" in cc.idx:
            for i, name in enumerate(cc.names["L"]):
                n1, n2 = nodes("L", i)
                d = Inductor(name, n1, n2, float(cc.params["L"]["value"][i]),
                             int(cc.idx["L"]["branch"][i]))
                made[name] = d
                ind_by_name[name] = d
        if "LM" in cc.idx:
            for i, name in enumerate(cc.names["LM"]):
                n1, n2 = nodes("LM", i)
                core = {k: float(cc.params["LM"][k][i])
                        for k in ("ms", "alpha", "a", "c", "k", "area", "len",
                                  "tc", "beta")}
                d = MagneticInductor(name, n1, n2, int(cc.idx["LM"]["branch"][i]),
                                     float(cc.params["LM"]["turns"][i]), core)
                made[name] = d
                ind_by_name[name] = d
        if "V" in cc.idx:
            for i, name in enumerate(cc.names["V"]):
                n1, n2 = nodes("V", i)
                spec = self._spec(cc, "V", i)
                d = VSource(name, n1, n2, int(cc.idx["V"]["branch"][i]), spec)
                made[name] = d
                self.vsources.append(d)
        if "I" in cc.idx:
            for i, name in enumerate(cc.names["I"]):
                n1, n2 = nodes("I", i)
                made[name] = ISource(name, n1, n2, self._spec(cc, "I", i))
        if "D" in cc.idx:
            for i, name in enumerate(cc.names["D"]):
                n1, n2 = nodes("D", i)
                p = {k: float(v[i]) for k, v in cc.params["D"].items()}
                made[name] = Diode(name, n1, n2, p)
        if "Q" in cc.idx:
            for i, name in enumerate(cc.names["Q"]):
                nc, nb, ne = nodes("Q", i)
                p = {k: float(v[i]) for k, v in cc.params["Q"].items()}
                made[name] = BJT(name, nc, nb, ne, p)
        if "M" in cc.idx:
            for i, name in enumerate(cc.names["M"]):
                nd, ng, ns, nb = nodes("M", i)
                p = {k: float(v[i]) for k, v in cc.params["M"].items()}
                made[name] = Mosfet(name, nd, ng, ns, nb, p,
                                    int(cc.idx["M"]["level"][i]))

        # devices in element order (matters for sequential stamping parity)
        for e in cc.netlist.elements:
            if e.name in made:
                self.devices.append(made[e.name])

        # mutual couplings appended after (circuit.go:125-152)
        for e in cc.netlist.elements:
            if e.type == "K":
                names_ = []
                i = 1
                while f"ind{i}" in e.params:
                    names_.append(e.params[f"ind{i}"])
                    i += 1
                self.devices.append(
                    Mutual(e.name, [ind_by_name[n] for n in names_], e.value)
                )

        self.nonlinear = [d for d in self.devices if d.nonlinear]
        self.time_dep = [d for d in self.devices if d.time_dependent]

    @staticmethod
    def _spec(cc, kind, i):
        from ..compiler import SourceSpec

        p = cc.params[kind]
        s = SourceSpec(name=cc.names[kind][i])
        s.stype = int(cc.idx[kind]["stype"][i])
        for f in ("dc", "amplitude", "freq", "phase", "v1", "v2", "delay",
                  "rise", "fall", "width", "period", "ac_mag", "ac_phase"):
            setattr(s, f, float(p[f][i]))
        # strip PWL padding (pad times are ≥1e29)
        ts = [t for t in p["pwl_t"][i] if t < 1e29]
        s.pwl_t = ts
        s.pwl_v = list(p["pwl_v"][i][: len(ts)])
        return s

    # ---- analysis entry points ----

    def assemble(self, st, linear_only=False):
        A = np.zeros((self.np1, self.np1))
        b = np.zeros(self.np1)
        for d in self.devices:
            if linear_only and d.nonlinear:
                continue
            d.stamp(A, b, st)
        A[0, :] = 0.0
        A[0, 0] = 1.0
        b[0] = 0.0
        return A, b

    def nr(self, st, x_init, warm_start=False, vnl=None, conv="op",
           max_iter=MAX_ITER):
        x_prev = np.array(x_init)
        for k in range(max_iter):
            if warm_start:
                if k > 0:
                    for d in self.nonlinear:
                        d.update_voltages(x_prev)
            else:
                for d in self.nonlinear:
                    d.update_voltages(x_prev)
            A, b = self.assemble(st)
            n = A.shape[0]
            A[np.arange(1, n), np.arange(1, n)] += st.gmin
            x = solve(A, b)
            if k > 0 and np.all(np.isfinite(x)):
                diff = np.abs(x - x_prev)
                if conv == "dc":
                    ok = (diff <= ABSTOL) | (diff <= RELTOL * np.abs(x))
                else:
                    ok = diff <= RELTOL * np.maximum(np.abs(x), np.abs(x_prev)) + ABSTOL
                if np.all(ok):
                    return x, True, k + 1
            x_prev = x
        return x_prev, False, max_iter

    def initial_estimate(self, dc_scale=1.0):
        for v in self.vsources:
            v.scale = dc_scale
        st = Status(mode="op", temp=self.temp)
        A, b = self.assemble(st, linear_only=True)
        x = solve(A, b)
        for v in self.vsources:
            v.scale = 1.0
        if not np.all(np.isfinite(x)):
            return np.zeros(self.np1)
        return x

    def op(self):
        st = Status(mode="op", gmin=0.0, temp=self.temp)
        seed = self.initial_estimate()
        x, ok, _ = self.nr(st, seed)
        if ok:
            return x, True
        # gmin ladder
        cur = x
        gmin = self.cc.n * 0.001 * 10.0 ** 10
        for i in range(11):
            sti = Status(mode="op", gmin=gmin, temp=self.temp)
            xi, oki, _ = self.nr(sti, cur)
            if not oki:
                break
            cur = xi
            gmin /= 10.0
        x, ok, _ = self.nr(Status(mode="op", gmin=0.0, temp=self.temp), cur)
        if ok:
            return x, True
        # source stepping
        cur = self.initial_estimate(0.1)
        f = 0.1
        ok = True
        while f <= 1.0:
            for v in self.vsources:
                v.scale = f
            cur, oki, _ = self.nr(Status(mode="op", gmin=0.0, temp=self.temp), cur)
            if not oki:
                ok = False
                break
            f += 0.1
        for v in self.vsources:
            v.scale = 1.0
        x, okf, _ = self.nr(Status(mode="op", gmin=0.0, temp=self.temp), cur)
        return x, ok and okf

    def tran(self, tstart, tstop, tstep, tmax, uic):
        if tstep > tstop / 300.0:
            tstep = tstop / 300.0
        minstep = tstep / 50.0
        if tmax == 0:
            tmax = tstep

        if not uic:
            x, ok = self.op()
            if not ok:
                raise RuntimeError("oracle OP failed")

        t = 0.0
        dt = minstep
        times, xs = [], []
        accepted = 0
        guard = 0
        while t < tstop:
            guard += 1
            if guard > 10_000_000:
                raise RuntimeError("oracle runaway")
            next_t = t + dt
            if next_t > tstop:
                next_t = tstop
                dt = next_t - t
            st = Status(mode="tran", time=t, dt=dt, gmin=0.0, temp=self.temp)
            x, ok, _ = self.nr(st, np.zeros(self.np1), warm_start=True)
            if not ok:
                if dt > minstep:
                    dt /= 2
                    continue
                raise RuntimeError(f"oracle tran failed at t={t}")
            lte = max((d.lte(st) for d in self.time_dep), default=0.0)
            if lte > TRTOL and dt > minstep:
                dt /= 2
                continue
            for d in self.time_dep:
                d.load_state(x, st)
            for d in self.devices:
                if d.time_dependent:
                    d.update_state(x, st)
            t = next_t
            accepted += 1
            if t >= tstart:
                times.append(t)
                xs.append(x.copy())
            if t < tstop and dt < tmax:
                if lte < TRTOL / 100:
                    dt = min(dt * 2, tmax)
                else:
                    dt = min(dt * 1.1, tmax)
        return np.array(times), np.array(xs), accepted

    def dc(self, src_names, sweeps):
        slots = []
        for nm in src_names:
            slots.append(next(v for v in self.vsources if v.name == nm))
        vnl = np.zeros(self.np1)
        xs = []
        pts = []
        if len(slots) == 1:
            grid = [(v,) for v in sweeps[0]]
        else:
            grid = [(v1, v2) for v1 in sweeps[0] for v2 in sweeps[1]]
        for vals in grid:
            for s, v in zip(slots, vals):
                s.s.dc = v
            st = Status(mode="op", gmin=0.0, temp=self.temp)
            x, ok, _ = self.nr(st, np.zeros(self.np1), warm_start=True, conv="dc")
            if not ok:
                raise RuntimeError(f"oracle dc failed at {vals}")
            xs.append(x)
            pts.append(vals)
        return np.array(pts), np.array(xs)

    def ac(self, freqs):
        x, ok = self.op()
        if not ok:
            raise RuntimeError("oracle OP failed")
        out_r, out_i = [], []
        for f in freqs:
            st = Status(mode="ac", freq=f, gmin=0.0, temp=self.temp)
            G = np.zeros((self.np1, self.np1))
            B = np.zeros((self.np1, self.np1))
            br = np.zeros(self.np1)
            bi = np.zeros(self.np1)
            for d in self.devices:
                d.stamp_ac(G, B, br, bi, st)
            G[0, :] = 0.0
            G[0, 0] = 1.0
            B[0, :] = 0.0
            br[0] = 0.0
            bi[0] = 0.0
            A2 = np.block([[G, -B], [B, G]])
            b2 = np.concatenate([br, bi])
            x2 = solve(A2, b2)
            out_r.append(x2[: self.np1])
            out_i.append(x2[self.np1 :])
        return np.array(out_r), np.array(out_i)


def oracle_op(cc):
    return OracleCircuit(cc).op()


def oracle_tran(cc, tstart=None, tstop=None, tstep=None, tmax=None, uic=None):
    tp = cc.netlist.tran
    oc = OracleCircuit(cc)
    return oc.tran(
        tp.tstart if tstart is None else tstart,
        tp.tstop if tstop is None else tstop,
        tp.tstep if tstep is None else tstep,
        tp.tmax if tmax is None else tmax,
        tp.uic if uic is None else uic,
    )


def oracle_dc(cc, src_names, sweeps):
    return OracleCircuit(cc).dc(src_names, sweeps)


def oracle_ac(cc, freqs):
    return OracleCircuit(cc).ac(freqs)
