"""MNA assembly: batched evaluate-and-scatter stamping in f64 torch.

The counterpart of the JAX package's ``ops/assemble.py``:
``assemble_entries`` (the flat entries of one Newton iteration that the
stamped solve builds and solves), ``assemble_system`` and ``load_gmin``
(the dense system, for the OP's initial estimate) in modes "op" and
"tran" for R, C, L, LM, K, V, I, D, Q and M under compat and physics, BE
and trapezoidal; and ``assemble_ac_blocks`` and ``assemble_system_ac``
(the AC system at the bias point: its parts, for the AC kernel, and the
dense (2np1, 2np1) real embedding of one frequency, for the general AC).
The kernels' own stamp plans are ``ops/run_plan.py``'s.

Each device kind adds a fixed set of (row, col) entries (static host numpy)
and a value per entry and lane: parameters are (nk,) shared or (B, nk)
batched leaves, values (B, k).  Stamps never special-case ground: the
ground row is the identity, and column 0 is inert because x[0] = 0.  A
dense build sums each cell's entries in entry order from 0 (``cell_sums``),
so it gives the same bits on any device.
"""

import math

import numpy as np
import torch

from ..consts import TEMP_DEFAULT
from ..models import bjt as bjt_model
from ..models import diode as diode_model
from ..models import magnetic as mag_model
from ..models import mosfet as mos_model
from ..models.sources import eval_sources, eval_sources_ac
from .run_plan import CORE_KEYS, first_leaf, infer_batch, semantics_reason
from .solve_stamped import cell_sums

F64 = torch.float64
LINEAR_KINDS = ("R", "C", "L", "LM", "K", "V", "I")
AC_KINDS = LINEAR_KINDS + ("D", "Q", "M")


def _tadjust(tbl, temp):
    """value·(1 + tc1·dT + tc2·dT²) at Tnom 300.15 K (resistor.go:77-81,
    capacitor.go:180-184)."""
    dtemp = temp - TEMP_DEFAULT
    return tbl["value"] * (1.0 + tbl["tc1"] * dtemp
                           + tbl["tc2"] * dtemp * dtemp)


class _Acc:
    """Accumulates (row, col, value) and (row, value) entries of B lanes."""

    def __init__(self, b, device):
        self.b = b
        self.device = device
        self.rows, self.cols, self.vals = [], [], []
        self.rrows, self.rvals = [], []

    def _lanes(self, v, k):
        v = torch.as_tensor(v, dtype=F64, device=self.device)
        if v.ndim == 0:
            v = v.expand(k)
        if v.ndim == 1:
            v = v[None]
        return v.expand(self.b, k)

    def add(self, r, c, v):
        r = np.asarray(r, dtype=np.int32).ravel()
        self.rows.append(r)
        self.cols.append(np.asarray(c, dtype=np.int32).ravel())
        self.vals.append(self._lanes(v, len(r)))

    def add_rhs(self, r, v):
        r = np.asarray(r, dtype=np.int32).ravel()
        self.rrows.append(r)
        self.rvals.append(self._lanes(v, len(r)))

    def entries(self):
        """(rows, cols, vals (B, nnz), rrows, rvals (B, nrhs))."""
        def cat(idx, vals):
            if not idx:
                return (np.zeros(0, np.int32),
                        torch.zeros((self.b, 0), dtype=F64,
                                    device=self.device))
            return np.concatenate(idx), torch.cat(vals, dim=1)

        rows, vals = cat(self.rows, self.vals)
        cols = (np.concatenate(self.cols) if self.cols
                else np.zeros(0, np.int32))
        rrows, rvals = cat(self.rrows, self.rvals)
        return rows, cols, vals, rrows, rvals

    def build(self, np1):
        """Dense (B, np1, np1) and (B, np1), each cell summed in entry
        order."""
        rows, cols, vals, rrows, rvals = self.entries()
        a = cell_sums(rows * np1 + cols, vals, np1 * np1)
        return a.view(self.b, np1, np1), cell_sums(rrows, rvals, np1)


def _lane_cols(leaf, i):
    """Column ``i`` of a (nk,) or (B, nk) leaf: a scalar or a (B,) tensor."""
    return leaf[..., int(i)]


def _two_node_pattern(acc: _Acc, nodes, g):
    """Conductance stamp: +g on the diagonals, -g off them."""
    n1, n2 = nodes[:, 0], nodes[:, 1]
    acc.add(n1, n1, g)
    acc.add(n1, n2, -g)
    acc.add(n2, n1, -g)
    acc.add(n2, n2, g)


def _branch_pattern(acc: _Acc, nodes, branch):
    """±1 node-branch couplings with the inductor's sign convention
    (n1 -> -1, n2 -> +1; inductor.go:59-66)."""
    n1, n2 = nodes[:, 0], nodes[:, 1]
    ones = torch.ones(len(branch), dtype=F64, device=acc.device)
    acc.add(n1, branch, -ones)
    acc.add(branch, n1, -ones)
    acc.add(n2, branch, ones)
    acc.add(branch, n2, ones)


def _vsource_pattern(acc: _Acc, nodes, branch):
    """±1 with the voltage-source convention (n1 -> +1;
    vsource.go:140-147)."""
    n1, n2 = nodes[:, 0], nodes[:, 1]
    ones = torch.ones(len(branch), dtype=F64, device=acc.device)
    acc.add(branch, n1, ones)
    acc.add(n1, branch, ones)
    acc.add(branch, n2, -ones)
    acc.add(n2, branch, -ones)


def _unported(cc, kinds):
    extra = sorted(set(cc.idx) - set(kinds))
    if extra:
        raise NotImplementedError(
            f"device kinds {extra} are not ported to this assembly (the "
            f"port assembles {', '.join(kinds)})")


def _two_or_one(started):
    """2.0 where a device has a committed step, else 1.0, in f64 (two
    Python scalars alone would give float32)."""
    two = torch.full(started.shape, 2.0, dtype=F64, device=started.device)
    return torch.where(started, two, 1.0)


def _lane_batch(params, state, jv, *vals):
    """Lane count of one assembly: the batched leaves of params, state and
    jv, and any (B,) per-lane scalar."""
    b = infer_batch(params, state or {})
    for tbl in (jv or {}).values():
        for leaf in tbl.values():
            if leaf.ndim == 2:
                b = max(b, int(leaf.shape[0]))
    for v in vals:
        if isinstance(v, torch.Tensor) and v.ndim >= 1:
            b = max(b, int(v.shape[0]))
    return b


def _gather_inductance(cc, params, state, kind_sel, idx_sel, temp,
                       semantics):
    """Per-pair (inductance, i0, i1) as Mutual sees them through
    GetValue()/GetCurrent() (mutual.go:79-103): a linear L gives (value,
    its junk i0, i1); a magnetic winding under compat the J-A GetValue at
    its own i0, under physics the incremental inductance of its branch
    stamp, with its i0 and i1.  Each (B,) or scalar column, stacked to
    (..., npairs)."""
    def column(kind, key, i):
        if kind == 0:
            tbl = params["L"] if key == "value" else state["L"]
            return _lane_cols(tbl[key], i)
        if key == "value":
            return _lane_cols(lm_val, i)
        return _lane_cols(state["LM"][key], i)

    lm_val = None
    if "LM" in cc.idx:
        pm, stm = params["LM"], state["LM"]
        if semantics == "compat":
            core = mag_model.CoreState(*(stm[key] for key in CORE_KEYS))
            lm_val = mag_model.value_for_mutual(pm, core, stm["i0"], temp)
        else:
            lm_val = mag_model.l_incremental(mag_model.l_zero(pm),
                                             stm["dMdH"])
    kinds, idxs = np.asarray(kind_sel), np.asarray(idx_sel)
    out = []
    for key in ("value", "i0", "i1"):
        cols = [column(int(kk), key, i) for kk, i in zip(kinds, idxs)]
        out.append(torch.stack(torch.broadcast_tensors(*cols), dim=-1))
    return out


def _assemble_acc(cc, params, state, jv, t, dt, mode, status_gmin,
                  dc_scale=1.0, linear_only=False, temp=TEMP_DEFAULT,
                  semantics="compat", gmin_floor=1e-12, integration="be"):
    """Device stamping into an accumulator of (row, col, value) entries:
    the JAX package's ``_assemble_acc`` with a batch of lanes.

    ``jv`` is the junction-voltage tree (engine/nlstate.py), ``state`` the
    committed transient state, ``status_gmin`` the stamp-visible gmin (the
    ladder's value in an OP, 0 in a transient), ``linear_only`` leaves the
    diodes, BJTs and MOSFETs out (the OP's initial estimate, op.go:90-111).
    ``t``, ``dt``, ``status_gmin`` and ``dc_scale`` are floats or (B,)
    tensors; leaves are (nk,) shared or (B, nk) batched.  Mode "op" is the
    OP and DC sweep (reference Mode=OperatingPoint), mode "tran" the
    transient's companion models."""
    assert mode in ("op", "tran")
    why = semantics_reason(semantics)
    if why is not None:
        raise NotImplementedError(why)
    _unported(cc, AC_KINDS)
    tran = mode == "tran"
    trap = semantics == "physics" and integration == "trap"
    b = _lane_batch(params, state, jv, t, dt, status_gmin, dc_scale)
    device = first_leaf(params).device
    acc = _Acc(b, device)

    def col(v):  # a float or (B,) tensor as a (B, 1) column
        v = torch.as_tensor(v, dtype=F64, device=device)
        return (v[:, None] if v.ndim == 1 else v.reshape(1, 1)).expand(b, 1)

    t_c, dt_c, sg = col(t), col(dt), col(status_gmin)
    dt_eff = torch.where(dt_c > 0, dt_c, 1e-9)

    if "R" in cc.idx:  # resistor.go:32-75, temperature-adjusted
        _two_node_pattern(acc, cc.idx["R"]["nodes"],
                          1.0 / _tadjust(params["R"], temp))

    if "C" in cc.idx:
        nodes = cc.idx["C"]["nodes"]
        cval = _tadjust(params["C"], temp)
        if tran:
            stc = state["C"]
            if trap:
                # trapezoidal companion, BE on the first committed step
                started = stc["hist"] > 0
                geq = torch.where(started, 2.0 * cval / dt_c, cval / dt_c)
                ceq = torch.where(started, geq * stc["v0"] + stc["i0"],
                                  stc["q0"] / dt_c)
            else:
                # BE charge form (capacitor.go:85-105): compat reads the
                # one-step-lagged q1 (PLAN.md 3), physics q0
                geq = cval / dt_c
                ceq = (stc["q1"] if semantics == "compat"
                       else stc["q0"]) / dt_c
            _two_node_pattern(acc, nodes, geq)
            acc.add_rhs(nodes[:, 0], ceq)
            acc.add_rhs(nodes[:, 1], -ceq)
        else:  # OP: the gmin leak (capacitor.go:67-83)
            gc = torch.maximum(sg, torch.full_like(sg, gmin_floor)) \
                * torch.ones_like(cval)
            _two_node_pattern(acc, nodes, gc)

    if "L" in cc.idx:  # inductor.go:38-79
        nodes = cc.idx["L"]["nodes"]
        branch = cc.idx["L"]["branch"]
        lval = params["L"]["value"]
        stl = state["L"]
        _branch_pattern(acc, nodes, branch)
        if trap:
            # -v1 + v2 - (2L/dt) x_b = (2L/dt) i1 + v_prev, BE on the first
            # step
            started = stl["hist"] > 0
            lcoef = torch.where(started, 2.0 * lval / dt_eff, lval / dt_eff)
            acc.add(branch, branch, -lcoef)
            acc.add_rhs(branch, lcoef * stl["i1"]
                        + torch.where(started, stl["v0"], 0.0))
        else:
            acc.add(branch, branch, -lval / dt_eff)
            acc.add_rhs(branch, lval / dt_eff * stl["i1"])

    if "LM" in cc.idx:  # magnetic.go:197-274
        nodes = cc.idx["LM"]["nodes"]
        branch = cc.idx["LM"]["branch"]
        pm, stm = params["LM"], state["LM"]
        _branch_pattern(acc, nodes, branch)
        if tran:
            l0 = mag_model.l_zero(pm)
            if semantics == "compat":
                # i0 frozen at 0 (PLAN.md 1): the |i0| < 1e-9 guard keeps L0
                core = mag_model.CoreState(*(stm[key] for key in CORE_KEYS))
                leff, _ = mag_model.l_effective(pm, core, stm["i0"], temp)
                use_l0 = (t_c < dt_eff) | (stm["i0"].abs() < 1e-9)
                l_used = torch.where(use_l0, l0, leff)
            else:  # the incremental inductance of the committed core
                l_used = mag_model.l_incremental(l0, stm["dMdH"])
            acc.add(branch, branch, -l_used / dt_eff)
            acc.add_rhs(branch, l_used / dt_eff * stm["i1"])
        else:  # OP: a small fixed branch diagonal, note the sign
            acc.add(branch, branch, torch.full((len(branch),), 1e-3,
                                               dtype=F64, device=device))

    t_lanes = t_c[:, 0]
    if "V" in cc.idx:  # vsource.go:131-152
        nodes = cc.idx["V"]["nodes"]
        branch = cc.idx["V"]["branch"]
        _vsource_pattern(acc, nodes, branch)
        acc.add_rhs(branch, eval_sources(cc.idx["V"]["stype"], params["V"],
                                         t_lanes, col(dc_scale)))

    if "I" in cc.idx:  # isource.go:130-147
        nodes = cc.idx["I"]["nodes"]
        ivals = eval_sources(cc.idx["I"]["stype"], params["I"], t_lanes)
        acc.add_rhs(nodes[:, 0], ivals)
        acc.add_rhs(nodes[:, 1], -ivals)

    if "K" in cc.idx and tran:  # mutual.go:57-120, transient only
        kidx = cc.idx["K"]
        coeff = params["K"]["coeff"]
        la, i0a, i1a = _gather_inductance(cc, params, state, kidx["kind_a"],
                                          kidx["idx_a"], temp, semantics)
        lb, i0b, i1b = _gather_inductance(cc, params, state, kidx["kind_b"],
                                          kidx["idx_b"], temp, semantics)
        mij = coeff * torch.sqrt(la * lb)
        ba, bb = kidx["branch_a"], kidx["branch_b"]
        if trap:
            # both-linear pairs after the windings' first step: -2M/dt with
            # the memory +2M/dt·I_prev (magnetic LM rows stay BE)
            both_linear = (np.asarray(kidx["kind_a"]) == 0) & (
                np.asarray(kidx["kind_b"]) == 0)
            if "L" in cc.idx:
                nl = max(1, cc.kind_count("L"))
                ia = np.minimum(kidx["idx_a"], nl - 1)
                ib = np.minimum(kidx["idx_b"], nl - 1)
                hist = state["L"]["hist"]
                started = (hist[..., ia] > 0) & (hist[..., ib] > 0)
            else:
                started = torch.zeros(len(ba), dtype=torch.bool,
                                      device=device)
            use_tr = torch.as_tensor(both_linear, device=device) & started
            mcoef = torch.where(use_tr, 2.0 * mij / dt_c, mij / dt_c)
            acc.add(ba, bb, -mcoef)
            acc.add(bb, ba, -mcoef)
            acc.add_rhs(ba, mcoef * i1b)
            acc.add_rhs(bb, mcoef * i1a)
        else:
            acc.add(ba, bb, -mij / dt_c)
            acc.add(bb, ba, -mij / dt_c)
            if semantics == "compat":
                # the reference's RHS reads GetCurrent(), the junk i0
                # (PLAN.md 4), with mutual.go:114-115's sign
                acc.add_rhs(ba, -mij * i0b / dt_c)
                acc.add_rhs(bb, -mij * i0a / dt_c)
            else:
                acc.add_rhs(ba, mij * i1b / dt_c)
                acc.add_rhs(bb, mij * i1a / dt_c)

    if linear_only:
        return acc

    if "D" in cc.idx:  # diode.go:184-227
        nodes = cc.idx["D"]["nodes"]
        pd = params["D"]
        vd = jv["D"]["vd"]
        id_, gd = (diode_model.dc_eval_physics(pd, vd, temp)
                   if semantics == "physics"
                   else diode_model.dc_eval(pd, vd, temp))
        if tran:
            std = state["D"]
            charge = pd["tt"] * id_
            pos = dt_c > 0
            if trap:
                started = std["hist"] > 0
                dq = charge - std["prev_charge"]
                cap_cur = torch.where(pos, torch.where(
                    started, 2.0 * dq / dt_c - std["ic0"], dq / dt_c), 0.0)
                geq = torch.where(pos, _two_or_one(started) * pd["tt"] * gd
                                  / dt_c, 0.0)
            else:
                cap_cur = torch.where(
                    pos, (charge - std["prev_charge"]) / dt_c, 0.0)
                geq = torch.where(pos, pd["tt"] * gd / dt_c, 0.0)
            gd = gd + geq
            id_ = id_ + cap_cur
        _two_node_pattern(acc, nodes, gd)
        rhs = id_ - gd * vd
        acc.add_rhs(nodes[:, 0], -rhs)
        acc.add_rhs(nodes[:, 1], rhs)

    if "Q" in cc.idx:
        # Ebers-Moll with its consistent Jacobian (the JAX package's
        # deviation from bjt.go:315-374); no transient charge, as in the
        # reference, where StampTransient is dead code (PLAN.md 1)
        nodes = cc.idx["Q"]["nodes"]
        pq = params["Q"]
        vbe, vbc, vce = bjt_model.cold_start(
            pq, jv["Q"]["vbe"], jv["Q"]["vbc"], jv["Q"]["vce"], temp)
        ic0, ib0, g11, g12, g21, g22 = bjt_model.jacobian(pq, vbe, vbc, temp)
        nc, nb, ne = nodes[:, 0], nodes[:, 1], nodes[:, 2]
        sb = pq["sign"]
        acc.add(nc, nb, (g11 + g12) * sb)
        acc.add(nc, ne, -g11 * sb)
        acc.add(nc, nc, -g12 * sb)
        acc.add(nb, nb, (g21 + g22) * sb)
        acc.add(nb, ne, -g21 * sb)
        acc.add(nb, nc, -g22 * sb)
        acc.add(ne, nb, -(g11 + g12 + g21 + g22) * sb)
        acc.add(ne, ne, (g11 + g21) * sb)
        acc.add(ne, nc, (g12 + g22) * sb)
        acc.add_rhs(nc, -ic0 + g11 * vbe + g12 * vbc)
        acc.add_rhs(nb, -ib0 + g21 * vbe + g22 * vbc)
        acc.add_rhs(ne, (ic0 + ib0) - (g11 + g21) * vbe - (g12 + g22) * vbc)

    if "M" in cc.idx:  # mosfet.go:668-786
        nodes = cc.idx["M"]["nodes"]
        level = torch.as_tensor(np.asarray(cc.idx["M"]["level"]),
                                device=device)
        pmo = params["M"]
        vgs, vds, vbs = mos_model.cold_start(
            pmo, jv["M"]["vgs"], jv["M"]["vds"], jv["M"]["vbs"])
        ev = mos_model.dc_eval(pmo, level, vgs, vds, vbs)
        nd, ng, ns, nb = nodes[:, 0], nodes[:, 1], nodes[:, 2], nodes[:, 3]
        acc.add(nd, nd, ev.gds + sg)
        acc.add(nd, ng, ev.gm)
        acc.add(nd, ns, -ev.gds - ev.gm - ev.gmbs)
        acc.add(nd, nb, ev.gmbs)
        acc.add(ns, ns, ev.gds + ev.gm + ev.gmbs + sg)
        acc.add(ns, nd, -ev.gds)
        acc.add(ns, ng, -ev.gm)
        acc.add(ns, nb, -ev.gmbs)
        lin_rhs = -ev.id + ev.gds * vds + ev.gm * vgs + ev.gmbs * vbs
        acc.add_rhs(nd, lin_rhs)
        acc.add_rhs(ns, -lin_rhs)

        if tran:
            qgs, qgd, qgb, qbs, qbd = mos_model.charges(pmo, ev, vgs, vds,
                                                        vbs)
            stm = state["M"]
            if trap:
                started = stm["hist"] > 0
                cfac = _two_or_one(started)

                def icap(q, qk, ik):
                    dq = (q - stm[qk]) / dt_c
                    return torch.where(started, 2.0 * dq - stm[ik], dq)
            else:
                cfac = 1.0

                def icap(q, qk, ik):
                    return (q - stm[qk]) / dt_c

            icgs = icap(qgs, "qgs", "icgs")
            icgd = icap(qgd, "qgd", "icgd")
            icgb = icap(qgb, "qgb", "icgb")
            icbs = icap(qbs, "qbs", "icbs")
            icbd = icap(qbd, "qbd", "icbd")
            # the reference nests these stamps inside ground checks of the
            # other terminal (mosfet.go:744-782): the RHS values are masked
            m_nd, m_ng, m_ns, m_nb = (
                torch.as_tensor((np.asarray(v) != 0).astype(np.float64),
                                device=device) for v in (nd, ng, ns, nb))
            acc.add(ng, nd, cfac * ev.cgd / dt_c)
            acc.add(nd, ng, cfac * ev.cgd / dt_c)
            acc.add(ng, ns, cfac * ev.cgs / dt_c)
            acc.add(ns, ng, cfac * ev.cgs / dt_c)
            acc.add(ng, nb, cfac * ev.cgb / dt_c)
            acc.add(nb, ng, cfac * ev.cgb / dt_c)
            acc.add(ng, ng, cfac * (ev.cgd + ev.cgs + ev.cgb) / dt_c)
            acc.add(nb, ns, cfac * ev.cbs_eff / dt_c)
            acc.add(ns, nb, cfac * ev.cbs_eff / dt_c)
            acc.add(nb, nd, cfac * ev.cbd_eff / dt_c)
            acc.add(nd, nb, cfac * ev.cbd_eff / dt_c)
            acc.add(nb, nb, cfac * (ev.cbd_eff + ev.cbs_eff) / dt_c)
            acc.add_rhs(ng, icgd * m_nd)
            acc.add_rhs(nd, -icgd * m_ng)
            acc.add_rhs(ng, icgs * m_ns)
            acc.add_rhs(ns, -icgs * m_ng)
            acc.add_rhs(ng, icgb * m_nb)
            acc.add_rhs(nb, -icgb * m_ng)
            acc.add_rhs(nb, icbs * m_ns)
            acc.add_rhs(ns, -icbs * m_nb)
            acc.add_rhs(nb, icbd * m_nd)
            acc.add_rhs(nd, -icbd * m_nb)
    return acc


def assemble_entries(cc, params, state, jv, t, dt, mode, status_gmin,
                     dc_scale=1.0, linear_only=False, temp=TEMP_DEFAULT,
                     semantics="compat", gmin_floor=1e-12,
                     integration="be"):
    """Flat entries of one Newton iteration for the stamped solve: (rows,
    cols, vals (B, nnz), rrows, rvals (B, nrhs)), the index arrays static
    host numpy (see ``_assemble_acc`` for the arguments).  The ground row
    and the gmin diagonal are the solver's."""
    return _assemble_acc(cc, params, state, jv, t, dt, mode, status_gmin,
                         dc_scale, linear_only, temp, semantics, gmin_floor,
                         integration).entries()


def assemble_system(cc, params, state, jv, t, dt, mode, status_gmin,
                    dc_scale=1.0, linear_only=False, temp=TEMP_DEFAULT,
                    semantics="compat", gmin_floor=1e-12, integration="be"):
    """The dense (A (B, np1, np1), b (B, np1)) of one Newton iteration,
    each cell summed in entry order, with the ground row x[0] = 0."""
    a, rhs = _assemble_acc(cc, params, state, jv, t, dt, mode, status_gmin,
                           dc_scale, linear_only, temp, semantics,
                           gmin_floor, integration).build(cc.np1)
    a[:, 0, :] = 0.0
    a[:, 0, 0] = 1.0
    rhs[:, 0] = 0.0
    return a, rhs


def load_gmin(a, gmin):
    """gmin (a float or (B,) tensor) added to every diagonal but the
    ground row's (matrix/circuit.go:107-114)."""
    n = a.shape[-1]
    diag = torch.arange(1, n, device=a.device)
    g = torch.as_tensor(gmin, dtype=a.dtype, device=a.device)
    out = a.clone()
    out[:, diag, diag] = a[:, diag, diag] + (g[:, None] if g.ndim else g)
    return out


def assemble_ac_blocks(cc, params, state, jv, freq, temp=TEMP_DEFAULT,
                       semantics="compat"):
    """The parts of the AC system at one frequency: G and B (B, np1, np1),
    the RHS phasor br, bi (B, np1), ground rows applied (G's the identity,
    B's zero).  Nonlinear devices stamp their small-signal conductances
    and capacitances at the OP bias ``jv`` (nlstate tree, (B, nk)
    leaves); under physics the diode's gd includes Rs and Bv.  A magnetic
    winding stamps -ωL and a mutual coupling -ωM on the branch rows, L
    the J-A ``value_for_mutual`` at the state's core and current, under
    either semantics, as the JAX package does."""
    why = semantics_reason(semantics)
    if why is not None:
        raise NotImplementedError(why)
    _unported(cc, AC_KINDS)
    b, device = infer_batch(params, state), first_leaf(params).device
    np1 = cc.np1
    omega = 2.0 * math.pi * freq
    gacc = _Acc(b, device)  # real parts
    bacc = _Acc(b, device)  # imaginary parts

    if "R" in cc.idx:
        _two_node_pattern(gacc, cc.idx["R"]["nodes"],
                          1.0 / _tadjust(params["R"], temp))
    if "C" in cc.idx:
        _two_node_pattern(bacc, cc.idx["C"]["nodes"],
                          omega * _tadjust(params["C"], temp))
    if "L" in cc.idx:
        # the branch-row stamp -v1 + v2 - jωL·x_b = 0 (the JAX package's
        # deviation from inductor.go:44-56, whose node stamp is singular)
        nodes = cc.idx["L"]["nodes"]
        branch = cc.idx["L"]["branch"]
        _branch_pattern(gacc, nodes, branch)
        bacc.add(branch, branch, -omega * params["L"]["value"])
    lm_val = None
    if "LM" in cc.idx:
        nodes = cc.idx["LM"]["nodes"]
        branch = cc.idx["LM"]["branch"]
        stm = state["LM"]
        core = mag_model.CoreState(*(stm[key] for key in CORE_KEYS))
        lm_val = mag_model.value_for_mutual(params["LM"], core, stm["i0"],
                                            temp)
        _branch_pattern(gacc, nodes, branch)
        bacc.add(branch, branch, -omega * lm_val)
    if "K" in cc.idx:
        # the branch-row mutual stamp (the JAX package's deviation from
        # mutual.go:122-185, whose node stamp is singular; PLAN.md 13)
        kidx = cc.idx["K"]

        def partner(kinds, idxs):
            cols = [_lane_cols(params["L"]["value"], i) if kk == 0
                    else _lane_cols(lm_val, i)
                    for kk, i in zip(np.asarray(kinds), np.asarray(idxs))]
            return torch.stack(torch.broadcast_tensors(*cols), dim=-1)

        la = partner(kidx["kind_a"], kidx["idx_a"])
        lb = partner(kidx["kind_b"], kidx["idx_b"])
        mij = params["K"]["coeff"] * torch.sqrt(la * lb)
        bacc.add(kidx["branch_a"], kidx["branch_b"], -omega * mij)
        bacc.add(kidx["branch_b"], kidx["branch_a"], -omega * mij)
    if "V" in cc.idx:
        nodes = cc.idx["V"]["nodes"]
        branch = cc.idx["V"]["branch"]
        _vsource_pattern(gacc, nodes, branch)
        vre, vim = eval_sources_ac(params["V"])
        gacc.add_rhs(branch, vre)
        bacc.add_rhs(branch, vim)
    if "I" in cc.idx:
        nodes = cc.idx["I"]["nodes"]
        ire, iim = eval_sources_ac(params["I"])
        gacc.add_rhs(nodes[:, 0], ire)
        bacc.add_rhs(nodes[:, 0], iim)
        gacc.add_rhs(nodes[:, 1], -ire)
        bacc.add_rhs(nodes[:, 1], -iim)
    if "D" in cc.idx:  # bias-point gd + jωCj (diode.go:230-260)
        nodes = cc.idx["D"]["nodes"]
        pd = params["D"]
        vd = jv["D"]["vd"]
        # the small-signal gd at the physics bias includes Rs and Bv
        _, gd = (diode_model.dc_eval_physics(pd, vd, temp)
                 if semantics == "physics"
                 else diode_model.dc_eval(pd, vd, temp))
        cj = diode_model.junction_cap(pd, vd)
        _two_node_pattern(gacc, nodes, gd)
        _two_node_pattern(bacc, nodes, omega * cj)
    if "Q" in cc.idx:
        # the consistent Jacobian at the bias (the JAX package's deviation
        # from bjt.go:376-409) and the junction capacitances Cbe, Cbc
        nodes = cc.idx["Q"]["nodes"]
        pq = params["Q"]
        vbe, vbc, vce = jv["Q"]["vbe"], jv["Q"]["vbc"], jv["Q"]["vce"]
        vbe, vbc, vce = bjt_model.cold_start(pq, vbe, vbc, vce, temp)
        ic0, ib0, g11, g12, g21, g22 = bjt_model.jacobian(pq, vbe, vbc, temp)
        cbe, cbc = bjt_model.junction_caps(pq, vbe, vbc, g11)
        nc, nb, ne = nodes[:, 0], nodes[:, 1], nodes[:, 2]
        sb = pq["sign"]
        gacc.add(nc, nb, (g11 + g12) * sb)
        gacc.add(nc, ne, -g11 * sb)
        gacc.add(nc, nc, -g12 * sb)
        gacc.add(nb, nb, (g21 + g22) * sb)
        gacc.add(nb, ne, -g21 * sb)
        gacc.add(nb, nc, -g22 * sb)
        gacc.add(ne, nb, -(g11 + g12 + g21 + g22) * sb)
        gacc.add(ne, ne, (g11 + g21) * sb)
        gacc.add(ne, nc, (g12 + g22) * sb)
        wbe = omega * cbe
        wbc = omega * cbc
        bacc.add(nb, nb, wbe + wbc)
        bacc.add(nb, ne, -wbe)
        bacc.add(ne, nb, -wbe)
        bacc.add(ne, ne, wbe)
        bacc.add(nb, nc, -wbc)
        bacc.add(nc, nb, -wbc)
        bacc.add(nc, nc, wbc)
    if "M" in cc.idx:
        # mosfet.go:788-866, with its asymmetric imaginary couplings
        nodes = cc.idx["M"]["nodes"]
        level = torch.as_tensor(np.asarray(cc.idx["M"]["level"]),
                                device=device)
        pmo = params["M"]
        vgs, vds, vbs = mos_model.cold_start(
            pmo, jv["M"]["vgs"], jv["M"]["vds"], jv["M"]["vbs"])
        ev = mos_model.dc_eval(pmo, level, vgs, vds, vbs)
        nd, ng, ns, nb = nodes[:, 0], nodes[:, 1], nodes[:, 2], nodes[:, 3]
        cgsi = omega * ev.cgs
        cgdi = omega * ev.cgd
        cgbi = omega * ev.cgb
        cbsi = omega * ev.cbs_eff
        cbdi = omega * ev.cbd_eff
        gacc.add(nd, nd, ev.gds)
        gacc.add(nd, ng, ev.gm)
        bacc.add(nd, ng, cgdi)
        gacc.add(nd, ns, -ev.gds - ev.gm - ev.gmbs)
        gacc.add(nd, nb, ev.gmbs)
        bacc.add(nd, nb, cbdi)
        gacc.add(ns, ns, ev.gds + ev.gm + ev.gmbs)
        gacc.add(ns, nd, -ev.gds)
        gacc.add(ns, ng, -ev.gm)
        bacc.add(ns, ng, cgsi)
        gacc.add(ns, nb, -ev.gmbs)
        bacc.add(ns, nb, cbsi)
        bacc.add(ng, ng, cgsi + cgdi + cgbi)
        bacc.add(ng, nd, cgdi)
        bacc.add(ng, ns, cgsi)
        bacc.add(ng, nb, cgbi)
        bacc.add(nb, nb, cbsi + cbdi + cgbi)
        bacc.add(nb, nd, cbdi)
        bacc.add(nb, ns, cbsi)
        bacc.add(nb, ng, cgbi)

    g, br = gacc.build(np1)
    bmat, bi = bacc.build(np1)
    g[:, 0, :] = 0.0  # ground rows of both components
    g[:, 0, 0] = 1.0
    bmat[:, 0, :] = 0.0
    br[:, 0] = 0.0
    bi[:, 0] = 0.0
    return g, bmat, br, bi



def assemble_system_ac(cc, params, state, jv, freq, temp=TEMP_DEFAULT,
                       semantics="compat", out=None):
    """The real embedding of the complex AC system at one frequency:
    a2 = [[G, -B], [B, G]] (B, 2np1, 2np1) and b2 = [br; bi] (B, 2np1),
    omega·C formed per device at this frequency (the JAX package's
    ``assemble_system_ac``).  ``out``, a pair of (B, 2np1, 2np1) and (B,
    2np1) views, receives them in place (the general AC fills one slice
    per frequency of its batch)."""
    g, bm, br, bi = assemble_ac_blocks(cc, params, state, jv, freq, temp,
                                       semantics)
    n = cc.np1
    b = g.shape[0]
    if out is None:
        out = (torch.empty((b, 2 * n, 2 * n), dtype=F64, device=g.device),
               torch.empty((b, 2 * n), dtype=F64, device=g.device))
    a2, b2 = out
    a2[:, :n, :n] = g
    a2[:, :n, n:] = -bm
    a2[:, n:, :n] = bm
    a2[:, n:, n:] = g
    b2[:, :n] = br
    b2[:, n:] = bi
    return a2, b2
