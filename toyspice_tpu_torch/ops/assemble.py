"""MNA assembly for the linear deck's Newton and for AC: batched
evaluate-and-scatter stamping in f64 torch.

The counterpart of the JAX package's ``ops/assemble.py`` for what the
port's paths use: ``assemble_entries`` in mode "op" for R, C, L, LM, K, V
and I (the flat entries ``engine/newton.nr_linear`` hands to the stamped
solve) and ``assemble_ac_blocks`` for R, C, L, LM, K, V, I, D, Q and M
(the parts of the JAX package's ``assemble_system_ac``, the AC system at
the bias point).  The nonlinear devices' OP, DC and transient stamps live
in the kernels' stamp plans (``ops/run_plan.py``).  Under physics
semantics the linear OP stamps are the compat ones, and the diode's AC
conductance is the physics one (Rs and Bv).

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
from ..utils.tensor import true_div
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


def assemble_entries(cc, params, state, status_gmin, dc_scale=1.0,
                     temp=TEMP_DEFAULT, semantics="compat", gmin_floor=1e-12):
    """Flat entries of one linear OP/DC Newton iteration for the stamped
    solve: (rows, cols, vals (B, nnz), rrows, rvals (B, nrhs)), the index
    arrays static host numpy.  The ground row and the gmin diagonal are
    the solver's.  The JAX package's mode "op" at t = 0, dt = 0 (reference
    Mode=OperatingPoint), for R, C, L, LM, K, V and I: a capacitor leaks
    max(status_gmin, gmin_floor), an inductor stamps its dt = 1e-9
    companion, a magnetic winding its +1e-3 branch diagonal
    (magnetic.go:216-217), a mutual coupling nothing, sources take their
    t = 0 values with ``dc_scale`` on the V sources' dc (source
    stepping).  ``status_gmin`` and ``dc_scale`` are floats or (B,)
    tensors.  Compat and physics stamp alike here."""
    why = semantics_reason(semantics, None)
    if why is not None:
        raise NotImplementedError(why)
    _unported(cc, LINEAR_KINDS)
    b, device = infer_batch(params, state), first_leaf(params).device
    acc = _Acc(b, device)

    def per_lane(v):
        v = torch.as_tensor(v, dtype=F64, device=device)
        return v[:, None] if v.ndim == 1 else v

    sg = per_lane(status_gmin)
    if "R" in cc.idx:  # resistor.go:32-75
        _two_node_pattern(acc, cc.idx["R"]["nodes"],
                          1.0 / _tadjust(params["R"], temp))
    if "C" in cc.idx:  # OP: the gmin leak (capacitor.go:67-83)
        cval = _tadjust(params["C"], temp)
        floor = torch.full_like(sg, gmin_floor)
        gc = torch.maximum(sg, floor) * torch.ones_like(cval)
        _two_node_pattern(acc, cc.idx["C"]["nodes"], gc)
    if "L" in cc.idx:  # inductor.go:38-79, BE companion at dt = 1e-9
        nodes = cc.idx["L"]["nodes"]
        branch = cc.idx["L"]["branch"]
        lval = params["L"]["value"]
        _branch_pattern(acc, nodes, branch)
        acc.add(branch, branch, -true_div(lval, 1e-9))
        acc.add_rhs(branch, true_div(lval, 1e-9) * state["L"]["i1"])
    if "LM" in cc.idx:  # OP: a small fixed branch diagonal, note the sign
        nodes = cc.idx["LM"]["nodes"]
        branch = cc.idx["LM"]["branch"]
        _branch_pattern(acc, nodes, branch)
        acc.add(branch, branch, torch.full((len(branch),), 1e-3, dtype=F64,
                                           device=device))
    t_lanes = torch.zeros(b, dtype=F64, device=device)
    if "V" in cc.idx:  # vsource.go:131-152
        nodes = cc.idx["V"]["nodes"]
        branch = cc.idx["V"]["branch"]
        _vsource_pattern(acc, nodes, branch)
        acc.add_rhs(branch, eval_sources(cc.idx["V"]["stype"], params["V"],
                                         t_lanes, per_lane(dc_scale)))
    if "I" in cc.idx:  # isource.go:130-147
        nodes = cc.idx["I"]["nodes"]
        ivals = eval_sources(cc.idx["I"]["stype"], params["I"], t_lanes)
        acc.add_rhs(nodes[:, 0], ivals)
        acc.add_rhs(nodes[:, 1], -ivals)
    return acc.entries()


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
    why = semantics_reason(semantics, None)
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

