"""The plain torch version of the in-kernel Newton of ``csrc/newton.cuh``,
shared by the whole-run transient (``ops/run.py``), the OP kernel
(``ops/op.py``) and the DC sweep kernel (``ops/dc.py``), and the
Gauss-Jordan of the stamped solve (``ops/solve_stamped.py``) and AC
(``ops/ac.py``).

The counterpart of ``ops/pallas_tran.py``'s ``_newton_in_kernel`` and
``_device_eval_lib`` in the JAX package, and of its general engine's
``engine/newton.py``.  One Newton iteration of a lane:

1. junction voltages: the carried ones at iteration 0 of a transient
   attempt (warm start, tran.go:174), else ``engine/nlstate.update_jv`` of
   the previous solution, limited against the previous voltages (pnjlim;
   physics adds the diode's breakdown-frame limit);
2. device evaluation into value slots (``run_plan.NL_SLOTS`` per device):
   the diode (compat, or physics with Bv and Rs) with its transit-time
   companion, the BJT's Ebers-Moll currents and exact Jacobian after the
   cold-start guess, the MOSFET's level 1-3 currents and conductances
   after its cold-start guess, with the Meyer charge stamps of a
   transient; compat freezes the previous charges, physics reads them
   from the committed state rows, with the trapezoidal companions after a
   device's first committed step;
3. the build: every stamp of the plan added into its cell in plan order,
   the ground row, and in an OP the status gmin on the non-ground
   diagonals (matrix/circuit.go:107-114);
4. Gauss-Jordan with the kernel's pivot rule;
5. convergence from iteration 1 on: every |new - old| <= reltol·max(|new|,
   |old|) + abstol, and x finite.

Batches carry the lanes in the leading axis; a lane that has converged or
reached ``max_iter`` is frozen by its caller's mask.
"""

import torch

from ..engine.nlstate import update_jv
from ..models import bjt, diode, mosfet
from .run_plan import (M_CHARGES, NL_KINDS, PHYS_ROWS, TAG_CEQ, TAG_G,
                       TAG_GEQ, TAG_ISRC, TAG_KRHSA, TAG_KRHSB, TAG_KTERM,
                       TAG_LMRHS, TAG_LMTERM, TAG_LRHS, TAG_LTERM, TAG_NL,
                       TAG_ONE, TAG_VSRC, jv_tree, nl_params)

F64 = torch.float64
# diodes + BJTs + MOSFETs per deck in the kernels: their junction voltages
# and value slots in a warp segment's shared memory (csrc/newton.cuh)
MAX_NL_DEVICES = 16


def gauss_jordan(m, poison):
    """Batched Gauss-Jordan on (B, n, n+1) augmented systems with the
    kernel's pivot rule; returns x (B, n), all NaN where singular.
    ``poison`` (n, n+1) holds the row a zero pivot at stage k leaves:
    inf everywhere but 1 at column k."""
    b, n, _ = m.shape
    lane = torch.arange(b, device=m.device)
    used = torch.zeros((b, n), dtype=torch.bool, device=m.device)
    perm, col_max = [], []
    for k in range(n):
        mk = m[:, :, k]
        col = mk.abs().masked_fill(used, -1.0)
        mx = col.amax(dim=1, keepdim=True)  # NaN if any unused entry is
        col_max.append(mx)
        # first row holding the largest |entry| among the unused rows
        p = (col == mx).to(torch.uint8).argmax(dim=1)
        prow = m[lane, p]  # (B, n+1)
        piv = prow[:, k:k + 1]
        bad = piv == 0
        prow = torch.where(bad, poison[k], prow / torch.where(bad, 1.0, piv))
        f = mk.scatter(1, p[:, None], 0.0)
        m = m - f[:, :, None] * prow[:, None, :]
        m[lane, p] = prow
        used = used.scatter(1, p[:, None], True)
        perm.append(p)
    x = m[:, :, n].gather(1, torch.stack(perm, dim=1))
    nan_col = torch.isnan(torch.cat(col_max, dim=1)).any(dim=1, keepdim=True)
    # one non-finite x makes every x of its system NaN (the JAX package's
    # one-hot gather does the same)
    bad = nan_col | ~torch.isfinite(x).all(dim=1, keepdim=True)
    return torch.where(bad, float("nan"), x)


def poison_rows(n, device):
    poison = torch.full((n, n + 1), float("inf"), dtype=F64, device=device)
    poison[torch.arange(n), torch.arange(n)] = 1.0
    return poison


class Builder:
    """Gather tables of one plan's build: where each stamp entry reads its
    term in the concatenated term columns, and each cell's entries in
    plan order (one slot per position in the cell's list)."""

    def __init__(self, plan, device, entries=None):
        nr, nc, nl, nv, ni = plan.counts[:5]
        ents = plan.entries if entries is None else entries
        widths = ((TAG_G, nr), (TAG_GEQ, nc), (TAG_LTERM, nl), (TAG_ONE, 1),
                  (TAG_CEQ, nc), (TAG_LRHS, nl), (TAG_VSRC, nv),
                  (TAG_ISRC, ni), (TAG_LMTERM, plan.nlm),
                  (TAG_LMRHS, plan.nlm), (TAG_KTERM, plan.nk),
                  (TAG_KRHSA, plan.nk), (TAG_KRHSB, plan.nk), (TAG_NL, 0))
        self.base, pos = {}, 0
        for tag, width in widths:
            self.base[tag] = pos
            pos += width
        n = plan.np1
        self.n = n
        term_col, sign, cells = [], [], {}
        for e, (row, col, tag, idx, sgn) in enumerate(ents.tolist()):
            term_col.append(self.base[tag] + (0 if tag == TAG_ONE else idx))
            sign.append(float(sgn))
            cells.setdefault(row * (n + 1) + col, []).append(e)
        flat = list(cells)
        nslot = max((len(v) for v in cells.values()), default=0)

        def lt(v):
            return torch.as_tensor(v, dtype=torch.long, device=device)

        self.term_col = lt(term_col)
        self.sign = torch.as_tensor(sign, dtype=F64, device=device)
        self.cell_flat = lt(flat)
        self.slot_entry = [lt([cells[c][s] if s < len(cells[c]) else 0
                               for c in flat]) for s in range(nslot)]
        self.slot_mask = [torch.as_tensor([s < len(cells[c]) for c in flat],
                                          device=device)
                          for s in range(nslot)]
        self.poison = poison_rows(n, device)
        self.diag = lt([r * (n + 1) + r for r in range(1, n)])

    def solve(self, terms, gmin=None):
        """Build the augmented systems from the (B, ·) term columns (in
        ``base`` order) and solve them; ``gmin`` (B, 1) goes on the
        non-ground diagonals."""
        b = terms.shape[0]
        n = self.n
        vals = terms[:, self.term_col] * self.sign
        cell = torch.zeros((b, len(self.cell_flat)), dtype=F64,
                           device=terms.device)
        for ent, mask in zip(self.slot_entry, self.slot_mask):
            cell = cell + torch.where(mask, vals[:, ent], 0.0)
        m = torch.zeros((b, n * (n + 1)), dtype=F64, device=terms.device)
        m[:, self.cell_flat] = cell
        m[:, 0] = 1.0  # ground row: x[0] = 0
        if gmin is not None:
            m[:, self.diag] = m[:, self.diag] + gmin
        return gauss_jordan(m.view(b, n, n + 1), self.poison)


class Devices:
    """The nonlinear devices of one plan on one batch: their dev rows as
    parameter leaves, and the evaluation of one Newton iteration under
    compat or (``physics``) physics semantics."""

    def __init__(self, plan, dev, physics=False):
        def lt(v):
            return torch.as_tensor(v, dtype=torch.long, device=dev.device)

        self.plan = plan
        self.physics = physics
        # the node tables as device tensors, so that a captured CUDA graph
        # copies nothing from the host
        self.idx = {kind: {key: lt(v) for key, v in tbl.items()}
                    for kind, tbl in plan.idx.items()}
        self.p = {kind: nl_params(plan, dev, kind) for kind in NL_KINDS
                  if kind in plan.idx}
        # the Rs inner Newton is an exact no-op where Rs = 0: skip it when
        # every lane's is (one host read here, none in a captured graph)
        self.rs_any = physics and "D" in self.p and bool(
            (self.p["D"]["rs"] != 0).any())

    def limit(self, x, jvs):
        """Junction voltages from ``x`` (B, n), limited against the rows
        ``jvs`` (B, kj); returns (B, kj) rows."""
        tree = update_jv(self.idx, self.p, x, jv_tree(self.plan, jvs),
                         "physics" if self.physics else "compat")
        keys = (("D", ("vd",)), ("Q", ("vbe", "vbc")),
                ("M", ("vgs", "vds", "vbs")))
        return torch.cat([tree[kind][key] for kind, names in keys
                          if kind in tree for key in names], dim=1)

    def diode(self, vd):
        """(id, gd) of the diodes at ``vd`` (B, nD), compat or physics."""
        p = self.p["D"]
        if self.physics:
            return diode.dc_eval_physics(p, vd, None, nvt=p["nvt"],
                                         is_t=p["is_t"], rs_any=self.rs_any)
        return diode.dc_eval(p, vd, None, nvt=p["nvt"], is_t=p["is_t"])

    def state_rows(self, st, kind):
        """One kind's physics state rows of the stack ``st`` (B, ks), keyed
        by ``run_plan.PHYS_ROWS``."""
        nk = self.plan.counts[5 + NL_KINDS.index(kind)]
        lay = self.plan.layout
        return {key: st[:, lay[f"{kind.lower()}_{key}"]:
                        lay[f"{kind.lower()}_{key}"] + nk]
                for key in PHYS_ROWS[kind]}

    def values(self, jvs, dte=None, gmin=0.0, st=None, trap=False):
        """Value slots (B, nval) at the junction voltages ``jvs``; ``dte``
        (B, 1) adds the transient companions, ``gmin`` is the status gmin
        of the MOSFET drain/source diagonals (0 in a transient).  Under
        physics the companions read the committed rows of the state stack
        ``st``, trapezoidal (``trap``) after a device's first committed
        step (hist > 0)."""
        tree = jv_tree(self.plan, jvs)
        out = []
        if "D" in self.p:  # diode.go:184-227
            p = self.p["D"]
            vd = tree["D"]["vd"]
            id_, gd = self.diode(vd)
            if dte is not None:
                charge = p["tt"] * id_
                pos = dte > 0
                if self.physics:  # assemble.py's physics D block
                    sd = self.state_rows(st, "D")
                    dq = charge - sd["prev_charge"]
                    tt = p["tt"]
                    if trap:
                        started = sd["hist"] > 0
                        cap = torch.where(started,
                                          2.0 * dq / dte - sd["ic0"],
                                          dq / dte)
                        tt = torch.where(started, 2.0 * tt, tt)
                    else:
                        cap = dq / dte
                    cap = torch.where(pos, cap, 0.0)
                    geq = torch.where(pos, tt * gd / dte, 0.0)
                else:  # compat: prev_charge frozen (PLAN.md 1)
                    cap = torch.where(pos, (charge - p["prev_charge"]) / dte,
                                      0.0)
                    geq = torch.where(pos, p["tt"] * gd / dte, 0.0)
                gd = gd + geq
                id_ = id_ + cap
            out += [gd, id_ - gd * vd]
        if "Q" in self.p:  # the cold start only feeds the evaluation
            p = self.p["Q"]
            vbe, vbc, vce = (tree["Q"][k] for k in ("vbe", "vbc", "vce"))
            cold = (vbe == 0.0) & (vce == 0.0)
            vbe = torch.where(cold, p["vbe0"], vbe)
            vbc = torch.where(cold, p["vbc0"], vbc)
            ic0, ib0, g11, g12, g21, g22 = bjt.jacobian(p, vbe, vbc, None,
                                                        inv=p)
            sb = p["sign"]
            out += [(g11 + g12) * sb, -g11 * sb, -g12 * sb,
                    (g21 + g22) * sb, -g21 * sb, -g22 * sb,
                    -(g11 + g12 + g21 + g22) * sb, (g11 + g21) * sb,
                    (g12 + g22) * sb,
                    -ic0 + g11 * vbe + g12 * vbc,
                    -ib0 + g21 * vbe + g22 * vbc,
                    (ic0 + ib0) - (g11 + g21) * vbe - (g12 + g22) * vbc]
        if "M" in self.p:  # mosfet.go:668-786
            p = self.p["M"]
            vgs, vds, vbs = mosfet.cold_start(
                p, *(tree["M"][k] for k in ("vgs", "vds", "vbs")))
            ev = mosfet.dc_eval(p, self.idx["M"]["level"], vgs, vds, vbs)
            out += [ev.gds + gmin, ev.gm, -ev.gds - ev.gm - ev.gmbs, ev.gmbs,
                    ev.gds + ev.gm + ev.gmbs + gmin, -ev.gds, -ev.gm,
                    -ev.gmbs,
                    -ev.id + ev.gds * vds + ev.gm * vgs + ev.gmbs * vbs]
            if dte is not None:
                q = mosfet.charges(p, ev, vgs, vds, vbs)
                caps = [ev.cgd, ev.cgs, ev.cgb, ev.cgd + ev.cgs + ev.cgb,
                        ev.cbs_eff, ev.cbd_eff, ev.cbd_eff + ev.cbs_eff]
                if self.physics:  # assemble.py's physics M block
                    sm = self.state_rows(st, "M")
                    icap = [(qk - sm[key]) / dte for qk, key in
                            zip(q, M_CHARGES)]
                    if trap:
                        started = sm["hist"] > 0
                        icap = [torch.where(started,
                                            2.0 * dq - sm["ic" + key[1:]], dq)
                                for dq, key in zip(icap, M_CHARGES)]
                        caps = [torch.where(started, 2.0 * c, c)
                                for c in caps]
                else:  # compat: the previous charges frozen (PLAN.md 1)
                    icap = [(qk - p[key]) / dte for qk, key in
                            zip(q, M_CHARGES)]
                out += [c / dte for c in caps]
                out += [icap[1], icap[0], icap[2], icap[3], icap[4]]
        return torch.cat(out, dim=1)


    def commit(self, x, dte, st, trap):
        """The physics D and M rows committed on an accepted step
        (engine/state.py make_commit of the JAX package): each device
        re-evaluated at the raw solution ``x`` (B, n), no limiting and no
        cold start, its charges and companion currents (BE, or trapezoidal
        after its first committed step), hist 1; a list of (B, nk) rows in
        ``PHYS_ROWS`` order."""
        rows = []
        if "D" in self.p:
            p = self.p["D"]
            nodes = self.idx["D"]["nodes"]
            vd = x[:, nodes[:, 0]] - x[:, nodes[:, 1]]
            id_, _ = self.diode(vd)
            sd = self.state_rows(st, "D")
            q = p["tt"] * id_
            dq = q - sd["prev_charge"]
            ic = dq / dte
            if trap:
                ic = torch.where(sd["hist"] > 0, 2.0 * dq / dte - sd["ic0"],
                                 ic)
            rows += [vd, id_, q, ic, torch.ones_like(vd)]
        if "M" in self.p:
            p = self.p["M"]
            vgs, vds, vbs = mosfet.terminal_voltages(
                p, x, self.idx["M"]["nodes"])
            ev = mosfet.dc_eval(p, self.idx["M"]["level"], vgs, vds, vbs)
            q = mosfet.charges(p, ev, vgs, vds, vbs)
            sm = self.state_rows(st, "M")
            ics = []
            for qk, key in zip(q, M_CHARGES):
                dq = (qk - sm[key]) / dte
                if trap:
                    dq = torch.where(sm["hist"] > 0,
                                     2.0 * dq - sm["ic" + key[1:]], dq)
                ics.append(dq)
            rows += list(q) + ics + [torch.ones_like(vgs)]
        return rows


def converged(xn, xp, reltol, abstol):
    """The reference's test (op.go:67-82) per lane: every row within
    reltol·max(|new|, |old|) + abstol, and the solution finite."""
    ok = (xn - xp).abs() <= reltol * torch.maximum(xn.abs(), xp.abs()) \
        + abstol
    return ok.all(dim=1) & torch.isfinite(xn).all(dim=1)
