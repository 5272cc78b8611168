"""The plain torch version of the in-kernel Newton of ``csrc/newton.cuh``,
shared by the whole-run transient (``ops/run.py``), the OP kernel
(``ops/op.py``) and the DC sweep kernel (``ops/dc.py``), and the
Gauss-Jordan of the stamped solve (``ops/solve_stamped.py``) and AC
(``ops/ac.py``).

The counterpart of ``ops/pallas_tran.py``'s ``_newton_in_kernel`` and
``_device_eval_lib`` in the JAX package, compat branches, and of its
general engine's ``engine/newton.py``.  One Newton iteration of a lane:

1. junction voltages: the carried ones at iteration 0 of a transient
   attempt (warm start, tran.go:174), else ``engine/nlstate.update_jv`` of
   the previous solution, limited against the previous voltages (pnjlim);
2. device evaluation into value slots (``run_plan.NL_SLOTS`` per device):
   the diode with its compat transit-time companion, the BJT's Ebers-Moll
   currents and exact Jacobian after the cold-start guess, the MOSFET's
   level 1-3 currents and conductances after its cold-start guess, with
   the Meyer charge stamps of a transient (previous charges frozen);
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
from .run_plan import (NL_KINDS, TAG_CEQ, TAG_G, TAG_GEQ, TAG_ISRC,
                       TAG_KRHSA, TAG_KRHSB, TAG_KTERM, TAG_LMRHS,
                       TAG_LMTERM, TAG_LRHS, TAG_LTERM, TAG_NL, TAG_ONE,
                       TAG_VSRC, jv_tree, nl_params)

F64 = torch.float64
MAX_NL_DEVICES = 16  # csrc/newton.cuh: diodes + BJTs + MOSFETs per deck


def gauss_jordan(m, poison):
    """Batched Gauss-Jordan on (B, n, n+1) augmented systems with the
    kernel's pivot rule; returns x (B, n), non-finite where singular.
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
    return torch.where(nan_col, float("nan"), x)


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
    parameter leaves, and the evaluation of one Newton iteration."""

    def __init__(self, plan, dev):
        def lt(v):
            return torch.as_tensor(v, dtype=torch.long, device=dev.device)

        self.plan = plan
        # the node tables as device tensors, so that a captured CUDA graph
        # copies nothing from the host
        self.idx = {kind: {key: lt(v) for key, v in tbl.items()}
                    for kind, tbl in plan.idx.items()}
        self.p = {kind: nl_params(plan, dev, kind) for kind in NL_KINDS
                  if kind in plan.idx}

    def limit(self, x, jvs):
        """Junction voltages from ``x`` (B, n), limited against the rows
        ``jvs`` (B, kj); returns (B, kj) rows."""
        tree = update_jv(self.idx, self.p, x, jv_tree(self.plan, jvs))
        keys = (("D", ("vd",)), ("Q", ("vbe", "vbc")),
                ("M", ("vgs", "vds", "vbs")))
        return torch.cat([tree[kind][key] for kind, names in keys
                          if kind in tree for key in names], dim=1)

    def values(self, jvs, dte=None, gmin=0.0):
        """Value slots (B, nval) at the junction voltages ``jvs``; ``dte``
        (B, 1) adds the transient companions, ``gmin`` is the status gmin
        of the MOSFET drain/source diagonals (0 in a transient)."""
        tree = jv_tree(self.plan, jvs)
        out = []
        if "D" in self.p:  # diode.go:184-227
            p = self.p["D"]
            vd = tree["D"]["vd"]
            id_, gd = diode.dc_eval(p, vd, None, nvt=p["nvt"],
                                    is_t=p["is_t"])
            if dte is not None:  # compat: prev_charge frozen (PLAN.md 1)
                charge = p["tt"] * id_
                pos = dte > 0
                cap = torch.where(pos, (charge - p["prev_charge"]) / dte, 0.0)
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
                icap = [(qk - p[key]) / dte for qk, key in
                        zip(q, ("qgs", "qgd", "qgb", "qbs", "qbd"))]
                out += [ev.cgd / dte, ev.cgs / dte, ev.cgb / dte,
                        (ev.cgd + ev.cgs + ev.cgb) / dte, ev.cbs_eff / dte,
                        ev.cbd_eff / dte, (ev.cbd_eff + ev.cbs_eff) / dte,
                        icap[1], icap[0], icap[2], icap[3], icap[4]]
        return torch.cat(out, dim=1)


def converged(xn, xp, reltol, abstol):
    """The reference's test (op.go:67-82) per lane: every row within
    reltol·max(|new|, |old|) + abstol, and the solution finite."""
    ok = (xn - xp).abs() <= reltol * torch.maximum(xn.abs(), xp.abs()) \
        + abstol
    return ok.all(dim=1) & torch.isfinite(xn).all(dim=1)
