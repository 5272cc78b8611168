"""Host-side tables of the whole-run transient and the OP kernel for decks
of R, C, L, LM, K, V, I, D, Q and M under compat and physics semantics.

The counterpart of ``ops/pallas_tran.py``'s ``_build_plan``, ``_layout``,
``_const_stack64``, ``_init_state_stack64``, ``_jv_stack64``,
``_unpack_state_jv`` and ``fused_ineligible_reason`` in the JAX package.
The TPU kernels unroll their stamp plan at trace time; here the plan is
data, so one compiled kernel (``csrc/run_kernel.cu``, ``csrc/op_kernel.cu``)
serves every eligible deck:

* ``entries``: int32 (row, col, tag, index, sign) stamps in the order the
  general engine scatters them (ops/assemble.py), so each cell sums its
  terms in the same order. Column ``np1`` is the right-hand side; stamps
  into the ground row 0 are dropped (that row is the identity). The linear
  stamps come first; the nonlinear ones (tag ``TAG_NL``) read the value
  slot ``index`` that the device evaluation of each Newton iteration fills
  (``NL_SLOTS`` per device). The LM branch rows and the K cross terms and
  their RHS memory (tags ``TAG_LMTERM`` .. ``TAG_KRHSB``) read the compat
  run constants below. Physics uses the same plan: the values of
  ``TAG_GEQ``, ``TAG_CEQ``, ``TAG_LTERM``, ``TAG_LRHS``, the magnetic tags
  and the D/M value slots then come from the physics state rows. A sign
  of 0 is the general engine's masked MOSFET charge current (value times
  0.0). The OP plan (``mode="op"``) has no capacitor companion RHS, no
  MOSFET charge stamps and no K, and an LM stamps its +1e-3 branch
  diagonal as ``TAG_LMTERM`` of value -1e-3 against sign -1, as
  assemble.py's mode "op".
* per-lane f64 rows, batch axis first: ``dev`` (B, nd) holds g = 1/R_t,
  C_t, C, L, the magnetic run constants (compat: each LM's L0, its
  frozen-core L_eff and its frozen i0 and i1, each K's M = k·sqrt(La·Lb),
  ``_run_const64`` of the JAX package; physics: each LM's
  ``LM_PHYS_ROWS``, the J-A leaves its commit reads, and each K's
  coefficient), then the ``D_ROWS``, ``Q_ROWS`` and ``M_ROWS`` of each
  nonlinear device (row r of device k of a kind at its block offset +
  r·nk + k); ``src`` (B, nrc) one record per source (``SRC_KEYS`` then
  the P knot times and P knot values); ``state`` (B, ks) the committed C/L
  rows, and under physics then the rows ``PHYS_ROWS`` of C, L, D and M
  and the live LM rows ``LM_STATE`` (``state_layout``); ``jv`` (B, kj)
  the junction voltages D vd | Q vbe | Q vbc | M vgs | M vds | M vbs.
* ``topo``: the int32 table the kernel copies to shared memory (a header
  of counts and offsets, then the entries, sources, device nodes, each
  K's partners: kind (0 linear L, 1 LM) and index of winding a, then of
  winding b (a pair with both kinds 0 is both-linear), the inductors'
  branch rows, each LM's nodes and branch row, and each LM's core). The
  plan appends the row view of the entries (``row_view``) at
  ``topo[H_ROWS]``, 16-byte aligned: the entries stably sorted by row as
  (col, tag, index, sign), then the np1 + 1 offsets of the rows into it;
  an OP plan then each row's linear prefix (``linear_prefix``), from which
  the OP kernel builds the linear-devices-only estimate. The segment
  kernels (run, OP, DC sweep) build row i on thread i from its slice of
  the view, in plan order (``RunPlan.base_len``: the table before it).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..consts import TEMP_DEFAULT
from ..engine.nlstate import limiter_constants
from ..models import bjt, diode, magnetic

# the kinds of ``RunPlan.counts``, which the OP, DC and AC paths run
DEVICE_KINDS = ("R", "C", "L", "V", "I", "D", "Q", "M")
MAG_KINDS = ("LM", "K")
SLICE_KINDS = DEVICE_KINDS + MAG_KINDS  # the transient's
NL_KINDS = ("D", "Q", "M")

# stamp tags, csrc/newton.cuh ``enum Tag``
(TAG_G, TAG_GEQ, TAG_LTERM, TAG_ONE, TAG_CEQ, TAG_LRHS, TAG_VSRC,
 TAG_ISRC, TAG_NL, TAG_LMTERM, TAG_LMRHS, TAG_KTERM, TAG_KRHSA,
 TAG_KRHSB) = range(14)

# per-device value slots of one Newton iteration (csrc/newton.cuh)
NL_SLOTS = {"D": 2, "Q": 12, "M": 21}

# per-device dev rows of the nonlinear kinds, csrc/newton.cuh ``enum DRow``,
# ``QRow``, ``MRow``: raw parameters, the values that depend only on the
# parameters and the temperature, and the frozen compat state they read
D_ROWS = ("n", "is_", "gmin", "tt", "prev_charge", "nvt", "is_t", "vte",
          "vcrit", "rs", "bv")
Q_ROWS = ("sign", "ies", "ics", "nf", "nr", "alphaf", "invnfvt", "invnrvt",
          "invvaf", "invvar", "invikf", "invikr", "vbe0", "vbc0", "vtef",
          "vcritf", "vter", "vcritr")
M_PARAMS = ("sign", "vto", "gamma", "phi", "kp", "w", "l", "lam", "tox",
            "uo", "ucrit", "uexp", "vmax", "theta", "kappa", "delta", "cgso",
            "cgdo", "cgbo", "cbs", "cbd", "cj", "cjsw", "as", "ad", "ps",
            "pd", "pb", "mj")
M_CHARGES = ("qgs", "qgd", "qgb", "qbs", "qbd")
M_ROWS = M_PARAMS + M_CHARGES
NL_ROWS = {"D": D_ROWS, "Q": Q_ROWS, "M": M_ROWS}

# the committed physics state rows after the compat C/L rows, kind by kind
# (the JAX package's _layout(physics=True)): C current and first-step flag,
# L first-step flag, the diode charge memory, the MOSFET charges, their
# companion currents and first-step flag
PHYS_ROWS = {"C": ("i0", "hist"), "L": ("hist",),
             "D": ("prev_vd", "prev_id", "prev_charge", "ic0", "hist"),
             "M": M_CHARGES + ("icgs", "icgd", "icgb", "icbs", "icbd",
                               "hist")}

# the live magnetic inductor rows of physics (the JAX package's
# _layout(physics=True) places them after the physics stack): the
# currents, voltages and flux, and the winding's copy of its J-A core
LM_STATE = ("i0", "i1", "v0", "v1", "flux0", "H", "Hold", "M", "Mirr",
            "dMdH")
CORE_KEYS = ("H", "Hold", "M", "Mirr", "dMdH")
# a physics LM's run constants, csrc/run_kernel.cuh ``enum LmRow``: L0,
# Ms at the commit's fixed 300.15 K (``magnetic.saturation``), the J-A
# leaves of ``magnetic.ja_step``, and the turns and path length of the mmf
LM_PHYS_ROWS = ("l0", "mst", "a", "k", "c", "alpha", "turns", "len")
# the commit's temperature: engine/state.py make_commit runs ja_calculate
# at 300.15 K whatever the stamp temperature
JA_COMMIT_TEMP = 300.15

# the scalar leaves of one source record, in record order
SRC_KEYS = ("dc", "amplitude", "freq", "phase", "v1", "v2", "delay", "rise",
            "fall", "width", "period")

# topo header slots, csrc/newton.cuh ``enum Hdr``
(H_NP1, H_NE, H_NR, H_NC, H_NL, H_NV, H_NI, H_ENT, H_SRC, H_CN, H_LN, H_KS,
 H_ND, H_NRC, H_NDD, H_NQ, H_NM, H_DN, H_QN, H_MN, H_NLIN, H_KJ, H_DOFF,
 H_QOFF, H_MOFF, H_NLM, H_NK, H_KP, H_LB, H_LMN, H_CORE, H_ROWS) = range(32)
H_LEN = 32


def kind_counts(cc, kinds=DEVICE_KINDS):
    """The counts of ``kinds`` in the deck: (nR, nC, nL, nV, nI, nD, nQ,
    nM) by default."""
    return tuple(cc.kind_count(k) if k in cc.idx else 0 for k in kinds)


def nonlinear(cc):
    """Whether the deck has a diode, BJT or MOSFET (a Newton per solve)."""
    return any(k in cc.idx for k in NL_KINDS)


def semantics_reason(semantics: str):
    """Why the port can NOT run this semantics in an OP, DC sweep or AC;
    None when it can (compat or physics, whatever the integration: compat
    stamps backward Euler under either, as the JAX package does)."""
    if semantics not in ("compat", "physics"):
        return f"semantics={semantics!r} (the port runs compat and physics)"
    return None


def tran_semantics_reason(semantics: str, opts):
    """Why the port can NOT run this semantics and integration in a
    transient; None when it can (compat BE, physics BE or trap)."""
    why = semantics_reason(semantics)
    if why is not None:
        return why
    if opts is not None and opts.integration != "be" \
            and semantics != "physics":
        return (f"integration={opts.integration!r} requires "
                "semantics='physics' (compat reproduces the reference's "
                "backward Euler)")
    return None


def fused_ineligible_reason(cc, semantics: str, store: str, opts):
    """Why the port can NOT run this deck; None when it can."""
    why = tran_semantics_reason(semantics, opts)
    if why is not None:
        return why
    if store not in ("none", "full"):
        return (f"store={store!r} (the whole-run kernel serves 'none' and "
                "'full')")
    extra = set(cc.idx.keys()) - set(SLICE_KINDS)
    if extra:
        return (f"device kinds {sorted(extra)} are not ported (the port "
                "runs R, C, L, LM, K, V, I, D, Q and M)")
    return None


def state_layout(nc, nl, nd=0, nm=0, physics=False, nlm=0):
    """Row offsets of the committed state stack: the compat C/L rows, and
    under physics then ``PHYS_ROWS`` (keys "c_i0", "d_prev_charge", ...)
    and the LM rows ``LM_STATE`` (keys "lm_i0", ..., "lm_dMdH")."""
    out = {"c_q0": 0, "c_q1": nc, "c_v0": 2 * nc, "c_v1": 3 * nc,
           "l_i0": 4 * nc, "l_i1": 4 * nc + nl, "l_v0": 4 * nc + 2 * nl,
           "l_v1": 4 * nc + 3 * nl, "l_flux0": 4 * nc + 4 * nl}
    row = 4 * nc + 5 * nl
    if physics:
        for kind, nk in (("C", nc), ("L", nl), ("D", nd), ("M", nm)):
            for key in PHYS_ROWS[kind]:
                out[f"{kind.lower()}_{key}"] = row
                row += nk
        for key in LM_STATE:
            out[f"lm_{key}"] = row
            row += nlm
    out["ks"] = row
    return out


def build_plan(cc, mode="tran"):
    """Stamp entries (E, 5) int32 in the general engine's scatter order:
    kind by kind, pattern slot by slot, device by device; and the count of
    leading linear entries (the OP's linear initial estimate uses those)."""
    assert mode in ("tran", "op")
    tran = mode == "tran"
    ents = []

    def add(rows, cols, tag, idx, sign):
        rows = np.asarray(rows).ravel()
        cols = np.asarray(cols).ravel()
        idx = np.broadcast_to(np.asarray(idx), rows.shape)
        sign = np.broadcast_to(np.asarray(sign), rows.shape)
        for r, c, k, s in zip(rows, cols, idx, sign):
            if r != 0:  # the ground row is the identity
                ents.append((int(r), int(c), tag, int(k), int(s)))

    def seq(n):
        return np.arange(n)

    rhs = cc.np1
    if "R" in cc.idx:
        n = np.asarray(cc.idx["R"]["nodes"])
        for (a, b), s in (((0, 0), 1), ((0, 1), -1), ((1, 0), -1),
                          ((1, 1), 1)):
            add(n[:, a], n[:, b], TAG_G, seq(len(n)), s)
    if "C" in cc.idx:
        n = np.asarray(cc.idx["C"]["nodes"])
        for (a, b), s in (((0, 0), 1), ((0, 1), -1), ((1, 0), -1),
                          ((1, 1), 1)):
            add(n[:, a], n[:, b], TAG_GEQ, seq(len(n)), s)
        if tran:  # the OP stamps only the gmin leak
            add(n[:, 0], np.full(len(n), rhs), TAG_CEQ, seq(len(n)), 1)
            add(n[:, 1], np.full(len(n), rhs), TAG_CEQ, seq(len(n)), -1)
    if "L" in cc.idx:
        n = np.asarray(cc.idx["L"]["nodes"])
        br = np.asarray(cc.idx["L"]["branch"])
        k = seq(len(br))
        # inductor sign convention n1 -> -1, n2 -> +1 (inductor.go:59-66)
        add(n[:, 0], br, TAG_ONE, k, -1)
        add(br, n[:, 0], TAG_ONE, k, -1)
        add(n[:, 1], br, TAG_ONE, k, 1)
        add(br, n[:, 1], TAG_ONE, k, 1)
        add(br, br, TAG_LTERM, k, -1)
        add(br, np.full(len(br), rhs), TAG_LRHS, k, 1)
    if "LM" in cc.idx:  # magnetic.go:197-274: the branch value, or in the
        # OP the +1e-3 branch diagonal (magnetic.go:216-217)
        n = np.asarray(cc.idx["LM"]["nodes"])
        br = np.asarray(cc.idx["LM"]["branch"])
        k = seq(len(br))
        add(n[:, 0], br, TAG_ONE, k, -1)
        add(br, n[:, 0], TAG_ONE, k, -1)
        add(n[:, 1], br, TAG_ONE, k, 1)
        add(br, n[:, 1], TAG_ONE, k, 1)
        add(br, br, TAG_LMTERM, k, -1)
        if tran:
            add(br, np.full(len(br), rhs), TAG_LMRHS, k, 1)
    if "V" in cc.idx:
        n = np.asarray(cc.idx["V"]["nodes"])
        br = np.asarray(cc.idx["V"]["branch"])
        k = seq(len(br))
        # voltage-source convention n1 -> +1 (vsource.go:140-147)
        add(br, n[:, 0], TAG_ONE, k, 1)
        add(n[:, 0], br, TAG_ONE, k, 1)
        add(br, n[:, 1], TAG_ONE, k, -1)
        add(n[:, 1], br, TAG_ONE, k, -1)
        add(br, np.full(len(br), rhs), TAG_VSRC, k, 1)
    if "I" in cc.idx:
        n = np.asarray(cc.idx["I"]["nodes"])
        add(n[:, 0], np.full(len(n), rhs), TAG_ISRC, seq(len(n)), 1)
        add(n[:, 1], np.full(len(n), rhs), TAG_ISRC, seq(len(n)), -1)
    if "K" in cc.idx and tran:
        # mutual.go:57-120: -M/dt between the windings' branch rows, and
        # the reference's junk-i0 memory -M·i0_b/dt, -M·i0_a/dt
        ba = np.asarray(cc.idx["K"]["branch_a"])
        bb = np.asarray(cc.idx["K"]["branch_b"])
        k = seq(len(ba))
        add(ba, bb, TAG_KTERM, k, -1)
        add(bb, ba, TAG_KTERM, k, -1)
        add(ba, np.full(len(ba), rhs), TAG_KRHSA, k, -1)
        add(bb, np.full(len(bb), rhs), TAG_KRHSB, k, -1)
    n_lin = len(ents)

    base = 0
    if "D" in cc.idx:  # diode.go:184-227: slot 0 gd, slot 1 id - gd·vd
        n = np.asarray(cc.idx["D"]["nodes"])
        nd = len(n)

        def slot(s):
            return base + s * nd + seq(nd)

        for (a, b), s in (((0, 0), 1), ((0, 1), -1), ((1, 0), -1),
                          ((1, 1), 1)):
            add(n[:, a], n[:, b], TAG_NL, slot(0), s)
        add(n[:, 0], np.full(nd, rhs), TAG_NL, slot(1), -1)
        add(n[:, 1], np.full(nd, rhs), TAG_NL, slot(1), 1)
        base += NL_SLOTS["D"] * nd
    if "Q" in cc.idx:  # assemble.py's BJT block: 9 matrix, 3 RHS slots
        n = np.asarray(cc.idx["Q"]["nodes"])
        nq = len(n)
        c, b_, e = n[:, 0], n[:, 1], n[:, 2]
        for s, (r, col) in enumerate(((c, b_), (c, e), (c, c), (b_, b_),
                                      (b_, e), (b_, c), (e, b_), (e, e),
                                      (e, c))):
            add(r, col, TAG_NL, base + s * nq + seq(nq), 1)
        for s, r in enumerate((c, b_, e)):
            add(r, np.full(nq, rhs), TAG_NL, base + (9 + s) * nq + seq(nq),
                1)
        base += NL_SLOTS["Q"] * nq
    if "M" in cc.idx:  # mosfet.go:668-786 as assemble.py stamps it
        n = np.asarray(cc.idx["M"]["nodes"])
        nm = len(n)
        d, g, s_, b_ = n[:, 0], n[:, 1], n[:, 2], n[:, 3]

        def slot(k):
            return base + k * nm + seq(nm)

        for k, (r, col) in enumerate(((d, d), (d, g), (d, s_), (d, b_),
                                      (s_, s_), (s_, d), (s_, g), (s_, b_))):
            add(r, col, TAG_NL, slot(k), 1)
        add(d, np.full(nm, rhs), TAG_NL, slot(8), 1)
        add(s_, np.full(nm, rhs), TAG_NL, slot(8), -1)
        if tran:
            for k, (r, col) in ((9, (g, d)), (9, (d, g)), (10, (g, s_)),
                                (10, (s_, g)), (11, (g, b_)), (11, (b_, g)),
                                (12, (g, g)), (13, (b_, s_)), (13, (s_, b_)),
                                (14, (b_, d)), (14, (d, b_)), (15, (b_, b_))):
                add(r, col, TAG_NL, slot(k), 1)
            # the charge currents, each masked by the OTHER terminal's
            # ground check (mosfet.go:744-782): sign 0 where it is ground
            def on(node):
                return (node != 0).astype(np.int64)

            col = np.full(nm, rhs)
            for k, r, other, sgn in ((16, g, d, 1), (16, d, g, -1),
                                     (17, g, s_, 1), (17, s_, g, -1),
                                     (18, g, b_, 1), (18, b_, g, -1),
                                     (19, b_, s_, 1), (19, s_, b_, -1),
                                     (20, b_, d, 1), (20, d, b_, -1)):
                add(r, col, TAG_NL, slot(k), sgn * on(other))
        base += NL_SLOTS["M"] * nm
    return np.asarray(ents, dtype=np.int32).reshape(-1, 5), n_lin


def row_view(entries, np1):
    """The entries bucketed by row: (the (E, 4) int32 (col, tag, index,
    sign) of the entries stably sorted by row, so that each row keeps plan
    order, and the (np1 + 1,) int32 offsets of each row's first entry)."""
    order = np.argsort(entries[:, 0], kind="stable")
    view = np.ascontiguousarray(entries[order][:, 1:], dtype=np.int32)
    counts = np.bincount(entries[:, 0], minlength=np1)[:np1]
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return view, offsets


def linear_prefix(entries, n_lin, np1):
    """The (np1,) int32 count of each row's entries among the plan's
    leading n_lin (the linear stamps): since they lead the plan and the row
    view keeps plan order within a row, they are a prefix of that row's
    part of the view."""
    return np.bincount(entries[:n_lin, 0], minlength=np1)[:np1].astype(
        np.int32)


@dataclass
class RunPlan:
    """Static tables of one deck (host numpy) for one stamp mode."""

    np1: int
    mode: str  # "tran" or "op" (build_plan)
    physics: bool  # the physics state rows (state_layout)
    counts: tuple  # (nR, nC, nL, nV, nI, nD, nQ, nM)
    nlm: int  # magnetic inductors
    nk: int  # mutual-coupling pairs
    kpairs: np.ndarray  # (nK, 4) int32 kind_a, idx_a, kind_b, idx_b
    lm_tab: np.ndarray  # (nLM, 3) int32 n1, n2, branch row
    core: np.ndarray  # (nLM,) int32 core id
    entries: np.ndarray  # (E, 5) int32
    n_lin: int  # the leading linear entries
    c_nodes: np.ndarray  # (nC, 2) int32
    l_nodes: np.ndarray  # (nL, 2) int32
    l_branch: np.ndarray  # (nL,) int32 branch rows
    stype: dict  # kind -> (nS,) source type codes
    knots: dict  # kind -> P, the padded PWL knot count
    src_offset: dict  # kind -> (nS,) record offsets into the src rows
    nrc: int  # width of the src rows
    layout: dict  # state_layout
    dev_offset: dict  # nonlinear kind -> offset of its block in dev rows
    idx: dict  # D/Q/M "nodes" (and M "level") tables of the deck
    topo: np.ndarray  # int32 table for the kernel

    @property
    def base_len(self):
        """Length of the table before the row view."""
        return int(self.topo[H_ROWS])

    @property
    def nd(self):
        """Width of the dev rows."""
        return int(self.topo[H_ND])

    @property
    def ks(self):
        """Width of the state rows."""
        return int(self.topo[H_KS])

    @property
    def kj(self):
        """Junction-voltage rows: nD + 2·nQ + 3·nM."""
        return int(self.topo[H_KJ])

    @property
    def nonlinear(self):
        return self.kj > 0


def mag_width(nlm, nk, physics):
    """The magnetic run constants' width in the dev rows: compat's L0,
    L_eff, i0 and i1 per LM and M per K; physics' ``LM_PHYS_ROWS`` per LM
    and the coefficient per K."""
    return (len(LM_PHYS_ROWS) if physics else 4) * nlm + nk


def make_plan(cc, mode="tran", physics=False) -> RunPlan:
    nr, nc, nl, nv, ni, n_d, n_q, n_m = counts = kind_counts(cc)
    nlm, nk = kind_counts(cc, MAG_KINDS)
    entries, n_lin = build_plan(cc, mode)
    kpairs = np.zeros((0, 4), np.int32)
    if nk:
        kidx = cc.idx["K"]
        kpairs = np.stack([np.asarray(kidx[key], np.int32) for key in
                           ("kind_a", "idx_a", "kind_b", "idx_b")], axis=1)
    c_nodes = (np.asarray(cc.idx["C"]["nodes"], np.int32).reshape(-1, 2)
               if nc else np.zeros((0, 2), np.int32))
    l_nodes = (np.asarray(cc.idx["L"]["nodes"], np.int32).reshape(-1, 2)
               if nl else np.zeros((0, 2), np.int32))
    stype, knots, src_offset = {}, {}, {}
    off = 0
    src_rows = []
    for kind, ns in (("V", nv), ("I", ni)):
        if not ns:
            continue
        stype[kind] = np.asarray(cc.idx[kind]["stype"], np.int32)
        P = int(np.asarray(cc.params[kind]["pwl_t"]).shape[-1])
        knots[kind] = P
        width = len(SRC_KEYS) + 2 * P
        src_offset[kind] = off + width * np.arange(ns, dtype=np.int32)
        for k in range(ns):
            src_rows.append((int(stype[kind][k]), off + width * k, P))
        off += width * ns
    layout = state_layout(nc, nl, n_d, n_m, physics, nlm)

    # nonlinear device nodes: D (n1, n2), Q (c, b, e), M (d, g, s, b, level)
    def nodes(kind, cols):
        if kind not in cc.idx:
            return np.zeros(0, np.int32)
        return np.asarray(cc.idx[kind]["nodes"], np.int32)[:, :cols]

    m_tab = np.zeros((0, 5), np.int32)
    if n_m:
        m_tab = np.concatenate(
            [nodes("M", 4), np.asarray(cc.idx["M"]["level"],
                                       np.int32)[:, None]], axis=1)
    dev_offset = {}
    row = nr + 2 * nc + nl + mag_width(nlm, nk, physics)
    for kind, count in (("D", n_d), ("Q", n_q), ("M", n_m)):
        dev_offset[kind] = row
        row += len(NL_ROWS[kind]) * count

    l_branch = (np.asarray(cc.idx["L"]["branch"], np.int32) if nl
                else np.zeros(0, np.int32))
    # each LM's (n1, n2, branch) and core, for the physics commit
    lm_tab = np.zeros((0, 3), np.int32)
    core = np.zeros(0, np.int32)
    if nlm:
        lm_tab = np.concatenate(
            [np.asarray(cc.idx["LM"]["nodes"], np.int32)[:, :2],
             np.asarray(cc.idx["LM"]["branch"], np.int32)[:, None]], axis=1)
        core = np.asarray(cc.idx["LM"]["core_id"], np.int32)
    hdr = np.zeros(H_LEN, np.int32)
    parts = [entries.ravel(), np.asarray(src_rows, np.int32).ravel(),
             c_nodes.ravel(), l_nodes.ravel(), nodes("D", 2).ravel(),
             nodes("Q", 3).ravel(), m_tab.ravel(), kpairs.ravel(), l_branch,
             lm_tab.ravel(), core]
    pos = H_LEN
    for key, part in zip((H_ENT, H_SRC, H_CN, H_LN, H_DN, H_QN, H_MN, H_KP,
                          H_LB, H_LMN, H_CORE), parts):
        hdr[key] = pos
        pos += part.size
    hdr[H_NP1] = cc.np1
    hdr[H_NE] = len(entries)
    hdr[H_NR], hdr[H_NC], hdr[H_NL], hdr[H_NV], hdr[H_NI] = nr, nc, nl, nv, ni
    hdr[H_NDD], hdr[H_NQ], hdr[H_NM] = n_d, n_q, n_m
    hdr[H_NLM], hdr[H_NK] = nlm, nk
    hdr[H_KS] = max(layout["ks"], 1)  # stack widths: a dummy row when 0
    hdr[H_ND] = max(row, 1)
    hdr[H_NRC] = max(off, 1)
    hdr[H_NLIN] = n_lin
    hdr[H_KJ] = n_d + 2 * n_q + 3 * n_m
    hdr[H_DOFF], hdr[H_QOFF], hdr[H_MOFF] = (dev_offset["D"], dev_offset["Q"],
                                             dev_offset["M"])
    # the row view, at a multiple of 4 words; an OP plan's linear prefixes
    view, offsets = row_view(entries, cc.np1)
    pad = -pos % 4
    hdr[H_ROWS] = pos + pad
    parts += [np.zeros(pad, np.int32), view.ravel(), offsets]
    if mode == "op":
        parts.append(linear_prefix(entries, n_lin, cc.np1))
    topo = np.concatenate([hdr] + parts).astype(np.int32)
    return RunPlan(np1=cc.np1, mode=mode, physics=bool(physics),
                   counts=counts, nlm=nlm, nk=nk,
                   kpairs=kpairs, lm_tab=lm_tab, core=core, entries=entries,
                   n_lin=n_lin, c_nodes=c_nodes, l_nodes=l_nodes,
                   l_branch=l_branch,
                   stype=stype, knots=knots, src_offset=src_offset,
                   nrc=max(off, 1), layout=layout, dev_offset=dev_offset,
                   idx={k: cc.idx[k] for k in NL_KINDS if k in cc.idx},
                   topo=topo)


# ------------------------------------------------------------ lane tables


def first_leaf(tree):
    """The first leaf of a {kind: {key: tensor}} tree (its device is the
    run's)."""
    for tbl in tree.values():
        for leaf in tbl.values():
            return leaf
    raise ValueError("empty parameter tree")


def infer_batch(params, state0):
    """Lane count: the leading axis of any batched leaf, else 1."""
    b = 1
    for tbl in params.values():
        for key, leaf in tbl.items():
            batched_ndim = 3 if key in ("pwl_t", "pwl_v") else 2
            if leaf.ndim == batched_ndim:
                b = max(b, int(leaf.shape[0]))
    for tbl in state0.values():
        for leaf in tbl.values():
            if leaf.ndim == 2:
                b = max(b, int(leaf.shape[0]))
    return b


def lanes(leaf, b):
    """(nk,) shared or (B, nk) batched leaf -> (b, nk) f64."""
    leaf = leaf.to(torch.float64)
    if leaf.ndim == 1:
        leaf = leaf[None, :]
    return leaf.expand(b, leaf.shape[1])


def nl_row_values(kind, p, st, temp):
    """The ``NL_ROWS`` of one nonlinear kind as a list of (nk,) or (B, nk)
    tensors, computed by the same model functions the general engine
    stamps with; ``st`` is the kind's committed state (None: zeros), whose
    frozen charges the diode and MOSFET read."""
    if kind == "D":
        vte, vc = limiter_constants(p, "n", "is_")
        vals = {"nvt": p["n"] * diode.thermal_voltage(temp),
                "is_t": diode.temperature_adjusted_is(p, temp),
                "vte": vte, "vcrit": vc}
    elif kind == "Q":
        vbe0, vbc0, _ = bjt.cold_start_bias(p, temp)
        vtef, vcritf = limiter_constants(p, "nf", "ies")
        vter, vcritr = limiter_constants(p, "nr", "ics")
        vals = dict(bjt.inverses(p, temp), vbe0=vbe0, vbc0=vbc0, vtef=vtef,
                    vcritf=vcritf, vter=vter, vcritr=vcritr)
    else:
        vals = {}
    for key in NL_ROWS[kind]:
        if key not in vals and key not in p:  # a frozen state leaf
            vals[key] = (torch.zeros_like(p["sign" if kind == "M" else "n"])
                         if st is None else st[key])
    return [vals[key] if key in vals else p[key] for key in NL_ROWS[kind]]


def magnetic_rows(plan, params, b, device, temp, state0):
    """The magnetic run constants.  Compat (``_run_const64`` of the JAX
    package): per LM, L0, the frozen-core L_eff (``l_effective``) and the
    frozen i0 and i1; per K, M = k·sqrt(La·Lb) with a linear partner's
    value or an LM partner's ``value_for_mutual`` at its frozen core.
    Physics: per LM the ``LM_PHYS_ROWS`` (the core moves, so L and M are
    the kernel's to compute from the state rows), per K its coefficient."""
    nl, nlm = plan.counts[2], plan.nlm
    if plan.physics:
        rows = []
        if nlm:
            pm = params["LM"]
            vals = {"l0": magnetic.l_zero(pm),
                    "mst": magnetic.saturation(pm, JA_COMMIT_TEMP)}
            rows += [lanes(vals[key] if key in vals else pm[key], b)
                     for key in LM_PHYS_ROWS]
        if plan.nk:
            rows.append(lanes(params["K"]["coeff"], b))
        return rows
    rows = []
    if nlm:
        pm = {key: lanes(leaf, b) for key, leaf in params["LM"].items()}
        stm = (state0 or {}).get("LM")

        def lmrow(key):
            if stm is None:
                return torch.zeros((b, nlm), dtype=torch.float64,
                                   device=device)
            return lanes(stm[key], b)

        core = magnetic.CoreState(*(lmrow(key) for key in CORE_KEYS))
        i0 = lmrow("i0")
        leff, _ = magnetic.l_effective(pm, core, i0, temp)
        rows += [magnetic.l_zero(pm), leff, i0, lmrow("i1")]
    if plan.nk:
        lval = lanes(params["L"]["value"], b) if nl else None
        lm_vm = (magnetic.value_for_mutual(pm, core, i0, temp) if nlm
                 else None)

        def partner(kinds, idxs):
            return torch.stack([lval[:, i] if kk == 0 else lm_vm[:, i]
                                for kk, i in zip(kinds, idxs)], dim=1)

        kp = plan.kpairs
        la = partner(kp[:, 0], kp[:, 1])
        lb = partner(kp[:, 2], kp[:, 3])
        rows.append(lanes(params["K"]["coeff"], b) * torch.sqrt(la * lb))
    return [row.expand(b, row.shape[1]) for row in rows]


def const_stack(plan, params, b, device, temp=TEMP_DEFAULT, state0=None):
    """Per-lane device rows (b, nd): g = 1/R_t, C_t, C, L (the general
    engine's stamp and commit values; _t = temperature adjusted), the
    compat magnetic run constants (``magnetic_rows``), then the nonlinear
    devices' ``NL_ROWS``.  ``state0`` supplies the frozen compat charges of
    D and M and the frozen LM currents and cores (zeros when it is
    None)."""
    nr, nc, nl = plan.counts[:3]
    dtemp = temp - TEMP_DEFAULT

    def tadj(tbl):
        return tbl["value"] * (1.0 + tbl["tc1"] * dtemp
                               + tbl["tc2"] * dtemp * dtemp)

    rows = []
    if nr:
        rows.append(lanes(1.0 / tadj(params["R"]), b))
    if nc:
        rows.append(lanes(tadj(params["C"]), b))
        rows.append(lanes(params["C"]["value"], b))
    if nl:
        rows.append(lanes(params["L"]["value"], b))
    rows += magnetic_rows(plan, params, b, device, temp, state0)
    for kind in NL_KINDS:
        if kind in params:
            st = (state0 or {}).get(kind)
            rows += [lanes(val, b) for val in
                     nl_row_values(kind, params[kind], st, temp)]
    if not rows:
        return torch.zeros((b, 1), dtype=torch.float64, device=device)
    return torch.cat(rows, dim=1).contiguous()


def nl_params(plan, dev, kind):
    """One nonlinear kind's dev rows read back as (B, nk) leaves keyed by
    ``NL_ROWS`` (the plain versions' device parameters)."""
    nk = plan.counts[5 + NL_KINDS.index(kind)]
    off = plan.dev_offset[kind]
    return {key: dev[:, off + r * nk: off + (r + 1) * nk]
            for r, key in enumerate(NL_ROWS[kind])}


def jv_stack(plan, jv, b):
    """Junction-voltage tree (leaves (nk,) or (B, nk), ``nlstate``'s form)
    -> the (b, kj) rows D vd | Q vbe | Q vbc | M vgs | M vds | M vbs."""
    keys = (("D", ("vd",)), ("Q", ("vbe", "vbc")),
            ("M", ("vgs", "vds", "vbs")))
    rows = [lanes(jv[kind][key], b) for kind, names in keys if kind in jv
            for key in names]
    return torch.cat(rows, dim=1).contiguous()


def jv_tree(plan, jvs):
    """(B, kj) rows -> the nlstate tree with (B, nk) leaves; the BJT's vce
    is vbe - vbc, as update_jv keeps it."""
    n_d, n_q, n_m = plan.counts[5:]
    jv = {}
    off = 0
    if n_d:
        jv["D"] = {"vd": jvs[:, :n_d]}
        off = n_d
    if n_q:
        vbe = jvs[:, off:off + n_q]
        vbc = jvs[:, off + n_q:off + 2 * n_q]
        jv["Q"] = {"vbe": vbe, "vbc": vbc, "vce": vbe - vbc}
        off += 2 * n_q
    if n_m:
        jv["M"] = {key: jvs[:, off + i * n_m:off + (i + 1) * n_m]
                   for i, key in enumerate(("vgs", "vds", "vbs"))}
    return jv


def source_stack(plan, params, b, device):
    """Per-lane source records (b, nrc), V sources then I sources."""
    cols = []
    for kind in ("V", "I"):
        if kind not in plan.stype:
            continue
        p = params[kind]
        ns = len(plan.stype[kind])
        P = plan.knots[kind]
        recs = [torch.stack([lanes(p[key], b) for key in SRC_KEYS], dim=2)]
        for key in ("pwl_t", "pwl_v"):
            knot = p[key].to(torch.float64)
            if knot.ndim == 2:
                knot = knot[None]
            recs.append(knot.expand(b, ns, P))
        cols.append(torch.cat(recs, dim=2).reshape(b, -1))
    if not cols:
        return torch.zeros((b, 1), dtype=torch.float64, device=device)
    return torch.cat(cols, dim=1).contiguous()


def source_leaves(plan, src, kind):
    """The per-lane source params of one kind, read back from the src rows
    as ``models/sources`` leaves: (B, nS) and (B, nS, P) knots."""
    off = torch.as_tensor(plan.src_offset[kind], device=src.device,
                          dtype=torch.long)
    P = plan.knots[kind]
    p = {key: src[:, off + i] for i, key in enumerate(SRC_KEYS)}
    base = off[:, None] + len(SRC_KEYS)
    knot = torch.arange(P, device=src.device)[None, :]
    p["pwl_t"] = src[:, base + knot]
    p["pwl_v"] = src[:, base + P + knot]
    return p


def init_state_stack(plan, state0, b, device):
    """Initial committed state (b, ks) in ``state_layout`` order."""
    nc, nl = plan.counts[1:3]
    rows = []

    def srow(kind, key):
        return lanes(state0[kind][key], b)

    if nc:
        rows += [srow("C", k) for k in ("q0", "q1", "v0", "v1")]
    if nl:
        rows += [srow("L", k) for k in ("i0", "i1", "v0", "v1", "flux0")]
    if plan.physics:
        for kind in ("C", "L", "D", "M"):
            if plan.counts[DEVICE_KINDS.index(kind)]:
                rows += [srow(kind, k) for k in PHYS_ROWS[kind]]
        if plan.nlm:
            rows += [srow("LM", k) for k in LM_STATE]
    if not rows:
        return torch.zeros((b, 1), dtype=torch.float64, device=device)
    return torch.cat(rows, dim=1).contiguous()


def unpack_state(plan, st, state0, accepted, b):
    """Final state stack -> the state dict of the JAX package's
    ``_unpack_state_jv``: C/L rows from the stack; under compat C.i0
    passed through, hist set on lanes that accepted a step, LM/D/Q/M
    passed through; under physics C.i0, every hist and the D, M and LM
    rows from the stack, Q passed through."""
    nc, nl = plan.counts[1:3]
    L = plan.layout
    started = (accepted > 0)[:, None]

    def grab(key, nk):
        return st[:, L[key]:L[key] + nk]

    def phys(kind, nk):
        return {key: grab(f"{kind.lower()}_{key}", nk)
                for key in PHYS_ROWS[kind]}

    def hist(kind):
        return torch.where(started, 1.0, lanes(state0[kind]["hist"], b))

    state = {}
    if nc:
        state["C"] = {
            "q0": grab("c_q0", nc), "q1": grab("c_q1", nc),
            "v0": grab("c_v0", nc), "v1": grab("c_v1", nc),
            **(phys("C", nc) if plan.physics else {
                "i0": lanes(state0["C"]["i0"], b).clone(),
                "hist": hist("C")}),
        }
    if nl:
        state["L"] = {
            "i0": grab("l_i0", nl), "i1": grab("l_i1", nl),
            "v0": grab("l_v0", nl), "v1": grab("l_v1", nl),
            "flux0": grab("l_flux0", nl),
            **(phys("L", nl) if plan.physics else {"hist": hist("L")}),
        }
    # compat never commits LM, D, Q or M state (PLAN.md 1), physics never
    # Q: pass it through, broadcast to the batch
    for kind in ("LM",) + NL_KINDS:
        if kind not in state0:
            continue
        if plan.physics and kind == "LM":
            state[kind] = {key: grab(f"lm_{key}", plan.nlm)
                           for key in LM_STATE}
        elif plan.physics and kind in ("D", "M"):
            state[kind] = phys(kind, plan.counts[DEVICE_KINDS.index(kind)])
        else:
            state[kind] = {key: lanes(leaf, b).clone()
                           for key, leaf in state0[kind].items()}
    return state
