"""Host-side tables of the whole-run transient for linear compat decks.

The counterpart of ``ops/pallas_tran.py``'s ``_build_plan``, ``_layout``,
``_const_stack64``, ``_init_state_stack64``, ``_unpack_state_jv`` and
``fused_ineligible_reason`` in the JAX package, for R/C/L/V/I decks.  The
TPU kernel unrolls its stamp plan at trace time; here the plan is data, so
one compiled kernel (``csrc/run_kernel.cu``) serves every eligible deck:

* ``entries``: int32 (row, col, tag, index, sign) stamps in the order the
  general engine scatters them (ops/assemble.py), so each cell sums its
  terms in the same order.  Column ``np1`` is the right-hand side; stamps
  into the ground row 0 are dropped (that row is the identity).
* per-lane f64 rows, batch axis first: ``dev`` (B, nd) holds g = 1/R_t,
  C_t, C, L; ``src`` (B, nrc) one record per source (``SRC_KEYS`` then the
  P knot times and P knot values); ``state`` (B, ks) the committed C/L
  rows.
* ``topo``: the int32 table the kernel copies to shared memory (a header
  of counts and offsets, then the entries, sources and device nodes).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..consts import TEMP_DEFAULT

SLICE_KINDS = ("R", "C", "L", "V", "I")

# stamp tags, csrc/run_kernel.cu ``enum Tag``
(TAG_G, TAG_GEQ, TAG_LTERM, TAG_ONE, TAG_CEQ, TAG_LRHS, TAG_VSRC,
 TAG_ISRC) = range(8)

# the scalar leaves of one source record, in record order
SRC_KEYS = ("dc", "amplitude", "freq", "phase", "v1", "v2", "delay", "rise",
            "fall", "width", "period")

# topo header slots, csrc/run_kernel.cu ``enum Hdr``
(H_NP1, H_NE, H_NR, H_NC, H_NL, H_NV, H_NI, H_ENT, H_SRC, H_CN, H_LN, H_KS,
 H_ND, H_NRC) = range(14)
H_LEN = 16


def kind_counts(cc):
    """(nR, nC, nL, nV, nI) of the slice's kinds."""
    return tuple(cc.kind_count(k) if k in cc.idx else 0 for k in SLICE_KINDS)


def fused_ineligible_reason(cc, semantics: str, store: str, opts):
    """Why the port can NOT run this deck; None when it can."""
    if semantics != "compat":
        return (f"semantics={semantics!r} (the port runs compat semantics "
                "only)")
    if opts.integration != "be":
        return f"integration={opts.integration!r} (compat is backward Euler)"
    if store != "none":
        return (f"store={store!r} (the whole-run kernel serves "
                "store='none')")
    extra = set(cc.idx.keys()) - set(SLICE_KINDS)
    if extra:
        return (f"device kinds {sorted(extra)} are not ported (the port "
                "runs R, C, L, V and I)")
    return None


def state_layout(nc, nl):
    """Row offsets of the committed compat state stack."""
    return {"c_q0": 0, "c_q1": nc, "c_v0": 2 * nc, "c_v1": 3 * nc,
            "l_i0": 4 * nc, "l_i1": 4 * nc + nl, "l_v0": 4 * nc + 2 * nl,
            "l_v1": 4 * nc + 3 * nl, "l_flux0": 4 * nc + 4 * nl,
            "ks": 4 * nc + 5 * nl}


def build_plan(cc):
    """Stamp entries (E, 5) int32 in the general engine's scatter order:
    kind by kind, pattern slot by slot, device by device."""
    ents = []

    def add(rows, cols, tag, sign):
        rows = np.asarray(rows).ravel()
        cols = np.asarray(cols).ravel()
        for k, (r, c) in enumerate(zip(rows, cols)):
            if r != 0:  # the ground row is the identity
                ents.append((int(r), int(c), tag, k, sign))

    rhs = cc.np1
    if "R" in cc.idx:
        n = np.asarray(cc.idx["R"]["nodes"])
        for (a, b), s in (((0, 0), 1), ((0, 1), -1), ((1, 0), -1),
                          ((1, 1), 1)):
            add(n[:, a], n[:, b], TAG_G, s)
    if "C" in cc.idx:
        n = np.asarray(cc.idx["C"]["nodes"])
        for (a, b), s in (((0, 0), 1), ((0, 1), -1), ((1, 0), -1),
                          ((1, 1), 1)):
            add(n[:, a], n[:, b], TAG_GEQ, s)
        add(n[:, 0], np.full(len(n), rhs), TAG_CEQ, 1)
        add(n[:, 1], np.full(len(n), rhs), TAG_CEQ, -1)
    if "L" in cc.idx:
        n = np.asarray(cc.idx["L"]["nodes"])
        br = np.asarray(cc.idx["L"]["branch"])
        # inductor sign convention n1 -> -1, n2 -> +1 (inductor.go:59-66)
        add(n[:, 0], br, TAG_ONE, -1)
        add(br, n[:, 0], TAG_ONE, -1)
        add(n[:, 1], br, TAG_ONE, 1)
        add(br, n[:, 1], TAG_ONE, 1)
        add(br, br, TAG_LTERM, -1)
        add(br, np.full(len(br), rhs), TAG_LRHS, 1)
    if "V" in cc.idx:
        n = np.asarray(cc.idx["V"]["nodes"])
        br = np.asarray(cc.idx["V"]["branch"])
        # voltage-source convention n1 -> +1 (vsource.go:140-147)
        add(br, n[:, 0], TAG_ONE, 1)
        add(n[:, 0], br, TAG_ONE, 1)
        add(br, n[:, 1], TAG_ONE, -1)
        add(n[:, 1], br, TAG_ONE, -1)
        add(br, np.full(len(br), rhs), TAG_VSRC, 1)
    if "I" in cc.idx:
        n = np.asarray(cc.idx["I"]["nodes"])
        add(n[:, 0], np.full(len(n), rhs), TAG_ISRC, 1)
        add(n[:, 1], np.full(len(n), rhs), TAG_ISRC, -1)
    return np.asarray(ents, dtype=np.int32).reshape(-1, 5)


@dataclass
class RunPlan:
    """Static tables of one deck (host numpy)."""

    np1: int
    counts: tuple  # (nR, nC, nL, nV, nI)
    entries: np.ndarray  # (E, 5) int32
    c_nodes: np.ndarray  # (nC, 2) int32
    l_nodes: np.ndarray  # (nL, 2) int32
    stype: dict  # kind -> (nS,) source type codes
    knots: dict  # kind -> P, the padded PWL knot count
    src_offset: dict  # kind -> (nS,) record offsets into the src rows
    nrc: int  # width of the src rows
    layout: dict  # state_layout
    topo: np.ndarray  # int32 table for the kernel

    @property
    def nd(self):
        """Width of the dev rows."""
        return int(self.topo[H_ND])

    @property
    def ks(self):
        """Width of the state rows."""
        return int(self.topo[H_KS])


def make_plan(cc) -> RunPlan:
    nr, nc, nl, nv, ni = kind_counts(cc)
    entries = build_plan(cc)
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
    layout = state_layout(nc, nl)

    hdr = np.zeros(H_LEN, np.int32)
    parts = [entries.ravel(), np.asarray(src_rows, np.int32).ravel(),
             c_nodes.ravel(), l_nodes.ravel()]
    pos = H_LEN
    for slot, part in zip((H_ENT, H_SRC, H_CN, H_LN), parts):
        hdr[slot] = pos
        pos += part.size
    hdr[H_NP1] = cc.np1
    hdr[H_NE] = len(entries)
    hdr[H_NR], hdr[H_NC], hdr[H_NL], hdr[H_NV], hdr[H_NI] = nr, nc, nl, nv, ni
    hdr[H_KS] = max(layout["ks"], 1)  # stack widths: a dummy row when 0
    hdr[H_ND] = max(nr + 2 * nc + nl, 1)
    hdr[H_NRC] = max(off, 1)
    topo = np.concatenate([hdr] + parts).astype(np.int32)
    return RunPlan(np1=cc.np1, counts=(nr, nc, nl, nv, ni), entries=entries,
                   c_nodes=c_nodes, l_nodes=l_nodes, stype=stype,
                   knots=knots, src_offset=src_offset, nrc=max(off, 1),
                   layout=layout, topo=topo)


# ------------------------------------------------------------ lane tables


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


def const_stack(plan, params, b, device, temp=TEMP_DEFAULT):
    """Per-lane device rows (b, nd): g = 1/R_t, C_t, C, L (the general
    engine's stamp and commit values; _t = temperature adjusted)."""
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
    if not rows:
        return torch.zeros((b, 1), dtype=torch.float64, device=device)
    return torch.cat(rows, dim=1).contiguous()


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
    if not rows:
        return torch.zeros((b, 1), dtype=torch.float64, device=device)
    return torch.cat(rows, dim=1).contiguous()


def unpack_state(plan, st, state0, accepted, b):
    """Final state stack -> the state dict of the JAX package's
    ``_unpack_state_jv`` (compat): C/L rows from the stack, C.i0 passed
    through, hist set on lanes that accepted a step."""
    nc, nl = plan.counts[1:3]
    L = plan.layout
    started = (accepted > 0)[:, None]

    def grab(key, nk):
        return st[:, L[key]:L[key] + nk]

    state = {}
    if nc:
        state["C"] = {
            "q0": grab("c_q0", nc), "q1": grab("c_q1", nc),
            "v0": grab("c_v0", nc), "v1": grab("c_v1", nc),
            "i0": lanes(state0["C"]["i0"], b).clone(),
            "hist": torch.where(started, 1.0, lanes(state0["C"]["hist"], b)),
        }
    if nl:
        state["L"] = {
            "i0": grab("l_i0", nl), "i1": grab("l_i1", nl),
            "v0": grab("l_v0", nl), "v1": grab("l_v1", nl),
            "flux0": grab("l_flux0", nl),
            "hist": torch.where(started, 1.0, lanes(state0["L"]["hist"], b)),
        }
    return state
