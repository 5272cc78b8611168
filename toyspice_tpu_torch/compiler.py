"""Host-side circuit compiler: netlist -> static topology + SoA device tables.

Replaces the reference's pkg/circuit responsibilities (node/branch numbering,
device construction, stamp wiring — circuit.go:48-163) and pkg/netlist's
CreateDevice factory (parser.go:752-918), but produces *tables*, not objects:
every device kind becomes a structure-of-arrays block of int32 topology indices
(static, baked into the compiled XLA program) and float64 parameters (a pytree
passed at call time, so Monte-Carlo batches can perturb them with a leading
batch axis).

Numbering matches the reference exactly:
* ground is node 0 (names "0"/"gnd"), real nodes numbered 1..N in first-seen
  element order (circuit.go:48-59);
* every V and L element gets a branch row appended after the nodes, in element
  order (circuit.go:61-67);
* matrix size = nodes + branches (circuit.go:73-76); we additionally keep row 0
  as an identity "ground row" so shapes stay static and stamps never
  special-case ground.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .netlist.data import AnalysisType, Element, ModelParam, NetlistData
from .netlist.parser import (
    NetlistError,
    parse_pulse_params,
    parse_pwl_params,
    parse_sin_params,
)
from .utils.units import parse_value

# Source waveform type codes (reference device.SourceType, device.go:58-65).
SRC_DC, SRC_SIN, SRC_PULSE, SRC_PWL = 0, 1, 2, 3

# BJT device-level defaults (reference bjt.go:85-108 setDefaultParameters).
# NOTE (parity): the netlist .model defaults populate keys is/bf/br/nf/nr/...
# but SetModelParameters (bjt.go:139-193) reads ies/ics/alphaf/... — so model
# Is/Bf/Br/Tr/Xtb never reach the device and these values survive unless the
# model literally contains "ies=..." etc.  nf/nr/vaf/var/ikf/ikr and the
# capacitance params DO apply (lower-case keys match).
_BJT_DEFAULTS = dict(
    ies=1e-15, ics=1e-15, nf=1.0, nr=1.0, alphaf=0.98, alphar=0.5,
    ikf=1e-3, ikr=1e-3, vaf=50.0, var=50.0,
    cje=1e-12, vje=0.7, mje=0.33, cjc=0.5e-12, vjc=0.7, mjc=0.33, tf=300e-12,
)
_BJT_MODEL_KEYS = (
    "ies", "ics", "alphaf", "alphar", "ikf", "ikr", "vaf", "var",
    "cje", "vje", "mje", "cjc", "vjc", "mjc", "tf",
)
# Keys the BJT reads with different capitalization semantics: nf/nr come from
# the model defaults table (always present in parsed models) — the reference
# does NOT read them in SetModelParameters, so they stay at device defaults.

# MOSFET device-level defaults (reference mosfet.go:145-208).
_MOS_DEFAULTS = dict(
    l=10e-6, w=10e-6, ad=0.0, **{"as": 0.0}, pd=0.0, ps=0.0, nrd=1.0, nrs=1.0,
    vto=0.7, kp=2e-5, gamma=0.5, phi=0.6, lam=0.01, rd=0.0, rs=0.0, rsh=0.0,
    is_=1e-14, js=0.0, n=1.0,
    cbd=0.0, cbs=0.0, cgso=0.0, cgdo=0.0, cgbo=0.0, cj=0.0, mj=0.5,
    cjsw=0.0, mjsw=0.33, pb=0.8, fc=0.5,
    tox=1e-7, nsub=1e16, nss=0.0, nfs=0.0, tpg=1.0, xj=0.0, ld=0.0,
    uo=600.0, ucrit=1e4, uexp=0.0, utra=0.0, vmax=0.0, neff=1.0, xqc=0.6,
    delta=0.0, theta=0.0, eta=0.0, kappa=0.2,
    tnom=300.15, kf=0.0, af=1.0,
)
# model-key -> our param name (lambda is a Python keyword; is is builtin-ish)
_MOS_KEY_MAP = {"lambda": "lam", "is": "is_", "as": "as"}

# Diode device-level defaults (reference diode.go:62-76).
_DIODE_DEFAULTS = dict(
    is_=1e-14, n=1.0, rs=0.0, cj0=0.0, m=0.5, vj=1.0, bv=100.0,
    eg=1.11, xti=3.0, tt=0.0, fc=0.5, gmin=1e-12,
)
_DIODE_MODEL_KEYS = {
    "is": "is_", "n": "n", "rs": "rs", "cj0": "cj0", "m": "m", "vj": "vj",
    "bv": "bv", "eg": "eg", "xti": "xti", "tt": "tt", "fc": "fc",
}

# Jiles-Atherton core defaults (reference magnetic.go:74-86).
_CORE_DEFAULTS = dict(
    ms=1.6e6, alpha=1e-3, a=1000.0, c=0.1, k=2000.0, tc=1043.0, beta=0.0,
    area=1e-4, len=0.1,
)
# SetCore (magnetic.go:164-191) copies only these keys from the model params —
# tc and beta are NOT copied, so they stay at core defaults even if the .model
# card sets them.
_CORE_MODEL_KEYS = ("ms", "alpha", "a", "c", "k", "area", "len")


@dataclass
class SourceSpec:
    """Host-side record of one V or I source (pre-vectorization)."""

    name: str
    stype: int = SRC_DC
    dc: float = 0.0  # dcValue: DC level / SIN offset
    amplitude: float = 0.0
    freq: float = 0.0
    phase: float = 0.0
    v1: float = 0.0
    v2: float = 0.0
    delay: float = 0.0
    rise: float = 0.0
    fall: float = 0.0
    width: float = 0.0
    period: float = 0.0
    pwl_t: List[float] = field(default_factory=list)
    pwl_v: List[float] = field(default_factory=list)
    ac_mag: float = 0.0
    ac_phase: float = 0.0


@dataclass
class CompiledCircuit:
    title: str
    node_map: Dict[str, int]  # name -> 1-based index (ground excluded)
    branch_map: Dict[str, int]  # element name -> row index
    n: int  # matrix size = nodes + branches (reference Size)
    np1: int  # n + 1 (padded with ground row 0)
    analysis: AnalysisType
    netlist: NetlistData

    # Static topology per kind: int32 numpy arrays.
    idx: Dict[str, Dict[str, np.ndarray]]
    # Runtime parameter pytree template per kind: float64 numpy arrays.
    params: Dict[str, Dict[str, np.ndarray]]
    # Ordered names per kind (for results / Monte-Carlo addressing).
    names: Dict[str, List[str]]

    # Output bookkeeping
    node_names: List[str]  # index i-1 -> name of node i
    branch_names: List[str]  # in branch-row order
    # resistors for GetSolution's I(R)=(v1-v2)/R (circuit.go:257-270)
    resistor_names: List[str]

    def kind_count(self, kind: str) -> int:
        tbl = self.idx.get(kind)
        if tbl is None:
            return 0
        for v in tbl.values():
            return int(v.shape[0])
        for v in self.params.get(kind, {}).values():
            return int(v.shape[0])
        return 0


def _merge_model(defaults: dict, keymap, model: Optional[ModelParam]) -> dict:
    out = dict(defaults)
    if model is None:
        return out
    if isinstance(keymap, dict):
        for mk, ours in keymap.items():
            if mk in model.params:
                out[ours] = float(model.params[mk])
    else:
        for mk in keymap:
            if mk in model.params:
                out[mk] = float(model.params[mk])
    return out


def _parse_source_spec(elem: Element) -> SourceSpec:
    s = SourceSpec(name=elem.name)
    stype = elem.params.get("type", "")
    if stype == "dc":
        s.stype, s.dc = SRC_DC, elem.value
    elif stype == "sin":
        off, amp, freq, phase = parse_sin_params(elem.params["sin"])
        s.stype, s.dc, s.amplitude, s.freq, s.phase = SRC_SIN, off, amp, freq, phase
    elif stype == "pulse":
        v1, v2, d, r, f, w, p = parse_pulse_params(elem.params["pulse"])
        s.stype = SRC_PULSE
        s.v1, s.v2, s.delay, s.rise, s.fall, s.width, s.period = v1, v2, d, r, f, w, p
        s.dc = v1  # Value field init (vsource.go:65-82)
    elif stype == "pwl":
        t, v = parse_pwl_params(elem.params["pwl"])
        s.stype, s.pwl_t, s.pwl_v = SRC_PWL, t, v
        s.dc = v[0]
    elif stype == "ac":
        # AC source: DC value 0, treated as DC in time-domain
        # (NewACVoltageSource, vsource.go:98-111: vtype=DC, dcValue=0).
        s.stype, s.dc = SRC_DC, 0.0
        s.ac_mag = elem.value
        s.ac_phase = parse_value(elem.params.get("phase", "0"))
    else:
        raise NetlistError(f"unsupported source type for {elem.name}: {stype!r}")
    return s


def compile_circuit(data: NetlistData) -> CompiledCircuit:
    elements = data.elements
    models = data.models

    # --- node numbering (circuit.go:48-59) ---
    node_map: Dict[str, int] = {}
    for elem in elements:
        for node in elem.nodes:
            if node in ("0", "gnd"):
                continue
            if node not in node_map:
                node_map[node] = len(node_map) + 1

    # --- branch numbering (circuit.go:61-67) ---
    branch_map: Dict[str, int] = {}
    b = len(node_map) + 1
    for elem in elements:
        if elem.type in ("V", "L"):
            branch_map[elem.name] = b
            b += 1

    n = len(node_map) + len(branch_map)
    np1 = n + 1

    def node_idx(name: str) -> int:
        if name in ("0", "gnd"):
            return 0
        return node_map[name]

    # --- per-kind accumulation ---
    rows: Dict[str, List[dict]] = {k: [] for k in
                                   ("R", "C", "L", "LM", "V", "I", "D", "Q", "M")}
    names: Dict[str, List[str]] = {k: [] for k in
                                   ("R", "C", "L", "LM", "V", "I", "D", "Q", "M", "K")}
    k_elements: List[Element] = []
    core_ids: Dict[str, int] = {}  # core model name -> shared core id

    for elem in elements:
        t = elem.type
        nodes = [node_idx(x) for x in elem.nodes]

        if t == "R":
            rows["R"].append(dict(nodes=nodes, value=elem.value))
            names["R"].append(elem.name)
        elif t == "C":
            rows["C"].append(dict(nodes=nodes, value=elem.value))
            names["C"].append(elem.name)
        elif t == "L":
            if "core" in elem.params:
                core_name = elem.params["core"]
                model = models.get(core_name)
                if model is None:
                    raise NetlistError(
                        f"undefined core model for inductor {elem.name}: {core_name}")
                if model.type != "CORE":
                    raise NetlistError(
                        f"invalid core model type for inductor {elem.name}: {model.type}")
                turns = 100
                if "turns" in elem.params:
                    try:
                        turns = int(elem.params["turns"])
                    except ValueError:
                        pass
                core = _merge_model(_CORE_DEFAULTS, _CORE_MODEL_KEYS, model)
                core_id = core_ids.setdefault(core_name, len(core_ids))
                rows["LM"].append(dict(
                    nodes=nodes, branch=branch_map[elem.name], turns=float(turns),
                    core_id=core_id, **core))
                names["LM"].append(elem.name)
            else:
                rows["L"].append(dict(nodes=nodes, branch=branch_map[elem.name],
                                      value=elem.value))
                names["L"].append(elem.name)
        elif t == "V":
            spec = _parse_source_spec(elem)
            rows["V"].append(dict(nodes=nodes, branch=branch_map[elem.name], spec=spec))
            names["V"].append(elem.name)
        elif t == "I":
            spec = _parse_source_spec(elem)
            rows["I"].append(dict(nodes=nodes, spec=spec))
            names["I"].append(elem.name)
        elif t == "D":
            model = models.get(elem.params.get("model", ""))
            p = _merge_model(_DIODE_DEFAULTS, _DIODE_MODEL_KEYS, model)
            rows["D"].append(dict(nodes=nodes, **p))
            names["D"].append(elem.name)
        elif t == "Q":
            model = models.get(elem.params.get("model", ""))
            p = _merge_model(_BJT_DEFAULTS, _BJT_MODEL_KEYS, model)
            # type: PNP iff model carries type=1 (parser sets it; bjt.go:140-145)
            sign = 1.0
            if model is not None and model.params.get("type", 0.0) == 1.0:
                sign = -1.0
            rows["Q"].append(dict(nodes=nodes, sign=sign, **p))
            names["Q"].append(elem.name)
        elif t == "M":
            model_name = elem.params.get("model")
            if model_name is None:
                raise NetlistError(f"mosfet {elem.name}: model not specified")
            model = models.get(model_name)
            p = dict(_MOS_DEFAULTS)
            level = 1
            sign = 1.0
            if model is not None:
                level = int(model.params.get("level", 1))
                if model.params.get("type", 0.0) == 1.0:
                    sign = -1.0
                for mk, val in model.params.items():
                    key = _MOS_KEY_MAP.get(mk, mk)
                    if key in p:
                        p[key] = float(val)
            # element-level L/W override (parser.go:832-841)
            if "l" in elem.params:
                p["l"] = parse_value(elem.params["l"])
            if "w" in elem.params:
                p["w"] = parse_value(elem.params["w"])
            rows["M"].append(dict(nodes=nodes, sign=sign, level=level, **p))
            names["M"].append(elem.name)
        elif t == "K":
            k_elements.append(elem)
            names["K"].append(elem.name)
        else:
            raise NetlistError(f"unsupported device type: {t}")

    idx: Dict[str, Dict[str, np.ndarray]] = {}
    params: Dict[str, Dict[str, np.ndarray]] = {}

    def ii(x):
        return np.asarray(x, dtype=np.int32)

    def ff(x):
        return np.asarray(x, dtype=np.float64)

    # R / C.  Resistors carry tc1/tc2 for the quadratic temperature
    # adjustment (resistor.go:77-81; not settable from a netlist — programmatic
    # API only, defaults 0 so the factor is exactly 1 at any temperature
    # unless overridden).  Capacitors likewise (capacitor.go:180-184).
    for kind in ("R", "C"):
        if rows[kind]:
            nk = len(rows[kind])
            idx[kind] = {"nodes": ii([r["nodes"] for r in rows[kind]])}
            params[kind] = {
                "value": ff([r["value"] for r in rows[kind]]),
                "tc1": np.zeros(nk, dtype=np.float64),
                "tc2": np.zeros(nk, dtype=np.float64),
            }

    # L
    if rows["L"]:
        idx["L"] = {
            "nodes": ii([r["nodes"] for r in rows["L"]]),
            "branch": ii([r["branch"] for r in rows["L"]]),
        }
        params["L"] = {"value": ff([r["value"] for r in rows["L"]])}

    # LM (magnetic inductors)
    if rows["LM"]:
        idx["LM"] = {
            "nodes": ii([r["nodes"] for r in rows["LM"]]),
            "branch": ii([r["branch"] for r in rows["LM"]]),
            "core_id": ii([r["core_id"] for r in rows["LM"]]),
        }
        params["LM"] = {
            key: ff([r[key] for r in rows["LM"]])
            for key in ("turns", "ms", "alpha", "a", "c", "k", "area", "len",
                        "tc", "beta")
        }

    # Sources
    def build_sources(kind: str, with_branch: bool):
        rws = rows[kind]
        if not rws:
            return
        specs = [r["spec"] for r in rws]
        # +1: even the longest PWL list needs one far-future pad point, else
        # t beyond its last knot extrapolates on the final segment instead of
        # holding the last value (vsource.go:211-231 clamps).
        pmax = max(2, max((len(s.pwl_t) + 1 for s in specs), default=2))
        pwl_t = np.zeros((len(specs), pmax), dtype=np.float64)
        pwl_v = np.zeros((len(specs), pmax), dtype=np.float64)
        for i, s in enumerate(specs):
            if s.pwl_t:
                ts, vs = list(s.pwl_t), list(s.pwl_v)
            else:
                ts, vs = [0.0], [0.0]
            last_t, last_v = ts[-1], vs[-1]
            j = 1
            while len(ts) < pmax:
                # pad with far-future points at the last value: interpolation
                # over the pad segment is exactly last_v
                ts.append(last_t + j * 1e30)
                vs.append(last_v)
                j += 1
            pwl_t[i], pwl_v[i] = ts, vs
        idx[kind] = {"nodes": ii([r["nodes"] for r in rws]),
                     "stype": ii([s.stype for s in specs])}
        if with_branch:
            idx[kind]["branch"] = ii([r["branch"] for r in rws])
        params[kind] = {
            "dc": ff([s.dc for s in specs]),
            "amplitude": ff([s.amplitude for s in specs]),
            "freq": ff([s.freq for s in specs]),
            "phase": ff([s.phase for s in specs]),
            "v1": ff([s.v1 for s in specs]),
            "v2": ff([s.v2 for s in specs]),
            "delay": ff([s.delay for s in specs]),
            "rise": ff([s.rise for s in specs]),
            "fall": ff([s.fall for s in specs]),
            "width": ff([s.width for s in specs]),
            "period": ff([s.period for s in specs]),
            "pwl_t": pwl_t,
            "pwl_v": pwl_v,
            "ac_mag": ff([s.ac_mag for s in specs]),
            "ac_phase": ff([s.ac_phase for s in specs]),
        }

    build_sources("V", with_branch=True)
    build_sources("I", with_branch=False)

    # Diodes
    if rows["D"]:
        idx["D"] = {"nodes": ii([r["nodes"] for r in rows["D"]])}
        params["D"] = {
            key: ff([r[key] for r in rows["D"]])
            for key in _DIODE_DEFAULTS
        }

    # BJTs
    if rows["Q"]:
        idx["Q"] = {"nodes": ii([r["nodes"] for r in rows["Q"]])}
        params["Q"] = {"sign": ff([r["sign"] for r in rows["Q"]])}
        params["Q"].update({
            key: ff([r[key] for r in rows["Q"]]) for key in _BJT_DEFAULTS
        })

    # MOSFETs
    if rows["M"]:
        idx["M"] = {"nodes": ii([r["nodes"] for r in rows["M"]]),
                    "level": ii([r["level"] for r in rows["M"]])}
        params["M"] = {"sign": ff([r["sign"] for r in rows["M"]])}
        params["M"].update({
            key: ff([r[key] for r in rows["M"]]) for key in _MOS_DEFAULTS
        })

    # Mutual couplings: expand to inductor pairs host-side (mutual.go:106-117).
    if k_elements:
        pair_rows = []
        lin_names = names["L"]
        mag_names = names["LM"]
        for elem in k_elements:
            ind_names: List[str] = []
            i = 1
            while f"ind{i}" in elem.params:
                ind_names.append(elem.params[f"ind{i}"])
                i += 1
            if len(ind_names) < 2:
                raise NetlistError(
                    f"mutual coupling {elem.name} requires at least two inductors")
            refs = []
            for name in ind_names:
                if name in lin_names:
                    li = lin_names.index(name)
                    refs.append((0, li, rows["L"][li]["branch"],
                                 rows["L"][li]["nodes"]))
                elif name in mag_names:
                    li = mag_names.index(name)
                    refs.append((1, li, rows["LM"][li]["branch"],
                                 rows["LM"][li]["nodes"]))
                else:
                    raise NetlistError(
                        f"inductor {name} not found for mutual coupling {elem.name}")
            for a in range(len(refs)):
                for c in range(a + 1, len(refs)):
                    ka, ia, ba, na = refs[a]
                    kc, ic, bc, nc = refs[c]
                    pair_rows.append(dict(
                        coeff=elem.value,
                        kind_a=ka, idx_a=ia, branch_a=ba, nodes_a=na,
                        kind_b=kc, idx_b=ic, branch_b=bc, nodes_b=nc,
                    ))
        idx["K"] = {
            "kind_a": ii([r["kind_a"] for r in pair_rows]),
            "idx_a": ii([r["idx_a"] for r in pair_rows]),
            "branch_a": ii([r["branch_a"] for r in pair_rows]),
            "nodes_a": ii([r["nodes_a"] for r in pair_rows]),
            "kind_b": ii([r["kind_b"] for r in pair_rows]),
            "idx_b": ii([r["idx_b"] for r in pair_rows]),
            "branch_b": ii([r["branch_b"] for r in pair_rows]),
            "nodes_b": ii([r["nodes_b"] for r in pair_rows]),
        }
        params["K"] = {"coeff": ff([r["coeff"] for r in pair_rows])}

    node_names = [None] * len(node_map)
    for nm, i in node_map.items():
        node_names[i - 1] = nm
    branch_names = [None] * len(branch_map)
    base = len(node_map) + 1
    for nm, i in branch_map.items():
        branch_names[i - base] = nm

    return CompiledCircuit(
        title=data.title,
        node_map=node_map,
        branch_map=branch_map,
        n=n,
        np1=np1,
        analysis=data.analysis,
        netlist=data,
        idx=idx,
        params=params,
        names=names,
        node_names=node_names,
        branch_names=branch_names,
        resistor_names=list(names["R"]),
    )
