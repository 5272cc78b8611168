"""SPICE-deck parser.

Line-oriented parser with the same accepted grammar as the reference
(pkg/netlist/parser.go): title line, ``*`` comments (full-line and trailing),
``+`` continuations, ``.op/.tran/.ac/.dc/.model`` dot-cards, element cards and
engineering-unit suffixes.  Quirks that affect fixture results are reproduced
deliberately and called out inline; ``;`` trailing comments are additionally
stripped (a strict superset: the reference tolerates them only by accident of
its field-count handling).
"""

import re
from typing import Dict, List, Tuple

from .data import AnalysisType, Element, ModelParam, NetlistData
from ..utils.units import parse_value

_WS = re.compile(r"\s+")

_SUPPORTED_MODEL_TYPES = ("D", "CORE", "NPN", "PNP", "NMOS", "PMOS")

# Default .model parameter tables (reference parser.go:348-431).  These are the
# values a model card starts from before user parameters are merged in.
MODEL_DEFAULTS: Dict[str, Dict[str, float]] = {
    "D": {
        "is": 1e-14,
        "n": 1.0,
        "rs": 0.0,
        "cj0": 0.0,
        "m": 0.5,
        "vj": 1.0,
        "bv": 100.0,
        "eg": 1.11,
        "xti": 3.0,
        "tt": 0.0,
        "fc": 0.5,
    },
    "CORE": {
        "ms": 1.6e6,
        "alpha": 1e-3,
        "a": 1000.0,
        "c": 0.1,
        "k": 2000.0,
        "tc": 1043.0,
        "beta": 0.0,
        "area": 1e-4,
        "len": 0.1,
    },
    "BJT": {
        "is": 1e-16,
        "bf": 100.0,
        "br": 1.0,
        "nf": 1.0,
        "nr": 1.0,
        "vaf": 100.0,
        "var": 100.0,
        "ikf": 0.01,
        "ikr": 0.01,
        "rc": 0.0,
        "re": 0.0,
        "rb": 0.0,
        "cje": 0.0,
        "vje": 0.75,
        "mje": 0.33,
        "cjc": 0.0,
        "vjc": 0.75,
        "mjc": 0.33,
        "tf": 0.0,
        "tr": 0.0,
        "xtb": 0.0,
        "eg": 1.11,
        "xti": 3.0,
    },
    "MOS": {
        "level": 1,
        "vto": 0.7,
        "kp": 2e-5,
        "gamma": 0.5,
        "phi": 0.6,
        "lambda": 0.01,
        "rd": 0.0,
        "rs": 0.0,
        "cbd": 0.0,
        "cbs": 0.0,
        "is": 1e-14,
        "pb": 0.8,
        "cgso": 0.0,
        "cgdo": 0.0,
        "cgbo": 0.0,
        "cj": 0.0,
        "mj": 0.5,
        "cjsw": 0.0,
        "mjsw": 0.33,
        "tox": 1e-7,
        "l": 10e-6,
        "w": 10e-6,
    },
}


class NetlistError(ValueError):
    pass


def parse(text: str) -> NetlistData:
    data = NetlistData()
    lines = text.splitlines()

    # First line is the title (leading '*' stripped), reference parser.go:83-86.
    if lines:
        data.title = lines[0].lstrip("*").strip()

    current = ""
    for raw in lines[1:]:
        line = raw.strip()

        if not line:
            if current:
                _parse_line(data, current)
                current = ""
            continue

        # Trailing comments: '*' anywhere cuts the line (parser.go:107-112);
        # ';' likewise (superset, see module docstring).
        for marker in ("*", ";"):
            idx = line.find(marker)
            if idx >= 0:
                line = line[:idx].strip()
        if not line:
            if current:
                _parse_line(data, current)
                current = ""
            continue

        if line.startswith("+"):
            cont = line[1:].strip()
            if current:
                current += " " + cont
            continue

        if current:
            _parse_line(data, current)
        current = line

    if current:
        _parse_line(data, current)

    return data


def _parse_line(data: NetlistData, line: str) -> None:
    line = _WS.sub(" ", line)

    if line.startswith("."):
        _parse_dot(data, line)
        return

    elem = _parse_element(line)
    data.elements.append(elem)
    for node in elem.nodes:
        if node not in data.nodes:
            data.nodes[node] = len(data.nodes)


def _parse_dot(data: NetlistData, line: str) -> None:
    fields = line.split()
    card = fields[0].lower()

    if card == ".model":
        _parse_model(data, fields[1:])
    elif card == ".op":
        data.analysis = AnalysisType.OP
    elif card == ".tran":
        data.analysis = AnalysisType.TRAN
        if len(fields) < 3:
            raise NetlistError("insufficient tran parameters, need at least tstep and tstop")
        data.tran.tstep = parse_value(fields[1])
        data.tran.tstop = parse_value(fields[2])
        for i in range(3, len(fields)):
            if fields[i] == "uic":
                data.tran.uic = True
                continue
            if i == 3:
                data.tran.tstart = parse_value(fields[i])
            if i == 4:
                data.tran.tmax = parse_value(fields[i])
        if data.tran.tmax == 0:
            data.tran.tmax = data.tran.tstep
    elif card == ".ac":
        data.analysis = AnalysisType.AC
        if len(fields) < 5:
            raise NetlistError("insufficient AC parameters")
        sweep = fields[1].upper()
        if sweep not in ("DEC", "OCT", "LIN"):
            raise NetlistError(f"invalid sweep type: {sweep}")
        data.ac.sweep = sweep
        data.ac.points = int(fields[2])
        data.ac.fstart = parse_value(fields[3])
        data.ac.fstop = parse_value(fields[4])
    elif card == ".dc":
        data.analysis = AnalysisType.DC
        if len(fields) < 5:
            raise NetlistError("insufficient DC sweep parameters")
        data.dc.source1 = fields[1]
        data.dc.start1 = parse_value(fields[2])
        data.dc.stop1 = parse_value(fields[3])
        data.dc.increment1 = parse_value(fields[4])
    else:
        raise NetlistError(f"unsupported analysis type: {fields[0]}")


def _parse_model(data: NetlistData, fields: List[str]) -> None:
    if len(fields) < 2:
        raise NetlistError("insufficient model parameters")

    model_name = fields[0]
    type_field = fields[1]
    has_open_paren = False

    if "(" in type_field:
        head, _, rest = type_field.partition("(")
        model_type = head.upper()
        has_open_paren = True
        fields = fields[:2] + [rest] + fields[2:]
    else:
        model_type = type_field.upper()

    if model_type not in _SUPPORTED_MODEL_TYPES:
        raise NetlistError(f"unsupported model type: {model_type}")

    if has_open_paren:
        param_parts = list(fields[2:])
        if param_parts and param_parts[-1].endswith(")"):
            param_parts[-1] = param_parts[-1][: -1]
        param_str = " ".join(param_parts)
    elif len(fields) > 2:
        param_str = " ".join(fields[2:])
        if param_str.endswith(")"):
            param_str = param_str[:-1]
    else:
        param_str = ""

    param_str = re.sub(r"\*.*$", "", param_str).strip()

    if model_type == "D":
        params = dict(MODEL_DEFAULTS["D"])
    elif model_type == "CORE":
        params = dict(MODEL_DEFAULTS["CORE"])
    elif model_type in ("NPN", "PNP"):
        params = dict(MODEL_DEFAULTS["BJT"])
        if model_type == "PNP":
            params["type"] = 1.0
    else:  # NMOS / PMOS
        params = dict(MODEL_DEFAULTS["MOS"])
        if model_type == "PMOS":
            params["type"] = 1.0

    # NOTE (parity quirk): when the deck reads ``.model X D (Is=... )`` with a
    # space before '(' the reference joins the fields unmodified, so the first
    # pair parses under the key "(is" and the *default* value of the intended
    # parameter survives (e.g. diode5.cir's Is).  We replicate that by not
    # stripping a leading '(' from pairs.
    for pair in param_str.split():
        name, eq, value = pair.partition("=")
        if not eq or not name or not value:
            continue
        params[name.strip().lower()] = parse_value(value.strip())

    data.models[model_name] = ModelParam(type=model_type, name=model_name, params=params)


def _parse_element(line: str) -> Element:
    fields = line.split()
    if len(fields) < 3:
        raise NetlistError(f"invalid element format: {line}")

    elem = Element(name=fields[0], type=fields[0][0].upper())

    if elem.type == "V":
        return _parse_source(fields, "V")
    if elem.type == "I":
        return _parse_source(fields, "I")

    if elem.type == "L":
        elem.nodes = fields[1:3]
        for f in fields[3:]:
            name, eq, value = f.partition("=")
            if eq:
                elem.params[name.lower()] = value
            else:
                elem.value = parse_value(f)
        return elem

    if elem.type == "K":
        if len(fields) < 4:
            raise NetlistError("insufficient mutual coupling parameters")
        coefficient = parse_value(fields[-1])
        if coefficient < -1 or coefficient > 1:
            raise NetlistError(
                f"coupling coefficient must be between -1 and 1: {coefficient}"
            )
        ind_names = fields[1:-1]
        if len(ind_names) < 2:
            raise NetlistError("mutual coupling requires at least two inductors")
        for i, name in enumerate(ind_names):
            elem.params[f"ind{i + 1}"] = name
        elem.value = coefficient
        return elem

    if elem.type == "D":
        elem.nodes = fields[1:3]
        if len(fields) > 3:
            elem.params["model"] = fields[3]
        return elem

    if elem.type == "Q":
        if len(fields) < 4:
            raise NetlistError("insufficient BJT parameters: need nodes and model name")
        elem.nodes = fields[1:4]  # collector, base, emitter
        if len(fields) > 4:
            elem.params["model"] = fields[4]
        return elem

    if elem.type == "M":
        if len(fields) < 6:
            raise NetlistError("insufficient MOSFET parameters: need nodes and model name")
        elem.nodes = fields[1:5]  # drain, gate, source, bulk
        elem.params["model"] = fields[5]
        for f in fields[6:]:
            name, eq, value = f.partition("=")
            if eq:
                elem.params[name.lower()] = value
        return elem

    # Generic two-terminal parts: R, C, ...  (the reference indexes
    # fields[3] unchecked and panics on a missing value; error instead)
    if len(fields) < 4:
        raise NetlistError(f"invalid element format: {line}")
    elem.nodes = fields[1:-1]
    elem.value = parse_value(fields[-1])
    return elem


def _parse_source(fields: List[str], kind: str) -> Element:
    if len(fields) < 4:
        raise NetlistError(f"insufficient {kind} source parameters")

    elem = Element(name=fields[0], type=kind, nodes=[fields[1], fields[2]])

    remaining = " ".join(fields[3:])
    remaining = remaining.replace("(", " ( ").replace(")", " ) ")
    words = remaining.split()
    if not words:
        raise NetlistError(f"missing {kind} source type")

    stype = words[0].upper()
    if stype == "DC":
        if len(words) < 2:
            raise NetlistError("missing DC value")
        elem.params["type"] = "dc"
        elem.value = parse_value(words[1])
    elif stype in ("SIN", "PULSE", "PWL"):
        key = stype.lower()
        elem.params["type"] = key
        elem.params[key] = " ".join(words[1:]).strip("() ")
    elif stype == "AC":
        if len(words) < 2:
            raise NetlistError("missing AC magnitude")
        elem.params["type"] = "ac"
        elem.value = parse_value(words[1])
        elem.params["phase"] = words[2] if len(words) > 2 else "0"
    else:
        raise NetlistError(f"unsupported {kind} source type: {words[0]}")

    return elem


def parse_sin_params(params: str) -> Tuple[float, float, float, float]:
    """offset, amplitude, freq, phase (reference parser.go:920-954)."""
    f = params.split()
    if len(f) < 3:
        raise NetlistError("insufficient SIN parameters")
    offset = parse_value(f[0])
    amplitude = parse_value(f[1])
    freq = parse_value(f[2])
    phase = parse_value(f[3]) if len(f) > 3 else 0.0
    return offset, amplitude, freq, phase


def parse_pulse_params(params: str):
    """v1, v2, delay, rise, fall, width, period (parser.go:956-1005)."""
    f = params.split()
    if len(f) < 7:
        raise NetlistError("insufficient PULSE parameters")
    return tuple(parse_value(x) for x in f[:7])


def parse_pwl_params(params: str) -> Tuple[List[float], List[float]]:
    """times, values — pairs, strictly increasing times (parser.go:1007-1035)."""
    f = params.split()
    if len(f) < 4 or len(f) % 2 != 0:
        raise NetlistError("insufficient or invalid PWL parameters, need time-value pairs")
    times, values = [], []
    for i in range(len(f) // 2):
        times.append(parse_value(f[2 * i]))
        values.append(parse_value(f[2 * i + 1]))
        if i > 0 and times[i] <= times[i - 1]:
            raise NetlistError("PWL time points must be strictly increasing")
    return times, values
