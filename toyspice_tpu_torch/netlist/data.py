"""Parsed-netlist data model (reference pkg/netlist/parser.go:23-60)."""

from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List


class AnalysisType(Enum):
    OP = 0
    TRAN = 1
    AC = 2
    DC = 3


@dataclass
class Element:
    type: str  # single-letter part type: R L C V I D Q M K
    name: str
    nodes: List[str] = field(default_factory=list)
    value: float = 0.0
    params: Dict[str, str] = field(default_factory=dict)


@dataclass
class ModelParam:
    type: str  # D, CORE, NPN, PNP, NMOS, PMOS
    name: str
    params: Dict[str, float] = field(default_factory=dict)


@dataclass
class TranParam:
    tstep: float = 0.0
    tstop: float = 0.0
    tstart: float = 0.0
    tmax: float = 0.0
    uic: bool = False


@dataclass
class ACParam:
    sweep: str = ""  # DEC, OCT, LIN
    fstart: float = 0.0
    points: int = 0  # TOTAL number of points (reference quirk, ac.go:100-126)
    fstop: float = 0.0


@dataclass
class DCParam:
    source1: str = ""
    start1: float = 0.0
    stop1: float = 0.0
    increment1: float = 0.0
    # The reference CLI parser never fills source2 (parser.go:263-283); the
    # nested sweep is reachable only through the programmatic API (dc.go:205).
    source2: str = ""
    start2: float = 0.0
    stop2: float = 0.0
    increment2: float = 0.0


@dataclass
class NetlistData:
    title: str = ""
    elements: List[Element] = field(default_factory=list)
    nodes: Dict[str, int] = field(default_factory=dict)
    models: Dict[str, ModelParam] = field(default_factory=dict)
    analysis: AnalysisType = AnalysisType.OP
    tran: TranParam = field(default_factory=TranParam)
    ac: ACParam = field(default_factory=ACParam)
    dc: DCParam = field(default_factory=DCParam)
