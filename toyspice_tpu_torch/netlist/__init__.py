from .data import (
    AnalysisType,
    Element,
    ModelParam,
    NetlistData,
    TranParam,
    ACParam,
    DCParam,
)
from .parser import parse
from ..utils.units import parse_value

__all__ = [
    "AnalysisType",
    "Element",
    "ModelParam",
    "NetlistData",
    "TranParam",
    "ACParam",
    "DCParam",
    "parse",
    "parse_value",
]
