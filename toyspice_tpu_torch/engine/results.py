"""Result extraction into the reference's keyed-series format (a copy of
the JAX package's engine/results.py: numpy in, numpy out).

The reference stores everything as map[string][]float64 with keys
V(node) / I(dev) / TIME / FREQ / SWEEP1 / SWEEP2 / name_MAG / name_PHASE
(anlysis.go:61-111).  Sign conventions reproduced exactly (PLAN.md 5):

* transient & DC sweep report I(name) = -x[branch] plus resistor currents
  I(R) = (v1 - v2)/R (circuit.go:242-273);
* the OP analysis stores I(name) = +x[branch] and no resistor currents
  (op.go:235-248);
* AC stores complex V(node) and +x[branch] currents of V-sources only, as
  name_MAG / name_PHASE pairs (ac.go:75-94, anlysis.go:87-111).
"""

import math
from typing import Dict

import numpy as np

from ..utils.formatter import format_value_factor


class Results(dict):
    """map[string][]float64 equivalent (values are numpy arrays)."""

    def series(self, name):
        return self[name]


def _branch_order(cc):
    return list(cc.branch_names)


def from_op(cc, x) -> Results:
    x = np.asarray(x)
    r = Results()
    for name, idx in cc.node_map.items():
        r[f"V({name})"] = np.array([x[idx]])
    for name, idx in cc.branch_map.items():
        r[f"I({name})"] = np.array([x[idx]])  # note: NOT negated (op.go:244-246)
    return r


def _solution_map(cc, x_rows):
    """GetSolution over an array of solutions: V(node), I(branch) = -x,
    resistor currents."""
    out = {}
    for name, idx in cc.node_map.items():
        out[f"V({name})"] = x_rows[:, idx]
    for name, idx in cc.branch_map.items():
        out[f"I({name})"] = -x_rows[:, idx]
    if "R" in cc.idx:
        nodes = cc.idx["R"]["nodes"]
        values = cc.params["R"]["value"]
        for i, name in enumerate(cc.names["R"]):
            v1 = x_rows[:, nodes[i, 0]]
            v2 = x_rows[:, nodes[i, 1]]
            out[f"I({name})"] = (v1 - v2) / values[i]
    return out


def from_tran(cc, out_t, out_x, out_n) -> Results:
    n = int(out_n)
    times = np.asarray(out_t)[:n]
    xs = np.asarray(out_x)[:n]

    # formatted-time dedup (anlysis.go:61-72): drop a row whose formatted time
    # equals the previously *kept* row's.
    keep = []
    last_fmt = None
    for i, t in enumerate(times):
        f = format_value_factor(t, "s")
        if last_fmt is not None and f == last_fmt:
            continue
        keep.append(i)
        last_fmt = f
    times = times[keep]
    xs = xs[keep]

    r = Results()
    r["TIME"] = times
    for k, v in _solution_map(cc, xs).items():
        r[k] = v
    return r


def from_dc(cc, points, xs, nested=False) -> Results:
    xs = np.asarray(xs)
    points = np.asarray(points)
    r = Results()
    if nested:
        r["SWEEP1"] = points[:, 0]
        r["SWEEP2"] = points[:, 1]
    else:
        r["SWEEP1"] = points
    for k, v in _solution_map(cc, xs).items():
        r[k] = v
    return r


def from_ac(cc, freqs, xr, xi) -> Results:
    xr = np.asarray(xr)
    xi = np.asarray(xi)
    r = Results()
    r["FREQ"] = np.asarray(freqs)

    def put(name, re, im):
        mag = np.hypot(re, im)
        phase = np.degrees(np.arctan2(im, re))
        r[f"{name}_MAG"] = mag
        r[f"{name}_PHASE"] = phase

    for name, idx in cc.node_map.items():
        put(f"V({name})", xr[:, idx], xi[:, idx])
    # branch currents of V-sources only (ac.go:86-91), not negated
    for i, name in enumerate(cc.names["V"]):
        idx = cc.branch_map[name]
        put(f"I({name})", xr[:, idx], xi[:, idx])
    return r
