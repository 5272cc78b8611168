"""The analyses' entry points: parse -> compile -> the general engine ->
Results.

The port's counterpart of the JAX package's top-level convenience API
(engine/__init__.py there; the reference CLI pipeline,
cmd/spice/main.go:187-362): ``run_analysis`` dispatches on the netlist's
dot-card; ``run_op``, ``run_transient``, ``run_ac`` and ``run_dc`` run a
specific analysis.  Each runs the one instance of the deck as a batch of
one through the general engine, as the JAX functions do:
``engine/op.make_op``, ``engine/tran.make_tran(store="full")``,
``engine/ac.make_ac`` and ``engine/dc.make_dc``, whose solves are the
stamped-solve kernel (every Newton iteration) and the GJ kernel (the OP's
initial estimate, the AC systems) on the card.  Each takes ``device``,
``"cuda"`` unless the caller asks for ``"cpu"``, where the kernels' plain
versions run.  ``TOYSPICE_SOLVER=xla`` runs the plain versions on the card
too, and ``TOYSPICE_SOLVER=pallas`` the kernels alone
(``engine/overrides.solves``, read when an engine is built).
"""

import os
from typing import Union

import numpy as np
import torch

from ..compiler import CompiledCircuit, compile_circuit
from ..netlist.data import AnalysisType, NetlistData
from ..netlist.parser import parse
from . import overrides
from . import results as results_mod
from .ac import frequency_points, make_ac
from .batch import batch_params
from .dc import make_dc, sweep_values
from .nlstate import init_jv
from .op import make_op
from .options import DEFAULTS, SimOptions
from .state import init_state
from .tran import build_config, make_tran
from .results import Results


def _to_compiled(src: Union[str, NetlistData, CompiledCircuit]
                 ) -> CompiledCircuit:
    if isinstance(src, CompiledCircuit):
        return src
    if isinstance(src, NetlistData):
        return compile_circuit(src)
    text = src
    if "\n" not in src and os.path.exists(src):
        with open(src) as f:
            text = f.read()
    return compile_circuit(parse(text))


def _params(cc, device) -> dict:
    """The deck's own parameters, every leaf shared: a batch of one."""
    return batch_params(cc, {}, device=device)[0]


def _engine(cc, key, device, build):
    """The per-circuit cache of built engines (a build makes the stamp
    patterns and plans once), keyed on the device and the solver override
    too: a CPU call must not reuse a callable built for the card, nor a
    call under one ``TOYSPICE_SOLVER`` the solves chosen under another.
    ``build(kw)`` takes the solves as keywords."""
    cache = getattr(cc, "_engines", None)
    if cache is None:
        cache = {}
        object.__setattr__(cc, "_engines", cache)
    key = key + (str(torch.device(device)), overrides.solver_backend())
    if key not in cache:
        cache[key] = build(overrides.solves())
    return cache[key]


def _host(x):
    """Lane 0 of a (1, ...) tensor as a numpy array."""
    return x[0].detach().cpu().numpy()


def _on(tree, device):
    """A {kind: {key: array}} tree (numpy, a checkpoint's or a Results'
    ``.final_state``) as f64 tensors on ``device``."""
    return {kind: {key: torch.as_tensor(np.asarray(leaf, dtype=np.float64),
                                        device=device)
                   for key, leaf in tbl.items()}
            for kind, tbl in tree.items()}


def _numpy_lane0(tree):
    return {kind: {key: _host(leaf) for key, leaf in tbl.items()}
            for kind, tbl in tree.items()}


def run_op(src, options: SimOptions = DEFAULTS,
           semantics: str = "compat", device="cuda") -> Results:
    cc = _to_compiled(src)
    fn = _engine(cc, ("op", options, semantics), device,
                 lambda kw: make_op(cc, options, semantics, **kw))
    r = fn(_params(cc, device), init_state(cc, device=device))
    if not bool(r.converged[0]):
        raise RuntimeError("operating point failed to converge")
    return results_mod.from_op(cc, _host(r.x))


def run_transient(src, tstart=None, tstop=None, tstep=None, tmax=None,
                  uic=None, semantics: str = "compat",
                  options: SimOptions = DEFAULTS,
                  initial_state=None, resume_t: float = 0.0,
                  initial_jv=None, device="cuda") -> Results:
    """Resume support: pass a checkpoint's (initial_state, resume_t,
    initial_jv) — from a prior run's .final_state/.final_time/.final_jv or
    engine/checkpoint.py, numpy or tensors — to continue a transient from
    its committed state: the clock starts at resume_t (so time-varying
    sources keep their phase), the OP re-bias is skipped, and tstart/tstop
    stay absolute.  The returned Results carries .final_state /
    .final_time / .final_jv as numpy."""
    cc = _to_compiled(src)
    tp = cc.netlist.tran
    cfg = build_config(
        tstart if tstart is not None else tp.tstart,
        tstop if tstop is not None else tp.tstop,
        tstep if tstep is not None else tp.tstep,
        tmax if tmax is not None else tp.tmax,
        uic if uic is not None else tp.uic,
        opts=options,
    )
    resume = initial_state is not None
    fn = _engine(cc, ("tran", cfg, semantics, options, resume), device,
                 lambda kw: make_tran(cc, cfg, semantics=semantics,
                                      store="full", opts=options,
                                      resume=resume, **kw))
    params = _params(cc, device)
    if resume:
        jv0 = (_on(initial_jv, device) if initial_jv is not None
               else init_jv(cc, device=device))
        out = fn(params, _on(initial_state, device), float(resume_t), jv0)
    else:
        out = fn(params, init_state(cc, device=device))
    if bool(out.fail[0]):
        raise RuntimeError("transient failed to converge at minimum timestep")
    n = int(out.out_n[0])
    r = results_mod.from_tran(cc, _host(out.out_t[:, :n]),
                              _host(out.out_x[:, :n]), n)
    r.final_state = _numpy_lane0(out.state)
    r.final_jv = _numpy_lane0(out.jv)
    r.final_time = float(out.t_final[0])
    return r


def run_ac(src, sweep=None, fstart=None, fstop=None, points=None,
           options: SimOptions = DEFAULTS,
           semantics: str = "compat", device="cuda") -> Results:
    cc = _to_compiled(src)
    ap = cc.netlist.ac
    freqs = frequency_points(
        sweep or ap.sweep,
        fstart if fstart is not None else ap.fstart,
        fstop if fstop is not None else ap.fstop,
        points if points is not None else ap.points,
    )
    fn = _engine(cc, ("ac", options, semantics), device,
                 lambda kw: make_ac(cc, options, semantics, **kw))
    xr, xi, opr = fn(_params(cc, device), init_state(cc, device=device),
                     freqs)
    if not bool(opr.converged[0]):
        raise RuntimeError("AC bias point failed to converge")
    return results_mod.from_ac(cc, freqs, _host(xr), _host(xi))


def run_dc(src, sources=None, starts=None, stops=None, increments=None,
           options: SimOptions = DEFAULTS,
           semantics: str = "compat", device="cuda") -> Results:
    cc = _to_compiled(src)
    dp = cc.netlist.dc
    if sources is None:
        sources = [dp.source1] + ([dp.source2] if dp.source2 else [])
        starts = [dp.start1] + ([dp.start2] if dp.source2 else [])
        stops = [dp.stop1] + ([dp.stop2] if dp.source2 else [])
        increments = [dp.increment1] + ([dp.increment2] if dp.source2
                                        else [])

    slots = []
    for s in sources:
        if s not in cc.names["V"]:
            raise RuntimeError(f"source {s} not found")
        slots.append(cc.names["V"].index(s))

    sweeps = [sweep_values(a, b, c)
              for a, b, c in zip(starts, stops, increments)]
    nested = len(sources) == 2
    if nested:
        pts = np.array([(v1, v2) for v1 in sweeps[0] for v2 in sweeps[1]],
                       dtype=np.float64)
    else:
        pts = np.asarray(sweeps[0], dtype=np.float64)

    fn = _engine(cc, ("dc", tuple(slots), options, semantics), device,
                 lambda kw: make_dc(cc, tuple(slots), options, semantics,
                                    solve=kw.get("solve")))
    xs, conv = fn(_params(cc, device), init_state(cc, device=device), pts)
    conv = _host(conv)
    if not conv.all():
        bad = int(np.argmin(conv))
        raise RuntimeError(f"DC sweep failed to converge at point {bad}")
    return results_mod.from_dc(cc, pts, _host(xs), nested=nested)


def run_analysis(src, semantics: str = "compat",
                 options: SimOptions = DEFAULTS, device="cuda") -> Results:
    cc = _to_compiled(src)
    if cc.analysis == AnalysisType.OP:
        return run_op(cc, options=options, semantics=semantics,
                      device=device)
    if cc.analysis == AnalysisType.TRAN:
        return run_transient(cc, semantics=semantics, options=options,
                             device=device)
    if cc.analysis == AnalysisType.AC:
        return run_ac(cc, options=options, semantics=semantics,
                      device=device)
    if cc.analysis == AnalysisType.DC:
        return run_dc(cc, options=options, semantics=semantics,
                      device=device)
    raise RuntimeError(f"unsupported analysis type: {cc.analysis}")
