"""The port's profiling hooks (``utils/profiling.py``) and debug printers
(``debug.py``) on the CPU, against the JAX package's.

* ``trace``/``report`` count calls and wall time as the JAX package's do,
  failed regions included; ``start_trace``/``stop_trace`` write a Chrome
  trace of a ``torch.profiler`` run into the directory.
* ``tran_stats`` of the port's TranOutput equals the JAX package's of its
  own run (the counters are equal).
* ``print_parse_report``, ``print_element_details`` and ``print_system``
  print the JAX package's text, character for character, on decks of
  every device kind.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from toyspice_tpu import debug as jdebug
from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.engine.tran import make_tran as jax_make_tran
from toyspice_tpu.netlist.parser import parse as jax_parse
from toyspice_tpu.utils import profiling as jprof

import toyspice_tpu_torch as pts
from toyspice_tpu_torch import debug
from toyspice_tpu_torch.utils import profiling

from test_torch_api import deck_text

RR = """* divider
.op
Vin 1 0 DC 5
R1 1 2 1k
R2 2 0 1k
"""
RC = """* rc
.tran 0.05m 1m
V1 1 0 SIN(0 5 1k)
R1 1 2 100
C1 2 0 1u
"""


def test_trace_report():
    profiling.report(reset=True)
    for _ in range(2):
        with profiling.trace("op"):
            pts.run_op(RR, device="cpu")
    with pytest.raises(RuntimeError):
        with profiling.trace("fails"):
            raise RuntimeError("counted anyway")
    rep = profiling.report(reset=True)
    assert rep["op"]["calls"] == 2 and rep["op"]["total_s"] > 0
    assert rep["fails"]["calls"] == 1
    assert profiling.report() == {}
    # the JAX package's report has the same shape
    jprof.report(reset=True)
    with jprof.trace("op"):
        pass
    assert set(jprof.report(reset=True)["op"]) == set(rep["op"])


def test_start_stop_trace_writes_a_chrome_trace(tmp_path):
    profiling.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        profiling.start_trace(str(tmp_path))
    with profiling.trace("divider"):
        pts.run_op(RR, device="cpu")
    path = profiling.stop_trace()
    with pytest.raises(RuntimeError, match="no trace"):
        profiling.stop_trace()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "divider" for e in events)


def test_tran_stats_matches_jax():
    cc = jax_compile(jax_parse(RC))
    tp = cc.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params = {k: {kk: jnp.asarray(vv) for kk, vv in t.items()}
              for k, t in cc.params.items()}
    jout = jax.jit(jax_make_tran(cc, cfg, store="none"))(params,
                                                         jax_init_state(cc))
    pc = pts.compile_circuit(pts.parse(RC))
    pcfg = pts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    pparams = pts.batch_params(pc, {}, device="cpu")[0]
    pout = pts.make_tran(pc, pcfg, store="none")(
        pparams, pts.init_state(pc, device="cpu"))
    want = jprof.tran_stats(jout, wall_s=1.0)
    got = profiling.tran_stats(pout, wall_s=1.0)
    assert got == want
    assert got["accepted_steps"] >= 29 and got["failed_instances"] == 0


def _printed(mod, cc, **kw):
    buf = io.StringIO()
    mod.print_parse_report(cc, out=buf)
    mod.print_element_details(cc, out=buf)
    mod.print_system(cc, out=buf, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", ["divider_op.cir", "ce_amplifier_op.cir",
                                  "half_wave_rectifier.cir",
                                  "nmos_inverter_tran.cir",
                                  "saturating_transformer.cir",
                                  "pwl_drive.cir"])
def test_printers_match_jax(name):
    text = deck_text(name)
    want = _printed(jdebug, jax_compile(jax_parse(text)))
    got = _printed(debug, pts.compile_circuit(pts.parse(text)),
                   device="cpu")
    assert got == want


def test_system_snapshot_matches_jax():
    text = deck_text("ce_amplifier_op.cir")
    ja, jb = jdebug.system_snapshot(jax_compile(jax_parse(text)))
    pa, pb = debug.system_snapshot(pts.compile_circuit(pts.parse(text)),
                                   device="cpu")
    np.testing.assert_allclose(pa, ja, rtol=1e-15, atol=0)
    np.testing.assert_allclose(pb, jb, rtol=1e-15, atol=0)
