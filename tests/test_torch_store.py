"""The port's waveform store on the CPU: ``make_tran_batch(store='full')``
(the plain version of the whole-run kernel's store instantiation, the
counterpart of ``make_tran_fused``) against the JAX package's general
engine with ``store='full'`` (``vmap(make_tran)``), and the streamed store
(``stream_transient_chunks``, ``run_transient_streamed``) against the
port's own monolithic run.

* ``store='full'`` on rc_lowpass_tran, rl_tran, pwl_drive,
  half_wave_rectifier, coupled_inductors and saturating_transformer from
  ``circuits/``, on an RC driven by SIN with trtol = 0.0125 (accepted and
  rejected attempts interleave) and on an RC with tstart = 0.4 ms, 4 lanes
  each with R spread from ``default_rng``: ``out_n`` equal per lane,
  ``out_t`` and ``out_x`` within rtol 1e-9 on the stored rows and exactly
  0 past them, the counters equal, state within 1e-9 and
  ``store_overflow`` all False.  rl_tran and the linear transformer run
  to 0.1 and 0.2 ms of their 0.6 and 1.5 ms: the compat inductor LTE paces
  them near minstep, and the plain version's CPU time grows with it.
* The same lanes with ``store='none'`` give bit-identical counters, state,
  jv, t_final and dt_final: storing does not move the trajectory.
* The streamed store (tests/test_stream_store.py's cases): with
  ``chunk_store=16`` the stitched chunks equal the monolithic run bit for
  bit over several re-entries, full chunks pause a lane without
  truncating it, ``max_attempts`` binds the whole run, and ``stream=True``
  needs ``store='full'``.

Each JAX engine is built and run once per deck (a module-scope cache).
"""

import os

import numpy as np
import pytest
import torch

import jax

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.options import SimOptions as JaxOptions
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.engine.tran import make_tran
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.options import SimOptions
from toyspice_tpu_torch.ops import run

from test_torch_run import RTOL, assert_matches, lognormal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 4


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


RC_SIN = """* rc sin
.tran 0.02m 1m
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
C1 2 0 1u
"""

RC_TSTART = """* rc sin with tstart
.tran 0.02m 1m 0.4m
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
C1 2 0 1u
"""

# name: (deck, stop time or None for the deck's own, trtol or None)
CASES = {
    "rc_lowpass_tran": (_deck("rc_lowpass_tran.cir"), None, None),
    "rl_tran": (_deck("rl_tran.cir"), 1e-4, None),
    "pwl_drive": (_deck("pwl_drive.cir"), None, None),
    "half_wave_rectifier": (_deck("half_wave_rectifier.cir"), None, None),
    "coupled_inductors": (_deck("coupled_inductors.cir"), 2e-4, None),
    "saturating_transformer": (_deck("saturating_transformer.cir"), None,
                               None),
    "rc_sin_reject_churn": (RC_SIN, None, 0.0125),
    "rc_tstart": (RC_TSTART, None, None),
}

_cache = {}


def case(name):
    """(cfg, port params, port cc, JAX store='full' output) of one case,
    built once."""
    if name in _cache:
        return _cache[name]
    deck, tstop, trtol = CASES[name]
    cc = jax_compile(jax_parse(deck))
    jopts = JaxOptions() if trtol is None else JaxOptions(trtol=trtol)
    tp = cc.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic,
                           jopts)
    if tstop is not None:
        cfg = cfg._replace(tstop=tstop)
    rng = np.random.default_rng(31)
    ov = {"R": {"value": lognormal(rng, cc.params["R"]["value"], LANES)}}
    params, axes = jax_batch_params(cc, ov)
    ref = jax.jit(jax.vmap(make_tran(cc, cfg, store="full", opts=jopts),
                           in_axes=(axes, None)))(params, jax_init_state(cc))
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    pcc = ts.compile_circuit(ts.parse(deck))
    _cache[name] = (cfg, params_from_numpy(params_np, device="cpu"), pcc,
                    ref, SimOptions() if trtol is None
                    else SimOptions(trtol=trtol))
    return _cache[name]


def port(name, store):
    """(fn, output) of the port on one case, run once per store."""
    if (name, store) not in _cache:
        cfg, params, pcc, _, opts = case(name)
        fn = ts.make_tran_batch(pcc, cfg, None, store=store, opts=opts)
        _cache[name, store] = fn, fn(params, ts.init_state(pcc,
                                                           device="cpu"))
    return _cache[name, store]


@pytest.mark.parametrize("name", list(CASES))
def test_store_full_matches_general_engine(name):
    cfg, _, _, ref, _ = case(name)
    fn, out = port(name, "full")
    assert fn.engine == "store" and "store instantiation" in fn.engine_reason
    assert_matches(out, ref)
    np.testing.assert_array_equal(out.out_n.numpy(), np.asarray(ref.out_n))
    assert not out.store_overflow.any()
    assert out.out_x.shape == (LANES, cfg.max_store, ref.out_x.shape[2])
    assert out.out_t.shape == (LANES, cfg.max_store)
    rx, rt = np.asarray(ref.out_x), np.asarray(ref.out_t)
    for lane in range(LANES):
        n = int(out.out_n[lane])
        assert n > 0
        np.testing.assert_allclose(out.out_t[lane, :n].numpy(), rt[lane, :n],
                                   rtol=RTOL, atol=0)
        scale = float(np.abs(rx[lane, :n]).max())
        np.testing.assert_allclose(out.out_x[lane, :n].numpy(),
                                   rx[lane, :n], rtol=RTOL,
                                   atol=RTOL * scale)
        assert not out.out_x[lane, n:].any()
        assert not out.out_t[lane, n:].any()
    if name == "rc_sin_reject_churn":
        assert bool((out.attempts > out.accepted).any())
    if name == "rc_tstart":
        assert bool((out.out_n < out.accepted).all())
        assert bool((out.out_t[:, 0] >= 0.4e-3).all())


@pytest.mark.parametrize("name", list(CASES))
def test_storing_does_not_move_the_trajectory(name):
    _, full = port(name, "full")
    fn, none = port(name, "none")
    assert fn.engine == "run"
    for key in ("accepted", "attempts", "fail", "nr_iters", "t_final",
                "dt_final"):
        assert torch.equal(getattr(none, key), getattr(full, key)), key
    for kind in full.state:
        for key in full.state[kind]:
            assert torch.equal(none.state[kind][key],
                               full.state[kind][key]), f"{kind}.{key}"
    for kind in full.jv:
        for key in full.jv[kind]:
            assert torch.equal(none.jv[kind][key], full.jv[kind][key])
    assert none.out_x.shape == (LANES, 1, full.out_x.shape[2])
    assert not none.out_n.any()


# ------------------------------------------------------- the streamed store

STREAM_LANES = 2


def _stream_setup():
    cc = ts.compile_circuit(ts.parse(RC_SIN))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    rng = np.random.default_rng(3)
    params, _ = ts.batch_params(cc, {"R": {"value": lognormal(
        rng, cc.params["R"]["value"], STREAM_LANES, 0.05)}}, device="cpu")
    return cc, cfg, params, ts.init_state(cc, device="cpu")


def test_streamed_equals_monolithic_bit_for_bit():
    cc, cfg, params, state0 = _stream_setup()
    mono = ts.make_tran_batch(cc, cfg, None, store="full")(params, state0)
    so = ts.run_transient_streamed(cc, cfg, params, state0, chunk_store=16)
    assert int(so.out_n.max()) > 3 * 16  # several re-entries
    assert torch.equal(so.out_n, mono.out_n)
    for key in ("accepted", "attempts", "fail", "nr_iters", "t_final",
                "dt_final", "store_overflow"):
        assert torch.equal(getattr(so, key), getattr(mono, key)), key
    for kind in mono.state:
        for key in mono.state[kind]:
            assert torch.equal(so.state[kind][key], mono.state[kind][key])
    n = int(so.out_n.max())
    assert torch.equal(so.out_x, mono.out_x[:, :n])
    assert torch.equal(so.out_t, mono.out_t[:, :n])


def test_stream_chunks_pause_not_truncate():
    cc, cfg, params, state0 = _stream_setup()
    outs = list(ts.stream_transient_chunks(cc, cfg, params, state0,
                                           chunk_store=16))
    assert len(outs) > 3
    for out in outs[:-1]:  # every chunk but the last fills its buffer
        assert out.out_n.tolist() == [16] * STREAM_LANES
        assert out.out_x.shape[1] == 16
    for out in outs:
        assert not out.store_overflow.any()
    assert outs[-1].t_final.tolist() == [cfg.tstop] * STREAM_LANES


def test_streamed_max_attempts_binds_the_whole_run():
    """max_attempts is the cumulative per-lane budget: the attempt count
    is carried into each re-entry, so the streamed run stops where the
    monolithic run stops."""
    cc, cfg, params, state0 = _stream_setup()
    cfg = cfg._replace(max_attempts=30)  # binds mid-run
    mono = ts.run_transient_batch(cc, cfg, params, None, state0,
                                  store="full")
    so = ts.run_transient_streamed(cc, cfg, params, state0, chunk_store=8)
    assert so.attempts.tolist() == [30] * STREAM_LANES
    assert bool((so.t_final < cfg.tstop).all())
    for key in ("attempts", "accepted", "out_n", "t_final", "dt_final"):
        assert torch.equal(getattr(so, key), getattr(mono, key)), key
    n = int(so.out_n.max())
    assert torch.equal(so.out_t, mono.out_t[:, :n])


def test_stream_requires_store_full():
    cc, cfg, _, _ = _stream_setup()
    with pytest.raises(ValueError, match="store='full'"):
        run.make_tran_run(cc, cfg, store="none", stream=True)


def test_overflow_drops_rows_and_warns():
    """Without the stream, a lane that keeps more rows than max_store
    drops the rest, sets store_overflow, and run_transient_batch warns;
    the trajectory is the same."""
    cc, cfg, params, state0 = _stream_setup()
    full = ts.make_tran_batch(cc, cfg, None, store="full")(params, state0)
    small = cfg._replace(max_store=10)
    with pytest.warns(RuntimeWarning, match="overflowed on 2"):
        out = ts.run_transient_batch(cc, small, params, None, state0,
                                     store="full")
    assert out.store_overflow.tolist() == [True] * STREAM_LANES
    assert out.out_n.tolist() == [10] * STREAM_LANES
    assert torch.equal(out.out_x, full.out_x[:, :10])
    assert torch.equal(out.accepted, full.accepted)
    assert torch.equal(out.t_final, full.t_final)
