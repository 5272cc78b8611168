"""The port's mesh-sharded analyses (toyspice_tpu_torch/parallel/mesh.py)
on CPU shards against the JAX package's parallel/mesh.py on its virtual
8-device CPU mesh (tests/conftest.py), and against the port's own unsharded
batch runs.

Against JAX the bars are those of the unsharded comparisons: the counters
and flags equal per lane, the transient's state within rtol 1e-9
(tests/test_torch_run.py), the OP's x and the DC sweep's xs within rtol
1e-9, atol 1e-12 (tests/test_torch_op.py, tests/test_torch_dc.py), AC
within 2e-9 of the largest |x| (tests/test_torch_ac.py).  Against the
port's unsharded run a lane's arithmetic is the same, so every leaf must be
equal bit for bit.  Inputs are made with numpy from a seed and handed to
both packages."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.netlist.parser import parse as jax_parse
from toyspice_tpu.parallel import mesh as jax_mesh

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.batch import (make_dc_engine,
                                             select_op_engine)
from toyspice_tpu_torch.ops import _build
from toyspice_tpu_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-9, 1e-12
AC_TOL = 2e-9
SHARDS = 8

# __graft_entry__.py's RLC_TINY and tests/test_mesh.py's RC_AC
RLC_TINY = """* RC tiny
.tran 0.02m 1m
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
C1 2 0 1u
"""

RC_AC = """* rc ac
.ac DEC 4 10 100k
Vin 1 0 AC 1 0
R1 1 2 1k
C1 2 0 1u
"""


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


def _numpy(tree):
    return {k: {kk: np.asarray(v) for kk, v in t.items()}
            for k, t in tree.items()}


def both(deck, b, kind="R", seed=0):
    """(jax cc, params, axes; port cc, params, axes) for the deck with the
    ``kind`` values spread log-normally by 0.05 over b lanes."""
    cc_j = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(seed)
    base = np.asarray(cc_j.params[kind]["value"])
    ov = {kind: {"value": base[None, :] * np.exp(
        rng.normal(0, 0.05, size=(b, len(base))))}}
    params_j, axes = jax_batch_params(cc_j, ov)
    cc_p = ts.compile_circuit(ts.parse(deck))
    params_p = params_from_numpy(_numpy(params_j), device="cpu")
    return cc_j, params_j, cc_p, params_p, axes


def assert_bits(a, b, what):
    assert mesh._same_bits(a, b), f"{what}: sharded differs from unsharded"


def close(port, ref, rtol, atol, what):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


def test_sharded_transient_matches_jax_and_unsharded():
    cc_j, params_j, cc, params, axes = both(RLC_TINY, 16)
    tp = cc_j.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    ref, ref_total = jax_mesh.run_transient_sharded(
        cc_j, cfg, jax_mesh.make_mesh(SHARDS), params_j, axes)

    cfg_p = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    out, total = mesh.run_transient_sharded(
        cc, cfg_p, mesh.make_mesh(SHARDS, device="cpu"), params, axes)
    for key in ("accepted", "attempts", "fail"):
        np.testing.assert_array_equal(getattr(out, key).numpy(),
                                      np.asarray(getattr(ref, key)), key)
    assert total.dtype == torch.int64 and total.ndim == 0
    assert int(total) == int(ref_total) == int(out.accepted.sum()) > 0
    for kind in ref.state:
        for key in ref.state[kind]:
            a = np.asarray(ref.state[kind][key])
            close(out.state[kind][key], a, RTOL,
                  RTOL * max(1e-300, float(np.abs(a).max())),
                  f"state.{kind}.{key}")

    fn = ts.make_tran_batch(cc, cfg_p, axes)
    unsharded = fn(params, ts.init_state(cc, device="cpu"))
    assert_bits(out, unsharded, "transient")
    assert (mesh.run_transient_sharded.last_engine,
            mesh.run_transient_sharded.last_reason) == (fn.engine,
                                                        fn.engine_reason)



def test_general_engine_lanes_do_not_depend_on_their_batch(monkeypatch):
    """The general engine's host loops freeze a finished lane by mask, so
    its bits must not depend on which lanes share its batch: the
    rectifier's Newton transient (its general OP first) on 4 shards, bit
    for bit with the unsharded run."""
    monkeypatch.setenv("TOYSPICE_TRAN", "general")
    monkeypatch.setenv("TOYSPICE_OP", "general")
    _, _, cc, params, axes = both(_deck("half_wave_rectifier.cir"), 8,
                                  seed=9)
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax,
                          tp.uic)._replace(tstop=0.3e-3)
    out, total = mesh.run_transient_sharded(
        cc, cfg, mesh.make_mesh(4, device="cpu"), params, axes)
    assert mesh.run_transient_sharded.last_engine == "general"
    fn = ts.make_tran_batch(cc, cfg, axes)
    unsharded = fn(params, ts.init_state(cc, device="cpu"))
    assert_bits(out, unsharded, "general transient")
    assert int(total) == int(unsharded.accepted.sum()) > 0

def test_sharded_op_matches_jax_and_unsharded():
    cc_j, params_j, cc, params, axes = both(
        _deck("half_wave_rectifier.cir"), 16, seed=3)
    ref = jax_mesh.run_op_sharded(cc_j, jax_mesh.make_mesh(SHARDS),
                                  params_j, axes)
    out = mesh.run_op_sharded(cc, mesh.make_mesh(SHARDS, device="cpu"),
                              params, axes)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    assert bool(out.converged.all())
    close(out.x, ref.x, RTOL, ATOL, "x")

    assert_bits(out, ts.run_op_batch(cc, params, axes), "OP")
    assert (mesh.run_op_sharded.last_engine,
            mesh.run_op_sharded.last_reason) == select_op_engine(cc)


def test_sharded_dc_matches_jax_and_unsharded():
    deck = _deck("diode_iv_sweep.cir")
    cc_j, params_j, cc, params, axes = both(deck, 16, seed=5)
    d = cc.netlist.dc
    slot = (cc.names["V"].index(d.source1),)
    pts = np.asarray(ts.sweep_values(d.start1, d.stop1, d.increment1))
    xs_r, conv_r = jax_mesh.run_dc_sharded(
        cc_j, slot, jax_mesh.make_mesh(SHARDS), params_j, axes,
        jnp.asarray(pts))
    xs, conv = mesh.run_dc_sharded(cc, slot, mesh.make_mesh(
        SHARDS, device="cpu"), params, axes, pts)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_r))
    assert bool(conv.all())
    close(xs, xs_r, RTOL, ATOL, "xs")

    assert_bits((xs, conv), ts.run_dc_batch(cc, slot, params, axes, pts),
                "DC sweep")
    engine, reason, _ = make_dc_engine(cc, slot)
    assert (mesh.run_dc_sharded.last_engine,
            mesh.run_dc_sharded.last_reason) == (engine, reason)


def test_sharded_ac_2d_mesh_matches_jax_and_unsharded():
    cc_j, params_j, cc, params, axes = both(RC_AC, 8, seed=7)
    freqs = ts.frequency_points("DEC", 10.0, 100e3, 16)
    xr_r, xi_r, opr_r = jax_mesh.run_ac_sharded(
        cc_j, jax_mesh.make_mesh_2d((4, 2)), params_j, axes,
        jnp.asarray(freqs))
    m2 = mesh.make_mesh_2d((4, 2), device="cpu")
    assert m2.shape == {"data": 4, "sweep": 2} and m2.size == 8
    xr, xi, opr = mesh.run_ac_sharded(cc, m2, params, axes, freqs)
    assert xr.shape == (8, 16, cc.np1)
    np.testing.assert_array_equal(opr.converged.numpy(),
                                  np.asarray(opr_r.converged))
    scale = float(np.hypot(np.asarray(xr_r), np.asarray(xi_r)).max())
    close(xr, xr_r, AC_TOL, AC_TOL * scale, "xr")
    close(xi, xi_r, AC_TOL, AC_TOL * scale, "xi")

    assert_bits((xr, xi, opr), ts.run_ac_batch(cc, params, axes, freqs),
                "AC")


def test_uneven_batch_raises_as_jax_does():
    cc_j, params_j, cc, params, axes = both(RLC_TINY, 12)
    with pytest.raises(ValueError):
        jax_mesh.shard_batch(jax_mesh.make_mesh(SHARDS), params_j, axes)
    with pytest.raises(ValueError, match="does not split evenly"):
        mesh.shard_batch(mesh.make_mesh(SHARDS, device="cpu"), params, axes)


def test_shard_batch_splits_and_copies():
    _, _, cc, params, axes = both(RLC_TINY, 8)
    shards = mesh.shard_batch(mesh.make_mesh(4, device="cpu"), params, axes)
    assert shards.shape == (4,)
    for i, p in enumerate(shards):
        assert torch.equal(p["R"]["value"], params["R"]["value"][2 * i:
                                                                 2 * i + 2])
        assert torch.equal(p["C"]["value"], params["C"]["value"])


def test_make_mesh_needs_the_cards():
    with pytest.raises(RuntimeError, match="CUDA device"):
        mesh.make_mesh(max(2, torch.cuda.device_count() + 1))
    with pytest.raises(ValueError, match="indexed"):
        mesh.Mesh(np.array([torch.device("cuda")] * 2, dtype=object),
                  ("data",))
    m = mesh.make_mesh(3, device="cpu")
    assert list(m.devices) == [torch.device("cpu")] * 3
    assert mesh.make_mesh(device="cpu").size == 1


def test_worker_exception_reaches_the_caller():
    m = mesh.Mesh(np.array(["cpu"] * 4, dtype=object), ("data",))

    def work(pos, dev):
        if pos == (2,):
            raise ZeroDivisionError("shard 2")
        return pos

    with pytest.raises(ZeroDivisionError, match="shard 2"):
        mesh._run(m, [(i,) for i in range(4)], work)
    assert mesh._run(m, [(i,) for i in range(4)], lambda p, d: p) == {
        (i,): (i,) for i in range(4)}


def test_launch_counts_survive_threads():
    """Shards on several devices count launches from several threads: no
    increment may be lost."""
    def wrapper():
        pass

    wrapper.launches = 0
    threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [_build.count(wrapper) for _ in range(per)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == threads * per

