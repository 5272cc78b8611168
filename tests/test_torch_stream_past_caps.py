"""The streamed store (``make_tran_stream``, ``stream_transient_chunks``)
on decks the JAX package streams, on the CPU, 2 lanes from numpy seeds:

* a 62-stage RC ladder (np1 = 65), which the run kernel's store
  instantiation streams through its block bucket (engine "store");
* 33 current sources into one resistor (``_many_sources(33)`` of
  tests/test_torch_eligibility.py), past the kernels' former source cap:
  the store instantiation too (engine "store"; the general engine's pair
  runs only under the overrides, tests/test_torch_past_caps.py).

Each chunk's rows are bit for bit those of one ``store='full'`` run of
the port (the same engine), every lane's attempts equal at the end, and
the stitched rows are held to the JAX package's general engine with
``store='full'`` at the standing bar: out_n and the counters equal per
lane, out_x and out_t within rtol 1e-9 of their scale.
"""

import numpy as np
import pytest
import torch

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy

from test_torch_eligibility import _many_sources
from test_torch_wide_bucket import rc_ladder

RTOL = 1e-9
LANES = 2

CASES = {"np1_65": (rc_ladder(62), ("R", "C"), "store", "whole-run"),
         "33_sources": (_many_sources(33), ("R",), "store", "whole-run")}


@pytest.mark.parametrize("name", list(CASES))
def test_stream_chunks_match_one_store_run_and_jax(name):
    from test_torch_general import jax_reference, spread

    deck, kinds, engine, reason = CASES[name]
    cfg, params_np, ref = jax_reference(deck, spread(deck, kinds,
                                                     lanes=LANES),
                                        store="full")
    cc = ts.compile_circuit(ts.parse(deck))
    params = params_from_numpy(params_np, device="cpu")
    state0 = ts.init_state(cc, device="cpu")
    whole = ts.make_tran_batch(cc, cfg, None, store="full")(params, state0)
    assert not bool(whole.store_overflow.any())
    chunk = int(whole.out_n.max()) // 3 + 1
    fns = ts.make_tran_stream(cc, cfg, chunk)
    assert all(f.engine == engine and reason in f.engine_reason
               for f in fns)
    chunks = list(ts.stream_transient_chunks(cc, cfg, params, state0, chunk,
                                             fns=fns))
    assert len(chunks) >= 3
    n0 = torch.zeros_like(whole.out_n)
    for c in chunks:
        for lane in range(LANES):
            a, b = int(n0[lane]), int(c.out_n[lane])
            assert torch.equal(c.out_x[lane, :b], whole.out_x[lane, a:a + b])
            assert torch.equal(c.out_t[lane, :b], whole.out_t[lane, a:a + b])
        n0 += c.out_n
    assert torch.equal(n0, whole.out_n)
    assert torch.equal(chunks[-1].attempts, whole.attempts)
    assert torch.equal(sum(c.accepted for c in chunks), whole.accepted)
    assert torch.equal(sum(c.nr_iters for c in chunks), whole.nr_iters)

    so = ts.run_transient_streamed(cc, cfg, params, state0, chunk)
    np.testing.assert_array_equal(so.out_n.numpy(), np.asarray(ref.out_n))
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        np.testing.assert_array_equal(getattr(so, key).numpy(),
                                      np.asarray(getattr(ref, key)), key)
    kmax = int(so.out_n.max())
    want_x = np.asarray(ref.out_x)[:, :kmax]
    want_t = np.asarray(ref.out_t)[:, :kmax]
    np.testing.assert_allclose(so.out_x.numpy(), want_x, rtol=RTOL,
                               atol=RTOL * np.abs(want_x).max())
    np.testing.assert_allclose(so.out_t.numpy(), want_t, rtol=RTOL, atol=0)
