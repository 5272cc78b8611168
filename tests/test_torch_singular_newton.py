"""A Newton that passes through a singular iteration, in the port's OP on
the CPU (the general engine, ``engine/op.make_op``, and the kernel engine,
the plain version of csrc/op_kernel.cu under ``make_op_fused``'s ladders)
against the JAX package's general engine (engine/op.py ``make_op``,
vmapped, as ``TOYSPICE_OP=general`` runs it).

Both decks hang a node ``f`` between two diodes whose GMIN is 0 (a batched
override): plain NR's first solve treats every diode as its zero-bias
conductance, which leaves D1 and D2 reverse-biased past -3·N·Vt, so the
second iteration's matrix has an all-zero column at ``f`` and a zero pivot
poisons the solve.

* V_DRIVEN: the column of ``f`` is eliminated before the supply's branch
  current, so every x of that solve is NaN in both packages; plain NR and
  the gmin ladder stay non-finite (the companion currents carry the NaN),
  and source stepping recovers from its 10 % estimate (stage 2, converged).
* I_DRIVEN: no voltage source, so ``f`` is the last column; there the port
  used to leave +inf in x[f] where the JAX package's one-hot gather gives
  NaN everywhere, and the lane's x parted from the reference.  Every
  elimination now sets each x of a system to NaN when any is non-finite.

The bar is tests/test_torch_op.py's: ``converged`` and ``stage`` equal per
lane, x and the junction voltages within rtol 1e-9 (NaN where the
reference is NaN), and the singular iteration seen in every lane."""

import numpy as np
import pytest
import torch

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.op import make_op
from toyspice_tpu_torch.ops.solve_stamped import solve_plain

from test_torch_op import assert_matches, reference

V_DRIVEN = """* a diode pair the first Newton step leaves reverse-biased
.op
Vs 1 0 DC 2
Ra 1 n1 1k
D4 n1 0 DN
Rb 1 n2 1k
Rc n2 0 1k
D2 n2 f DZ
D1 f n1 DZ
.model DN D(Is=1e-6)
.model DZ D(Is=1e-14)
"""

I_DRIVEN = V_DRIVEN.replace("Vs 1 0 DC 2", "I1 1 0 DC 5m")

LANES = 2


def overrides(lanes=LANES):
    """D2 and D1 without GMIN, Ra spread a little per lane."""
    return {"D": {"gmin": np.tile([1e-12, 0.0, 0.0], (lanes, 1))},
            "R": {"value": np.asarray([[1e3, 1e3, 1e3], [1.05e3, 1e3,
                                                          1e3]])}}


@pytest.mark.parametrize("deck,converged,stage", [
    (V_DRIVEN, True, 2), (I_DRIVEN, False, 2)],
    ids=["v_driven_recovers", "i_driven_last_column"])
def test_singular_iteration_matches_general_engine(deck, converged, stage):
    params_np, ref = reference(deck, overrides())
    cc = ts.compile_circuit(ts.parse(deck))
    params = params_from_numpy(params_np, device="cpu")
    state0 = ts.init_state(cc, device="cpu")
    singular = torch.zeros(LANES, dtype=torch.bool)

    def watched(pat, vals, rvals, gmin):
        nonlocal singular
        x = solve_plain(pat, vals, rvals, gmin)
        bad = ~torch.isfinite(x).all(dim=1)
        # a singular solve's x is NaN throughout, as in the JAX package
        assert bool(torch.isnan(x[bad]).all())
        if x.shape[0] == LANES:
            singular = singular | bad
        return x

    general = make_op(cc, solve=watched)(params, state0)
    assert bool(singular.all())
    for out in (general, ts.run_op_batch(cc, params)):
        assert_matches(out, ref)
        assert out.converged.tolist() == [converged] * LANES
        assert out.stage.tolist() == [stage] * LANES
        assert bool(torch.isfinite(out.x).all()) == converged
