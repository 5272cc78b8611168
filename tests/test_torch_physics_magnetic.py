"""The port's physics transient of magnetic decks on the CPU
(``make_tran_batch(semantics="physics")``: the linear OP with the LM
+1e-3 branch diagonal, the bias-point seed of each winding's current, and
the plain version of the run kernel's PHYS·MAG instantiation, with the
live Jiles-Atherton core committed on every accepted step and the physics
mutual M = k·sqrt(La·Lb) from the live inductances) against the JAX
package's general engine (``vmap(make_tran(semantics="physics"))``),
under backward Euler and the trapezoidal rule:

* ``saturating_transformer.cir`` (two LM windings on one core, K = 0.98)
  to its 2 ms, the main path's deck;
* ``coupled_inductors.cir`` (K between two linear L) stopped at 0.3 ms as
  tests/test_torch_magnetic.py stops it: trap doubles M to 2M/dt once
  both windings have history;
* TRANS_SMALL (tests/test_fused_tran.py), where the JAX run kernel misses
  the general engine by 1.96e-3 in LM.M under physics/be (VERDICT.md);
* XFMR_MAG (tests/test_fused_tran.py, transformer3's topology) under
  physics/be, every counter (``fail`` included) per lane;
* the linear primary coupled to a saturating secondary
  (tests/test_torch_magnetic.py's LINEAR_PRIMARY), the only deck whose K
  pairs a linear L with an LM (no 2M/dt), stopped at 2 us (18 accepted
  steps under BE, 21 under trap): past ~25 its state is rounding-bound
  (tests/test_torch_physics_magnetic_paths.py).

4 lanes, R spread log-normally by 0.1 from ``default_rng(13)``; the bar of
tests/test_torch_physics_run.py: ``accepted``, ``attempts``, ``fail`` and
``nr_iters`` equal per lane, t_final, state (all ten LM rows) and jv
within rtol 1e-9 of each leaf's scale."""

import numpy as np
import pytest

from test_fused_tran import TRANS_SMALL, XFMR_MAG
from test_torch_magnetic import LINEAR_PRIMARY
from test_torch_physics_run import (assert_physics_matches, deck_file,
                                    port, reference, spread)

LM_ROWS = ("i0", "i1", "v0", "v1", "flux0", "H", "Hold", "M", "Mirr",
           "dMdH")

# name: (deck, stop time or None for the deck's own)
DECKS = {"saturating_transformer": (deck_file("saturating_transformer.cir"),
                                    None),
         "coupled_inductors": (deck_file("coupled_inductors.cir"), 3e-4),
         "trans_small": (TRANS_SMALL, None),
         "xfmr_mag": (XFMR_MAG, None),
         "linear_primary": (LINEAR_PRIMARY, 2e-6)}
CASES = [("saturating_transformer", "be"), ("saturating_transformer", "trap"),
         ("coupled_inductors", "be"), ("coupled_inductors", "trap"),
         ("trans_small", "be"), ("trans_small", "trap"), ("xfmr_mag", "be"),
         ("linear_primary", "be"), ("linear_primary", "trap")]


def run_case(name, integration):
    deck, tstop = DECKS[name]
    cfg, params_np, ref = reference(deck, spread(deck, ("R",)), integration,
                                    cfg_edit={"tstop": tstop} if tstop
                                    else None)
    return cfg, ref, port(deck, cfg, params_np, integration)


@pytest.mark.parametrize("name,integration", CASES,
                         ids=[f"{n}-{i}" for n, i in CASES])
def test_physics_magnetic_matches_general_engine(name, integration):
    cfg, ref, out = run_case(name, integration)
    assert_physics_matches(out, ref, cfg)
    np.testing.assert_array_equal(out.fail.numpy(), np.asarray(ref.fail))
    assert bool((out.accepted > 0).all())
    if "LM" in ref.state:
        assert set(out.state["LM"]) == set(LM_ROWS)
        # the core moved: physics commits it (compat freezes it at 0)
        assert float(out.state["LM"]["M"].abs().max()) > 0


def test_trans_small_lm_m_gap():
    """The cell where the JAX package disagrees with itself (TRANS_SMALL
    physics/be: its run kernel's LM.M 1.96e-3 from the general engine):
    the port's f64 leg sits on the general engine, far inside 1e-9."""
    _, ref, out = run_case("trans_small", "be")
    a = np.asarray(ref.state["LM"]["M"])
    gap = float(np.abs(out.state["LM"]["M"].numpy() - a).max()
                / np.abs(a).max())
    assert gap < 1e-9
    assert not bool(out.fail.any())
