"""The port's physics transient on MOSFET decks against the JAX package's
general engine, under BE and trap (the bar and the helpers of
tests/test_torch_physics_run.py): the NMOS inverter of
tests/test_trapezoidal.py (UIC: no OP, the Meyer-charge companions from
the zero state) and nmos_inverter_tran.cir (from its physics bias
point), whose committed charges and companion currents carry the MOSFET's
charge memory."""

import pytest

from test_torch_physics_run import (assert_physics_matches, deck_file, port,
                                    reference, spread)

# tests/test_trapezoidal.py's inverter at its 0.2 us step
M_TRAP = """nmos inverter trap
.tran 0.2u 20u uic
VDD 1 0 DC 5
VG 2 0 SIN(2.5 2 100k)
RD 1 3 10k
M1 3 2 0 0 NM L=2u W=20u
.model NM NMOS(VTO=0.7 KP=20u CGSO=1n CGDO=1n)
"""


@pytest.mark.parametrize("integration", ["be", "trap"])
def test_uic_inverter_matches_general_engine(integration):
    cfg, params_np, ref = reference(M_TRAP, spread(M_TRAP, ("R",)),
                                    integration)
    out = port(M_TRAP, cfg, params_np, integration)
    assert_physics_matches(out, ref, cfg)
    assert not out.fail.any()
    assert float(out.state["M"]["qgd"].abs().max()) > 0


@pytest.mark.parametrize("integration", ["be", "trap"])
def test_nmos_inverter_matches_general_engine(integration):
    deck = deck_file("nmos_inverter_tran.cir")
    cfg, params_np, ref = reference(deck, spread(deck), integration)
    out = port(deck, cfg, params_np, integration)
    assert_physics_matches(out, ref, cfg)
    assert not out.fail.any()
