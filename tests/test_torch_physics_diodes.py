"""The port's physics transient on the Rs and Bv diodes against the JAX
package's general engine, under BE and trap (the bar and the helpers of
tests/test_torch_physics_run.py): the DC-driven decks of
tests/test_physics_mode.py (an Rs diode forward, a Bv diode in
breakdown), whose runs start at their physics bias point, and the same
diodes driven by a sine into a capacitor with a transit time, which take
the Rs inner Newton and the breakdown-frame limit through a transient."""

import pytest

from test_torch_physics_run import (assert_physics_matches, port, reference,
                                    spread)

D_RS = """* forward diode with series resistance
.tran 0.05m 0.5m
Vin 1 0 DC 5
R1 1 2 1k
D1 2 0 DM
.model DM D (Is=1e-14 Rs=100)
"""

D_BV = """* reverse diode into breakdown
.tran 0.05m 0.5m
Vin 1 0 DC -200
R1 1 2 1k
D1 2 0 DM
.model DM D (Is=1e-14 Bv=100)
"""

D_RS_SIN = """* Rs diode, sine drive
.tran 0.05m 0.5m
Vin 1 0 SIN(0 5 5k)
R1 1 2 1k
D1 2 0 DM
C1 2 0 10n
.model DM D (Is=1e-14 Rs=100 Tt=10n)
"""

D_BV_SIN = """* Bv diode, sine drive through breakdown
.tran 0.05m 0.5m
Vin 1 0 SIN(-150 60 5k)
R1 1 2 1k
D1 2 0 DM
C1 2 0 10n
.model DM D (Is=1e-14 Bv=100 Tt=10n)
"""


@pytest.mark.parametrize("integration", ["be", "trap"])
@pytest.mark.parametrize("name", ["d_rs", "d_bv"])
def test_dc_driven_diodes_match_general_engine(name, integration):
    deck = {"d_rs": D_RS, "d_bv": D_BV}[name]
    cfg, params_np, ref = reference(deck, spread(deck, ("R",)), integration)
    out = port(deck, cfg, params_np, integration)
    assert_physics_matches(out, ref, cfg)
    assert not out.fail.any()


@pytest.mark.parametrize("name", ["d_rs_sin", "d_bv_sin"])
def test_sine_driven_diodes_match_general_engine(name):
    deck = {"d_rs_sin": D_RS_SIN, "d_bv_sin": D_BV_SIN}[name]
    cfg, params_np, ref = reference(deck, spread(deck), "trap")
    out = port(deck, cfg, params_np, "trap")
    assert_physics_matches(out, ref, cfg)
    assert not out.fail.any()
    if name == "d_bv_sin":  # the run went through breakdown
        assert float(out.state["D"]["prev_id"].abs().max()) > 1e-6
