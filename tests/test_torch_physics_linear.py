"""The port's physics transient on a BJT deck and on linear decks against
the JAX package's general engine, under BE and trap (the bar and the
helpers of tests/test_torch_physics_run.py).

* The CE-amplifier BJT transient of tests/test_torch_run_nonlinear.py from
  its physics bias point.  ``nr_iters`` is not held there: at the bias
  point the coupling capacitor's node sits near 1e-9 V between companion
  terms of ~100 S, so rounding moves it by ~3e-12 V from one Newton
  iteration to the next, above abstol (1e-12): when a lane's Newton
  stops depends on each engine's last bits, and the counts differ by a
  few per hundred.  The accepted steps, attempts, failures and the state
  agree at the bar.
* rc_lowpass_tran.cir and rlc_ringdown.cir: a physics run of a linear
  deck starts from the linear OP's bias point (the stamped solve), then
  the PHYS linear instantiation.  rlc_ringdown.cir is cut to 0.1 ms: its
  1 ms is ~20,800 attempts per lane, ~35 s of the plain version on one
  core."""

import pytest

from test_torch_physics_run import (assert_physics_matches, deck_file, port,
                                    reference, spread)

from test_torch_run_nonlinear import BJT_TRAN


@pytest.mark.parametrize("integration", ["be", "trap"])
def test_bjt_transient_matches_general_engine(integration):
    cfg, params_np, ref = reference(BJT_TRAN, spread(BJT_TRAN), integration)
    out = port(BJT_TRAN, cfg, params_np, integration)
    assert_physics_matches(out, ref, cfg,
                           counters=("accepted", "attempts", "fail"))
    assert not out.fail.any()


@pytest.mark.parametrize("integration", ["be", "trap"])
@pytest.mark.parametrize("name,keys,edit", [
    ("rc_lowpass_tran.cir", ("R", "C"), None),
    ("rlc_ringdown.cir", ("R", "L", "C"), {"tstop": 1e-4})],
    ids=["rc_lowpass", "rlc_ringdown"])
def test_linear_decks_match_general_engine(name, keys, edit, integration):
    deck = deck_file(name)
    cfg, params_np, ref = reference(deck, spread(deck, keys), integration,
                                    cfg_edit=edit)
    out = port(deck, cfg, params_np, integration)
    assert_physics_matches(out, ref, cfg)
    assert not out.fail.any()
