"""The port's single-instance API (``toyspice_tpu_torch.run_analysis`` and
``run_op``/``run_transient``/``run_ac``/``run_dc``) on the CPU against the
JAX package's (``toyspice_tpu.run_analysis``), on the decks of
``circuits/``.

* Every deck, compat: the same keys and row counts, every series within
  rtol 1e-9 of its largest magnitude plus atol 1e-12 (a series such as
  rl_tran's V(n1) = 9 V - I·47 Ω is a difference of volts, so its rounding
  is the volts'); an AC node's phase is compared through its phasor
  MAG·e^(j·PHASE) at that tolerance, since the phase of a node at
  rounding noise (ce_amplifier_ac's V(vcc), ~1e-24 against an exact 0) is
  the angle of that noise.  The three decks whose runs take 20,000 steps
  (rl_tran, rlc_ringdown, coupled_inductors) have files of their own
  (``test_torch_api_<deck>.py``), each checking the CLI on the same run.
* Physics, backward Euler and trapezoidal, on half_wave_rectifier.cir and
  saturating_transformer.cir.
* A transient resumed from a first leg's ``.final_state``/``.final_time``/
  ``.final_jv`` (numpy) equals the JAX package's same split run, and
  tracks the one-piece run as the JAX package's own test asks.
* Each ``RuntimeError`` message of the JAX package on a deck that fails.
"""

import os

import numpy as np
import pytest
import torch

import toyspice_tpu as jts
import toyspice_tpu_torch as pts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CIRCUITS = os.path.join(ROOT, "circuits")
RTOL, ATOL = 1e-9, 1e-12
# 20,000-step transients: a file each (test_torch_api_<deck>.py)
LONG = ("rl_tran.cir", "rlc_ringdown.cir", "coupled_inductors.cir")
DECKS = sorted(f for f in os.listdir(CIRCUITS)
               if f.endswith(".cir") and f not in LONG)


def deck_path(name):
    return os.path.join(CIRCUITS, name)


def deck_text(name):
    with open(deck_path(name)) as f:
        return f.read()


def _series_close(key, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (key, got.shape, want.shape)
    scale = np.abs(want).max(initial=0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL + RTOL * scale,
                               err_msg=key)


def assert_results_match(got, want):
    """The same keys and row counts; each series within RTOL of its
    largest magnitude plus ATOL; AC phases through the phasor."""
    assert set(got) == set(want)
    for key in want:
        if key.endswith("_PHASE"):
            name = key[:-len("_PHASE")]

            def phasor(r):
                return r[name + "_MAG"] * np.exp(
                    1j * np.radians(r[key]))

            _series_close(key, phasor(got), phasor(want))
        else:
            _series_close(key, got[key], want[key])


@pytest.mark.parametrize("name", DECKS)
def test_run_analysis_matches_jax(name):
    want = jts.run_analysis(deck_path(name))
    got = pts.run_analysis(deck_path(name), device="cpu")
    assert_results_match(got, want)


@pytest.mark.parametrize("integration", ["be", "trap"])
@pytest.mark.parametrize("name", ["half_wave_rectifier.cir",
                                  "saturating_transformer.cir"])
def test_physics_matches_jax(name, integration):
    want = jts.run_analysis(deck_path(name), semantics="physics",
                            options=jts.SimOptions(integration=integration))
    got = pts.run_analysis(deck_path(name), semantics="physics",
                           options=pts.SimOptions(integration=integration),
                           device="cpu")
    assert_results_match(got, want)


RC_SIN = """* rc sine drive
.tran 0.02m 1m uic
V1 1 0 SIN(0 5 2k)
R1 1 2 1k
C1 2 0 100n
"""


@pytest.mark.parametrize("deck", [
    RC_SIN, deck_text("half_wave_rectifier.cir")],
    ids=["rc_sin", "half_wave_rectifier"])
def test_resume_matches_jax_and_the_one_piece_run(deck):
    legs = []
    for ts_, kw in ((jts, {}), (pts, {"device": "cpu"})):
        tstop = ts_.compile_circuit(ts_.parse(deck)).netlist.tran.tstop
        half = ts_.run_transient(deck, tstop=tstop / 2, **kw)
        rest = ts_.run_transient(deck, initial_state=half.final_state,
                                 resume_t=half.final_time,
                                 initial_jv=half.final_jv, **kw)
        legs.append((half, rest))
    (jhalf, jrest), (phalf, prest) = legs
    assert_results_match(phalf, jhalf)
    assert_results_match(prest, jrest)
    assert prest.final_time == pytest.approx(jrest.final_time, abs=0)
    for kind, tbl in jrest.final_state.items():
        for key, leaf in tbl.items():
            _series_close(f"{kind}.{key}", prest.final_state[kind][key],
                          leaf)
    assert prest["TIME"][0] >= phalf.final_time
    full = pts.run_transient(deck, device="cpu")
    # different step grids near the seam: the JAX package's bar
    # (tests/test_checkpoint.py) on every node at the end
    for key in full:
        if key.startswith("V("):
            v_full, v_split = full[key][-1], prest[key][-1]
            assert abs(v_split - v_full) < 0.15 * max(1.0, abs(v_full))


HARD_I = """i-driven stack
{card}
I1 0 1 DC 1
D1 1 2 DM
D2 2 3 DM
D3 3 0 DM
{extra}
.model DM D (Is=1e-18 N=0.7)
"""
FAILING = {
    "op": (HARD_I.format(card=".op", extra=""),
           "operating point failed to converge"),
    "tran": (HARD_I.format(card=".tran 1u 10u", extra=""),
             "transient failed to converge at minimum timestep"),
    "ac": (HARD_I.format(card=".ac dec 2 10 100",
                         extra="Vac 9 0 AC 1\nR9 9 0 1k"),
           "AC bias point failed to converge"),
    "dc": (HARD_I.format(card=".dc Vx 0 1 0.5",
                         extra="Vx 9 0 DC 0\nR9 9 0 1k"),
           "DC sweep failed to converge at point 0"),
}


@pytest.mark.parametrize("analysis", sorted(FAILING))
def test_runtime_errors_match_jax(analysis):
    deck, message = FAILING[analysis]
    with pytest.raises(RuntimeError) as jerr:
        jts.run_analysis(deck)
    with pytest.raises(RuntimeError) as perr:
        pts.run_analysis(deck, device="cpu")
    assert str(perr.value) == str(jerr.value) == message


def test_dc_unknown_source_message():
    deck = deck_text("diode_iv_sweep.cir")
    kw = dict(sources=["Vnone"], starts=[0.0], stops=[1.0],
              increments=[0.5])
    with pytest.raises(RuntimeError) as jerr:
        jts.run_dc(deck, **kw)
    with pytest.raises(RuntimeError) as perr:
        pts.run_dc(deck, device="cpu", **kw)
    assert str(perr.value) == str(jerr.value) == "source Vnone not found"


def test_engine_cache_is_keyed_on_the_device(monkeypatch):
    """One engine for "cpu" and torch.device("cpu"), keyed on the device
    and on TOYSPICE_SOLVER, whose solves the engine is built with."""
    monkeypatch.delenv("TOYSPICE_SOLVER", raising=False)
    cc = pts.compile_circuit(pts.parse(deck_text("divider_op.cir")))
    pts.run_op(cc, device="cpu")
    pts.run_op(cc, device=torch.device("cpu"))
    keys = list(cc._engines)
    assert len(keys) == 1 and keys[0][-2:] == ("cpu", "auto")
    monkeypatch.setenv("TOYSPICE_SOLVER", "xla")
    pts.run_op(cc, device="cpu")
    assert [k[-2:] for k in cc._engines] == [("cpu", "auto"), ("cpu", "xla")]
