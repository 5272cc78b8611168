"""The port's command line (``toyspice_tpu_torch.cli.main``, ``python -m
toyspice_tpu_torch``) on the CPU against the JAX package's.

* ``main([deck, "--platform", "cpu"])`` prints the JAX CLI's tables on
  every deck of ``circuits/`` (the three 20,000-step transients in
  ``test_torch_api_<deck>.py``).  The lines are equal but for numbers at
  the last printed digit or at rounding noise, which ``same_tables``
  admits and nothing else: two engines within rtol 1e-9 of each other
  print a value whose digits sit on a rounding edge one unit apart (a
  value as small as 1e-14 A prints four significant digits of rounding
  noise: half_wave_rectifier's I(Vac), nmos_inverter_tran's I(Vdd)), a
  zero with either sign (coupled_inductors' I(Ls) at its first rows), and
  the phase of an AC node whose magnitude is at rounding noise
  (ce_amplifier_ac's V(vcc), ~1e-24 against the port's exact 0).  The
  same decks' Results are held to the JAX package's at rtol 1e-9 in
  ``test_torch_api.py``.
* ``-v``: the same report, but for the engine line.
* A parse error exits 1 with the JAX CLI's message; ``--platform cuda``
  exits 1 without a card; the host engines run through the CLI.
"""

import contextlib
import io
import re
import subprocess
import sys

import pytest
import torch

from toyspice_tpu.cli import main as jax_main
from toyspice_tpu_torch.cli import main as port_main

from test_torch_api import DECKS, ROOT, deck_path

NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?")
NOISE = 1e-12  # the Results' atol: below it a value is rounding noise


def run_main(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _last_unit(token):
    """One unit of the last printed digit of a number token."""
    mant, _, exp = token.lower().partition("e")
    decimals = len(mant.partition(".")[2])
    return 10.0 ** (-decimals + (int(exp) if exp else 0))


def _scaled(token, unit_text):
    """The token's value in base units (the SI prefix that follows it)."""
    prefix = {"m": 1e-3, "u": 1e-6, "n": 1e-9, "p": 1e-12}
    return float(token) * prefix.get(unit_text[:1], 1.0) if len(
        unit_text) > 1 else float(token)


def same_line(a, b):
    """Equal, or equal in their text and in every number but one unit of
    the last printed digit, a signed zero, or at rounding noise (AC: a
    phase whose magnitude is noise on both sides)."""
    if a == b:
        return True
    ta, tb = NUMBER.split(a), NUMBER.split(b)
    na, nb = NUMBER.findall(a), NUMBER.findall(b)
    if len(na) != len(nb) or [t.strip() for t in ta] != [t.strip()
                                                         for t in tb]:
        return False
    noise_mag = False
    for i, (x, y) in enumerate(zip(na, nb)):
        after = ta[i + 1].strip()
        if after.startswith("deg") and noise_mag:
            noise_mag = False
            continue  # the phase of rounding noise
        if after.startswith("<"):  # an AC magnitude
            noise_mag = max(abs(float(x)), abs(float(y))) < NOISE
        if x == y or float(x) == float(y):
            continue
        unit = after.split()[0] if after.split() else ""
        if max(abs(_scaled(x, unit)), abs(_scaled(y, unit))) < NOISE:
            continue
        if abs(float(x) - float(y)) <= max(_last_unit(x),
                                           _last_unit(y)) * 1.0000001:
            continue
        return False
    return True


def same_tables(got, want):
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl)
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(gl, wl))
           if not same_line(g, w)]
    assert not bad, bad[:3]


@pytest.mark.parametrize("name", DECKS)
def test_tables_match_jax_cli(name):
    jrc, jout, _ = run_main(jax_main, [deck_path(name)])
    prc, pout, _ = run_main(port_main, [deck_path(name), "--platform",
                                        "cpu"])
    assert jrc == prc == 0
    same_tables(pout, jout)


def test_same_line_admits_only_last_digit_and_noise():
    assert same_line("V(a)=942.375 uV  ", "V(a)=942.376 uV  ")
    assert not same_line("V(a)=942.375 uV  ", "V(a)=942.377 uV  ")
    assert same_line("I(L)=-0.000e+00 A  ", "I(L)=0.000e+00 A  ")
    assert same_line("V(v)=7.38e-28<  90.0deg  ", "V(v)=       0<   0.0deg  ")
    assert not same_line("V(c)=  0.0057<  89.3deg  ",
                         "V(c)=  0.0057<  88.3deg  ")
    assert not same_line("V(a)=1.000 V", "I(a)=1.000 V")


@pytest.mark.parametrize("name", ["ce_amplifier_op.cir", "diode_iv_sweep.cir"])
def test_verbose_matches_but_for_the_engine_line(name):
    jrc, jout, _ = run_main(jax_main, [deck_path(name), "-v"])
    prc, pout, _ = run_main(port_main, [deck_path(name), "-v", "--platform",
                                        "cpu"])
    assert jrc == prc == 0
    jl, pl = jout.splitlines(), pout.splitlines()
    eng = [i for i, line in enumerate(jl) if line.startswith("engine: ")]
    assert len(eng) == 1
    assert pl[eng[0]].startswith("engine: xla (")
    assert "plain torch versions" in pl[eng[0]]
    del jl[eng[0]], pl[eng[0]]
    same_tables("\n".join(pl), "\n".join(jl))


def test_parse_error_exits_1(tmp_path):
    bad = tmp_path / "bad.cir"
    bad.write_text("bad\n.op\nR1 1 0 abc\nV1 1 0 DC 1\n")
    jrc, _, jerr = run_main(jax_main, [str(bad)])
    prc, pout, perr = run_main(port_main, [str(bad), "--platform", "cpu"])
    assert jrc == prc == 1
    assert perr == jerr and perr.startswith("Analysis failed: ")
    assert pout == ""
    rc, _, err = run_main(port_main, [str(tmp_path / "none.cir"),
                                      "--platform", "cpu"])
    assert rc == 1 and err.startswith("Error reading netlist file")


def test_platform_cuda_exits_1_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --platform cuda runs there")
    rc, out, err = run_main(port_main, [deck_path("divider_op.cir")])
    assert rc == 1 and out == ""
    assert "torch.cuda.is_available() is false" in err
    proc = subprocess.run(
        [sys.executable, "-m", "toyspice_tpu_torch",
         deck_path("divider_op.cir"), "--platform", "cuda"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and proc.stdout == ""


def test_python_m_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "toyspice_tpu_torch",
         deck_path("divider_op.cir"), "--platform", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    _, want, _ = run_main(jax_main, [deck_path("divider_op.cir")])
    assert proc.stdout == want


@pytest.mark.parametrize("engine", ["host", "host-native"])
def test_host_engines_through_the_cli(engine):
    from toyspice_tpu_torch import hostsim, native

    if engine == "host-native" and not native.available():
        pytest.skip("no native toolchain")
    deck = deck_path("half_wave_rectifier.cir")
    try:
        jrc, jout, _ = run_main(jax_main, [deck, "--engine", engine])
        prc, pout, _ = run_main(port_main, [deck, "--engine", engine,
                                            "--platform", "cpu"])
    finally:
        hostsim.set_solver("numpy")
        import toyspice_tpu.hostsim as jhost

        jhost.set_solver("numpy")
    assert jrc == prc == 0
    assert pout == jout  # the same sequential engine, bit for bit


def test_host_engine_refuses_physics():
    rc, _, err = run_main(port_main, [deck_path("divider_op.cir"), "--engine",
                                      "host", "--semantics", "physics",
                                      "--platform", "cpu"])
    assert rc == 1 and "compat semantics only" in err


def test_debug_nans_raises_at_a_non_finite_solve(tmp_path):
    floating = tmp_path / "floating.cir"
    floating.write_text("floating node\n.op\nV1 1 0 DC 1\nR1 1 0 1k\n"
                        "C1 2 3 1u\n")
    rc, _, err = run_main(port_main, [str(floating), "--platform", "cpu",
                                      "--debug-nans"])
    assert rc == 1 and "debug_nans" in err
    # off by default: the run ends as the JAX CLI's does
    jrc, _, jerr = run_main(jax_main, [str(floating)])
    prc, _, perr = run_main(port_main, [str(floating), "--platform", "cpu"])
    assert prc == jrc and perr == jerr


def tables_and_results(name, monkeypatch):
    """One run of each CLI on ``name``: the tables compared with
    ``same_tables`` and the Results the CLIs printed (recorded where each
    main calls its run_analysis) with test_torch_api's bar."""
    import toyspice_tpu.cli as jcli
    import toyspice_tpu_torch.cli as pcli

    from test_torch_api import assert_results_match

    seen = {}
    for mod, key in ((jcli, "jax"), (pcli, "port")):
        def recording(*args, _run=mod.run_analysis, _key=key, **kw):
            seen[_key] = _run(*args, **kw)
            return seen[_key]

        monkeypatch.setattr(mod, "run_analysis", recording)
    jrc, jout, _ = run_main(jax_main, [deck_path(name)])
    prc, pout, _ = run_main(port_main, [deck_path(name), "--platform", "cpu"])
    assert jrc == prc == 0
    same_tables(pout, jout)
    assert_results_match(seen["port"], seen["jax"])
