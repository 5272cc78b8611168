"""The port's examples (toyspice_tpu_torch/examples/) under
TOYSPICE_PLATFORM=cpu against the JAX package's examples/, both run in
this process: every printed line equal, apart from the lines that report
wall times, where the numbers the run computed (accepted steps, accept
ratio, failures) must be equal.

montecarlo runs at BATCH = 4 with each lane stopped at 2000 attempts on
both sides (``max_attempts`` of its config): the whole deck takes 23,656
attempts a lane, about 25 s a run of the run kernel's plain version on one
CPU core, and the example runs it twice."""

import importlib
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("rr", "diode1", "diode2", "bjt", "montecarlo")
TIMED = re.compile(r"^(compile|build) \+ first run: ")
AGGREGATE = re.compile(r"^aggregate: (\d+) accepted steps in [\d.]+s -> "
                       r"[\d.]+M steps/s, accept ratio ([\d.]+), (\d+) "
                       r"failures$")


def _lines(module, capsys):
    module.main()
    return [line for line in capsys.readouterr().out.splitlines()
            if not TIMED.match(line)]


def _shorten(module, monkeypatch):
    build = module.build_config
    monkeypatch.setattr(module, "BATCH", 4)
    monkeypatch.setattr(module, "build_config", lambda *a, **k: build(
        *a, **k)._replace(max_attempts=2000))


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_what_the_jax_example_prints(name, monkeypatch,
                                                    capsys):
    monkeypatch.setenv("TOYSPICE_PLATFORM", "cpu")
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))
    port = importlib.import_module(f"toyspice_tpu_torch.examples.{name}")
    ref = importlib.import_module(name)
    assert ref.__file__ == os.path.join(ROOT, "examples", f"{name}.py")
    if name == "montecarlo":
        _shorten(port, monkeypatch)
        _shorten(ref, monkeypatch)
    got, want = _lines(port, capsys), _lines(ref, capsys)
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        gm, wm = AGGREGATE.match(g), AGGREGATE.match(w)
        if wm:
            assert gm and gm.groups() == wm.groups(), (g, w)
        else:
            assert g == w
    assert got[-1] == "Done!"
