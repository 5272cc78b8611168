"""Every public name of the JAX package's user surface has its
counterpart in the port: ``toyspice_tpu``, ``toyspice_tpu.engine``,
``.utils``, ``.ops``, ``.hostsim``, ``.debug``, ``.cli``, ``.native``,
``.utils.profiling`` and ``.parallel``.

A public name is one in the module's ``__all__`` where it has one, else
one without a leading underscore that the JAX package defines (its
``__module__`` is in ``toyspice_tpu``) or that is a constant.  Three
names of ``toyspice_tpu.ops`` are the Pallas kernels' wrappers and have
the hand-written kernels' wrappers as counterparts (``RENAMED``).  Every
subpackage of the JAX package has its counterpart; none is exempt."""

import importlib
import inspect

import pytest

import toyspice_tpu  # noqa: F401  (tests/conftest.py set JAX up)

MODULES = ("", ".engine", ".utils", ".ops", ".hostsim", ".debug", ".cli",
           ".native", ".utils.profiling", ".parallel")
# the JAX package's Pallas wrappers -> the port's kernel wrappers
RENAMED = {(".ops", "pallas_solve_batched"): "launch_gj"}
EXEMPT = ()


def public_names(mod):
    if hasattr(mod, "__all__"):
        return sorted(mod.__all__)
    out = []
    for name, obj in vars(mod).items():
        if name.startswith("_") or inspect.ismodule(obj):
            continue
        owner = getattr(obj, "__module__", None) or ""
        if (owner.split(".")[0] == "toyspice_tpu"
                or isinstance(obj, (int, float, str))):
            out.append(name)
    return sorted(out)


@pytest.mark.parametrize("suffix", MODULES, ids=[m or "top" for m in
                                                 MODULES])
def test_port_has_every_public_name(suffix):
    jmod = importlib.import_module("toyspice_tpu" + suffix)
    pmod = importlib.import_module("toyspice_tpu_torch" + suffix)
    names = public_names(jmod)
    assert names, f"toyspice_tpu{suffix} lists no public name"
    missing = [n for n in names
               if not hasattr(pmod, RENAMED.get((suffix, n), n))]
    assert not missing, f"toyspice_tpu_torch{suffix} lacks {missing}"


def test_parallel_is_the_only_exempt_package():
    import pkgutil

    subs = {m.name for m in pkgutil.iter_modules(toyspice_tpu.__path__,
                                                 "toyspice_tpu.")
            if m.ispkg}
    port = {"toyspice_tpu." + m.name for m in pkgutil.iter_modules(
        importlib.import_module("toyspice_tpu_torch").__path__) if m.ispkg}
    assert subs - port == set(EXEMPT)
