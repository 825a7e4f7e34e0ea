"""The reference's doc-example goldens, run on the port's host API.

Five test files hold the JAX package's constriction-compatible host API to
bamler-lab/constriction's own published bitstreams:
``test_golden_reference.py``, ``test_docexamples.py``,
``test_docexamples_f32_lazy.py``, ``test_docexamples_full.py`` and
``test_docexamples_parity.py``.  Here each is loaded under a private name
with every import of ``constriction_tpu`` (the module's global
``constriction`` and the imports inside its functions) resolved to
``constriction_tpu_torch`` instead, and each of its ``test_*`` functions,
its ``parametrize`` marks expanded, is one case of one parametrised test.
The files themselves are neither edited nor copied.  Tolerance: the
goldens' own (equality for every word and symbol).
"""

import builtins
import importlib.util
import itertools
import os

import pytest

import constriction_tpu_torch

TESTS = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("test_golden_reference.py", "test_docexamples.py",
           "test_docexamples_f32_lazy.py", "test_docexamples_full.py",
           "test_docexamples_parity.py")
JAX_PACKAGE, PORT = "constriction_tpu", "constriction_tpu_torch"


def _port_import(name, globals=None, locals=None, fromlist=(), level=0):
    """``__import__`` with the JAX package's name mapped to the port's."""
    if level == 0 and (name == JAX_PACKAGE
                       or name.startswith(JAX_PACKAGE + ".")):
        name = PORT + name[len(JAX_PACKAGE):]
    return builtins.__import__(name, globals, locals, fromlist, level)


def _load(source: str):
    """One golden file, every import of the JAX package bound to the
    port's."""
    spec = importlib.util.spec_from_file_location(
        "_golden_on_port_" + source[:-3], os.path.join(TESTS, source))
    module = importlib.util.module_from_spec(spec)
    module.__builtins__ = {**vars(builtins), "__import__": _port_import}
    spec.loader.exec_module(module)
    assert module.constriction is constriction_tpu_torch
    return module


def _expand(fn):
    """The keyword sets of ``fn``'s stacked ``parametrize`` marks, with
    their ids."""
    axes = []
    for mark in getattr(fn, "pytestmark", []):
        assert mark.name == "parametrize", mark
        names, values = mark.args[0], mark.args[1]
        names = [n.strip() for n in (names.split(",")
                                     if isinstance(names, str) else names)]
        axis = []
        for v in values:
            v = v.values if hasattr(v, "values") else (
                v if len(names) > 1 else (v,))
            axis.append((dict(zip(names, v)), "-".join(map(str, v))))
        axes.append(axis)
    for combo in itertools.product(*axes):
        kwargs = {k: v for kw, _ in combo for k, v in kw.items()}
        yield kwargs, "-".join(i for _, i in combo)


def _cases():
    for source in SOURCES:
        module = _load(source)
        for name, fn in vars(module).items():
            if name.startswith("test_") and callable(fn):
                for kwargs, ident in _expand(fn):
                    case = f"{source[:-3]}.{name}"
                    yield pytest.param(module, name, kwargs,
                                       id=f"{case}-{ident}" if ident
                                       else case)


CASES = list(_cases())


def test_case_count():
    """Every function and parameter set of the five files (157 cases)."""
    assert len(CASES) == 157


@pytest.mark.parametrize("module, name, kwargs", CASES)
def test_golden_on_port(module, name, kwargs):
    getattr(module, name)(**kwargs)
