"""The JAX package's test cases, run against the PyTorch port.

:func:`load_cases` reads one of the JAX package's test files, points
every import of ``distributed_oracle_search_tpu`` at
``distributed_oracle_search_tpu_torch`` (``_PORT_IMPORTS`` names the
imports the port spells differently), drops the cases the caller names
(each with its reason), and executes the rest as the calling test
module's own cases: same names, same bodies, same assertions. The cases
then hold the port to exactly what they hold the JAX package to.

Two fixtures come with them:

* ``toy_graph`` / ``toy_queries`` override the root conftest's (which
  build JAX-package graphs) with the port's own, from the same seeds;
* ``_port_on_cpu`` (autouse, per module) resolves the port's default
  device to the CPU for these cases, which call the entry points with
  no ``device`` as the JAX package's tests do; a wrapper then takes its
  plain torch path because its tensors lie on the CPU;
* ``_port_reset`` (autouse) resets the port's fault injector and flight
  recorder after each case, as the root conftest does for the JAX
  package's;
* ``_keep_package_loggers`` (autouse, per module) puts both packages'
  root loggers back after the module: a CLI's ``set_verbosity`` gives
  one a handler and stops it propagating, which later modules of the
  process that read logs through ``caplog`` would otherwise miss.

Imports nothing of JAX; the rewritten cases import the port only.
"""

import ast
import importlib
import logging
import os
import pkgutil
import re

import pytest

PORT = "distributed_oracle_search_tpu_torch"
HERE = os.path.dirname(os.path.abspath(__file__))
_JAX_NAME = re.compile(r"\bdistributed_oracle_search_tpu\b(?!_torch)")
#: imports the port spells differently: its worker package exports the
#: engine only (importing the server there would register the server's
#: metrics in every build process)
_PORT_IMPORTS = {
    f"from {PORT}.worker import FifoServer, stop_server":
        f"from {PORT}.worker.server import FifoServer, stop_server",
}

_FIXTURES = '''

@pytest.fixture(scope="module")
def toy_graph():
    from distributed_oracle_search_tpu_torch.data import synth_city_graph
    return synth_city_graph(8, 6, seed=7)


@pytest.fixture(scope="module")
def toy_queries(toy_graph):
    from distributed_oracle_search_tpu_torch.data import synth_scenario
    return synth_scenario(toy_graph.n, 64, seed=11)
'''


def _import_port() -> list:
    """Every module of the port, imported (so a patch of an imported
    name reaches each module that holds it)."""
    pkg = importlib.import_module(PORT)
    mods = [pkg]
    for info in pkgutil.walk_packages(pkg.__path__, PORT + "."):
        mods.append(importlib.import_module(info.name))
    return mods


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    import torch

    from distributed_oracle_search_tpu_torch.utils import device as dmod

    real = dmod.resolve_device

    def on_cpu(device=None):
        if device is None or torch.device(device).type == "cuda":
            device = "cpu"
        return real(device)

    with pytest.MonkeyPatch.context() as mp:
        for mod in _import_port():
            if getattr(mod, "resolve_device", None) is real:
                mp.setattr(mod, "resolve_device", on_cpu)
        yield


@pytest.fixture(autouse=True)
def _port_reset():
    yield
    from distributed_oracle_search_tpu_torch.obs import recorder
    from distributed_oracle_search_tpu_torch.testing import faults

    faults.reset()
    recorder.set_recorder(None)


@pytest.fixture(autouse=True, scope="module")
def _keep_package_loggers():
    saved = []
    for name in ("dos_tpu", "dos_torch"):
        lg = logging.getLogger(name)
        saved.append((lg, list(lg.handlers), lg.propagate, lg.level))
    yield
    for lg, handlers, propagate, level in saved:
        lg.handlers[:] = handlers
        lg.propagate = propagate
        lg.setLevel(level)


def load_cases(jax_file: str, module_name: str, drop: dict,
               replace: dict | None = None, only=()) -> dict:
    """The cases of ``tests/<jax_file>`` over the port, as a namespace
    for the calling module's ``globals().update``. ``drop`` maps each
    case left out to its reason (every name must exist); ``replace``
    maps exact source snippets to their port text (each must occur).
    ``only``: the namespace holds just these cases (each must exist,
    none may need an entry point's default device) and ``_port_reset``,
    for a module that has cases of its own."""
    path = os.path.join(HERE, jax_file)
    with open(path) as f:
        src = f.read()
    for old, new in (replace or {}).items():
        assert old in src, (jax_file, old)
        src = src.replace(old, new)
    src = _JAX_NAME.sub(PORT, src)
    for old, new in _PORT_IMPORTS.items():
        src = src.replace(old, new)
    tree = ast.parse(src)
    names = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    missing = set(drop) - names
    assert not missing, (jax_file, sorted(missing))
    tree.body = [n for n in tree.body
                 if not (isinstance(n, ast.FunctionDef) and n.name in drop)]
    tree.body += ast.parse(_FIXTURES).body
    ns = {"__name__": module_name, "__file__": path,
          "__builtins__": __builtins__}
    exec(compile(tree, f"{path} (over {PORT})", "exec"), ns)
    ns["_port_on_cpu"] = _port_on_cpu
    ns["_port_reset"] = _port_reset
    ns["_keep_package_loggers"] = _keep_package_loggers
    if only:
        assert set(only) <= names, (jax_file, sorted(set(only) - names))
        return {k: ns[k] for k in (*only, "_port_reset",
                                   "_keep_package_loggers")}
    return {k: v for k, v in ns.items() if not k.startswith("__")}
