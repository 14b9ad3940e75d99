"""The port's packaging: its console script and its optional extra, offline.

The counterpart of tests/test_packaging.py::test_console_entry_resolves for
the PyTorch/CUDA port: the ``erasurehead-tpu-torch`` entry names a callable
before any pip machinery runs, the ``torch`` extra lists what the port
imports, and the JAX package's entry and dependencies stay as they were.
"""

import importlib
import os
import tomllib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _project():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]


def test_torch_console_entry_resolves():
    target = _project()["scripts"]["erasurehead-tpu-torch"]
    module, attr = target.split(":")
    assert (module, attr) == ("erasurehead_tpu_torch.cli", "main")
    assert callable(getattr(importlib.import_module(module), attr))


def test_torch_extra_lists_the_ports_imports():
    extra = _project()["optional-dependencies"]["torch"]
    names = {dep.split(">")[0].split("=")[0].strip() for dep in extra}
    assert {"torch", "numpy", "scipy", "scikit-learn"} <= names


def test_jax_entry_and_dependencies_unchanged():
    project = _project()
    assert project["scripts"]["erasurehead-tpu"] == "erasurehead_tpu.cli:main"
    assert "jax>=0.4.30" in project["dependencies"]
    assert not any(dep.startswith("torch") for dep in project["dependencies"])
