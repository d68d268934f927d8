"""Everything of the benchmark that is found by name: a cell's file
``workloads/<cell>.json``, a configuration's ``configs/<config>.json``, a
job kind's generator ``traffic/<kind>.py``, a per-layer metric's reader
``metrics/<metric>.py`` and a mesh generator ``meshes/<generator>.py``.
Adding any of these is adding a file."""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _json(folder, name):
    path = os.path.join(HERE, folder, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


def _module(folder, name):
    path = os.path.join(HERE, folder, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder} file named {name!r} ({path})")
    key = f"gpubench.{folder}.{name.replace('.', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def cell(name):
    """The cell's parameters (``workloads/<name>.json``)."""
    return _json("workloads", name)


def config(name):
    """The configuration (``configs/<name>.json``)."""
    return _json("configs", name)


def kind(name):
    """The job kind's generator module (``traffic/<name>.py``)."""
    return _module("traffic", name)


def metric(name):
    """The per-layer metric's reader module (``metrics/<name>.py``)."""
    return _module("metrics", name)


def mesh_generator(name):
    """The mesh generator module (``meshes/<name>.py``)."""
    return _module("meshes", name)
