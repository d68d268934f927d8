"""The port stands without the JAX package: its data files are its own
copies (the same bytes as the reference's), and no module of the port nor
``chip_smoke.py`` imports ``jax`` or ``computational_ray_tracer_tpu`` or
builds a path from that package's name.

The scan reads each file's syntax tree: imports (also ``importlib.
import_module`` and ``__import__`` of a constant), and every string
constant outside docstrings. A string may still name a reference file
with a line number ("computational_ray_tracer_tpu/ops/pallas_interp.py:36"
in ``chip_smoke.py``'s ``replaces`` fields): that cites the replaced TPU
kernel and is not a path the code opens.
"""

import ast
import hashlib
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "computational_ray_tracer_tpu_torch")
REF = "computational_ray_tracer_tpu"
DATA_FILES = ("spectra_tables.npz", "sobol_tail.npz", "rgb2spec_srgb_64.npy")
# The reference package's name, not followed by "_torch".
REF_NAME = re.compile(REF + r"(?!_torch)")
# A citation of a reference file and line: "<ref>/<path>.py:<line>".
CITATION = re.compile(REF + r"/[\w/]+\.py:\d+")


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("name", DATA_FILES)
def test_data_file_is_a_copy(name):
    got = os.path.join(PORT, "ops", "data", name)
    want = os.path.join(ROOT, REF, "ops", "data", name)
    assert _sha256(got) == _sha256(want)


def test_port_reads_its_own_data_dir():
    from computational_ray_tracer_tpu_torch.ops import spectra_data
    assert os.path.samefile(spectra_data.DATA_DIR,
                            os.path.join(PORT, "ops", "data"))


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return out


def _docstrings(tree):
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value,
                                                          ast.Constant):
                ids.add(id(first.value))
    return ids


def _is_reference_module(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", REF)


def violations(source, filename="<source>"):
    """(line, what) for each import of jax or the reference package and
    each string constant naming the reference package outside docstrings
    and file:line citations."""
    tree = ast.parse(source, filename)
    docs = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, "import " + a.name) for a in node.names
                      if _is_reference_module(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _is_reference_module(node.module):
            found.append((node.lineno, "from " + node.module))
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str) and _is_reference_module(
                node.args[0].value) and (
                getattr(node.func, "attr", None) == "import_module"
                or getattr(node.func, "id", None) == "__import__"):
            found.append((node.lineno, "imports " + node.args[0].value))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs \
                and REF_NAME.search(CITATION.sub("", node.value)):
            found.append((node.lineno, "names " + repr(node.value)))
    return found


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_reference_imports_or_paths(path):
    with open(path) as f:
        assert violations(f.read(), path) == []


@pytest.mark.parametrize("source, n", [
    ("import jax.numpy as jnp", 1),
    ("from computational_ray_tracer_tpu.ops import rng", 1),
    ("import importlib\nimportlib.import_module('jax')", 1),
    ("os.path.join(root, 'computational_ray_tracer_tpu', 'ops')", 1),
    ("p = 'computational_ray_tracer_tpu/ops/data/sobol_tail.npz'", 1),
    ("from computational_ray_tracer_tpu_torch.ops import rng", 0),
    ("r = 'computational_ray_tracer_tpu/ops/pallas_octree.py:242'", 0),
    ('def f():\n    """Port of computational_ray_tracer_tpu/ops/x.py."""', 0),
])
def test_scan_finds_what_it_should(source, n):
    assert len(violations(source)) == n
