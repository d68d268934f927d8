"""What the harness and the reference load: never JAX nor the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "computational_ray_tracer_tpu"}
PORT = "computational_ray_tracer_tpu_torch"


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(HERE, "**", "*.py"), recursive=True)),
    ids=lambda p: os.path.relpath(p, HERE))
def test_sources_import_no_jax(path):
    top = _imported(path)
    assert not top & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert PORT not in top


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    loaded = _loaded(
        "import sys, glob, os\n"
        "from gpubench import cells, harness, scenes\n"
        "for f in glob.glob('gpubench/traffic/*.py'):\n"
        "    cells.kind(os.path.basename(f)[:-3])\n"
        "for f in glob.glob('gpubench/metrics/*.py'):\n"
        "    cells.metric(os.path.basename(f)[:-3])\n"
        "scenes.namespace(scenes.PORT); scenes.namespace(scenes.REFERENCE)\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    assert not loaded & FORBIDDEN
    assert PORT in loaded


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded(
        "import sys, glob, importlib\n"
        "for f in sorted(glob.glob('gpubench/reference/**/*.py',"
        " recursive=True)):\n"
        "    importlib.import_module(f[:-3].replace('/', '.')"
        ".removesuffix('.__init__'))\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    assert not loaded & (FORBIDDEN | {PORT})
