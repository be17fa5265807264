"""What the benchmark loads: no module of the JAX package, ``jax``,
``jaxlib`` or ``flax`` (compared by whole top-level names), and a
reference that loads nothing of the program."""
import os
import subprocess
import sys

import pytest

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "linkpred_tpu"}


def _modules():
    base = os.path.join(ROOT, "lpbench")
    for dirpath, dirs, files in os.walk(base):
        dirs[:] = [d for d in dirs if d not in ("tests", "__pycache__",
                                                ".cache")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), ROOT)


def _loaded(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr
    return set(p.stdout.split())


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    paths = sorted(_modules())
    assert "lpbench/run.py" in paths and "lpbench/reference/linkpred.py" in paths
    code = (
        "import importlib, os, sys\n"
        "from lpbench import run\n"
        f"for p in {paths!r}:\n"
        "    folder, name = os.path.split(p[len('lpbench/'):-3])\n"
        "    if folder in ('end_to_end', 'layer_metrics') and name[0] != '_':\n"
        "        run.load_reader(folder, name)\n"
        "    else:\n"
        "        importlib.import_module(p[:-3].replace('/', '.'))\n"
        "import linkpred_tpu_torch.predict.api, linkpred_tpu_torch.predict.plan\n"
        "print(' '.join({m.split('.')[0] for m in sys.modules}))\n")
    top = _loaded(code)
    assert "linkpred_tpu_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


@pytest.mark.parametrize("module", ["lpbench.reference", "lpbench.graph500",
                                    "lpbench.judge"])
def test_the_yardstick_loads_nothing_of_the_program(module):
    top = _loaded(f"import sys, {module}\n"
                  "print(' '.join({m.split('.')[0] for m in sys.modules}))")
    assert not top & (FORBIDDEN | {"linkpred_tpu_torch"})
