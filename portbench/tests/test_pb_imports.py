"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program.  Module names are compared by
their whole top-level name: the port's ``tqdne_tpu_torch`` begins with the JAX
package's ``tqdne_tpu``."""

import ast
import json
import os
import subprocess
import sys

from portbench.tests.conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tqdne_tpu"}


def imported(path) -> set[str]:
    """Top-level names of every absolute import in a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not imported(path) & (FORBIDDEN | {"tqdne_tpu_torch"}), path
        # nor the harness: only its own modules, torch and numpy
        text = path.read_text()
        assert "portbench.harness" not in text and "portbench.kinds" not in text, path


def test_a_run_loads_no_jax():
    """A whole run of a cell (on the CPU, the card's check skipped) leaves no
    JAX, flax or JAX-package module in the process."""
    code = (
        "import sys, torch\n"
        "from portbench.tests.conftest import GEN, tiny_cell\n"
        "from portbench.harness.context import Ctx\n"
        "from portbench.run import run_cell, loaded_forbidden\n"
        "name, over = GEN['1d']\n"
        "run_cell(tiny_cell(name, **over), Ctx(torch.device('cpu'), 3, 0.0, False))\n"
        "print(loaded_forbidden())\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert done.returncode == 0, done.stderr[-2000:]
    assert json.loads(done.stdout.strip().splitlines()[-1].replace("'", '"')) == []
