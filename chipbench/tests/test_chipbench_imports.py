"""What the benchmark's sources import: nothing of JAX or the JAX package
(``repro``; top-level names compared whole, since ``repro_torch`` begins
with it), and the reference nothing of the port or the harness."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from chipbench.tests.tiny import ROOT  # noqa: I001  (first: puts src/ on the path)

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path):
    """Top-level names of every module ``path`` imports (relative ones as '.')."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value.split(".")[0])
    return out


SOURCES = sorted((ROOT / "chipbench").rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "chipbench/reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = imported(path)
    assert "repro_torch" not in names
    text = path.read_text()
    assert "chipbench.harness" not in text and "repro_torch" not in text


def test_the_forbidden_check_compares_whole_names():
    from chipbench import run

    assert run.forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.models", "jax", "flax.linen", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_without_a_card_exits_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, str(ROOT / "chipbench/run.py"), "--workload",
                        "qwen3-1.7b.train", "--seed", "3000000000", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, env=env, timeout=120,
                       cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr
