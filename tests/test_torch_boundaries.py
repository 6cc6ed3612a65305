"""Boundaries of the port: it imports nothing of JAX or of the JAX package.

An AST scan of every module of ``src/repro_torch``, of the port's examples
(``examples/torch/``) and of ``chip_smoke.py``
fails on any import of ``jax``, ``ml_dtypes``, ``repro`` or ``repro.*``
(``repro_torch`` itself is allowed). The machine with the card has neither
JAX nor ml_dtypes, and the port keeps its own copy of what it needs.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + sorted((ROOT / "examples" / "torch").glob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_the_port_has_sources_to_scan():
    assert len(SOURCES) > 20
    assert all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_modules(tree)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_catches_what_it_forbids():
    src = ("import jax.numpy as jnp\nfrom repro.core import types\n"
           "from repro_torch.core import types\nimport ml_dtypes\n"
           "importlib.import_module('repro.models')\n")
    mods = [m for _, m in _imported_modules(ast.parse(src))
            if m.split(".")[0] in FORBIDDEN]
    assert mods == ["jax.numpy", "repro.core", "ml_dtypes", "repro.models"]


def test_the_training_modules_are_scanned():
    rel = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("train/loss.py", "train/optimizer.py", "train/train_step.py",
                "train/trainer.py", "checkpoint/checkpointer.py",
                "launch/train.py", "data/pipeline.py",
                "core/chunk_search.py"):
        assert f"src/repro_torch/{mod}" in rel, mod


def test_the_paper_core_and_the_examples_are_scanned():
    rel = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("core/oracle.py", "core/platforms.py", "core/simulate.py"):
        assert f"src/repro_torch/{mod}" in rel, mod
    for name in ("quickstart", "overhead_analysis", "serve_hetero",
                 "train_hetero_lm", "observe"):
        assert f"examples/torch/{name}.py" in rel, name


def test_the_sharding_and_dry_run_modules_are_scanned():
    rel = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("sharding/__init__.py", "sharding/rules.py",
                "sharding/partition.py", "launch/mesh.py",
                "launch/dryrun.py", "kernels/cost.py"):
        assert f"src/repro_torch/{mod}" in rel, mod
