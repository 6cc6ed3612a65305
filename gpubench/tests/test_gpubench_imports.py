"""Nothing under gpubench/ imports JAX or the JAX package (top-level
module names compared whole: the port's ``repro_torch`` is not the JAX
package ``repro``), and the plain reference imports nothing of the
program under test."""
import ast
from pathlib import Path

import pytest

GPUBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    """The top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(GPUBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(GPUBENCH)) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((GPUBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_takes_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)


def test_the_scan_compares_whole_names(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import repro_torch.serve\nfrom repro.core import x\n"
                   "import jaxtyping\n")
    assert imported(src) & FORBIDDEN == {"repro"}
