"""Nothing under bench/ imports JAX or the JAX package (top-level module
names compared whole, so ``repro_torch`` passes), and the plain reference
(its common parts, the model families and the engines) imports nothing
of the program."""
import ast
import subprocess
import sys

import pytest
from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted((ROOT / "bench").rglob("*.py"))
REFERENCE = sorted(
    [ROOT / "bench" / "harness" / f"{m}.py" for m in
     ("reference", "compare", "sizes", "spec", "weights", "traffic",
      "yardstick")]
    + list((ROOT / "bench" / "references").glob("*.py"))
    + list((ROOT / "bench" / "engines").glob("*.py")))


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[str(p.relative_to(ROOT)) for p in REFERENCE])
def test_reference_takes_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert "repro_torch" not in tops
    kind, name = path.parent.name, path.stem
    load = (f"import harness.{name}" if kind == "harness" else
            f"from harness import spec; spec.module({kind!r}, {name!r})")
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'bench')!r}]; "
            f"{load}; "
            f"bad = sorted({{m.split('.')[0] for m in sys.modules}} & "
            f"{{'repro_torch', 'jax', 'repro'}}); "
            f"assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
