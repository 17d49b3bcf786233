"""Import hygiene of the benchmark: no module under ``servebench/``
imports JAX, Flax or the JAX package (top-level names compared whole:
``repro_torch`` is not ``repro``), and only ``program.py`` imports the
program."""
import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent
BANNED = {"jax", "jaxlib", "flax", "repro"}


def roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(ROOT.rglob("*.py"))
    assert len(files) > 20
    bad = {str(p.relative_to(ROOT)): sorted(set(roots(p)) & BANNED)
           for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_only_the_program_module_imports_the_program():
    users = sorted(str(p.relative_to(ROOT)) for p in ROOT.rglob("*.py")
                   if "repro_torch" in set(roots(p))
                   and not p.name.startswith("test_"))
    assert users == ["program.py"]


def test_the_reference_imports_only_torch():
    files = ["reference.py", "judge.py", "weights.py"] + sorted(
        str(p.relative_to(ROOT)) for p in (ROOT / "families").glob("*.py"))
    assert "families/dense.py" in files
    for name in files:
        assert set(roots(ROOT / name)) <= {"__future__", "contextlib",
                                           "dataclasses", "importlib",
                                           "math", "typing", "numpy",
                                           "torch", "servebench"}, name
