"""Import hygiene of the port: nothing under ``src/repro_torch/``, no
``examples/torch_*.py`` and not ``chip_smoke.py`` imports ``jax`` or
anything of the JAX package ``repro``, and importing the port's engine
or trainer loads neither."""
import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + sorted(
    (REPO / "examples").glob("torch_*.py")) + [REPO / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.JoinedStr)):
            head = node.args[0].values[0]
            if isinstance(head, ast.Constant):
                yield head.value.split(".")[0]


def test_port_files_import_no_jax_and_no_repro():
    assert len(FILES) > 20
    bad = {str(p.relative_to(REPO)): sorted(set(_imported_roots(p))
                                            & set(BANNED))
           for p in FILES}
    assert {k: v for k, v in bad.items() if v} == {}


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.engine, repro_torch.bridge, "
            "repro_torch.configs, repro_torch.kernels.ops, "
            "repro_torch.training.checkpoint, repro_torch.data, "
            "repro_torch.launch.train; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
